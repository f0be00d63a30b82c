"""The port stands alone: no module under ``src/repro_torch/``, not
``chip_smoke.py``, no script under ``tools/`` and no example under
``examples_torch/`` imports JAX or the JAX package, nor the JAX package's
``benchmarks/`` (the faceoff example keeps its own copy of what it needs).

The machine with the card has PyTorch and no JAX, so one such import would
stop the port there. The scan reads every import statement (top level or
nested in a function) with ``ast``; nothing is imported to check it.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")
SOURCES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py"))
           + sorted((ROOT / "examples_torch").glob("*.py")))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_the_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for expected in ("chip_smoke.py", "src/repro_torch/kernels/rmnp_update.py",
                     "src/repro_torch/kernels/flash_attention.py",
                     "src/repro_torch/kernels/matmul.py",
                     "src/repro_torch/kernels/newton_schulz.py",
                     "src/repro_torch/core/muon.py", "src/repro_torch/core/dominance.py",
                     "src/repro_torch/launch/train.py",
                     "src/repro_torch/checkpoint/manager.py",
                     "src/repro_torch/checkpoint/faults.py",
                     "src/repro_torch/distributed/monitor.py",
                     "src/repro_torch/distributed/elastic.py",
                     "src/repro_torch/train/faults.py", "src/repro_torch/train/pipeline.py",
                     "src/repro_torch/train/dp_step.py",
                     "src/repro_torch/distributed/comm.py",
                     "src/repro_torch/distributed/compression.py",
                     "src/repro_torch/distributed/sharding.py",
                     "src/repro_torch/launch/serve.py",
                     "src/repro_torch/configs/qwen3_4b.py",
                     "src/repro_torch/models/moe.py",
                     "src/repro_torch/configs/deepseek_v2_lite_16b.py",
                     "src/repro_torch/configs/olmoe_1b_7b.py",
                     "src/repro_torch/configs/minicpm3_4b.py",
                     "src/repro_torch/models/ssm.py", "src/repro_torch/core/adamw.py",
                     "src/repro_torch/configs/xlstm_350m.py",
                     "src/repro_torch/configs/jamba_v0_1_52b.py",
                     "tools/step_repeat.py", "tools/flash_hd128_variants.py",
                     "src/repro_torch/configs/paligemma_3b.py",
                     "src/repro_torch/configs/musicgen_large.py",
                     "src/repro_torch/configs/all_archs.py",
                     "examples_torch/quickstart.py", "examples_torch/serve_batched.py",
                     "examples_torch/train_optimizer_faceoff.py",
                     "examples_torch/fault_tolerant_restart.py",
                     "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/cost.py",
                     "src/repro_torch/launch/dryrun.py", "src/repro_torch/launch/perf.py",
                     "src/repro_torch/launch/roofline.py"):
        assert expected in names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [f"{path.name}:{line} imports {mod}"
           for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_scan_catches_a_reference_import(tmp_path):
    """The check itself: nested and dotted imports of the reference are found,
    while ``repro_torch`` (which only starts with the same letters) is not."""
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.core\n"
                     "def f():\n    from repro.core import rmnp\n"
                     "    import jax.numpy as jnp\n"
                     "    from benchmarks.faceoff import loss_at_wall\n")
    mods = [m.split(".")[0] for _, m in _imported_modules(probe)]
    assert [m for m in mods if m in FORBIDDEN] == ["repro", "jax", "benchmarks"]
