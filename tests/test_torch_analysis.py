"""The port's analysis passes (``src/repro_torch/analysis``), on the CPU.

Counterpart of tests/test_analysis.py: the findings and their allowlist,
the combo matrix, the whole matrix recorded and finding-free, and the two
deliberately broken steps caught by the passes that guard against them
(``gather-momentum`` by the sharding and memory passes, ``defensive-copy``,
eager PyTorch's counterpart of a dropped donation, by the donation pass).
Everything runs in this process on meta tensors: no subprocess, no process
group, no device.
"""
import json

import pytest
import torch

from repro_torch.analysis import check, conventions, trace
from repro_torch.analysis.findings import Finding, Severity, apply_allowlist, report_dict
from repro_torch.analysis.framework import (
    Artifacts, BucketMeta, Combo, OpRecord, TensorInfo, run_passes,
)
from repro_torch.analysis.kernel_lint import lint_launch
from repro_torch.analysis.overlap import collective_overlap_report
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import introspect
from repro_torch.kernels import rmnp_update as rm
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


class TestFindings:
    def test_report_ranks_errors_first_and_counts(self):
        fs = [Finding("a", Severity.INFO, "i", "m"),
              Finding("b", Severity.ERROR, "e", "m"),
              Finding("c", Severity.WARNING, "w", "m")]
        r = report_dict(fs, ["x"], ["a", "b", "c"])
        assert [f["severity"] for f in r["findings"]] == ["error", "warning", "info"]
        assert r["counts"]["error"] == 1 and not r["ok"]
        assert r["version"] == 1

    def test_allowlist_downgrades_matching_only(self):
        fs = [Finding("memory", Severity.ERROR, "full-bucket-fp32", "abc"),
              Finding("memory", Severity.ERROR, "full-slot-stripe", "abc")]
        out = apply_allowlist(fs, [{"pass": "memory", "code": "full-bucket-fp32"}])
        assert out[0].severity is Severity.ALLOWLISTED
        assert out[1].severity is Severity.ERROR

    def test_empty_allowlist_entry_matches_nothing(self):
        fs = [Finding("memory", Severity.ERROR, "x", "m")]
        assert apply_allowlist(fs, [{}])[0].severity is Severity.ERROR


def test_combo_validation():
    with pytest.raises(ValueError):
        Combo("rmnp", "zero3", "fp32")
    with pytest.raises(ValueError):
        Combo("rmnp", "single-pass", "fp16")
    with pytest.raises(ValueError):
        Combo("rmnp", "single-pass", "fp32", accum=0)


def test_the_matrix_is_the_jax_packages():
    """Every registry optimizer x engine x wire, the rmnp accumulation
    points, and the guarded combos: 31, as repro.analysis.lowering builds."""
    combos = trace.build_combos()
    assert len(combos) == len({c.id for c in combos}) == 31
    assert {c.id for c in trace.build_combos(optimizers=["rmnp"], engines=["single-pass"])} == {
        "rmnp/single-pass/fp32/accum1", "rmnp/single-pass/int8-ef/accum1",
        "rmnp/single-pass/fp32/accum4", "rmnp/single-pass/int8-ef/accum4",
        "rmnp/single-pass/fp32/accum1/guard", "rmnp/single-pass/int8-ef/accum1/guard",
        "rmnp/single-pass/fp32/accum4/guard"}


@pytest.fixture(scope="module")
def sweep():
    return {c.id: trace.record_combo(c) for c in trace.build_combos()}


def test_registry_sweep_finding_free(sweep):
    """Every optimizer x engine x wire x accum step records and passes every
    check; the ZeRO-2 steps launch the kernels their rules take and
    gather each bucket's weights once."""
    findings = run_passes(list(sweep.values()))
    errors = [f for f in findings if f.severity in (Severity.ERROR, Severity.WARNING)]
    assert errors == [], errors[:5]
    art = sweep["rmnp/single-pass/fp32/accum1"]
    assert [launch.name for launch in art.launches] == ["rmnp_apply"] * len(art.buckets)
    assert [op.name for op in art.collectives].count("all_gather") >= len(art.buckets)
    muon = sweep["muon/single-pass/fp32/accum1"]
    assert len(muon.launches) == 3 * 5 * len(muon.buckets)
    assert {f.code for f in findings if f.pass_name == "donation"} == {"old-values-alive"}


@pytest.mark.parametrize("mode, codes", [
    ("gather-momentum", {("memory", "full-bucket-fp32"), ("sharding", "state-replicated")}),
    ("defensive-copy", {("donation", "defensive-copy")}),
])
def test_broken_variants_are_caught(mode, codes):
    """The forced momentum all-gather and the defensive copy are found in
    every combo they apply to, by the passes that guard against them."""
    arts = [trace.record_combo(c, break_mode=mode) for c in trace.build_combos()]
    findings = [f for f in run_passes(arts) if f.severity is Severity.ERROR]
    assert {(f.pass_name, f.code) for f in findings} == codes
    zero2_rules = {c.id for c in trace.build_combos(engines=["single-pass"])
                   if c.optimizer != "adamw"}
    caught = {f.combo for f in findings}
    if mode == "gather-momentum":
        assert caught == zero2_rules
    else:
        assert caught == {c.id for c in trace.build_combos()}


def test_check_cli_in_process(tmp_path):
    report = tmp_path / "report.json"
    assert check.main(["--optimizer", "rmnp", "--report", str(report)]) == 0
    r = json.loads(report.read_text())
    assert r["ok"] and len(r["combos"]) == 9 and r["counts"]["error"] == 0
    assert check.main(["--optimizer", "rmnp", "--engine", "single-pass", "--break",
                       "gather-momentum", "--pass", "sharding", "--report", str(report)]) == 1
    assert json.loads(report.read_text())["findings"][0]["code"] == "state-replicated"
    assert check.main(["--optimizer", "rmnp", "--break", "defensive-copy", "--pass",
                       "donation", "--report", str(report)]) == 1
    assert check.main(["--pass", "no-such-pass", "--report", str(report)]) == 2
    assert check.main(["--list"]) == 0


def _synthetic(ops, tensors):
    b = BucketMeta("8x16", 8, 16, 4, 4, {}, ((2, 8, 16), (2, 8, 16)))
    return Artifacts(combo=Combo("rmnp", "single-pass", "fp32"), ops=tuple(ops),
                     tensors=tensors, buckets=(b,))


def test_overlap_pass_finds_a_serialization_edge():
    """An updated-weight gather whose result feeds, through an op, a later
    gradient all_to_all is an edge; the same collective fed by the gradient
    alone is not."""
    t = {1: TensorInfo((1, 8, 16), torch.float32, 1), 2: TensorInfo((4, 8, 16), torch.float32, 2),
         3: TensorInfo((4, 8, 16), torch.float32, 3), 4: TensorInfo((4, 8, 16), torch.float32, 4),
         5: TensorInfo((4, 8, 16), torch.float32, 5)}
    ops = [OpRecord(0, "collective", "all_gather", (1,), (2,), ()),
           OpRecord(1, "op", "mul", (2, 5), (3,), (3,)),
           OpRecord(2, "collective", "all_to_all", (3,), (4,), ())]
    rep = collective_overlap_report(_synthetic(ops, t))
    assert rep["serialization_edges"] == [(0, 2, "8x16")]
    ops[1] = OpRecord(1, "op", "mul", (5,), (3,), (3,))
    assert collective_overlap_report(_synthetic(ops, t))["serialization_edges"] == []


def test_memory_and_sharding_passes_on_a_synthetic_step():
    from repro_torch.analysis.memory import MemoryPass
    from repro_torch.analysis.sharding import ShardingPass

    t = {1: TensorInfo((1, 8, 16), torch.float32, 1), 2: TensorInfo((4, 8, 16), torch.float32, 2),
         3: TensorInfo((4, 8, 16), torch.float32, 3)}
    ops = [OpRecord(0, "op", "empty", (), (2,), (2,)),  # the gather's own output
           OpRecord(1, "collective", "all_gather", (1,), (2,), ()),
           OpRecord(2, "op", "cat", (1,), (3,), (3,))]
    art = _synthetic(ops, t)
    mem = [f.code for f in MemoryPass().run(art) if f.severity is Severity.ERROR]
    assert mem == ["full-bucket-fp32"]  # the cat, not the gather's result
    assert [f.code for f in ShardingPass().run(art) if f.severity is Severity.ERROR] == []
    art.ops = art.ops[:2] + (OpRecord(2, "collective", "all_gather", (1,), (3,), ()),)
    assert [f.code for f in ShardingPass().run(art)
            if f.severity is Severity.ERROR] == ["state-replicated"]


def _launch(pair=(128, 128), dtype=torch.bfloat16):
    q = torch.empty(2, 1000, 8, pair[0], dtype=dtype, device="meta")
    k = torch.empty(2, 1000, 2, pair[0], dtype=dtype, device="meta")
    v = torch.empty(2, 1000, 2, pair[1], dtype=dtype, device="meta")
    (launch,) = introspect.collect_kernel_launches(lambda: fa.flash_attention_fwd(q, k, v))
    return launch


@pytest.mark.parametrize("bad, code", [
    ({"smem_bytes": 232449}, "smem-over-limit"),
    ({"cluster": (3, 1, 1)}, "cluster-too-large"),
    ({"block": (2048, 1, 1)}, "launch-limits"),
    ({"grid": (0, 1, 1)}, "launch-limits"),
], ids=["smem", "cluster", "block", "grid"])
def test_kernel_lint_flags_a_bad_launch(bad, code):
    launch = _launch()
    assert lint_launch(launch, "x") == []
    assert code in [c for c, _ in lint_launch(launch._replace(**bad), "x")]


def test_kernel_lint_holds_the_split_to_its_launch():
    g = torch.empty(2, 3072, 768, device="meta")
    launch = rm.describe(g, g, g, g, g, apply=True)
    assert lint_launch(launch, "x") == []
    drifted = launch._replace(smem_bytes=launch.smem_bytes - 4)
    assert [c for c, _ in lint_launch(drifted, "x")] == ["split-accounting"]
    short = rm.Split(K=2, R=100, C=64, threads=256, one_read=True)
    codes = [c for c, _ in lint_launch(rm.describe(g, g, g, g, g, apply=True, layout=short), "x")]
    # K * R < d_in, and every one of the five operands has the gap
    assert codes == ["split-accounting"] + ["grid-gap"] * 5


@pytest.mark.parametrize("source, code", [
    ("from repro_torch.kernels.build import load_library\nlib = load_library('x')\n",
     "kernel-library-outside-kernels"),
    ("import ctypes\nlib = ctypes.CDLL('libx.so')\n", "kernel-library-outside-kernels"),
    ("plan_cache = {}\n", "bare-dict-plan-cache"),
    ("import jax.numpy as jnp\n", "forbidden-import"),
    ("def f():\n    from repro.core import rmnp\n", "forbidden-import"),
], ids=["load_library", "CDLL", "plan-cache", "jax", "repro"])
def test_conventions_rule_fails_its_case(source, code):
    assert [c for c, _, _ in conventions.scan_source(source, "core/x.py")] == [code]


def test_conventions_allow_kernels_and_the_tree_is_clean():
    assert conventions.scan_source("lib = load_library('x')\n", "kernels/x.py") == []
    findings = conventions.ConventionsPass().run()
    assert [f for f in findings if f.severity is Severity.ERROR] == []
    assert findings[-1].code == "summary"
