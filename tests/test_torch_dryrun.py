"""The dry run of the port (``launch/mesh.py``, ``launch/cost.py``,
``launch/dryrun.py``, ``launch/perf.py``, ``launch/roofline.roofline_row``)
on the CPU, on meta tensors.

- The cost count on functions whose counts are known: each matmul form's
  ``2 M N K``, a view's zero bytes, an in-place op's zero allocations,
  elementwise and transcendental counts as ``tests/test_hlo_cost.py:23``
  and ``:53`` state them for XLA, and each kernel counted once through its
  launch record.
- The FLOPs of reduced gpt2-small (fp32) against the JAX package's HLO dot
  FLOPs of the same functions, compiled on the CPU and counted with
  ``repro.launch.hlo_cost``'s own ``_dot_flops`` and loop multipliers.
- The ring wire bytes against ``repro.launch.hlo_cost._wire_bytes``.
- The memory count: a hand-built function's peak, exact with the 512-byte
  rounding; the ZeRO-2 shards of a world of 4; the parameter bytes against
  the JAX package's specs, leaf by leaf.
- ``run_cell``, the skipped cells, ``perf._parse_overrides`` and the CLIs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import cost, dryrun, mesh, perf, roofline

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 32  # reduced gpt2-small's serving cells; training takes 8 x 32


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(fn, *args, world=1):
    counter = cost.StepCounter(world)
    names = [f"arg{i}" for i in range(len(args))]
    for name, a in zip(names, args, strict=True):
        counter.register(a, name)
    counter.run(fn, *args)
    return counter


# -- the cost count on known functions ---------------------------------------

MATMULS = {
    "mm": (lambda a, b: a @ b, (64, 32), (32, 48), 2 * 64 * 48 * 32),
    "bmm": (torch.bmm, (3, 64, 32), (3, 32, 48), 2 * 3 * 64 * 48 * 32),
    "linear": (lambda x, w: torch.nn.functional.linear(x, w), (5, 7, 32), (48, 32),
               2 * 35 * 48 * 32),
    "matmul_3d_2d": (torch.matmul, (5, 7, 32), (32, 48), 2 * 35 * 48 * 32),
    "einsum": (lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k), (2, 16, 4, 8),
               (2, 24, 4, 8), 2 * 2 * 4 * 16 * 24 * 8),
    "addmm": (lambda a, b: torch.addmm(_meta(64, 48), a, b), (64, 32), (32, 48),
              2 * 64 * 48 * 32),
    "baddbmm": (lambda a, b: torch.baddbmm(_meta(3, 64, 48), a, b, beta=2.0),
                (3, 64, 32), (3, 32, 48), 2 * 3 * 64 * 48 * 32),
}


@pytest.mark.parametrize("form", list(MATMULS))
def test_matmul_flops_are_exact(form):
    fn, sa, sb, want = MATMULS[form]
    c = _count(fn, _meta(*sa), _meta(*sb)).cost()
    assert c["matmul_flops"] == want
    # the epilogue's add of addmm/baddbmm is elementwise, beside the product
    extra = 64 * 48 * (3 if form == "baddbmm" else 1) if form in ("addmm", "baddbmm") else 0
    assert c["flops"] == want + extra
    assert c["flops_by_unit"][cost.FP32_FFMA] == c["flops"]  # fp32: TF32 is off


def test_bf16_products_go_to_the_tensor_cores():
    c = _count(lambda a, b: a @ b, _meta(64, 32, dtype=torch.bfloat16),
               _meta(32, 48, dtype=torch.bfloat16)).cost()
    assert c["flops_by_unit"][cost.BF16_TC] == 2 * 64 * 48 * 32
    assert c["compute_s"] == pytest.approx(2 * 64 * 48 * 32 / roofline.PEAK_FLOPS_BF16)


def test_a_view_costs_nothing():
    counter = _count(lambda x: x.view(8, 32, 4).transpose(0, 1)[..., :3].unsqueeze(0),
                     _meta(32, 32))
    c = counter.cost()
    assert c["bytes_accessed"] == 0 and c["flops"] == 0
    assert counter.memory.peak == 32 * 32 * 4  # the argument alone


def test_an_in_place_op_allocates_nothing():
    x = _meta(100, 30)
    counter = _count(lambda t: t.add_(1.0).mul_(2.0), x)
    assert counter.memory.peak == cost._rounded(x.numel() * 4)
    c = counter.cost()
    assert c["flops"] == 2 * x.numel()
    assert c["bytes_accessed"] == 2 * 2 * x.nbytes  # each op reads and writes x


def test_elementwise_and_transcendentals_counted():
    """``tests/test_hlo_cost.py:53``: exp(x) + x on 128 x 128, at least 2 N
    FLOPs and N transcendentals; here exactly."""
    c = cost.analyze_step(lambda x: torch.exp(x) + x, _meta(128, 128))
    n = 128 * 128
    assert c["flops"] == 2 * n and c["transcendentals"] == n
    # exp reads x and writes e; add reads e and x and writes the sum
    assert c["bytes_accessed"] == 5 * n * 4


def test_a_slice_write_moves_only_the_slice():
    def fn(big, small):
        big[3:5, :8] = small
        return big
    c = cost.analyze_step(fn, _meta(4096, 4096), _meta(2, 8))
    assert c["bytes_accessed"] == 2 * 2 * 8 * 4
    agg, top = cost.breakdown(fn, _meta(4096, 4096), _meta(2, 8))
    assert agg["copy"] == {"count": 1, "flops": 0.0, "bytes": 2 * 2 * 8 * 4.0}
    assert top[0][1] == "copy"


def test_a_kernel_is_counted_through_its_launch_record():
    """A wrapper on meta tensors records its launch and dispatches only its
    allocations: the RMNP apply, the Newton-Schulz step's three GEMMs and
    the flash kernel count their own formulas, once."""
    L, d_in, d_out = 3, 64, 96
    g, v, w = _meta(L, d_in, d_out), _meta(L, d_in, d_out), _meta(L, d_in, d_out,
                                                                   dtype=torch.bfloat16)
    counter = _count(lambda *a: ops.rmnp_bucket_update_apply(*a, 1e-3, 0.1, beta=0.95),
                     g, v, w)
    c = counter.cost()
    n = L * d_in * d_out
    assert c["kernel_launches"] == {"rmnp_apply": 1}
    assert c["flops"] == 10 * n and c["transcendentals"] == L * d_out
    agg, _ = counter.breakdown()
    assert agg["kernel:rmnp_apply"]["bytes"] == roofline.rmnp_bytes((L, d_in, d_out), 4, 2, True)
    # beside it only the copy of [scale, wd] to the device: 8 bytes read, 8 written
    assert c["bytes_accessed"] - agg["kernel:rmnp_apply"]["bytes"] == 16

    x = _meta(2, 48, 80)
    c = _count(lambda t: ops.ns_step(t, 3.4445, -4.775, 2.0315), x).cost()
    assert c["kernel_launches"] == {"matmul3": 2, "ns_poly3": 1}
    # Gram 48x48 over 80, the polynomial 48x48 over 48, the apply 48x80 over 48
    prod = 2 * 2 * (48 * 48 * 80 + 48 * 48 * 48 + 48 * 80 * 48)
    assert c["matmul_flops"] == prod
    assert c["flops_by_unit"][cost.TF32X3_TC] == prod
    # each input read once: the Gram's X and X^T, the polynomial's G thrice,
    # the apply's X twice
    reads = 2 * 48 * 80 + 2 * 48 * 48 + (2 * 48 * 48 + 2 * 48 * 80)
    writes = 2 * (48 * 48 + 48 * 48 + 48 * 80)
    assert c["bytes_accessed"] == 4 * (reads + writes)

    q, k = _meta(2, 100, 4, 64), _meta(2, 100, 2, 64)
    for causal in (True, False):
        from repro_torch.kernels.flash_attention import flash_attention_fwd
        c = _count(lambda a, b, vv: flash_attention_fwd(a, b, vv, causal=causal),
                   q, k, k).cost()
        assert c["kernel_launches"] == {"flash_attention_fwd": 1}
        assert c["matmul_flops"] == roofline.attention_flops(2, 100, 4, 64, causal)
        assert c["flops_by_unit"][cost.TF32X3_TC] == c["matmul_flops"]


def test_gemm_reads_and_counts_are_one_rule():
    """``roofline.gemm_reads`` and ``gemm_counts``, which the GEMM's launch
    record, its cost and its bound all take: an input passed twice, or
    beside its own transpose, is read once; a copy or another slice of it
    is another read."""
    x = torch.zeros(2, 48, 80)
    assert roofline.gemm_reads(x, x.transpose(1, 2)) == x.numel()
    assert roofline.gemm_reads(x, x, x) == x.numel()
    assert roofline.gemm_reads(x, x.clone(), None) == 2 * x.numel()
    assert roofline.gemm_reads(x[:, :24], x[:, 24:]) == x.numel()
    flops, nbytes = roofline.gemm_counts(2, 48, 48, 80, x.numel())
    assert flops == 2 * 2 * 48 * 48 * 80 and nbytes == 4 * (x.numel() + 2 * 48 * 48)
    ms, by, _ = roofline.gemm_bound(2, 48, 48, 80, x.numel())
    assert ms == nbytes / roofline.HBM_BW * 1e3 and by == "bytes"


def test_wire_bytes_match_the_jax_formula():
    from repro.launch.hlo_cost import _wire_bytes
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        for g in (2, 4, 16):
            for b in (512, 3 * 2**20):
                assert cost.wire_bytes(kind, b, g) == _wire_bytes(kind, b, g), (kind, g, b)


def test_collectives_of_a_group_are_counted_by_kind():
    counter = cost.StepCounter(4)
    comm = counter.comm()

    def fn(x, y):
        shard = comm.reduce_scatter(x)
        return comm.all_gather(shard), comm.all_reduce(y)
    counter.run(fn, _meta(4, 10, 16), _meta(37))
    coll = counter.cost()["collectives"]
    assert coll["reduce-scatter"] == {"count": 1, "result_bytes": 640.0,
                                      "wire_bytes": 640.0 * 3}
    assert coll["all-gather"] == {"count": 1, "result_bytes": 2560.0,
                                  "wire_bytes": 2560.0 * 3 / 4}
    # the all-reduce's own reduce-scatter and all-gather are parts of it
    assert coll["all-reduce"] == {"count": 1, "result_bytes": 148.0,
                                  "wire_bytes": 2 * 148.0 * 3 / 4}
    assert coll["all-to-all"]["count"] == 0


def test_replayed_ops_count_as_their_meta_kernels(monkeypatch):
    """An op met again with the same argument metadata makes its outputs
    from what its first call kept, without its meta kernel: the records
    equal those of every op run through its meta kernel, for training at
    worlds 1 and 4 (MoE and MLA among them), prefill and decode."""
    def strip(rec):
        return json.loads(json.dumps({k: v for k, v in rec.items() if k != "record_s"}))
    cells = [("gpt2-small", "train", 16, 4), ("deepseek-v2-lite-16b", "train", 8, 1),
             ("xlstm-350m", "prefill", 4, 1), ("jamba-v0.1-52b", "decode", 4, 1)]
    scan = cost._scan
    for arch, kind, batch, world in cells:
        cfg, shape = get_config(arch).reduced(), ShapeConfig(kind, S, batch, kind)
        replayed = dryrun.record(cfg, shape, world)
        monkeypatch.setattr(cost, "_scan", lambda f, a, k: (scan(f, a, k)[0], None))
        every = dryrun.record(cfg, shape, world)
        monkeypatch.setattr(cost, "_scan", scan)
        assert strip(replayed) == strip(every), arch


# -- FLOPs against the JAX package -------------------------------------------

def _jax_dot_flops(text):
    """The HLO's dot FLOPs by ``hlo_cost``'s own ``_dot_flops``, walked as
    ``HloCostAnalyzer.cost_of`` walks it (while bodies times their trip
    counts, the worst branch of a conditional, calls and fusions)."""
    from repro.launch import hlo_cost as hc
    an = hc.HloCostAnalyzer(text)
    memo = {}

    def walk(name):
        if name in memo:
            return memo[name]
        memo[name] = 0.0
        comp, total = an.comps.get(name), 0.0
        for op in (comp.ops if comp is not None else ()):
            if op.opcode == "while":
                body, cond = hc._BODY_RE.search(op.attrs), hc._COND_RE.search(op.attrs)
                total += an.trip_count(cond.group(1)) * (walk(body.group(1))
                                                          + walk(cond.group(1)))
            elif op.opcode == "conditional":
                m = hc._BRANCHES_RE.search(op.attrs)
                names = hc._PCT_NAME.findall(m.group(1) if m else op.attrs)
                total += max([walk(n) for n in names if n in an.comps] or [0.0])
            elif op.opcode in ("call", "fusion"):
                m = (hc._TO_APPLY_RE if op.opcode == "call" else hc._CALLS_RE).search(op.attrs)
                total += walk(m.group(1)) if m else 0.0
            elif op.opcode == "dot":
                total += hc._dot_flops(op, comp.symtab)
        memo[name] = total
        return total
    return walk(an.entry)


@pytest.fixture(scope="module")
def jax_flops():
    """The JAX package's dot FLOPs of reduced gpt2-small's prefill step (B x
    S), one decode step and the train step (8 x S, 4 microbatches,
    remat="full"), compiled on the CPU."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.core import cosine_with_warmup, mixed_optimizer
    from repro.models.layers import ParamSpec
    from repro.models.model import build_cache_specs, build_param_specs
    from repro.train.step import make_prefill_step, make_serve_step, make_train_step

    cfg = jax_config("gpt2-small").reduced()

    def sds(specs):
        return jax.tree_util.tree_map(
            lambda sp: jax.ShapeDtypeStruct(sp.shape, jnp.dtype(sp.dtype or cfg.dtype)),
            specs, is_leaf=lambda x: isinstance(x, ParamSpec))

    def i32(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.int32)

    def flops(fn, *args):
        return _jax_dot_flops(jax.jit(fn).lower(*args).compile().as_text())

    p = sds(build_param_specs(cfg))
    opt = mixed_optimizer("rmnp", cosine_with_warmup(2e-3, 10_000),
                          cosine_with_warmup(3e-4, 10_000))
    state = jax.eval_shape(opt.init, p)
    return {
        "prefill": flops(make_prefill_step(cfg), p, {"tokens": i32(B, S)}),
        "decode": flops(make_serve_step(cfg), p, sds(build_cache_specs(cfg, B, S)),
                        i32(B, 1), i32()),
        "train": flops(make_train_step(cfg, opt, num_microbatches=4, remat="full"), p, state,
                       {"tokens": i32(8, S), "labels": i32(8, S)}, i32()),
        "d_model": cfg.d_model, "padded_vocab": cfg.padded_vocab,
    }


@pytest.fixture(scope="module")
def records():
    """Dry-run records of reduced gpt2-small: train (8 x S), prefill and
    decode (B x S), at worlds 1 and 4 (train at world 4 takes 16 rows, 4 a
    rank)."""
    cfg = get_config("gpt2-small").reduced()
    out = {}
    for world in (1, 4):
        for kind, batch in (("train", 8 if world == 1 else 16), ("prefill", B * world),
                            ("decode", B * world)):
            out[kind, world] = dryrun.record(cfg, ShapeConfig(kind, S, batch, kind), world)
    return out


def test_prefill_and_decode_flops_equal_jax(jax_flops, records):
    """Decode equals JAX's dot FLOPs exactly. Prefill differs by one cause,
    exactly: the JAX prefill step forms the logits at every position and
    keeps the last (``repro/train/step.py:147``); the port applies the head
    to the last position only, so JAX's count is the port's plus the head
    over the other ``B * (S - 1)`` positions."""
    assert records["decode", 1]["cost"]["matmul_flops"] == jax_flops["decode"]
    head = 2 * B * (S - 1) * jax_flops["d_model"] * jax_flops["padded_vocab"]
    assert records["prefill", 1]["cost"]["matmul_flops"] + head == jax_flops["prefill"]


def test_train_flops_agree_with_jax(jax_flops, records):
    """The train step (4 microbatches, remat="full": the forward, its
    recomputation and the backward) within 2 % of JAX's dot FLOPs. Both
    count the same products; no difference is expected, and none shows."""
    got = records["train", 1]["cost"]["matmul_flops"]
    assert abs(got - jax_flops["train"]) <= 0.02 * jax_flops["train"]
    assert got == jax_flops["train"]


# -- the memory count ---------------------------------------------------------

def test_a_hand_built_peak_is_exact():
    def fn(x):
        a = torch.empty(1000, device="meta")       # 4000 B -> 4096
        b = torch.empty(10, device="meta")         # 40 B -> 512
        _ = b[1:]                                  # a view: nothing
        del a
        c = torch.empty(300, device="meta") + b[0]  # 1536 (empty) and 1536 (sum)
        return c
    counter = cost.StepCounter()
    x = _meta(100)                                 # 400 B -> 512
    assert counter.register(x, "x") == 400
    out = counter.run(fn, x)
    assert counter.memory.peak == 512 + 4096 + 512
    assert counter.memory.live == 512 + 1536  # x and the sum
    assert counter.memory.at_peak == {"x": 512, "forward": 4608}
    del out


def test_world_4_holds_its_shards(records):
    """Each stacked momentum bucket of rank 0 of 4 holds its ``padded / 4``
    rows, as ``distributed/sharding.shard_state`` cuts them."""
    from repro_torch.launch.specs import param_specs
    cfg = get_config("gpt2-small").reduced()
    opt = dryrun.make_optimizer_for("rmnp", cost.StepCounter(4).comm())
    plan = opt.bucket_plan(param_specs(cfg))
    buckets = records["train", 4]["memory"]["momentum_buckets"]
    assert {b.key: [b.padded // 4, b.d_in, b.d_out] for b in plan.buckets} == buckets
    assert records["train", 4]["memory"]["state_bytes"] < records["train", 1]["memory"][
        "state_bytes"]
    assert records["train", 4]["collective_wire_bytes"] > 0
    assert records["train", 1]["collective_wire_bytes"] == 0


def test_params_bytes_equal_the_jax_specs():
    import jax
    from repro.configs import get_config as jax_config
    from repro.launch.specs import param_specs as jax_param_specs
    from repro_torch.core.types import tree_paths
    from repro_torch.launch.specs import param_specs

    for arch in ("gpt2-small", "deepseek-v2-lite-16b"):
        cfg = get_config(arch).reduced()
        jmesh = jax.make_mesh((1, 1), ("data", "model"))
        sds, _ = jax_param_specs(jax_config(arch).reduced(), jmesh)
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                leaf.size * leaf.dtype.itemsize
                for path, leaf in jax.tree_util.tree_flatten_with_path(sds)[0]}
        got = {path: t.numel() * t.element_size() for path, t in tree_paths(param_specs(cfg))}
        assert got == want
        rec = dryrun.record(cfg, ShapeConfig("decode", 8, 2, "decode"), 1)
        assert rec["memory"]["params_bytes"] == sum(want.values())


# -- run_cell and the CLIs ----------------------------------------------------

def test_records_are_ok_at_worlds_1_and_4(records):
    for (kind, world), rec in records.items():
        assert rec["status"] == "ok" and rec["kind"] == kind and rec["world"] == world
        assert rec["model_parallel"] == 1
        assert rec["cost"]["flops"] > 0 and rec["memory"]["fits"]
        assert rec["cost"]["unclassified_ops"] == {}
        row = roofline.roofline_row(dict(rec, cell=f"{kind}_{world}"))
        assert row["dominant"] in ("compute", "memory", "collective")
        assert row["useful_flops_ratio"] > 0
        if kind != "prefill":
            # model_flops counts the head at every prompt position, which
            # the port's prefill forms at the last one only
            assert row["useful_flops_ratio"] <= 1.0


def test_long_500k_on_full_attention_is_skipped_with_the_jax_reason(tmp_path):
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_config
    from repro.configs import shape_applicable
    rec = dryrun.run_cell("qwen3-4b", "long_500k", False, tmp_path)
    _, why = shape_applicable(jax_config("qwen3-4b"), JAX_SHAPES["long_500k"])
    assert rec["status"] == "skipped" and rec["reason"] == why
    # a sub-quadratic arch is skipped too: its batch of 1 does not split
    rec = dryrun.run_cell("xlstm-350m", "long_500k", False, tmp_path)
    assert rec["status"] == "skipped" and "does not split over 16 ranks" in rec["reason"]


def test_the_worlds():
    single, multi = mesh.make_production_world(), mesh.make_production_world(multi_pod=True)
    assert (single.size, single.jax_mesh, multi.size, multi.jax_mesh) == (
        16, (16, 16), 32, (2, 16, 16))
    assert single.collective_lower_bound and multi.collective_lower_bound
    local = mesh.make_local_world()
    assert local.size == 1 and not local.collective_lower_bound
    assert single.describe()["model_parallel"] == 1


def test_parse_overrides_equals_jax():
    import jax
    jax.devices()  # the JAX module sets XLA_FLAGS on import; the backend is up first
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.perf import _parse_overrides
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    pairs = ["attn_impl=chunked", "attn_chunk_q=1024", "rope_theta=5e5", "x=1.5",
             "moe_dispatch=per_row", "n=-3", "s=", "e=1e-3x"]
    assert perf._parse_overrides(pairs) == _parse_overrides(pairs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        perf.run("gpt2-small", "decode_32k", "t", rules=["kv_seq=model"])


def test_the_clis(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "gpt2-small", "--shape", "decode_32k", "--out", str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "gpt2-small__decode_32k__single: OK mem=" in res.stdout
    rec = json.loads((tmp_path / "gpt2-small__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["world"] == 16 and rec["jax_mesh"] == [16, 16]
    (tmp_path / "qwen3-4b__long_500k__single.json").write_text(json.dumps(
        dryrun.run_cell("qwen3-4b", "long_500k", False, tmp_path)))
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        roofline.main(["--dir", str(tmp_path), "--markdown"])
    rows = [line for line in buf.getvalue().splitlines() if line.startswith("| ")][1:]
    assert len(rows) == 2
    assert any("gpt2-small__decode_32k__single" in r and r.endswith("| yes |") for r in rows)
    assert any("long_500k" in r and "skipped" in r for r in rows)
