"""The port's tooling against the JAX package's, on the CPU: launch counts
(``train/step.optimizer_launches`` against ``count_pallas_calls``), fp32
buffer counts, the meta-tensor input specs, the roofline's parameter and
FLOP counts, and the launch records themselves (coverage, and the layouts
that ``kernels/introspect.py`` mirrors from the CUDA sources).

Launch counts. The port's kernels launch where the JAX package's Pallas
kernels do, with one documented difference: a Newton-Schulz iteration is
three launches a bucket in the port (Gram, the polynomial fused into the
G@G epilogue, apply) against four in the JAX package (Gram, G@G,
polynomial, apply). So the expected ratio of the port's count to JAX's is
1 for RMNP, 3/4 for the Newton-Schulz rules (muon, normuon, muown) and 0 to
0 for nora and adamw, which launch no kernel in either package.

fp32 buffers. Each package counts full-bucket fp32 buffers its way (JAX:
jaxpr equation outputs, reshapes included; the port: op outputs with new
storage), so the counts are held by relation: the single-pass step makes
fewer than the two-pass step in both packages at every parameter and
momentum type, and with bf16 parameters and momentum exactly one in both:
the gradient bucket gathered in fp32, which the kernel reads. Neither
writes the two-pass ``d`` bucket.
"""
import ctypes
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.core import constant as jax_constant
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import mixed_optimizer as jax_mixed_optimizer
from repro.core.rmnp import rmnp as jax_rmnp
from repro.core.types import tree_paths as jax_tree_paths
from repro.launch.dryrun import model_flops as jax_model_flops
from repro.launch.mesh import make_local_mesh
from repro.launch.roofline import active_params as jax_active_params
from repro.launch.specs import input_specs as jax_input_specs
from repro.models import init_params as jax_init_params
from repro.train.step import optimizer_fp32_buffers as jax_fp32_buffers
from repro.train.step import optimizer_launches as jax_launches
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.core import constant, make_optimizer, mixed_optimizer, optimizer_names
from repro_torch.core.rmnp import rmnp
from repro_torch.core.types import tree_paths
from repro_torch.kernels import LAUNCHES, introspect, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import rmnp_update as rm
from repro_torch.launch import roofline, specs
from repro_torch.train.step import optimizer_fp32_buffers, optimizer_launches
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# tests/test_fused_engine.py's tree: 5 matrix leaves in 3 shape buckets
RAGGED_SHAPES = {
    "layer_0/w_in": (8, 16),
    "layer_1/w_in": (8, 16),
    "stack/w_in": (3, 8, 16),
    "layer_0/w_out": (16, 8),
    "odd/w": (24, 9),
}
# port launches : JAX launches, per rule (see the module docstring)
RATIO = {"rmnp": (1, 1), "muon": (3, 4), "normuon": (3, 4), "muown": (3, 4),
         "nora": (0, 0), "adamw": (0, 0)}
ENGINES = {"per-leaf": {}, "bucketed": {"fused": True}, "single-pass": {"fused_apply": True}}
CELLS = ("train_4k", "prefill_32k", "decode_32k")


def _trees(shapes, dtype="float32"):
    """(JAX tree, port tree) of zeros of ``shapes``."""
    jt = {k: jnp.zeros(s, jnp.dtype(dtype)) for k, s in shapes.items()}
    tt = {k: torch.zeros(s, dtype=getattr(torch, dtype)) for k, s in shapes.items()}
    return jt, tt


class TestLaunchCounts:
    """tests/test_fused_engine.py::TestLaunchCounts, both packages."""

    def test_fused_launches_equal_bucket_count(self):
        jt, tt = _trees(RAGGED_SHAPES)
        assert optimizer_launches(rmnp(constant(0.1), fused=True), tt) == 3
        assert optimizer_launches(rmnp(constant(0.1)), tt) == 5
        assert jax_launches(jax_rmnp(jax_constant(0.1), use_kernel=True, fused=True), jt) == 3
        assert jax_launches(jax_rmnp(jax_constant(0.1), use_kernel=True), jt) == 5

    def test_mixed_fused_launches(self):
        jt, tt = _trees(dict(RAGGED_SHAPES, norm=(8,), bias=(16,)))
        for fused, n in ((True, 3), (False, 5)):  # buckets, or the matrix leaves
            assert optimizer_launches(mixed_optimizer(
                "rmnp", constant(0.1), constant(0.05), fused=fused), tt) == n
            assert jax_launches(jax_mixed_optimizer(
                "rmnp", jax_constant(0.1), jax_constant(0.05), use_kernel=True,
                fused=fused), jt) == n

    def test_muon_fused_batches_ns_over_buckets(self):
        """3 launches per Newton-Schulz iteration and bucket in the port, 4
        in the JAX package; 2 iterations over 3 buckets, or 5 leaves."""
        jt, tt = _trees(dict(RAGGED_SHAPES, norm=(8,), bias=(16,)))
        for fused, units in ((True, 3), (False, 5)):
            assert optimizer_launches(mixed_optimizer(
                "muon", constant(0.1), constant(0.05), fused=fused, ns_steps=2),
                tt) == 3 * 2 * units
            assert jax_launches(jax_mixed_optimizer(
                "muon", jax_constant(0.1), jax_constant(0.05), use_kernel=True,
                fused=fused, ns_steps=2), jt) == 4 * 2 * units


@pytest.fixture(scope="module")
def reduced_gpt2():
    jcfg = jax_get_config("gpt2-small").reduced()
    jparams = jax.eval_shape(lambda k: jax_init_params(jcfg, k), jax.random.PRNGKey(0))
    return jparams, specs.param_specs(get_config("gpt2-small").reduced())


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("rule", list(optimizer_names()))
def test_launches_per_rule_and_engine_against_jax(reduced_gpt2, rule, engine):
    jparams, params = reduced_gpt2
    kw = ENGINES[engine]
    got = optimizer_launches(make_optimizer(rule, dict(lr_matrix=0.01, **kw)), params)
    want = jax_launches(jax_make_optimizer(rule, dict(lr_matrix=0.01, use_kernel=True, **kw)),
                        jparams)
    num, den = RATIO[rule]
    assert got * den == want * num if den else got == want == 0, (got, want)
    assert (got > 0) == (num > 0)


def test_launches_need_no_device_and_count_nothing():
    """optimizer_launches runs on meta tensors: LAUNCHES stays untouched and
    CPU parameters are not read."""
    _, tt = _trees(RAGGED_SHAPES)
    before = dict(LAUNCHES)
    assert optimizer_launches(rmnp(constant(0.1), fused_apply=True), tt) == 3
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
def test_fp32_buffers_single_pass_below_two_pass_in_both(pdt, mdt):
    shapes = {"a/w": (8, 16), "b/w": (8, 16), "c/w": (2, 8, 16)}
    jt, tt = _trees(shapes, pdt)
    bucket = (4, 8, 16)
    one = optimizer_fp32_buffers(rmnp(constant(0.1), fused_apply=True, momentum_dtype=mdt),
                                 tt, bucket)
    two = optimizer_fp32_buffers(rmnp(constant(0.1), fused=True, momentum_dtype=mdt), tt, bucket)
    jone = jax_fp32_buffers(jax_rmnp(jax_constant(0.1), use_kernel=True, fused_apply=True,
                                     momentum_dtype=mdt), jt, bucket)
    jtwo = jax_fp32_buffers(jax_rmnp(jax_constant(0.1), use_kernel=True, fused=True,
                                     momentum_dtype=mdt), jt, bucket)
    assert 0 < one < two and 0 < jone < jtwo, (one, two, jone, jtwo)
    if pdt == mdt == "bfloat16":  # the fp32 gradient bucket alone
        assert one == jone == 1


def test_buffer_count_sees_new_storage_only():
    """A view or an in-place result allocates nothing; a kernel entry's
    outputs count once each; ``exclude_ops`` drops an op's outputs."""
    x = torch.zeros(4, 8, 16)

    def fn(x):
        y = x * 2            # new
        y.add_(1)            # in place
        z = y.reshape(4, 8, 16)  # view
        v, w = ops.rmnp_bucket_update_apply(x, x, x, torch.tensor(0.1), 0.1, beta=0.9)
        return z, v, w
    assert ops.count_buffer_allocs(fn, (4, 8, 16), torch.float32, x) == 3
    assert ops.count_buffer_allocs(fn, (4, 8, 16), torch.float32, x, exclude_ops=("mul",)) == 2
    assert ops.count_kernel_launches(fn, x) == 1


def _specs_rows(tree, paths):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in paths(tree)]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", jax_list_configs())
def test_input_specs_equal_jax(arch, cell):
    """Every input of every config's train, prefill and decode step: paths,
    shapes and dtypes equal JAX's ``input_specs`` on a one-device mesh."""
    assert sorted(list_configs()) == sorted(jax_list_configs())
    want, _ = jax_input_specs(jax_get_config(arch), JAX_SHAPES[cell], make_local_mesh(1, 1))
    got = specs.input_specs(get_config(arch), SHAPES[cell])
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert _specs_rows(g, tree_paths) == [
            (p, tuple(x.shape), str(x.dtype)) for p, x in jax_tree_paths(w)]
        assert all(x.is_meta for _, x in tree_paths(g))


def test_input_specs_of_a_zero2_rank():
    """world=4: the dp step's inputs, every stacked bucket cut to its
    padded L / 4 rows as distributed/sharding.py cuts it."""
    cfg = get_config("gpt2-small")
    params, state, comp, batch, step = specs.input_specs(cfg, SHAPES["train_4k"], world=4)
    opt = make_optimizer("rmnp", dict(lr_matrix=1e-3, shard_axis=object(), shard_size=4))
    plan = opt.bucket_plan(params)
    assert {b.key: (b.padded // 4, b.d_in, b.d_out) for b in plan.buckets} == {
        k: tuple(v.shape) for k, v in state.buckets.items()}
    assert [(p, x.shape) for p, x in tree_paths(comp.error)] == [
        (p, x.shape) for p, x in tree_paths(params)]
    assert batch["tokens"].shape == (256, 4096) and step.shape == ()


@pytest.mark.parametrize("arch", jax_list_configs())
def test_active_params_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roofline.active_params(cfg) == jax_active_params(jcfg)
    for cell in CELLS:
        assert roofline.model_flops(cfg, SHAPES[cell]) == jax_model_flops(jcfg, JAX_SHAPES[cell])


def test_bound_formulas():
    """The bounds chip_smoke.py reports, from the data sheet's peaks: a
    bytes-bound RMNP bucket, a FLOP-bound GEMM, both flash types."""
    assert roofline.rmnp_bytes((48, 768, 768), 4, 2, True) == 48 * 768 * 768 * 16
    ms, by, ffma = roofline.gemm_bound(48, 768, 768, 768, 2 * 48 * 768 * 768)
    assert by == "operations" and ms == 3 * 48 * 2 * 768 ** 3 / 495e12 * 1e3 and ffma > ms
    ms, by, ffma = roofline.attention_bounds(8, 1024, 12, 12, 64, torch.bfloat16, True)
    assert ffma is None and ms == max(8 * 1024 * 24 * 128 * 2 / 3.35e12 * 1e3,
                                      roofline.attention_flops(8, 1024, 12, 64) / 989e12 * 1e3)
    assert roofline.attention_bounds(8, 1024, 12, 12, 64, torch.float32, True)[2] is not None


def _lint_launches():
    from repro_torch.analysis.kernel_lint import trace_targets
    return [(label, launch) for label, thunk in trace_targets()
            for launch in introspect.collect_kernel_launches(thunk)]


def test_real_layouts_cover_their_operands():
    launches = _lint_launches()
    assert {launch.kernel for _, launch in launches} == {
        "rmnp_kernel", "gemm_kernel", "fa_fwd_tc", "fa_fwd_tf32_kernel"}
    for label, launch in launches:
        cov = introspect.launch_coverage(launch)
        assert cov["covers"], (label, cov)


def _gappy():
    g = torch.empty(4, 768, 768, device="meta")
    short = rm.Split(K=2, R=100, C=64, threads=256, one_read=True)  # 200 of 768 rows
    yield "rows", rm.describe(g, g, None, g, g, apply=False, layout=short), ("g", 1, 200, 768)
    launch = rm.describe(g, g, None, g, g, apply=False)
    tiles = (introspect.Tiling("g", (4, 768, 768), (1, 384, 64), (4, 2, 11)),)
    yield "columns", launch._replace(tiles=tiles), ("g", 2, 704, 768)
    tiles = (introspect.Tiling("g", (4, 768, 768), (1, 384, 64), (5, 2, 12)),)
    yield "past_the_end", launch._replace(tiles=tiles), ("g", 0, 4)


@pytest.mark.parametrize("case", list(_gappy()), ids=lambda c: c[0])
def test_gappy_layout_is_caught(case):
    _, launch, where = case
    cov = introspect.launch_coverage(launch)
    assert not cov["covers"]
    assert where in cov["uncovered"] + cov["out_of_bounds"]


def test_recording_reroutes_no_cpu_tensor():
    """Inside the recording context CPU tensors still take the plain
    version (and give its bits); only meta tensors are recorded."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(3, 16, 8, generator=gen)
    v = torch.randn(3, 16, 8, generator=gen)
    want = ops.rmnp_bucket_update(g, v, beta=0.9)
    with introspect.recording() as launches:
        got = ops.rmnp_bucket_update(g, v, beta=0.9)
        x = torch.randn(2, 8, 16, generator=gen)
        ops.ns_step(x, 3.4, -4.7, 2.0)
    assert launches == []
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def test_meta_tensors_raise_outside_the_recording():
    x = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.ns_step(x, 3.4, -4.7, 2.0)
    with pytest.raises(ValueError, match="meta"):
        ops.matmul(x[0], x[0].T)
    with pytest.raises(ValueError, match="CUDA"):
        mm.gemm(x, x.transpose(1, 2))
    with pytest.raises(RuntimeError, match="recording"):
        introspect.record(None)


def test_launch_records_name_the_instantiation():
    g = torch.empty(12, 3072, 768, device="meta")
    w = torch.empty(12, 3072, 768, dtype=torch.bfloat16, device="meta")
    (launch,) = introspect.collect_kernel_launches(
        lambda: ops.rmnp_bucket_update_apply(g, g, w, torch.tensor(0.1), 0.1, beta=0.9))
    s = rm.split(3072, 768)
    assert launch.signature == "rmnp_kernel<64, true, true, float, __nv_bfloat16>"
    assert launch.grid == (s.K, 12 * 768 // 64, 1) and launch.cluster == (s.K, 1, 1)
    assert launch.block == (s.threads, 1, 1) and launch.smem_bytes == s.smem_bytes()
    assert [o.name for o in launch.operands] == ["g", "v", "w", "v_out", "w_out"]
    x = torch.empty(4, 768, 768, device="meta")
    gram, poly, apply = introspect.collect_kernel_launches(lambda: ops.ns_step(x, 3, -4, 2))
    assert [r.name for r in (gram, poly, apply)] == ["matmul3", "ns_poly3", "matmul3"]
    assert gram.layout == (mm.k_chunk(768, 768, 768), mm.split_blocks(4, 768, 768, 768,
                                                                       gram.layout[0]))


# --- the layouts introspect.py mirrors, against the CUDA sources ---------

def _probe(tmp_path, source_name, headers, body, substitute=True):
    """Compile ``csrc/<source_name>`` with the emulation headers of
    tests/_torch_emulation.py and ``body`` appended in the same
    translation unit (its anonymous namespace is visible there)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    import _torch_emulation as emu
    for name, text in headers(emu).items():
        (tmp_path / name).write_text(text)
    src = (emu.SOURCE.with_name(source_name)).read_text()
    if substitute:
        src = re.sub(r"(\w+<[\w, ]+>)<<<([^,]*), ([^,]*), [^>]*>>>\((\w+)\)",
                     r"emulate_launch(\1, \2, \3, \4)", src)
    (tmp_path / "probe.cpp").write_text(src + "\n" + body)
    lib = tmp_path / "libprobe.so"
    subprocess.run([cxx, "-std=c++20", "-O0", "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    "-pthread", "-I", str(tmp_path), "-o", str(lib), str(tmp_path / "probe.cpp")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _layout_probe(pairs, fields):
    lines = ['extern "C" void probe(long long* out) {', "  int i = 0;"]
    for hd, hdv in pairs:
        lines += [f"  out[i++] = {f.format(hd=hd, hdv=hdv)};" for f in fields]
    return "\n".join(lines + ["}"])


def _read(lib, n):
    out = (ctypes.c_longlong * n)()
    lib.probe(out)
    return list(out)


def test_flash_bf16_layout_mirrors_the_source(tmp_path):
    pairs = fa.HEAD_DIM_PAIRS[torch.bfloat16]
    fields = ("BQ", "THREADS", "Layout<{hd}, {hdv}>::alloc", "Layout<{hd}, {hdv}>::nstage")
    lib = _probe(tmp_path, "flash_attention_fwd.cu", lambda emu: {
        "cuda_runtime.h": emu.EMULATION_HEADER, "cuda_bf16.h": emu.BF16_HEADER,
        "cuda.h": emu.TENSOR_MAP_HEADER,
        "sm90.cuh": emu.SM90_MODEL + emu.FLASH_MODEL + emu.BF16_FLASH_MODEL},
        _layout_probe(pairs, fields))
    want = [v for hd, hdv in pairs for v in fa.flash_layout(torch.bfloat16, hd, hdv)]
    got = _read(lib, len(want))
    assert got == want


def test_flash_fp32_layout_mirrors_the_source(tmp_path):
    pairs = fa.HEAD_DIM_PAIRS[torch.float32]
    fields = ("Layout<{hd}, {hdv}>::bq", "Layout<{hd}, {hdv}>::threads",
              "Layout<{hd}, {hdv}>::alloc", "Layout<{hd}, {hdv}>::nslot")
    lib = _probe(tmp_path, "flash_attention_fwd_tf32.cu", lambda emu: {
        "cuda_runtime.h": emu.EMULATION_HEADER, "sm90.cuh": emu.SM90_MODEL + emu.FLASH_MODEL},
        _layout_probe(pairs, fields))
    want = [v for hd, hdv in pairs for v in fa.flash_layout(torch.float32, hd, hdv)]
    assert _read(lib, len(want)) == want


def test_gemm_and_rmnp_shared_memory_mirror_the_sources(tmp_path):
    for sub in ("gemm", "rmnp"):
        (tmp_path / sub).mkdir()
    gemm = _probe(tmp_path / "gemm", "matmul.cu", lambda emu: {"cuda_runtime.h": emu.EMULATION_HEADER,
                                            "sm90.cuh": emu.SM90_MODEL},
                  'extern "C" void probe(long long* out) { out[0] = SMEM_BYTES; '
                  "out[1] = THREADS; out[2] = BM; out[3] = BK; }")
    assert _read(gemm, 4) == [mm.SMEM_BYTES, 256, 128, 32]
    splits = sorted({rm.split(d_in, d_out) for _, d_in, d_out in (
        (1, 768, 768), (1, 3072, 768), (1, 50432, 768), (1, 257280, 2048), (1, 2048, 768),
        (1, 60000, 24))})
    body = ['extern "C" void probe(long long* out) {']
    body += [f"  out[{i}] = smem_bytes({s.threads}, {s.C}, {s.R}, {str(s.one_read).lower()});"
             for i, s in enumerate(splits)]
    lib = _probe(tmp_path / "rmnp", "rmnp_update.cu", lambda emu: {
                     "cuda_runtime.h": emu.EMULATION_HEADER, "cuda_bf16.h": emu.BF16_HEADER,
                     "sm90.cuh": emu.SM90_CLUSTER_MODEL}, "\n".join(body + ["}"]),
                 substitute=False)
    assert _read(lib, len(splits)) == [s.smem_bytes() for s in splits]
    assert any(not s.one_read for s in splits) and any(s.K == 16 for s in splits)


def test_param_specs_allocate_nothing():
    """A full-width 15.7 B-parameter model's specs are meta tensors."""
    params = specs.param_specs(get_config("deepseek-v2-lite-16b"))
    assert sum(x.numel() for _, x in tree_paths(params)) > 15e9
    assert all(x.is_meta for _, x in tree_paths(params))


def test_census_lines_up_the_profiler_with_the_record(monkeypatch):
    """kernels/census.py without a card: the profiler's events are given.
    Equal events pass; a wrong grid, a missing launch, shared memory past
    the static allowance or a LAUNCHES count that differs is named."""
    from repro_torch.kernels import census

    g = torch.empty(48, 768, 768, device="meta")
    x = torch.empty(4, 256, 256, device="meta")
    predicted = introspect.collect_kernel_launches(
        lambda: (ops.rmnp_bucket_update(g, g, beta=0.9), ops.ns_step(x, 3, -4, 2)))
    names = {"rmnp_kernel": "void (anonymous namespace)::rmnp_kernel<{}>((anonymous "
                            "namespace)::Args)",
             "gemm_kernel": "void (anonymous namespace)::gemm_kernel<{}>((anonymous "
                            "namespace)::Args)"}
    events = [{"signature": census.signature(names[r.kernel].format(", ".join(r.template))),
               "grid": r.grid, "block": r.block, "smem": r.smem_bytes, "ts": i}
              for i, r in enumerate(predicted)]
    assert events[0]["signature"] == predicted[0].signature

    def run_with(evs, counts):
        def fake(run):
            run()
            return evs
        monkeypatch.setattr(census, "profiled_kernels", fake)
        return census.census(lambda: census.LAUNCHES.update(counts), predicted)

    monkeypatch.setattr(census, "LAUNCHES", dict(LAUNCHES))  # the module's own counts
    monkeypatch.setattr(census, "reset_launches", lambda: census.LAUNCHES.update(
        dict.fromkeys(census.LAUNCHES, 0)))
    counts = {"rmnp_precondition": 1, "matmul3": 2, "ns_poly3": 1}
    res = run_with(events, counts)
    assert res["ok"] and res["kernels"]["matmul3"] == {"meta": 2, "launches": 2, "profiler": 2}
    bad = [dict(events[0], grid=(1, 1, 1))] + events[1:]
    assert "launch 0" in run_with(bad, counts)["mismatches"][0]
    assert not run_with(events[:-1], counts)["ok"]
    big = [dict(events[0], smem=events[0]["smem"] + census.STATIC_SMEM + 4)] + events[1:]
    assert "shared memory" in run_with(big, counts)["mismatches"][0]
    assert not run_with(events, dict(counts, matmul3=3))["ok"]
    assert census.signature("at::native::vectorized_elementwise_kernel<4, ...>") == ""
