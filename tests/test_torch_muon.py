"""The port's Muon path and rule family on the CPU against the JAX package's.

On CPU tensors the GEMM and Newton-Schulz wrappers run their plain
versions, so these tests hold the plain versions (what the Hopper kernel is
checked against on the card, in ``tests/test_torch_gpu.py``) against the
Pallas kernels in interpret mode, and the rules, engines and driver against
the JAX package. Inputs come from numpy with a seed; parameters are exported
from ``repro.models.init_params``; the JAX side is jitted.

Tolerances, each with its reason:

- One product (``matmul``): both sides sum K fp32 products in other orders,
  each within the classic bound K * 2^-24 * (|A| @ |B|) of the exact sum,
  so they are held within twice that, element by element.
- One Newton-Schulz step and five-step ``newton_schulz`` in fp32: three
  products a step, each a few ulps apart, and the quintic keeps a relative
  error near its size: 1e-5 of the largest entry (measured about 1e-6).
- bf16 ``newton_schulz``: both round the same fp32 values once, so an entry
  that straddles a rounding boundary differs by one bf16 step: 2^-7
  relative, plus the fp32 tolerance.
- Three optimizer steps: the Adam leaves and the RMNP path agree to an ulp
  (``tests/test_torch_optim.py``); Newton-Schulz directions agree to about
  1e-6 relative, and a parameter moves by lr-sized steps, so parameters are
  held at 1e-6 relative plus ``NS_ATOL``. bf16 momentum rounds once a step
  and may land one bf16 step apart (2^-7 relative); the next EMA carries
  that difference and may round one more step apart, so after three steps
  momentum is held at two bf16 steps (2^-6 relative), and the
  orthogonalized direction moves by at most as much, hence
  ``BF16_NS_ATOL``.
- Inside the port, bucketed, single-pass and the per-leaf reference run the
  same ops on the same slices (the plain products go slice by slice), so
  fp32 results are equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cosine_with_warmup as jax_cosine
from repro.core import make_optimizer as jax_make_optimizer
from repro.core import optimizer_names as jax_optimizer_names
from repro.core.dominance import dominance_ratios as jax_dominance_ratios
from repro.core.dominance import global_dominance as jax_global_dominance
from repro.core.mixed import momentum_for_diagnostics as jax_momentum_for_diagnostics
from repro.core.muon import newton_schulz as jax_newton_schulz
from repro.kernels import ops as jops
from repro.kernels.matmul import matmul as jax_matmul
from repro.kernels.matmul import matmul3 as jax_matmul3
from repro.kernels.ref import dominance_ref as jax_dominance_ref
from repro_torch.core import (cosine_with_warmup, dominance_ratios, global_dominance,
                              make_optimizer, momentum_for_diagnostics, newton_schulz,
                              optimizer_names, per_leaf_reference, rule_names)
from repro_torch.core import bucketing, is_matrix_param
from repro_torch.core.engine import matrix_optimizer
from repro_torch.core.muon import muon
from repro_torch.core.rules import make_rule
from repro_torch.core.types import tree_paths
from repro_torch.interop import to_numpy, to_tensor, tree_from_numpy
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import newton_schulz as nsk
from repro_torch.kernels.ref import dominance_ref
from repro_torch.launch import train as train_mod
from test_torch_optim import (ENGINES, STEPS, _assert_trees_close, _grads, _jax_params,
                              _np_tree, _run_torch)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

COEFFS = (3.4445, -4.7750, 2.0315)
PEAK_LR = 2e-2
NS_ATOL = 1e-6
BF16_NS_ATOL = 2 * PEAK_LR * 2.0 ** -6


def _run_jax(params, grads, config, name):
    """``make_optimizer(name, config)`` on the JAX side, each step jitted."""
    opt = jax_make_optimizer(name, config)
    state = opt.init(params)
    if opt.update_apply is not None:
        step_fn = jax.jit(opt.update_apply)
    else:
        def two_pass(g, s, p, step):
            updates, s = opt.update(g, s, p, step)
            return jax.tree_util.tree_map(lambda a, u: a + u.astype(a.dtype), p, updates), s
        step_fn = jax.jit(two_pass)
    for step, g in enumerate(grads):
        params, state = step_fn(jax.tree_util.tree_map(jnp.asarray, g), state, params, step)
    return params, state


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _held_to_sum_bound(got, want, a, b):
    """|got - want| within twice the fp32 K-term sum bound, per element."""
    bound = 2 * (a.shape[-1] + 2) * 2.0 ** -24 * (np.abs(a).astype(np.float64)
                                                  @ np.abs(b).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - want.astype(np.float64)) <= bound)


MATMULS = [((16, 24), (24, 8)), ((33, 17), (17, 9)), ((100, 300), (300, 50)),
           ((3, 20, 13), (3, 13, 7)), ((2, 64, 264), (2, 264, 40))]


@pytest.mark.parametrize("shapes", MATMULS, ids=lambda s: "x".join(map(str, s[0] + s[1][-1:])))
def test_matmul_plain_matches_pallas(shapes):
    sa, sb = shapes
    a, b = _rand(sa, 1), _rand(sb, 2)
    jfn = jax_matmul if len(sa) == 2 else jax_matmul3
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b), interpret=True))
    wrapper = ops.matmul if len(sa) == 2 else mm.matmul3_plain
    got = wrapper(to_tensor(a), to_tensor(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _held_to_sum_bound(to_numpy(got), want, a, b)


def _assert_ns_close(want, got, rtol=0.0):
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(to_numpy(got), want, rtol=rtol,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(16, 40), (3, 24, 56), (2, 2, 9, 33)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ns_step_plain_matches_jax(shape):
    x = _rand(shape, 3)
    x /= np.linalg.norm(x.reshape(-1, *shape[-2:]), axis=(-2, -1)).reshape(
        shape[:-2] + (1, 1))
    want = jops.ns_step(jnp.asarray(x), *COEFFS)
    got = ops.ns_step(to_tensor(x), *COEFFS)
    _assert_ns_close(want, got)
    if len(shape) == 3:  # the stacked plain version is the per-slice one
        assert torch.equal(nsk.ns_step3_plain(to_tensor(x), *COEFFS), got)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("shape", [(16, 40), (40, 16), (3, 24, 10), (2, 12, 30)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_newton_schulz_matches_jax(use_kernel, shape, dtype):
    x = np.asarray(jnp.asarray(_rand(shape, 4)).astype(dtype))
    want = jax.jit(lambda v: jax_newton_schulz(v, steps=5, use_kernel=use_kernel))(
        jnp.asarray(x))
    got = newton_schulz(to_tensor(x), steps=5, use_kernel=use_kernel)
    assert str(got.dtype).split(".")[1] == dtype and tuple(got.shape) == shape
    _assert_ns_close(want, got, rtol=2.0 ** -7 if dtype == "bfloat16" else 0.0)


def test_newton_schulz_slices_and_zero_slices():
    """Each slice of a stack gets the bits it gets alone; a zero slice (the
    engine's shard padding) stays exactly zero."""
    x = to_tensor(_rand((4, 12, 20), 5))
    x[2] = 0.0
    out = newton_schulz(x)
    assert not out[2].any()
    for i in range(4):
        assert torch.equal(out[i], newton_schulz(x[i]))
    assert torch.equal(out[1:3], newton_schulz(x[1:3]))


def test_the_kernel_wrappers_refuse_cpu_tensors_and_count_nothing_on_the_cpu():
    a = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        mm.gemm(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        nsk.ns_step3(a, *COEFFS)
    with pytest.raises(ValueError, match="meta"):
        ops.ns_step(a.to("meta"), *COEFFS)
    with pytest.raises(ValueError, match="meta"):
        ops.matmul(a[0].to("meta"), a[0].to("meta"))
    reset_launches()
    ops.ns_step(a, *COEFFS)
    ops.ns_step(a[0], *COEFFS)
    ops.matmul(a[0], a[0])
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


def test_registry_equals_jax():
    assert optimizer_names() == jax_optimizer_names()
    assert rule_names() == tuple(n for n in jax_optimizer_names() if n != "adamw")


# (rule, engine, momentum dtype, JAX use_kernel): every engine each rule
# allows (NorMuon, Muown and Nora are bucketed only), fp32 and bf16 momentum
RULE_CASES = ([("muon", e, "float32", e == "single-pass") for e in ENGINES]
              + [("muon", "bucketed", "bfloat16", False)]
              + [(r, e, m, False) for r in ("normuon", "muown", "nora")
                 for e, m in (("bucketed", "float32"), ("single-pass", "bfloat16"))])


@pytest.mark.parametrize("rule,engine,momentum_dtype,jax_kernel", RULE_CASES,
                         ids=[f"{r}-{e}-m{m[:4]}" + ("-pallas" if k else "")
                              for r, e, m, k in RULE_CASES])
def test_rule_three_steps_match_jax(rule, engine, momentum_dtype, jax_kernel):
    jparams = _jax_params()
    grads = _grads(jparams, seed=11)
    cfg = dict(lr_matrix=PEAK_LR, lr_adamw=1e-2, momentum_dtype=momentum_dtype,
               ns_steps=5, **ENGINES[engine])
    want_p, want_s = _run_jax(jparams, grads, dict(
        cfg, lr_matrix=jax_cosine(PEAK_LR, STEPS), lr_adamw=jax_cosine(1e-2, STEPS),
        use_kernel=jax_kernel), name=rule)
    opt = make_optimizer(rule, dict(cfg, lr_matrix=cosine_with_warmup(PEAK_LR, STEPS),
                                    lr_adamw=cosine_with_warmup(1e-2, STEPS)))
    got_p, got_s = _run_torch(opt, tree_from_numpy(_np_tree(jparams)), grads)
    bf16 = momentum_dtype == "bfloat16"
    _assert_trees_close(want_p, got_p, rtol=1e-6, atol=BF16_NS_ATOL if bf16 else NS_ATOL)
    want_state, got_state = want_s._asdict(), got_s._asdict()
    assert sorted(want_state) == sorted(got_state)
    for field, want in want_state.items():
        tol = (dict(rtol=2.0 ** -6, atol=1e-9) if bf16 and field == "buckets"
               else dict(rtol=1e-5, atol=1e-9))
        _assert_trees_close(want, got_state[field], **tol)


def test_per_leaf_muon_optimizer_matches_jax():
    """The pure-matrix ``muon(...)`` optimizer, per leaf, against JAX's."""
    from repro.core.muon import muon as jax_muon
    jparams = {p: a for p, a in tree_paths(_np_tree(_jax_params()))
               if is_matrix_param(p, a)}
    grads = _grads(jparams, seed=12)
    jopt = jax_muon(jax_cosine(PEAK_LR, STEPS))
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    js = jopt.init(jp)
    update = jax.jit(jopt.update)
    for step, g in enumerate(grads):
        updates, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, step)
        jp = {k: jp[k] + updates[k] for k in jp}
    got, gs = _run_torch(muon(cosine_with_warmup(PEAK_LR, STEPS)),
                         tree_from_numpy(jparams), grads)
    _assert_trees_close(jp, got, rtol=1e-6, atol=NS_ATOL)
    _assert_trees_close(js.momentum, gs.momentum, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("rule", ["rmnp", "muon", "normuon", "muown", "nora"])
def test_engines_equal_the_per_leaf_reference_bitwise(rule):
    """fp32: the single-pass engine equals the rule's per-leaf reference bit
    for bit, parameters, momentum and slots, and the bucketed two-pass engine
    equals the reference's two-pass form (``update`` + ``apply_updates``;
    for Muown, which is not additive, that form re-associates the final add,
    so only like is compared with like). For Muon the mixed per-leaf engine
    equals the bucketed ones too."""
    params = tree_from_numpy(_np_tree(_jax_params()))
    mat = {p: t for p, t in tree_paths(params) if is_matrix_param(p, t)}
    grads = [{p: g for p, g in tree_paths(gr) if p in mat}
             for gr in _grads(_jax_params(), seed=13)]
    r = make_rule(rule, beta=0.9, ns_steps=5)
    lr = cosine_with_warmup(PEAK_LR, STEPS)
    for fused_apply in (False, True):
        ref_opt = per_leaf_reference(r, lr)
        if not fused_apply:
            ref_opt = dataclasses.replace(ref_opt, update_apply=None)
        ref, ref_state = _run_torch(ref_opt, dict(mat), grads)
        opt = matrix_optimizer(r, lr, fused_apply=fused_apply)
        got, state = _run_torch(opt, dict(mat), grads)
        plan = opt.bucket_plan(mat)
        momentum = bucketing.scatter(plan, state.buckets, mat)
        for path in mat:
            assert torch.equal(got[path], ref[path]), (fused_apply, path)
            assert torch.equal(momentum[path], ref_state.momentum[path]), (fused_apply, path)
        for name, per_bucket in state.slots.items():
            for b in plan.buckets:
                for e in b.entries:
                    want = ref_state.slots[name][e.path]
                    assert torch.equal(per_bucket[b.key][e.offset:e.offset + e.lead], want)
    if rule == "muon":
        full = [tree_from_numpy(g) for g in _grads(_jax_params(), seed=14)]
        results = [_run_torch(make_optimizer("muon", dict(lr_matrix=lr, **ENGINES[e])),
                              dict(params), full)[0] for e in ENGINES]
        for other in results[1:]:
            for path, t in tree_paths(other):
                assert torch.equal(t, dict(tree_paths(results[0]))[path]), path


@pytest.mark.parametrize("shape", [(48, 16), (3, 20, 12)], ids=["2d", "stacked"])
def test_dominance_ratios_match_jax(shape):
    v = _rand(shape, 6)
    want = jax_dominance_ratios(jnp.asarray(v))
    got = dominance_ratios(to_tensor(v))
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    if len(shape) == 2:
        for w, g in zip(jax_dominance_ref(jnp.asarray(v)), dominance_ref(to_tensor(v)),
                        strict=True):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("engine", ["per-leaf", "single-pass"])
def test_global_dominance_of_the_optimizer_state_matches_jax(engine):
    """``momentum_for_diagnostics`` scatters the bucketed momentum back onto
    the leaves (a per-leaf state passes through), and ``global_dominance``
    averages the per-parameter ratios, as in JAX."""
    jparams = _jax_params()
    grads = _grads(jparams, seed=15)[:2]
    cfg = dict(lr_matrix=PEAK_LR, **ENGINES[engine])
    want_p, want_s = _run_jax(jparams, grads, dict(cfg, lr_matrix=jax_cosine(PEAK_LR, 2)),
                              name="muon")
    got_p, got_s = _run_torch(make_optimizer("muon", dict(
        cfg, lr_matrix=cosine_with_warmup(PEAK_LR, 2))),
        tree_from_numpy(_np_tree(jparams)), grads)
    want_m = jax_momentum_for_diagnostics(want_s, want_p)
    got_m = momentum_for_diagnostics(got_s, got_p)
    _assert_trees_close(want_m, got_m, rtol=1e-6, atol=1e-9)
    want, got = jax_global_dominance(want_m), global_dominance(got_m)
    assert sorted(want) == sorted(got) == ["r_avg", "r_max", "r_min"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_cli_trains_muon_on_each_engine_with_dominance(engine, capsys):
    train_mod.main(["--arch", "gpt2-small", "--optimizer", "muon", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--log-every", "1", "--engine", engine,
                    "--dominance-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 2 and out.count("r_avg=") == 2


def test_train_driver_runs_every_rule_on_the_cpu():
    for name in optimizer_names():
        _, state, hist = train_mod.train("gpt2-small", optimizer=name, steps=2, batch=2,
                                         seq=16, log_every=1, dominance_every=1,
                                         fused=True, fused_apply=True, device="cpu")
        assert all(np.isfinite(h["loss"]) for h in hist), name
        assert all(n == 0 for h in hist for n in h["launches"].values())
        assert ("r_avg" in hist[0]) == (name != "adamw")
        if name in ("normuon", "nora"):
            assert list(state.slots) == [{"normuon": "nu", "nora": "r"}[name]]
