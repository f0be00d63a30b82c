"""The port's optimizer against the JAX package's, and its own invariants.

Parameters come from ``repro.models.init_params`` for reduced gpt2 (exported
as numpy, loaded with ``repro_torch.interop``); gradients are numpy draws
from a seed. Three steps of the same gradients go through
``make_optimizer("rmnp", ...)`` on both sides, with ``use_kernel=True``: on
the JAX side the Pallas kernels run in interpret mode, on the port's side
CPU tensors take the kernels' plain versions (the port routes every RMNP
update through ``kernels/ops.py`` whatever ``use_kernel`` says).

Tolerances. fp32 state and parameters: XLA and PyTorch take the momentum
EMA, the column sum of squares and the Adam square root with other
instruction choices and summation orders, an ulp or two per step, so rtol
1e-6 with an atol of 1e-7 for values near 0 (measured: 3e-8 on parameters,
5e-10 on momentum). bf16 momentum: a value that straddles a bf16 rounding
boundary rounds to neighbouring bf16 values on the two sides, one bf16 step
(2^-8 relative); that element's parameter then moves by up to lr * 2^-8
more on one side, so parameters keep rtol 1e-6 with an atol of that much
per step (``BF16_MOMENTUM_ATOL``; measured up to 2.8e-6). bf16 parameters:
one bf16 step, 2^-7 relative.

Inside the port, fp32 single-pass, two-pass, per-leaf and the rule's
per-leaf reference all take the same ops in the same order, so they agree
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import bucketing as jbucketing
from repro.core import clip_by_global_norm as jax_clip
from repro.core import cosine_with_warmup as jax_cosine
from repro.core import is_matrix_param as jax_is_matrix_param
from repro.core import make_optimizer as jax_make_optimizer
from repro.core.rmnp import rmnp as jax_rmnp
from repro.models import init_params as jax_init_params
from repro_torch.core import apply_updates, clip_by_global_norm, cosine_with_warmup
from repro_torch.core import is_matrix_param, make_optimizer, optimizer_names, rmnp
from repro_torch.core import bucketing
from repro_torch.core.engine import matrix_optimizer
from repro_torch.core.rules import RmnpRule, make_rule, per_leaf_reference
from repro_torch.core.types import tree_paths
from repro_torch.interop import mixed_state_from_numpy, to_numpy, tree_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEPS = 3
PEAK_LR = 2e-2
# a bf16 momentum element one rounding step off moves its normalized
# direction (|d| <= 1) by 2^-8 relative, and the parameter by at most
# PEAK_LR * 2^-8 in each of the two steps with a non-zero learning rate
BF16_MOMENTUM_ATOL = 2 * PEAK_LR * 2.0 ** -8
ENGINES = {"per-leaf": dict(fused=False, fused_apply=False),
           "bucketed": dict(fused=True, fused_apply=False),
           "single-pass": dict(fused=True, fused_apply=True)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(arch="gpt2-small", dtype=None, **overrides):
    cfg = get_config(arch).reduced(**overrides)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    if dtype is not None:
        params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    return params


def _grads(params, seed=0):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), _np_tree(params))
        for _ in range(STEPS)]


def _opt_config(engine, momentum_dtype, cosine):
    return dict(lr_matrix=cosine(PEAK_LR, STEPS), lr_adamw=cosine(1e-2, STEPS),
                use_kernel=True, momentum_dtype=momentum_dtype, **ENGINES[engine])


def _run_jax(params, grads, config):
    opt = jax_make_optimizer("rmnp", config)
    state = opt.init(params)
    for step, g in enumerate(grads):
        g = jax.tree_util.tree_map(jnp.asarray, g)
        if opt.update_apply is not None:
            params, state = opt.update_apply(g, state, params, step)
        else:
            updates, state = opt.update(g, state, params, step)
            params = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype),
                                            params, updates)
    return params, state


def _run_torch(opt, params, grads):
    state = opt.init(params)
    for step, g in enumerate(grads):
        g = tree_from_numpy(g)
        if opt.update_apply is not None:
            params, state = opt.update_apply(g, state, params, step)
        else:
            updates, state = opt.update(g, state, params, step)
            params = apply_updates(params, updates)
    return params, state


def _assert_trees_close(want, got, **tol):
    want = dict(tree_paths(_np_tree(want)))
    got = dict(tree_paths(got))
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype).split(".")[1] == w.dtype.name, path
        np.testing.assert_allclose(to_numpy(g), w.astype(np.float32), err_msg=path, **tol)


CASES = [("per-leaf", "float32", None), ("bucketed", "float32", None),
         ("bucketed", "bfloat16", None), ("single-pass", "float32", None),
         ("single-pass", "bfloat16", None), ("single-pass", "float32", "bfloat16")]


@pytest.mark.parametrize("engine,momentum_dtype,param_dtype", CASES,
                         ids=[f"{e}-m{m[:4]}-p{(p or 'float32')[:4]}" for e, m, p in CASES])
def test_three_steps_match_jax(engine, momentum_dtype, param_dtype):
    jparams = _jax_params(dtype=param_dtype)
    grads = _grads(jparams)
    want_p, want_s = _run_jax(jparams, grads, _opt_config(engine, momentum_dtype,
                                                          jax_cosine))
    opt = make_optimizer("rmnp", _opt_config(engine, momentum_dtype, cosine_with_warmup))
    got_p, got_s = _run_torch(opt, tree_from_numpy(_np_tree(jparams)), grads)

    p_tol = (dict(rtol=2.0 ** -7, atol=1e-6) if param_dtype == "bfloat16"
             else dict(rtol=1e-6, atol=BF16_MOMENTUM_ATOL if momentum_dtype == "bfloat16"
                       else 1e-7))
    _assert_trees_close(want_p, got_p, **p_tol)
    want_state = want_s._asdict()
    got_state = got_s._asdict()
    assert sorted(want_state) == sorted(got_state)
    m_tol = (dict(rtol=2.0 ** -7, atol=1e-9) if momentum_dtype == "bfloat16"
             else dict(rtol=1e-6, atol=1e-9))
    for field, want in want_state.items():
        tol = m_tol if field == "buckets" else dict(rtol=1e-6, atol=1e-9)
        _assert_trees_close(want, got_state[field], **tol)


def test_interop_loads_the_jax_state():
    """A JAX ``FusedMixedState`` exported as numpy loads as the port's state,
    every leaf with its path, shape, dtype and bits."""
    jparams = _jax_params()
    cfg = _opt_config("single-pass", "bfloat16", jax_cosine)
    _, jstate = _run_jax(jparams, _grads(jparams)[:1], cfg)
    exported = _np_tree(jstate._asdict())
    state = mixed_state_from_numpy(exported)
    assert type(state).__name__ == "FusedMixedState"
    for path, want in tree_paths(exported):
        got = dict(tree_paths(state._asdict()))[path]
        assert tuple(got.shape) == want.shape
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("matrix_embed", [True, False], ids=["rmnp_embed", "adamw_embed"])
def test_engines_bitwise_equal_inside_the_port(matrix_embed):
    """fp32: per-leaf == bucketed two-pass == single-pass, and the matrix
    partition of each equals the rule's per-leaf reference, bit for bit.
    ``use_kernel`` selects nothing in the port: with and without it the
    results are the same bits."""
    jparams = _jax_params()
    grads = _grads(jparams, seed=1)
    results = {}
    for engine, use_kernel in [(e, False) for e in ENGINES] + [("single-pass", True)]:
        opt = make_optimizer("rmnp", dict(lr_matrix=cosine_with_warmup(2e-2, STEPS),
                                          lr_adamw=cosine_with_warmup(1e-2, STEPS),
                                          matrix_embed=matrix_embed,
                                          use_kernel=use_kernel, **ENGINES[engine]))
        results[engine, use_kernel], _ = _run_torch(
            opt, tree_from_numpy(_np_tree(jparams)), grads)
    first = dict(tree_paths(results["per-leaf", False]))
    for key in [("bucketed", False), ("single-pass", False), ("single-pass", True)]:
        for path, t in tree_paths(results[key]):
            assert torch.equal(t, first[path]), (key, path)

    # matrix partition alone: bucketed engine vs the rule's per-leaf reference
    mat = {p: t for p, t in tree_paths(tree_from_numpy(_np_tree(jparams)))
           if is_matrix_param(p, t, matrix_embed)}
    assert any("embed" in p for p in mat) == matrix_embed
    mgrads = [{p: g for p, g in tree_paths(gr) if p in mat} for gr in grads]
    rule = RmnpRule()
    lr = cosine_with_warmup(2e-2, STEPS)
    ref, ref_state = _run_torch(per_leaf_reference(rule, lr), dict(mat), mgrads)
    for fused_apply in (False, True):
        opt = matrix_optimizer(rule, lr, fused_apply=fused_apply)
        eng, eng_state = _run_torch(opt, dict(mat), mgrads)
        momentum = bucketing.scatter(opt.bucket_plan(mat), eng_state.buckets, mat)
        for path in mat:
            assert torch.equal(eng[path], ref[path]), (fused_apply, path)
            assert torch.equal(eng[path], first[path]), (fused_apply, path)
            assert torch.equal(momentum[path], ref_state.momentum[path]), (fused_apply, path)


def test_per_leaf_rmnp_matches_jax():
    """The pure-matrix ``rmnp(...)`` optimizer, per leaf with the kernel entry
    points, against the JAX package's."""
    jparams = {p: a for p, a in tree_paths(_np_tree(_jax_params()))
               if jax_is_matrix_param(p, a)}
    grads = _grads(jparams, seed=2)
    jopt = jax_rmnp(jax_cosine(2e-2, STEPS), use_kernel=True)
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    js = jopt.init(jp)
    for step, g in enumerate(grads):
        updates, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, step)
        jp = {k: jp[k] + updates[k] for k in jp}
    got, gs = _run_torch(rmnp(cosine_with_warmup(2e-2, STEPS)),
                         tree_from_numpy(jparams), grads)
    _assert_trees_close(jp, got, rtol=1e-6, atol=1e-7)
    _assert_trees_close(js.momentum, gs.momentum, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch,overrides,pad",
                         [("gpt2-small", {}, 1), ("llama-60m", {}, 4),
                          ("llama-60m", {"n_kv_heads": 2}, 3)],
                         ids=["gpt2", "llama_pad4", "llama_gqa_pad3"])
def test_bucket_plan_matches_jax(arch, overrides, pad):
    """Bucket keys, their order, entry paths, shapes, leads and offsets, and
    the padded sizes equal JAX's ``build_plan`` on the same tree."""
    jparams = _jax_params(arch, **overrides)
    want = jbucketing.build_plan(jparams, predicate=jax_is_matrix_param,
                                 pad_multiple=pad)
    got = bucketing.build_plan(tree_from_numpy(_np_tree(jparams)),
                               predicate=is_matrix_param, pad_multiple=pad)
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets, strict=True):
        assert (g.key, g.d_in, g.d_out, g.size, g.padded) == (
            w.key, w.d_in, w.d_out, w.size, w.padded)
        assert [tuple(e) for e in g.entries] == [tuple(e) for e in w.entries]
    assert got.paths == want.paths
    assert bucketing.plan_signature(tree_from_numpy(_np_tree(jparams))) == \
        jbucketing.plan_signature(jparams)


def test_gather_scatter_round_trip_with_padding():
    params = tree_from_numpy(_np_tree(_jax_params()))
    plan = bucketing.build_plan(params, predicate=is_matrix_param, pad_multiple=3)
    stacked = bucketing.gather(plan, params)
    for b in plan.buckets:
        assert stacked[b.key].shape == (b.padded, b.d_in, b.d_out)
        assert not stacked[b.key][b.size:].any()
    back = bucketing.scatter(plan, stacked, params)
    for path, t in tree_paths(params):
        assert torch.equal(dict(tree_paths(back))[path], t), path


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_entry"])
def test_fused_rownorm_update_matches_jax(use_kernel):
    """One momentum-EMA + row-normalize pass per bucket, bf16 momentum,
    against the JAX package's jnp path and its Pallas kernel (interpret)."""
    jparams = _jax_params()
    plan_j = jbucketing.build_plan(jparams, predicate=jax_is_matrix_param)
    grads = _grads(jparams, seed=5)[0]
    rng = np.random.default_rng(6)
    g_j = jbucketing.gather(plan_j, jax.tree_util.tree_map(jnp.asarray, grads))
    v_j = {k: jnp.asarray(0.01 * rng.standard_normal(x.shape), jnp.float32).astype(
        jnp.bfloat16) for k, x in g_j.items()}
    want_d, want_v = jbucketing.fused_rownorm_update(plan_j, g_j, v_j, beta=0.9, eps=1e-8,
                                                     use_kernel=use_kernel)
    plan = bucketing.build_plan(tree_from_numpy(_np_tree(jparams)),
                                predicate=is_matrix_param)
    got_d, got_v = bucketing.fused_rownorm_update(
        plan, tree_from_numpy(_np_tree(g_j)), tree_from_numpy(_np_tree(v_j)),
        beta=0.9, eps=1e-8)
    _assert_trees_close(want_d, got_d, rtol=1e-6, atol=1e-7)
    _assert_trees_close(want_v, got_v, rtol=2.0 ** -7, atol=1e-9)


@pytest.mark.parametrize("max_norm", [1e-3, 1e3, 0.0], ids=["clipped", "unclipped", "off"])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _grads(_jax_params(), seed=3)[0]
    want, wstats = jax_clip(jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    got, gstats = clip_by_global_norm(tree_from_numpy(grads), max_norm)
    np.testing.assert_allclose(float(gstats.global_norm), float(wstats.global_norm),
                               rtol=1e-6)
    assert float(gstats.clipped) == float(wstats.clipped)
    _assert_trees_close(want, got, rtol=1e-6, atol=1e-9)
    if max_norm <= 0:  # passthrough: the very same tensors
        for path, t in tree_paths(got):
            assert torch.equal(t, dict(tree_paths(tree_from_numpy(grads)))[path])


def test_schedule_matches_jax_in_fp32():
    for total in (3, 10, 1000):
        want = jax_cosine(2e-3, total)
        got = cosine_with_warmup(2e-3, total)
        for step in sorted({0, 1, total // 10, total // 2, total - 1}):
            w, g = np.asarray(want(step)), got(step)
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-7, atol=0)
    assert float(cosine_with_warmup(1.0, 3)(0)) == 0.0


def test_registry_names_and_refusals():
    assert optimizer_names() == ("muon", "muown", "nora", "normuon", "rmnp", "adamw")
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd", dict(lr_matrix=1e-3))
    with pytest.raises(ValueError, match="lr_matrix"):
        make_optimizer("rmnp", {})
    with pytest.raises(ValueError, match="unknown matrix update rule"):
        make_rule("nope")


def test_adamw_baseline_matches_jax():
    """``adamw`` on everything, through the bucketed path (empty plan)."""
    jparams = _jax_params()
    grads = _grads(jparams, seed=4)
    jopt = jax_make_optimizer("adamw", dict(lr_matrix=jax_cosine(1e-2, STEPS), fused=True))
    js, jp = jopt.init(jparams), jparams
    for step, g in enumerate(grads):
        updates, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, step)
        jp = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), jp, updates)
    got, state = _run_torch(make_optimizer("adamw", dict(
        lr_matrix=cosine_with_warmup(1e-2, STEPS), fused=True)),
        tree_from_numpy(_np_tree(jparams)), grads)
    assert state.buckets == {}
    _assert_trees_close(jp, got, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_every_engine_routes_rmnp_through_the_kernel_entry(engine):
    """No engine has a plain path of its own: every RMNP update goes through
    ``kernels/ops.py``, which takes CUDA tensors to the kernels and CPU
    tensors to the plain versions, and raises on any other device (here
    ``meta``), with or without ``use_kernel``."""
    params = {p: t.to("meta") for p, t in
              tree_paths(tree_from_numpy(_np_tree(_jax_params())))}
    grads = {p: torch.zeros(t.shape, dtype=torch.float32, device="meta")
             for p, t in params.items()}
    for use_kernel in (False, True):
        opt = make_optimizer("rmnp", dict(lr_matrix=2e-2, use_kernel=use_kernel,
                                          **ENGINES[engine]))
        state = opt.init(params)
        run = opt.update_apply if opt.update_apply is not None else opt.update
        with pytest.raises(ValueError, match="plain versions CPU tensors; got a tensor on meta"):
            run(grads, state, params, 1)


@pytest.mark.parametrize("arch", ["gpt2-small", "xlstm-350m"])
def test_standalone_adamw_matches_jax(arch):
    """``repro_torch.core.adamw`` against ``repro.core.adamw`` on a reduced
    model's parameters, three steps of the same numpy gradients: every
    update and the state ``AdamWState(mu, nu)``, at this file's fp32
    tolerance. The exports of ``repro_torch.core`` that ``repro.core`` has
    are there too."""
    import repro.core as jax_core
    import repro_torch.core as core
    from repro.core.adamw import AdamWState as JaxAdamWState
    for name in ("adamw", "BucketPlan", "build_plan", "fused_rownorm_update"):
        assert hasattr(jax_core, name) and hasattr(core, name), name
    assert core.BucketPlan is core.bucketing.BucketPlan
    jparams = _jax_params(arch)
    grads = _grads(jparams, seed=5)
    jopt = jax_core.adamw(jax_cosine(1e-2, STEPS), weight_decay=0.1)
    opt = core.adamw(cosine_with_warmup(1e-2, STEPS), weight_decay=0.1)
    js, jp = jopt.init(jparams), jparams
    state, params = opt.init(tree_from_numpy(_np_tree(jparams))), tree_from_numpy(
        _np_tree(jparams))
    assert isinstance(state, core.AdamWState) and state._fields == JaxAdamWState._fields
    for step, g in enumerate(grads):
        jupd, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, step)
        jp = jax.tree_util.tree_map(lambda p, u: p + u.astype(p.dtype), jp, jupd)
        upd, state = opt.update(tree_from_numpy(g), state, params, step)
        params = apply_updates(params, upd)
        _assert_trees_close(jupd, upd, rtol=1e-6, atol=1e-7)
    _assert_trees_close(js._asdict(), state._asdict(), rtol=1e-6, atol=1e-7)
    _assert_trees_close(jp, params, rtol=1e-6, atol=1e-7)


def test_single_pass_apply_gathers_one_bucket_at_a_time(monkeypatch):
    """The single-pass apply gathers, launches and scatters bucket by
    bucket, so only one bucket's fp32 gradient and weights are gathered at
    a time (jamba's 16-expert stack alone is 8 GB of fp32 gradient); the
    result is the per-leaf engine's, bit for bit."""
    params = tree_from_numpy(_np_tree(_jax_params()))
    grads = _grads(_jax_params(), seed=6)
    gathered = []
    gather = bucketing.gather

    def recording(plan, tree, dtype=None):
        gathered.append(len(plan.buckets))
        return gather(plan, tree, dtype)

    opt = make_optimizer("rmnp", _opt_config("single-pass", "float32", cosine_with_warmup))
    monkeypatch.setattr(bucketing, "gather", recording)
    got, _ = _run_torch(opt, params, grads)
    monkeypatch.setattr(bucketing, "gather", gather)
    n_buckets = len(opt.bucket_plan(params).buckets)
    assert n_buckets > 1 and gathered == [1] * (2 * n_buckets * STEPS)
    want, _ = _run_torch(make_optimizer("rmnp", _opt_config("per-leaf", "float32",
                                                            cosine_with_warmup)),
                         params, grads)
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want), strict=True):
        assert torch.equal(a, b), path
