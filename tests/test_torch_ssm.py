"""The port's SSM mixers (``repro_torch.models.ssm``: mamba, mLSTM, sLSTM)
and the two SSM architectures (xlstm-350m, jamba-v0.1-52b) against the JAX
package's, on the CPU in fp32.

Each mixer's ``*_apply`` runs in train, prefill and decode mode from the
same numpy-drawn parameters and inputs as ``repro.models.ssm``'s: the
output, the gradients of a random projection of it (train), the final
states (prefill) and the advanced caches (decode, which the port writes in
place). mamba runs at S = 128 (two chunks of 64) and S = 72 (not a
multiple: one chunk), mLSTM at S = 32 (four chunks of the reduced config's
8). The whole reduced models load the JAX package's ``init_params``
through ``interop``: logits, loss and every gradient, one single-pass RMNP
step, the bucket plan and the split of leaves between RMNP and AdamW, and
a decode step from a prefill-built cache against the forward over one more
token.

Tolerances. fp32 on both sides with sums in other orders: every tensor
agrees element by element to rtol 1e-5 plus 2e-6 of its largest magnitude
(the bound of ``tests/test_torch_serve.py`` and ``test_torch_mla.py``),
the loss to 1e-6 relative. The in-chunk scan associates its products as a
doubling scan where ``lax.associative_scan`` uses an odd/even recursion;
both are held against a float64 sequential recurrence at 2e-6 of the
largest magnitude, and against each other at the bound above. Whole-model
gradients and the parameters after a step use the bound of
``tests/test_torch_model.py`` and ``test_torch_train.py``, 1e-5 of each
leaf's largest entry (measured at most 4e-6 here), below phase D's 1e-4;
an AdamW element whose gradient is near AdamW's eps adds the gradients'
bound carried through the step's slope (see the step's test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import shape_applicable as jax_shape_applicable
from repro.core import constant as jax_constant
from repro.core import is_matrix_param as jax_is_matrix_param
from repro.core import make_optimizer as jax_make_optimizer
from repro.core.bucketing import build_plan as jax_build_plan
from repro.data.pipeline import make_stream as jax_make_stream
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro.models.model import forward as jax_forward
from repro.models.model import loss_fn as jax_loss_fn
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import SHAPES, cut_layers, get_config, list_configs, shape_applicable
from repro_torch.core import build_plan, constant, is_matrix_param, make_optimizer
from repro_torch.core.types import map_with_path, tree_paths
from repro_torch.data.pipeline import make_stream
from repro_torch.interop import to_numpy, to_tensor, tree_from_numpy
from repro_torch.launch.serve import place_cache
from repro_torch.models import ssm
from repro_torch.models.model import (MIXERS, build_param_specs, forward, init_cache, loss_fn,
                                      plan_stack)
from repro_torch.train.step import make_train_step

RTOL, ATOL_FRAC = 1e-5, 2e-6
GRAD_FRAC = 1e-5   # whole-model gradients, as tests/test_torch_model.py
B = 2
# (mixer, the reduced arch it comes from, S)
CASES = [("mamba", "jamba-v0.1-52b", 128), ("mamba", "jamba-v0.1-52b", 72),
         ("mlstm", "xlstm-350m", 32), ("slstm", "xlstm-350m", 16)]
CASE_IDS = ["mamba_2_chunks", "mamba_1_chunk", "mlstm_4_chunks", "slstm"]
ARCHS = ["xlstm-350m", "jamba-v0.1-52b"]


def _configs(arch):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def _params(specs, seed=0):
    """numpy parameters of the specs' shapes: ones and zeros perturbed (so
    every bias and scale matters), normals at their scale, the rest at
    1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        noise = rng.standard_normal(spec.shape)
        if spec.init == "ones":
            out[name] = 1.0 + 0.1 * noise
        elif spec.init == "zeros":
            out[name] = 0.1 * noise
        elif spec.init == "normal":
            out[name] = spec.scale * noise
        else:
            out[name] = noise / np.sqrt(spec.shape[-2])
        out[name] = out[name].astype(np.float32)
    return out


def _close(got, want, what, rtol=RTOL, atol_frac=ATOL_FRAC):
    want = np.asarray(want, np.float32)
    got = to_numpy(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _mixer_fns(mixer):
    return getattr(jax_ssm, f"{mixer}_apply"), getattr(ssm, f"{mixer}_apply")


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("mixer,arch,S", CASES, ids=CASE_IDS)
def test_mixer_train_and_prefill_match_jax(mixer, arch, S, mode):
    """train: the output and the gradients of <y, r> with respect to every
    parameter and the input; prefill: the output and the final states."""
    jcfg, cfg = _configs(arch)
    p = _params(getattr(ssm, f"{mixer}_specs")(cfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    japply, apply = _mixer_fns(mixer)

    def jrun(jp, jx):
        y, cache = japply(jcfg, jp, jx, jnp.asarray(pos), mode)
        return jnp.sum(y * jnp.asarray(r)), (y, cache)

    (_, (want, wcache)), want_g = jax.jit(jax.value_and_grad(
        jrun, argnums=(0, 1), has_aux=True))({k: jnp.asarray(v) for k, v in p.items()},
                                             jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got, cache = apply(cfg, tp, tx, torch.from_numpy(pos), mode)
    _close(got.detach(), want, f"{mode} y")
    if mode == "prefill":
        assert sorted(cache) == sorted(wcache)
        for name in cache:
            assert cache[name].dtype == torch.float32 or name == "conv", name
            _close(cache[name].detach(), wcache[name], f"final state {name}")
        return
    assert cache is None and wcache is None
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(r)), [*tp.values(), tx])
    for name, g in zip(tp, grads, strict=False):
        _close(g, want_g[0][name], f"grad {name}")
    _close(grads[-1], want_g[1], "grad x")


@pytest.mark.parametrize("mixer,arch,S", CASES[1:], ids=CASE_IDS[1:])
def test_mixer_decode_matches_jax(mixer, arch, S):
    """One decode step after a prefill of S tokens, from the JAX prefill's
    caches: the output and the advanced caches, which the port writes into
    the tensors it was given and returns."""
    jcfg, cfg = _configs(arch)
    p = _params(getattr(ssm, f"{mixer}_specs")(cfg))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    japply, apply = _mixer_fns(mixer)
    _, jcache = jax.jit(lambda q, jx: japply(jcfg, q, jx, jnp.asarray(pos), "prefill"))(
        jp, jnp.asarray(x[:, :S]))
    want, wcache = jax.jit(lambda q, jx, c: japply(
        jcfg, q, jx, jnp.full((B, 1), S, jnp.int32), "decode", cache=c, pos=S))(
        jp, jnp.asarray(x[:, S:]), jcache)
    cache = {k: to_tensor(np.asarray(v)) for k, v in jcache.items()}
    got, out = apply(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x[:, S:]), torch.full((B, 1), S, dtype=torch.int32),
                     "decode", cache=cache, pos=S)
    _close(got, want, "decode y")
    assert sorted(out) == sorted(wcache)
    for name in cache:
        assert out[name] is cache[name]
        _close(out[name], wcache[name], f"decode cache {name}")


@pytest.mark.parametrize("n", [1, 2, 63, 64, 72])
def test_doubling_scan_matches_a_sequential_float64_recurrence(n):
    """The in-chunk scan of h_t = a_t h_{t-1} + b_t (a in (0, 1), as
    exp(dt * A) with A < 0), through ``ssm.doubling_scan`` and through
    ``lax.associative_scan`` with the reference's combine, against the
    recurrence run step by step in float64: the composed maps (a, b) and
    the states from a nonzero h0."""
    rng = np.random.default_rng(n)
    a = np.exp(-rng.uniform(0.0, 0.3, (B, n, 8, 4))).astype(np.float32)
    b = rng.standard_normal((B, n, 8, 4)).astype(np.float32)
    h0 = rng.standard_normal((B, 8, 4)).astype(np.float32)
    want_a, want_b = np.empty((B, n, 8, 4)), np.empty((B, n, 8, 4))
    acc_a, acc_b = np.ones((B, 8, 4)), np.zeros((B, 8, 4))
    for t in range(n):
        acc_a, acc_b = acc_a * a[:, t], a[:, t] * acc_b + b[:, t]
        want_a[:, t], want_b[:, t] = acc_a, acc_b
    want_h = want_a * h0[:, None] + want_b

    def comb(x, y):
        return x[0] * y[0], y[0] * x[1] + y[1]

    ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = ssm.doubling_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1)
    for name, (sa, sb) in (("doubling", (to_numpy(ta), to_numpy(tb))),
                           ("associative_scan", (np.asarray(ja), np.asarray(jb)))):
        _close(to_tensor(sa), want_a, f"{name} a", rtol=0)
        _close(to_tensor(sb), want_b, f"{name} b", rtol=0)
        _close(to_tensor(sa * h0[:, None] + sb), want_h, f"{name} h", rtol=0)
    _close(tb, np.asarray(jb), "doubling against associative_scan")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """A reduced architecture with the JAX package's parameters, a batch from
    the data pipeline both packages share, and JAX's loss, logits and
    gradients there."""
    arch = request.param
    jcfg, cfg = _configs(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    np_batch = make_stream(cfg, 32, B, seed=0).sample(0)
    jbatch = jax_make_stream(jcfg, 32, B, seed=0).sample(0)
    assert all(np.array_equal(np_batch[k], jbatch[k]) for k in np_batch)

    @jax.jit
    def run(p, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jax_loss_fn(jcfg, q, batch, remat="full"), has_aux=True)(p)
        return loss, jax_forward(jcfg, p, batch, "train")[0], grads

    loss, logits, grads = run(jparams, {k: jnp.asarray(v) for k, v in np_batch.items()})
    want = (float(loss), np.asarray(logits),
            dict(tree_paths(jax.tree_util.tree_map(np.asarray, grads))))
    return arch, jcfg, cfg, jparams, params, np_batch, want


def test_model_logits_loss_and_grads_match_jax(model):
    _, _, cfg, _, params, np_batch, (want_loss, want_logits, want_grads) = model
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    leaves = {p: t.detach().requires_grad_(True) for p, t in tree_paths(params)}
    loss, _ = loss_fn(cfg, map_with_path(lambda path, _t: leaves[path], params), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        logits = forward(cfg, params, batch, "train")[0]
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-6)
    _close(logits, want_logits, "logits")
    assert sorted(leaves) == sorted(want_grads)
    for path, g in zip(leaves, grads, strict=True):
        _close(g, want_grads[path], path, rtol=0, atol_frac=GRAD_FRAC)


def test_bucket_plan_and_matrix_split_match_jax(model):
    """The port sends exactly the reference's leaves to RMNP (``x_proj``,
    the gate matrices, the 4-D ``r_gates`` stack, the expert stacks) and
    the rest (``conv_w``, ``dt_w``, ``dt_bias``, ``A_log``, norms, biases)
    to AdamW, and packs the same buckets in the same order."""
    arch, _, _, jparams, params, _, _ = model
    jflat = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jparams)))
    split = {p: is_matrix_param(p, t) for p, t in tree_paths(params)}
    assert split == {p: jax_is_matrix_param(p, a) for p, a in jflat.items()}
    names = {p.split("/")[-1]: m for p, m in split.items() if "/mixer/" in p}
    expect = {"xlstm-350m": {"w_igate": True, "w_fgate": True, "r_gates": True,
                             "igate_bias": False, "head_norm": False},
              "jamba-v0.1-52b": {"x_proj": True, "in_proj": True, "conv_w": False,
                                 "conv_bias": False, "dt_w": False, "dt_bias": False,
                                 "A_log": False, "D_skip": False}}[arch]
    assert {name: names[name] for name in expect} == expect
    plan = build_plan(params, predicate=is_matrix_param)
    jplan = jax_build_plan(jparams, predicate=jax_is_matrix_param)
    got = [(b.key, b.size, [(e.path, e.offset) for e in b.entries]) for b in plan.buckets]
    want = [(b.key, b.size, [(e.path, e.offset) for e in b.entries]) for b in jplan.buckets]
    assert got == want


def test_one_single_pass_rmnp_step_matches_jax(model):
    """One single-pass mixed RMNP step (constant rates, step 0, no clip) from
    the same parameters and batch: loss, grad norm, and every parameter
    after it, at 1e-5 of each leaf's largest entry. An AdamW element's first
    step moves it by lr * g / (|g| + eps), whose slope in g is
    lr * eps / (|g| + eps)^2: near |g| ~ eps (jamba's ``A_log`` has a third
    of its gradients below 100 eps) the gradients' agreement, GRAD_FRAC of
    the leaf's largest, is carried into the step by that slope and added to
    the element's bound."""
    _, jcfg, cfg, jparams, params, np_batch, (_, _, grads) = model
    lr, eps = 1e-2, 1e-8
    conf = dict(use_kernel=True, fused=True, fused_apply=True, adam_eps=eps)
    jopt = jax_make_optimizer("rmnp", dict(conf, lr_matrix=jax_constant(2e-2),
                                           lr_adamw=jax_constant(lr)))
    opt = make_optimizer("rmnp", dict(conf, lr_matrix=constant(2e-2), lr_adamw=constant(lr)))
    jnew, _, jm = jax.jit(jax_make_train_step(jcfg, jopt, clip_norm=0.0, remat="full"))(
        jparams, jopt.init(jparams), {k: jnp.asarray(v) for k, v in np_batch.items()}, 0)
    new, _, m = make_train_step(cfg, opt, clip_norm=0.0, remat="full")(
        params, opt.init(params), {k: torch.from_numpy(v) for k, v in np_batch.items()}, 0)
    np.testing.assert_allclose([float(m["loss"]), float(m["grad_norm"])],
                               [float(jm["loss"]), float(jm["grad_norm"])], rtol=1e-6)
    after = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jnew)))
    for path, t in tree_paths(new):
        want = after[path].astype(np.float32)
        atol = 1e-5 * float(np.abs(want).max())
        if not is_matrix_param(path, t):
            g = grads[path]
            atol = atol + lr * eps * GRAD_FRAC * float(np.abs(g).max()) / (np.abs(g) + eps) ** 2
        np.testing.assert_array_less(np.abs(to_numpy(t) - want), atol + 1e-30, err_msg=path)


def test_decode_from_a_prefill_cache_matches_the_forward(model):
    """The port's counterpart of ``tests/test_models.py``'s decode test, held
    at this file's bound: the prefill's caches equal the JAX prefill's;
    placed into a zeroed cache of T + 2 positions (a fixed-size SSM state
    is copied whole), one decode step at position T gives the logits of
    the JAX forward over T + 1 tokens at T. jamba's MoE runs at capacity
    factor E / K, where a forward over B * (T + 1) tokens drops nothing
    that a decode step over B tokens keeps."""
    arch, jcfg, cfg, jparams, params, _, _ = model
    if cfg.moe:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=c.moe.num_experts / c.moe.top_k)) for c in (jcfg, cfg))
    T = 16
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (B, T + 1), 0, jcfg.vocab),
                      np.int32)
    want = np.asarray(jax.jit(lambda p, b: jax_forward(jcfg, p, b, "train")[0])(
        jparams, {"tokens": jnp.asarray(toks)}))
    _, jpc = jax.jit(jax_make_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(toks[:, :T])})
    _, pc, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks[:, :T])}, "prefill")
    jflat = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jpc)))
    assert sorted(p for p, _ in tree_paths(pc)) == sorted(jflat)
    for path, t in tree_paths(pc):
        _close(t, jflat[path], f"prefill cache {path}")
    cache = place_cache(init_cache(cfg, B, T + 2, device="cpu"), pc)
    states = {path.split("/")[-1] for path, _ in tree_paths(cache)}
    assert states >= ({"C", "n", "h", "c"} if arch == "xlstm-350m" else {"h", "conv", "k"})
    logits, out, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks[:, T:])},
                             "decode", cache=cache, pos=T)
    assert all(a is b for (_, a), (_, b) in zip(tree_paths(out), tree_paths(cache),
                                                strict=True))
    _close(logits[:, 0], want[:, T], "decode logits")


def test_configs_and_mixers_are_the_jax_packages():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert cfg.has_ssm_state == jcfg.has_ssm_state is True
        assert cfg.full_attention_only == jcfg.full_attention_only is False
        for name, shape in SHAPES.items():
            assert shape_applicable(cfg, shape) == jax_shape_applicable(jcfg, JAX_SHAPES[name])
    assert {"mamba", "mlstm", "slstm"} <= set(MIXERS)
    # every architecture the JAX package defines resolves in the port
    assert list_configs() == jax_list_configs()


def _full_width(arch, layers=None):
    """Parameter count and RMNP buckets (L, d_in, d_out) of a full-width
    config, from its specs alone (meta tensors: nothing is allocated)."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers.stop - layers.start,
                                  pattern=cfg.pattern[layers])
    shapes = {p: torch.empty(s.shape, device="meta")
              for p, s in tree_paths(build_param_specs(cfg))}
    plan = build_plan(shapes, predicate=is_matrix_param)
    return (sum(t.numel() for t in shapes.values()), plan_stack(cfg.pattern),
            {(b.size, b.d_in, b.d_out) for b in plan.buckets})


def test_full_width_cuts_and_their_buckets():
    """The shapes the card runs: xlstm-350m whole (its gate matrices, four
    columns wide, and the 4-D ``r_gates`` stack at L = 12 x 4 heads),
    jamba cut to its first group of 8 layers (served) and to layers 3-4
    (trained: a mamba layer with the 16-expert FFN, then the GQA layer)."""
    n, plan, buckets = _full_width("xlstm-350m")
    assert n == 468_497_504 and plan == (0, 2, 12)
    assert {(24, 2048, 4), (48, 256, 1024), (1, 50432, 1024)} <= buckets
    assert len(buckets) == 7
    n, plan, _ = _full_width("jamba-v0.1-52b", slice(0, 8))
    assert n == 13_295_235_072 and plan == (2, 6, 1)
    n, plan, buckets = _full_width("jamba-v0.1-52b", slice(3, 5))
    assert n == 3_678_941_184 and plan == (1, 1, 1)
    assert {(1, 8192, 288), (17, 4096, 28672), (17, 14336, 4096),
            (1, 65536, 4096)} <= buckets
    assert len(buckets) == 10
    assert _full_width("jamba-v0.1-52b")[0] == 51_570_315_264


def test_entry_points_train_and_serve_the_ssm_archs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train`` and ``.serve`` with the two
    archs, reduced, on the CPU: xlstm whole, jamba also cut in depth with
    ``--layers`` (a mamba layer with the MoE FFN, then the GQA layer)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    common = ["--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
              "--engine", "single-pass", "--device", "cpu"]
    train_mod.main(["--arch", "xlstm-350m"] + common)
    train_mod.main(["--arch", "jamba-v0.1-52b", "--layers", "1:3"] + common)
    assert capsys.readouterr().out.count("[train] step=1") == 2
    for argv in (["--arch", "xlstm-350m"], ["--arch", "jamba-v0.1-52b", "--layers", "0:4",
                                            "--attn-impl", "pallas"]):
        serve_mod.main(argv + ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                               "--tokens", "4"])
    assert capsys.readouterr().out.count("seq[1]") == 2
    cut = cut_layers(get_config("jamba-v0.1-52b"), "3:5")
    assert cut.pattern == (("mamba", "moe"), ("gqa", "dense")) and cut.d_model == 4096
    with pytest.raises(ValueError, match="outside"):
        cut_layers(get_config("xlstm-350m"), "20:26")
