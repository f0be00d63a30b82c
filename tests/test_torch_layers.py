"""The port's dense layers, parameter specs and model plumbing against the
JAX package's, and the refusals of what is not ported yet.

Tolerances. ``rms_norm`` and ``apply_rope``: both frameworks reduce in fp32
and emit outputs and cotangents in the activation type, so fp32 agrees to
1e-6 of the largest magnitude and bf16 to one bf16 step (2^-7 relative to
the largest, a rounding boundary straddled). Attention paths inside the
port: the same fp32 math tiled differently, rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models.model import build_param_specs as jax_param_specs
from repro_torch.configs import get_config
from repro_torch.core import bucketing, is_matrix_param
from repro_torch.core.types import tree_paths
from repro_torch.interop import to_numpy, to_tensor
from repro_torch.models import layers
from repro_torch.models.model import build_param_specs, init_cache, init_params
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _close_to_max(got, want, frac, what):
    want = np.asarray(want).astype(np.float32)
    got = to_numpy(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("arch", ["gpt2-small", "llama-60m", "deepseek-v2-lite-16b",
                                  "olmoe-1b-7b", "minicpm3-4b", "xlstm-350m",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_param_specs_match_jax(arch, reduced):
    """Same paths, shapes, init kinds and scales, full width included (specs
    only: nothing is allocated)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    assert cfg.padded_vocab == jcfg.padded_vocab
    want = dict(tree_paths(jax.tree_util.tree_map(
        _describe, jax_param_specs(jcfg),
        is_leaf=lambda x: isinstance(x, jax_layers.ParamSpec))))
    got = {p: _describe(s) for p, s in tree_paths(build_param_specs(cfg))}
    assert got == want


def _describe(spec):
    return f"{spec.shape} {spec.init} {spec.scale} {spec.dtype}"


def test_gpt2_small_full_width_buckets():
    """The shapes the main path's optimizer sees at full width: four buckets,
    the tied embedding among them."""
    cfg = get_config("gpt2-small")
    assert (cfg.padded_vocab, cfg.dtype, cfg.tie_embeddings) == (50432, "bfloat16", True)
    shapes = {p: torch.empty(s.shape, device="meta")
              for p, s in tree_paths(build_param_specs(cfg))}
    plan = bucketing.build_plan(shapes, predicate=is_matrix_param)
    assert [(b.key, b.size) for b in plan.buckets] == [
        ("768x768", 48), ("768x6144", 12), ("3072x768", 12), ("50432x768", 1)]
    assert sum(b.size * b.d_in * b.d_out for b in plan.buckets) == 151_977_984


def test_init_params_on_the_cpu_from_a_seed():
    cfg = get_config("gpt2-small").reduced()
    a = init_params(cfg, seed=0, device="cpu")
    b = init_params(cfg, seed=0, device="cpu")
    c = init_params(cfg, seed=1, device="cpu")
    specs = dict(tree_paths(build_param_specs(cfg)))
    for path, t in tree_paths(a):
        assert tuple(t.shape) == specs[path].shape and t.dtype == torch.float32
        assert torch.equal(t, dict(tree_paths(b))[path])
    emb = a["embed"]["tokens"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    assert not torch.equal(emb, c["embed"]["tokens"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_and_rope_vjps_match_jax(dtype):
    """The hand-written backward passes: cotangents in the activation dtype,
    reductions in fp32, as the JAX package's custom VJPs."""
    rng = np.random.default_rng(5)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.standard_normal((2, 8, 4, 16)), jnp.float32).astype(jdt)
    scale = jnp.asarray(1.0 + 0.1 * rng.standard_normal(16), jnp.float32).astype(jdt)
    ct = jnp.asarray(rng.standard_normal((2, 8, 4, 16)), jnp.float32).astype(jdt)
    pos = jnp.asarray(np.tile(np.arange(8, dtype=np.int32), (2, 1)) + 3)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7

    out, vjp = jax.vjp(lambda a, s: jax_layers.rms_norm(a, s, 1e-6), x, scale)
    dx, ds = vjp(ct)
    tx, ts = (to_tensor(np.asarray(a)).requires_grad_(True) for a in (x, scale))
    tout = layers.rms_norm(tx, ts, 1e-6)
    tdx, tds = torch.autograd.grad(tout, (tx, ts), to_tensor(np.asarray(ct)))
    assert tdx.dtype == tx.dtype and tds.dtype == ts.dtype
    for want, got in ((out, tout), (dx, tdx), (ds, tds)):
        _close_to_max(got.detach(), want, tol, "rms_norm")

    out, vjp = jax.vjp(lambda a: jax_layers.apply_rope(a, pos, 10_000.0), x)
    (dx,) = vjp(ct)
    tx = to_tensor(np.asarray(x)).requires_grad_(True)
    tout = layers.apply_rope(tx, torch.from_numpy(np.array(pos)), 10_000.0)
    (tdx,) = torch.autograd.grad(tout, (tx,), to_tensor(np.asarray(ct)))
    assert tdx.dtype == tx.dtype
    for want, got in ((out, tout), (dx, tdx)):
        _close_to_max(got.detach(), want, tol, "apply_rope")


def test_attention_impls_agree_on_the_cpu():
    """dense, chunked and the flash Function (plain version on the CPU) give
    the same attention, G = 2, with blocks that cross the causal diagonal."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 4, 16, generator=gen)
    k = torch.randn(2, 32, 2, 16, generator=gen)
    v = torch.randn(2, 32, 2, 16, generator=gen)
    dense = layers.attention(q, k, v, impl="dense")
    for impl in ("chunked", "pallas"):
        got = layers.attention(q, k, v, impl=impl, chunk_q=8, chunk_k=8)
        torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-6)


def test_unported_paths_raise_and_name_the_roadmap_item():
    """Every family the JAX package defines is ported: the frontend configs
    (paligemma-3b, musicgen-large) resolve and equal the JAX package's, and
    a mixer name neither package knows raises a KeyError in both, the
    port's naming the mixers it knows."""
    from repro.models.model import build_cache_specs as jax_cache_specs
    for arch in ("paligemma-3b", "musicgen-large"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    cfg = get_config("gpt2-small").reduced()
    jcfg = jax_get_config("gpt2-small").reduced()
    vision = dataclasses.replace(cfg, pattern=(("vision", "dense"),) * 2)
    jvision = dataclasses.replace(jcfg, pattern=(("vision", "dense"),) * 2)
    with pytest.raises(KeyError, match="unknown mixer 'vision'; known: gqa, mla, mamba"):
        init_cache(vision, 2, 16, device="cpu")
    with pytest.raises(KeyError, match="unknown mixer 'vision'"):
        build_param_specs(vision)
    for build in (lambda: jax_cache_specs(jvision, 2, 16), lambda: jax_param_specs(jvision)):
        with pytest.raises(KeyError, match="vision"):
            build()
    # a mamba pattern now builds its parameters and its state cache
    mamba = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                                num_layers=2, pattern=(("mamba", "dense"),) * 2)
    assert "stack" in build_param_specs(mamba)
    assert {p.split("/")[-1] for p, _ in tree_paths(init_cache(mamba, 2, 16, device="cpu"))} \
        == {"h", "conv"}


def _old_materialize(spec, generator, dtype, device):
    """``layers.materialize`` before it scaled its noise in place: the
    scaled noise as a second fp32 tensor, then the cast."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    noise = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    if spec.init == "normal":
        return (spec.scale * noise).to(dtype)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / (fan_in ** 0.5)
    return (std * noise).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_materialize_in_place_keeps_the_bits(dtype):
    """Scaling the noise in place gives the bits of the old two-tensor
    formula from one generator state, for every init kind."""
    specs = [layers.ParamSpec((7, 33, 65), ("a", "d_in", "b")),
             layers.ParamSpec((130, 24), ("vocab", "embed"), "normal", 0.02),
             layers.ParamSpec((3, 64, 48), ("layers", "d_in", "mlp"), "fan_in", 0.5),
             layers.ParamSpec((40,), ("embed",)), layers.ParamSpec((5,), (None,), "ones"),
             layers.ParamSpec((4, 4), (None, None), "zeros")]
    for spec in specs:
        g_new, g_old = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
        new = layers.materialize(spec, g_new, dtype, "cpu")
        old = _old_materialize(spec, g_old, dtype, "cpu")
        assert new.dtype == old.dtype == dtype
        assert torch.equal(new.view(torch.int16) if dtype == torch.bfloat16 else new,
                           old.view(torch.int16) if dtype == torch.bfloat16 else old), spec


@pytest.mark.parametrize("arch", ["gpt2-small", "llama-130m", "qwen3-4b", "phi3-mini-3.8b",
                                  "yi-9b"])
def test_init_params_keeps_the_bits_of_every_existing_config(arch):
    """``init_params`` of each config ported before the in-place repair, in
    its own type (bf16, at reduced size with the full config's dtype),
    against the old formula drawn leaf by leaf in the same order."""
    from repro_torch.models.model import _spec_paths
    cfg = get_config(arch).reduced(dtype="bfloat16")
    got = dict(tree_paths(init_params(cfg, seed=3, device="cpu")))
    gen = torch.Generator().manual_seed(3)
    for path, spec in _spec_paths(build_param_specs(cfg)):
        want = _old_materialize(spec, gen, torch.bfloat16, "cpu")
        assert torch.equal(got[path].view(torch.int16), want.view(torch.int16)), path


def test_deepseek_three_layer_cut_buckets():
    """The shapes RMNP sees when deepseek-v2-lite-16b is cut to its first 3
    layers (the dense prefix and 2 MoE units) at full width: 13 buckets,
    the expert stacks at L = 2 units x 64 experts = 128."""
    base = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(base, num_layers=3, pattern=base.pattern[:3])
    shapes = {p: torch.empty(s.shape, device="meta")
              for p, s in tree_paths(build_param_specs(cfg))}
    assert sum(t.numel() for t in shapes.values()) == 1_670_135_296
    plan = bucketing.build_plan(shapes, predicate=is_matrix_param)
    sizes = {b.key: b.size for b in plan.buckets}
    assert len(sizes) == 13
    assert sizes["2048x2816"] == 128 and sizes["1408x2048"] == 128
    for key in ("10944x2048", "2048x21888", "2048x64", "102400x2048"):
        assert key in sizes
