"""The port's MLA attention (``repro_torch.models.layers.mla_*``) against the
JAX package's, and the flash kernel's plain version at hdv != hd.

Reduced deepseek-v2-lite-16b (full-rank q) and minicpm3-4b (the q-LoRA
branch: ``wq_a``, ``q_a_norm``, ``wq_b``), fp32. Layer inputs and
parameters are drawn with numpy from a seed and handed to both; the model
tests load the JAX package's ``init_params`` through ``interop``.

Tolerances. fp32 on both sides, sums in other orders: every output and
cache leaf agrees element by element to rtol 1e-5 plus 2e-6 of its
largest magnitude (the bound of ``tests/test_torch_serve.py``, whose
docstring gives the floor of an fp32 dot product). The flash plain version
against the Pallas kernel in interpret mode: fp32 to rtol 1e-5 (the same
online softmax, tiled alike), bf16 to one bf16 step of the largest element
(both round one fp32 result).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models.model import forward as jax_forward
from repro_torch.configs import get_config
from repro_torch.interop import to_numpy, to_tensor, tree_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.serve import place_cache
from repro_torch.models import layers
from repro_torch.models.model import forward, init_cache

RTOL, ATOL_FRAC = 1e-5, 2e-6
B, T = 2, 12
ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]


def _configs(arch, **overrides):
    return (jax_get_config(arch).reduced(**overrides),
            get_config(arch).reduced(**overrides))


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(layers.mla_specs(cfg).items()):
        if spec.init == "ones":
            out[name] = (1.0 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        else:
            out[name] = (rng.standard_normal(spec.shape)
                         / np.sqrt(spec.shape[-2])).astype(np.float32)
    return out


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(to_numpy(got), want, rtol=RTOL,
                               atol=ATOL_FRAC * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mla_train_and_prefill_match_jax(arch, impl):
    """``mla_apply`` in train and prefill mode: the output and, in prefill,
    the latent cache (``ckv``, ``k_rope``)."""
    jcfg, cfg = _configs(arch, attn_impl=impl, attn_chunk_q=4, attn_chunk_k=4)
    p = _params(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for mode in ("train", "prefill"):
        want, wcache = jax_layers.mla_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), mode)
        got, cache = layers.mla_apply(cfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                                      mode)
        _close(got, want, f"{mode} y")
        if mode == "prefill":
            assert sorted(cache) == sorted(wcache) == ["ckv", "k_rope"]
            for name in cache:
                _close(cache[name], wcache[name], f"cache {name}")
        else:
            assert cache is None and wcache is None


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_decode_matches_jax(arch):
    """One decode step at position T from a prefilled latent cache of T + 4
    positions: the output and the written cache; the port writes in place
    and returns the cache it was given."""
    jcfg, cfg = _configs(arch)
    p = _params(cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T + 1, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    m = cfg.mla
    zeros = {"ckv": np.zeros((B, T + 4, m.kv_lora_rank), np.float32),
             "k_rope": np.zeros((B, T + 4, m.qk_rope_head_dim), np.float32)}
    _, wpc = jax_layers.mla_apply(jcfg, jp, jnp.asarray(x[:, :T]), jnp.asarray(pos), "prefill")
    jcache = {k: jnp.asarray(v).at[:, :T].set(wpc[k]) for k, v in zeros.items()}
    want, wcache = jax_layers.mla_apply(jcfg, jp, jnp.asarray(x[:, T:]),
                                        jnp.full((B, 1), T, jnp.int32), "decode",
                                        cache=jcache, pos=T)
    cache = {k: to_tensor(np.asarray(v)) for k, v in jcache.items()}
    got, out = layers.mla_apply(cfg, tp, torch.from_numpy(x[:, T:]),
                                torch.full((B, 1), T, dtype=torch.int32), "decode",
                                cache=cache, pos=T)
    _close(got, want, "decode y")
    for name in cache:
        assert out[name] is cache[name]
        _close(out[name], wcache[name], f"decode cache {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_model_prefill_then_decode_matches_jax_forward(arch):
    """The whole reduced model from the JAX package's parameters: prefill of
    T tokens, the latent caches placed in a zeroed cache of T + 2 (prefix
    layers unstacked, the units stacked), then one decode step, against the
    JAX package's dense forward over the T + 1 tokens at position T. The
    MoE FFN (deepseek) runs at capacity factor E / K, where no expert
    overflows: the forward over B * (T + 1) tokens would otherwise drop
    pairs that a decode step over B tokens keeps."""
    jcfg, cfg = _configs(arch)
    if cfg.moe:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=c.moe.num_experts / c.moe.top_k)) for c in (jcfg, cfg))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (B, T + 1), 0, jcfg.vocab),
                      np.int32)
    want = np.asarray(jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, "train")[0])
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    _, pc, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks[:, :T])}, "prefill")
    cache = place_cache(init_cache(cfg, B, T + 2, device="cpu"), pc)
    mixers = {path.split("/")[-1] for path in _paths(cache)}
    assert mixers == {"ckv", "k_rope"}
    logits, _, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks[:, T:])}, "decode",
                           cache=cache, pos=T)
    _close(logits[:, 0], want[:, T], "decode logits")


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_at_hd192_hdv128_matches_pallas(dtype, causal):
    """The flash kernel's plain version at MLA's head dims (q/k 192, v 128,
    deepseek-v2-lite's) against the JAX package's Pallas kernel in
    interpret mode, blocks of 16 over S = 48; v is a column slice of a
    wider tensor, as MLA's is."""
    rng = np.random.default_rng(192)
    jdt = jnp.dtype(dtype)
    q, k = (np.asarray(jnp.asarray(rng.standard_normal((1, 48, 2, 192)), jnp.float32)
                       .astype(jdt)) for _ in range(2))
    kv = np.asarray(jnp.asarray(rng.standard_normal((1, 48, 2, 256)), jnp.float32).astype(jdt))
    v = kv[..., 128:]
    want = np.asarray(jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, block_q=16, block_k=16, interpret=True))
    tv = to_tensor(kv)[..., 128:]
    assert not tv.is_contiguous()
    got = fa.flash_attention_fwd(to_tensor(q), to_tensor(k), tv, causal=causal, block_q=16,
                                 block_k=16)
    assert tuple(got.shape) == (1, 48, 2, 128)
    if dtype == "float32":
        _close(got, want, "attention")
    else:
        want = want.astype(np.float32)
        np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                                   atol=2.0 ** -7 * float(np.abs(want).max()))


def test_flash_kernel_pairs_and_refusals():
    """(192, 128) and minicpm3-4b's (96, 64) are built for bf16 and fp32,
    and the wrapper raises on an unbuilt pair before it reaches any kernel
    (on CPU tensors it refuses to launch at all)."""
    for dt in (torch.bfloat16, torch.float32):
        assert (192, 128) in fa.HEAD_DIM_PAIRS[dt]
        assert (96, 64) in fa.HEAD_DIM_PAIRS[dt]  # minicpm3-4b's MLA
        assert (80, 80) not in fa.HEAD_DIM_PAIRS[dt]
        assert (192, 192) not in fa.HEAD_DIM_PAIRS[dt]
    q, v = torch.zeros(1, 8, 2, 192), torch.zeros(1, 8, 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd_kernel(q, q, v)


def test_reduced_configs_keep_mla_shapes():
    """The reduced configs the tests use, as the JAX package reduces them."""
    for arch in ARCHS + ["olmoe-1b-7b"]:
        jcfg, cfg = _configs(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
