"""The port's serving path against the JAX package's: prefill, the KV cache,
decode, greedy generation and the cache specs.

Parameters come from the JAX package's ``init_params`` (exported as numpy,
loaded with ``repro_torch.interop``), and so do the prompts. Reduced
qwen3-4b keeps GQA with ``n_heads=8, n_kv_heads=2, head_dim=16`` (plain
``.reduced()`` gives H = K = 4); reduced phi3-mini is MHA, reduced
gpt2-small ties its head, reduced llama-130m does not; phi3-mini also at
its real head dim 96 and minicpm3-4b at its real MLA head dims (q/k 96, v
64), the pairs of the bf16 flash kernel's hd-96 builds. Prefill runs
``attn_impl="dense"`` and ``"pallas"``: on the JAX side the Pallas kernel in
interpret mode, on the port's side the kernel's plain version (CPU
tensors); blocks of 8 over T = 16 make the online softmax cross tiles.

Tolerances. fp32: the two frameworks sum the matmuls and reductions in
other orders, a few fp32 ulps per layer; logits and every cache leaf agree
element by element to rtol 1e-5 plus an absolute 2e-6 of the leaf's
largest magnitude, decode included. The absolute part is the floor of an
fp32 dot product: the LM head alone puts 1.3e-6 of error on logits of
magnitude 4 in either package (each against a float64 product of its own
hidden state), and the two packages' hidden states already differ by about
3 ulps (2.8e-6 at magnitude 3.2), so a small logit cannot hold 1e-5 of
itself. bf16: each matmul and norm rounds to bf16 on both sides from fp32
sums an ulp apart, so an element can land one bf16 step away; logits agree
to 2^-6 of the largest logit, the bound the port's bf16 model tests use
(``tests/test_torch_model.py``: 2^-5, measured 2^-6.2 with the backward;
the forward alone stays inside 2^-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MLAConfig as JaxMLAConfig
from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.layers import ParamSpec as JaxParamSpec
from repro.models.model import build_cache_specs as jax_build_cache_specs
from repro.models.model import build_param_specs as jax_build_param_specs
from repro.train.step import eval_step as jax_eval_step
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs import MLAConfig, get_config
from repro_torch.core.types import tree_paths
from repro_torch.interop import to_numpy, to_tensor, tree_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.serve import place_cache, serve
from repro_torch.models.layers import ParamSpec
from repro_torch.models.model import (
    build_cache_specs,
    build_param_specs,
    forward,
    init_cache,
    init_params,
)
from repro_torch.train.step import eval_step, make_prefill_step, make_serve_step

RTOL, ATOL_FRAC = 1e-5, 2e-6
BF16_FRAC = 2.0 ** -6
B, T, S_MAX, DECODE_STEPS = 2, 16, 24, 4
GQA = dict(n_heads=8, n_kv_heads=2, head_dim=16)
# minicpm3-4b's MLA head dims (q/k nope 64 + rope 32, v 64) on reduced
# ranks; each package gets its own MLAConfig
MINICPM3_MLA = dict(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=64,
                    qk_rope_head_dim=32, v_head_dim=64)
MODELS = {"qwen3_gqa": ("qwen3-4b", GQA), "phi3_mha": ("phi3-mini-3.8b", {}),
          "gpt2_tied": ("gpt2-small", {}), "llama": ("llama-130m", {}),
          "phi3_hd96": ("phi3-mini-3.8b", dict(head_dim=96)),
          "minicpm3_hd96": ("minicpm3-4b", dict(mla=MINICPM3_MLA))}


def _configs(arch, overrides):
    jo, to = dict(overrides), dict(overrides)
    if "mla" in overrides:
        jo["mla"], to["mla"] = JaxMLAConfig(**overrides["mla"]), MLAConfig(**overrides["mla"])
    return jax_get_config(arch).reduced(**jo), get_config(arch).reduced(**to)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_place(full, prompt_cache):
    """The placement of ``examples/serve_batched.py``."""
    def place(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        return dst.at[tuple(slice(0, s) for s in src.shape)].set(src.astype(dst.dtype))
    return jax.tree_util.tree_map(place, full, prompt_cache)


def _prompts(cfg, batch, length, seed=1):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (batch, length), 0,
                                         cfg.vocab), np.int32)


def _assert_close(got, want, what):
    """fp32: rtol 1e-5 of each element plus 2e-6 of the largest."""
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(to_numpy(got), want, rtol=RTOL,
                               atol=ATOL_FRAC * float(np.abs(want).max()), err_msg=what)


def _assert_tree_close(got, want, what):
    got, want = dict(tree_paths(got)), dict(tree_paths(want))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        _assert_close(got[path], w, f"{what} {path}")


@pytest.fixture(scope="module")
def jax_runs():
    """Per (model, attention): the JAX prefill at T, the placed cache and
    DECODE_STEPS serve steps from it, computed once."""
    cache = {}

    def run(model, impl):
        if (model, impl) not in cache:
            arch, overrides = MODELS[model]
            jcfg, cfg = _configs(arch, dict(overrides, attn_impl=impl, attn_chunk_q=8,
                                            attn_chunk_k=8))
            jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
            toks = _prompts(jcfg, B, T)
            last, pc = jax.jit(jax_make_prefill_step(jcfg))(jparams, {"tokens": toks})
            placed = _jax_place(jax_init_cache(jcfg, B, S_MAX), pc)
            serve_fn = jax.jit(jax_make_serve_step(jcfg))
            jcache = placed
            tok = jnp.argmax(last[:, :jcfg.vocab], -1).astype(jnp.int32)[:, None]
            steps = []
            for i in range(DECODE_STEPS):
                tok_in = tok
                tok, logits, jcache = serve_fn(jparams, jcache, tok, jnp.int32(T + i))
                steps.append((np.asarray(tok_in), np.asarray(tok), np.asarray(logits)))
            cache[(model, impl)] = dict(
                cfg=cfg, params=_np_tree(jparams), toks=toks, last=np.asarray(last),
                prompt_cache=_np_tree(pc), placed=_np_tree(placed), steps=steps,
                final_cache=_np_tree(jcache))
        return cache[(model, impl)]

    return run


@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("model", list(MODELS))
def test_prefill_matches_jax(jax_runs, model, impl):
    """Last-token logits and every leaf of the prompt cache."""
    run = jax_runs(model, impl)
    cfg = run["cfg"]
    last, pc = make_prefill_step(cfg)(tree_from_numpy(run["params"]),
                                      {"tokens": torch.from_numpy(run["toks"].copy())})
    assert last.shape == (B, cfg.padded_vocab)
    _assert_close(last, run["last"], "last logits")
    _assert_tree_close(pc, run["prompt_cache"], "prompt cache")
    # stacked as build_cache_specs lays it out for S = T
    specs = dict(tree_paths(build_cache_specs(cfg, B, T)))
    assert {p: tuple(t.shape) for p, t in tree_paths(pc)} == {
        p: s.shape for p, s in specs.items()}


@pytest.mark.parametrize("model", list(MODELS))
def test_decode_steps_match_jax(jax_runs, model):
    """DECODE_STEPS serve steps from the same placed cache: the greedy
    tokens are equal, the logits and the cache agree."""
    run = jax_runs(model, "dense")
    cfg = run["cfg"]
    params = tree_from_numpy(run["params"])
    cache = tree_from_numpy(run["placed"])
    serve_fn = make_serve_step(cfg)
    tok = torch.from_numpy(run["steps"][0][0].copy())
    for i, (_, want_tok, want_logits) in enumerate(run["steps"]):
        tok, logits, cache = serve_fn(params, cache, tok, T + i)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        assert np.array_equal(tok.numpy(), want_tok), i
        assert logits.shape == (B, 1, cfg.padded_vocab)
        _assert_close(logits, want_logits, f"decode step {i}")
    _assert_tree_close(cache, run["final_cache"], "decode cache")


def test_decode_consumes_the_cache_in_place(jax_runs):
    """The cache passed to a decode step is updated in place and returned:
    the same tensors, written at ``pos`` and nowhere else."""
    run = jax_runs("qwen3_gqa", "dense")
    cfg = run["cfg"]
    cache = tree_from_numpy(run["placed"])
    before = {p: t.clone() for p, t in tree_paths(cache)}
    tok = torch.from_numpy(run["steps"][0][0].copy())
    _, _, out = make_serve_step(cfg)(tree_from_numpy(run["params"]), cache, tok, T)
    for (path, t), (_, o) in zip(tree_paths(cache), tree_paths(out), strict=True):
        assert o is t, path
        changed = (t != before[path]).flatten(3).any(-1)  # (n_units, B, S)
        assert changed[:, :, T].all() and not changed[:, :, :T].any(), path
        assert not changed[:, :, T + 1:].any(), path


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3-mini-3.8b", "yi-9b",
                                  "deepseek-v2-lite-16b", "minicpm3-4b", "olmoe-1b-7b",
                                  "xlstm-350m", "jamba-v0.1-52b"])
def test_serve_loop_gives_the_jax_examples_tokens(arch):
    """``launch/serve.serve`` (B=2, T=8, 8 tokens) from JAX's parameters and
    prompts gives the token sequence of ``examples/serve_batched.py``'s loop
    (jitted, the cache donated), reduced as that example reduces."""
    jcfg = jax_get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    batch, prompt_len, tokens = 2, 8, 8
    prompts = jax.random.randint(jax.random.PRNGKey(1), (batch, prompt_len), 0, jcfg.vocab)
    logits, pc = jax.jit(jax_make_prefill_step(jcfg))(jparams, {"tokens": prompts})
    cache = _jax_place(jax_init_cache(jcfg, batch, prompt_len + tokens), pc)
    decode = jax.jit(jax_make_serve_step(jcfg), donate_argnums=(1,))
    tok = jnp.argmax(logits[:, :jcfg.vocab], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(tokens - 1):
        tok, _, cache = decode(jparams, cache, tok, jnp.int32(prompt_len + i))
        out.append(tok)
    want = np.asarray(jnp.concatenate(out, axis=1))

    res = serve(arch, batch=batch, prompt_len=prompt_len, tokens=tokens, device="cpu",
                params=tree_from_numpy(_np_tree(jparams)),
                prompts=torch.from_numpy(np.asarray(prompts)))
    assert res["tokens"].dtype == torch.int32
    assert np.array_equal(res["tokens"].numpy(), want)
    assert len(res["decode_ms"]) == tokens - 1 and res["peak_bytes"] is None


def test_serve_draws_its_own_inputs_from_the_seed():
    """Without parameters and prompts, ``serve`` draws both from the seed:
    the same seed gives the same tokens, within the real vocabulary."""
    a = serve("qwen3-4b", batch=2, prompt_len=8, tokens=4, seed=3, device="cpu")
    b = serve("qwen3-4b", batch=2, prompt_len=8, tokens=4, seed=3, device="cpu")
    cfg = get_config("qwen3-4b").reduced()
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].shape == (2, 4)
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen3-4b", "yi-9b", "gpt2-small",
                                  "llama-130m", "minicpm3-4b", "xlstm-350m"])
def test_decode_matches_dense_forward(arch):
    """The port's form of the JAX package's test of the same name, with its
    tolerance: decoding token T from a prefill-built cache reproduces the
    dense forward's logits at position T."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_prompts(cfg, 2, 9, seed=7))
    dense_logits = forward(cfg, params, {"tokens": toks}, "train")[0]
    _, pc, _ = forward(cfg, params, {"tokens": toks[:, :8]}, "prefill")
    cache = place_cache(init_cache(cfg, 2, 16, device="cpu"), pc)
    dec_logits, _, _ = forward(cfg, params, {"tokens": toks[:, 8:9]}, "decode",
                               cache=cache, pos=8)
    np.testing.assert_allclose(to_numpy(dec_logits[:, 0]), to_numpy(dense_logits[:, 8]),
                               atol=2e-2, rtol=2e-2)


def test_bf16_reduced_qwen3_matches_jax():
    """bf16 parameters and caches: the prefill's last logits and four
    decode steps' logits within 2^-6 of the largest logit. Both sides decode
    the same tokens (JAX's greedy choices), so a near tie at bf16 precision
    cannot send them down different sequences."""
    jcfg, cfg = _configs("qwen3-4b", dict(GQA, dtype="bfloat16"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    toks = _prompts(jcfg, B, T)
    jlast, jpc = jax.jit(jax_make_prefill_step(jcfg))(jparams, {"tokens": toks})
    params = tree_from_numpy(_np_tree(jparams))
    last, pc = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)})
    assert last.dtype == torch.bfloat16

    def close(got, want, what):
        want = np.asarray(want).astype(np.float32)
        np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                                   atol=BF16_FRAC * float(np.abs(want).max()), err_msg=what)

    close(last, jlast, "prefill logits")
    jcache = _jax_place(jax_init_cache(jcfg, B, S_MAX), jpc)
    cache = place_cache(init_cache(cfg, B, S_MAX, device="cpu"), pc)
    assert all(t.dtype == torch.bfloat16 for _, t in tree_paths(cache))
    jserve, tserve = jax.jit(jax_make_serve_step(jcfg)), make_serve_step(cfg)
    tok = jnp.argmax(jlast[:, :jcfg.vocab], -1).astype(jnp.int32)[:, None]
    for i in range(DECODE_STEPS):
        _, logits, cache = tserve(params, cache, torch.from_numpy(np.asarray(tok)), T + i)
        tok, jlogits, jcache = jserve(jparams, jcache, tok, jnp.int32(T + i))
        close(logits, jlogits, f"decode step {i}")


def test_eval_step_matches_jax():
    jcfg, cfg = _configs("qwen3-4b", GQA)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    toks = _prompts(jcfg, B, T + 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = jax_eval_step(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = eval_step(cfg, tree_from_numpy(_np_tree(jparams)),
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)


def _spec_table(tree, cls):
    out = {}

    def walk(t, prefix):
        if isinstance(t, cls):
            out["/".join(prefix)] = (tuple(t.shape), tuple(t.axes), t.init, t.dtype)
        else:
            for k, v in t.items():
                walk(v, prefix + (k,))
    walk(tree, ())
    return out


@pytest.mark.parametrize("kind", ["params", "cache"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-9b", "phi3-mini-3.8b",
                                  "deepseek-v2-lite-16b", "olmoe-1b-7b", "minicpm3-4b",
                                  "xlstm-350m", "jamba-v0.1-52b"])
def test_full_size_specs_match_jax(arch, kind):
    """Built abstractly at full size (no tensor is allocated): the same tree
    paths, shapes, logical axes, inits and types as the JAX package's; the
    cache at qwen3-4b's serving shape, B = 8 and S_max = 1152."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if kind == "params":
        want, got = jax_build_param_specs(jcfg), build_param_specs(cfg)
    else:
        want, got = jax_build_cache_specs(jcfg, 8, 1152), build_cache_specs(cfg, 8, 1152)
    want, got = _spec_table(want, JaxParamSpec), _spec_table(got, ParamSpec)
    assert got == want
    if arch == "qwen3-4b" and kind == "cache":
        assert got["stack/layer_0/k"][0] == (36, 8, 1152, 8, 128)
    if arch == "qwen3-4b" and kind == "params":
        n = sum(int(np.prod(s[0])) for s in got.values())
        assert n == 4_412_079_616 and cfg.padded_vocab == 152064
    if arch == "deepseek-v2-lite-16b":
        if kind == "params":
            n = sum(int(np.prod(s[0])) for s in got.values())
            assert n == 15_706_484_224
            assert got["stack/layer_0/ffn/w_in"][0] == (26, 64, 2048, 2816)
        else:  # the latent cache: 576 values a token per layer
            assert got["prefix_0/ckv"][0] == (8, 1152, 512)
            assert got["stack/layer_0/k_rope"][0] == (26, 8, 1152, 64)
            n = sum(int(np.prod(s[0])) for s in got.values())
            assert n == 27 * 8 * 1152 * 576


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_from_numpy_carries_a_jax_cache(dtype):
    """A JAX cache tree, exported as numpy, loads with ``tree_from_numpy``
    onto the port's paths, shapes and types; no cache-specific interop is
    needed."""
    jcfg, cfg = _configs("qwen3-4b", dict(GQA, dtype=dtype))
    rng = np.random.default_rng(0)
    jcache = jax.tree_util.tree_map(
        lambda c: jnp.asarray(rng.standard_normal(c.shape), jnp.float32).astype(c.dtype),
        jax_init_cache(jcfg, B, S_MAX))
    got = tree_from_numpy(_np_tree(jcache))
    like = init_cache(cfg, B, S_MAX, device="cpu")
    assert [(p, t.shape, t.dtype) for p, t in tree_paths(got)] == [
        (p, t.shape, t.dtype) for p, t in tree_paths(like)]
    for (p, t), (_, w) in zip(tree_paths(got), tree_paths(_np_tree(jcache)), strict=True):
        assert np.array_equal(to_numpy(t), np.asarray(w, np.float32)), p


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_at_hd128_matches_pallas(dtype, causal):
    """The flash kernel's plain version at head dim 128 (the CPU side of the
    hd-128 kernel) against the Pallas kernel in interpret mode, GQA with
    G = 4 and blocks of 32 over S = 64."""
    rng = np.random.default_rng(128)
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal((1, 64, h, 128)),
                                      jnp.float32).astype(dtype)) for h in (4, 1, 1))
    want = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                         block_q=32, block_k=32, interpret=True)
    got = fa.flash_attention_fwd(to_tensor(q), to_tensor(k), to_tensor(v), causal=causal,
                                 block_q=32, block_k=32)
    assert str(got.dtype).split(".")[1] == dtype
    if dtype == "bfloat16":
        np.testing.assert_allclose(to_numpy(got), np.asarray(want).astype(np.float32),
                                   rtol=2.0 ** -7, atol=1e-7)
    else:
        _assert_close(got, want, "attention")


def test_flash_kernel_admits_hd128_in_bf16_only():
    """hd 128 is built for bf16 and, through its ring of spans, for fp32 too
    (the name predates the fp32 build). On CPU tensors the wrapper refuses
    to launch either way (the check comes first)."""
    assert (128, 128) in fa.HEAD_DIM_PAIRS[torch.bfloat16]
    assert (128, 128) in fa.HEAD_DIM_PAIRS[torch.float32]
    q = torch.zeros(1, 8, 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd_kernel(q, q, q)


def test_decode_refuses_a_missing_cache_or_a_position_past_it():
    cfg = get_config("qwen3-4b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    tok = {"tokens": torch.zeros(1, 1, dtype=torch.int64)}
    with pytest.raises(ValueError, match="cache"):
        forward(cfg, params, tok, "decode", pos=0)
    cache = init_cache(cfg, 1, 4, device="cpu")
    forward(cfg, params, tok, "decode", cache=cache, pos=3)
    with pytest.raises(ValueError, match="outside the cache"):
        forward(cfg, params, tok, "decode", cache=cache, pos=4)


def test_configs_copy_the_jax_packages():
    for arch in ("qwen3-4b", "phi3-mini-3.8b", "yi-9b", "deepseek-v2-lite-16b",
                 "olmoe-1b-7b", "minicpm3-4b", "xlstm-350m", "jamba-v0.1-52b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
