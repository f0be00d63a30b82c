"""The port's dense model against the JAX package's: logits, loss and every
gradient, from the same parameters.

``torch.Generator`` cannot reproduce ``jax.random``, so the parameters come
from ``repro.models.init_params`` (exported as numpy, loaded with
``repro_torch.interop``) and the batch from the data pipeline, which both
packages keep identical. Reduced gpt2 and llama (and llama with two kv
heads, G = 2) run with ``attn_impl="auto"`` (dense attention at this S) and
``"pallas"``: on the JAX side the Pallas forward in interpret mode and the
recompute backward, on the port's side the flash-attention Function, whose
CPU forward is the kernel's plain version. Blocks of 8 over S = 32 make the
online softmax cross tile boundaries.

Tolerances. fp32: XLA and PyTorch sum the matmuls and reductions in other
orders; logits agree to 1e-5 of their largest magnitude and each gradient
leaf to 1e-5 of its largest entry (measured at most 2e-6 of it); the loss to
1e-6 relative. bf16 parameters and activations: each matmul and norm rounds
its output to bf16 on both sides, but the fp32 sums underneath differ by an
ulp, so an element can land one bf16 step (2^-8 relative) apart, and these
differences pass through two layers and the backward. The loss, an fp32 mean
over all tokens, still agrees to 1e-4 relative (measured 2e-5); logits and
gradients to 2^-5 of their largest magnitude (measured 2^-6.2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_stream as jax_make_stream
from repro.models import init_params as jax_init_params
from repro.models.model import forward as jax_forward
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch.configs import get_config
from repro_torch.core.types import map_with_path, tree_paths
from repro_torch.data.pipeline import make_stream
from repro_torch.interop import to_numpy, tree_from_numpy
from repro_torch.models.model import forward, init_params, loss_fn

SEQ, BATCH = 32, 2
MODELS = [("gpt2-small", {}), ("llama-60m", {}), ("llama-60m", {"n_kv_heads": 2})]
MODEL_IDS = ["gpt2", "llama", "llama_gqa"]


def _configs(arch, overrides):
    return (jax_get_config(arch).reduced(**overrides),
            get_config(arch).reduced(**overrides))


def _batch(cfg):
    return make_stream(cfg, SEQ, BATCH, seed=0).sample(0)


def _jax_value_and_grad(cfg, params, np_batch):
    @jax.jit
    def run(params, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jax_loss_fn(cfg, p, batch, remat="full"), has_aux=True)(params)
        return loss, jax_forward(cfg, params, batch, "train")[0], grads

    loss, logits, grads = run(params, {k: jnp.asarray(v) for k, v in np_batch.items()})
    return float(loss), np.asarray(logits), dict(tree_paths(jax.tree_util.tree_map(
        np.asarray, grads)))


def _torch_value_and_grad(cfg, params, np_batch, remat="full"):
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    leaves = {p: t.detach().requires_grad_(True) for p, t in tree_paths(params)}
    live = map_with_path(lambda path, _t: leaves[path], params)
    loss, _ = loss_fn(cfg, live, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        logits = forward(cfg, params, batch, "train")[0]
    return float(loss.detach()), logits, dict(zip(leaves, grads, strict=True))


def _close_to_max(got, want, frac, what):
    want = np.asarray(want).astype(np.float32)
    got = to_numpy(got)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(scale, 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("arch,overrides", MODELS, ids=MODEL_IDS)
def test_loss_logits_and_grads_match_jax(arch, overrides, impl):
    overrides = dict(overrides, attn_impl=impl, attn_chunk_q=8, attn_chunk_k=8)
    jcfg, cfg = _configs(arch, overrides)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_batch = _batch(cfg)
    assert all(np.array_equal(a, b) for a, b in zip(
        np_batch.values(), jax_make_stream(jcfg, SEQ, BATCH, seed=0).sample(0).values(),
        strict=True))
    want_loss, want_logits, want_grads = _jax_value_and_grad(jcfg, jparams, np_batch)
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    loss, logits, grads = _torch_value_and_grad(cfg, params, np_batch)

    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    _close_to_max(logits, want_logits, 1e-5, "logits")
    assert sorted(grads) == sorted(want_grads)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path
        _close_to_max(g, want_grads[path], 1e-5, path)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_bf16_model_matches_jax(impl):
    overrides = dict(dtype="bfloat16", attn_impl=impl, attn_chunk_q=8, attn_chunk_k=8)
    jcfg, cfg = _configs("gpt2-small", overrides)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_batch = _batch(cfg)
    want_loss, want_logits, want_grads = _jax_value_and_grad(jcfg, jparams, np_batch)
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    loss, logits, grads = _torch_value_and_grad(cfg, params, np_batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    assert logits.dtype == torch.bfloat16
    _close_to_max(logits, want_logits, 2.0 ** -5, "logits")
    for path, g in grads.items():
        assert g.dtype == torch.bfloat16, path
        _close_to_max(g, want_grads[path], 2.0 ** -5, path)


def test_remat_changes_no_number():
    cfg = get_config("llama-60m").reduced()
    params = init_params(cfg, seed=3, device="cpu")
    np_batch = _batch(cfg)
    full = _torch_value_and_grad(cfg, params, np_batch, remat="full")
    none = _torch_value_and_grad(cfg, params, np_batch, remat="none")
    assert full[0] == none[0]
    for path in full[2]:
        assert torch.equal(full[2][path], none[2][path]), path


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_forward_leaves_no_reference_cycle_on_the_parameters(mode):
    """Once a forward has returned and the caller drops the parameters,
    they are freed at once, with the garbage collector off: no reference
    cycle (such as a tree helper's recursive closure holding a lambda over
    per-unit views of the stacked parameters) keeps them alive. On the card
    such a cycle kept 6.8 GiB of a full-width model allocated after a
    serving phase."""
    import gc
    import weakref

    cfg = get_config("qwen3-4b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    refs = [weakref.ref(t) for _, t in tree_paths(params)]
    toks = torch.zeros(2, 8, dtype=torch.int64)
    gc.disable()
    try:
        with torch.no_grad():
            forward(cfg, params, {"tokens": toks}, mode)
        del params
        alive = [r for r in refs if r() is not None]
    finally:
        gc.enable()
    assert not alive, f"{len(alive)} of {len(refs)} parameters outlive the forward"
