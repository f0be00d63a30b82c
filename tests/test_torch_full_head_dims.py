"""Reduced models at their full configs' head dims in the port against the
JAX package, on the CPU in fp32 with attn_impl="pallas": the flash kernel's
plain version in the port, its Pallas kernel in interpret mode in the JAX
package, at every (hd, hdv) pair wider than 64 that the fp32 kernel builds.

Each config is its architecture's ``.reduced()`` (width 64, 2 to 4 layers,
vocabulary 512) with the full config's head dims put back: qwen3-4b at hd
128 (8 query heads on 2 kv heads), phi3-mini-3.8b at 96, paligemma-3b at
256 (4 heads on 1), minicpm3-4b's MLA at q/k 64 + 32 and v 64 and
deepseek-v2-lite-16b's at 128 + 64 and v 128 (``chip_smoke.py`` phase D
runs the same configs card against CPU). Each loads the JAX package's
``init_params`` through ``repro_torch.interop``, takes a batch of the data
stream both packages share, and holds the loss and every gradient.

Tolerance: fp32 on both sides with sums in other orders, element by element
to rtol 1e-5 plus 2e-6 of each tensor's largest magnitude
(``tests/test_torch_serve.py``'s bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_stream as jax_make_stream
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch.configs import get_config
from repro_torch.core.types import map_with_path, tree_paths
from repro_torch.data.pipeline import make_stream
from repro_torch.interop import to_numpy, tree_from_numpy
from repro_torch.models.model import loss_fn

RTOL, ATOL_FRAC = 1e-5, 2e-6
B, S = 2, 32
# the reduced heads' overrides of each architecture (qwen3-4b keeps GQA)
ARCHS = {"qwen3-4b": dict(n_heads=8, n_kv_heads=2), "phi3-mini-3.8b": {}, "paligemma-3b": {},
         "minicpm3-4b": {}, "deepseek-v2-lite-16b": {}}
PAIRS = {"qwen3-4b": (128, 128), "phi3-mini-3.8b": (96, 96), "paligemma-3b": (256, 256),
         "minicpm3-4b": (96, 64), "deepseek-v2-lite-16b": (192, 128)}


def full_head_dims(get, arch):
    """``arch`` reduced with attn_impl="pallas" and the full config's head
    dims (hd; MLA's nope, rope and v), through either package's
    ``get_config``."""
    full = get(arch)
    cfg = full.reduced(attn_impl="pallas", **ARCHS[arch])
    if full.mla is None:
        return dataclasses.replace(cfg, head_dim=full.head_dim)
    return dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, qk_nope_head_dim=full.mla.qk_nope_head_dim,
        qk_rope_head_dim=full.mla.qk_rope_head_dim, v_head_dim=full.mla.v_head_dim))


def _pair(cfg):
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) if m else (cfg.head_dim,) * 2


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = to_numpy(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_FRAC * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def test_configs_keep_the_full_head_dims_in_both_packages():
    """Both packages reduce alike, and each config's (hd, hdv) is a pair the
    fp32 kernel builds."""
    from repro_torch.kernels.flash_attention import HEAD_DIM_PAIRS
    for arch in ARCHS:
        cfg, jcfg = full_head_dims(get_config, arch), full_head_dims(jax_get_config, arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert _pair(cfg) == PAIRS[arch] and PAIRS[arch] in HEAD_DIM_PAIRS[torch.float32]
        assert cfg.attn_impl == "pallas" and cfg.dtype == "float32" and cfg.d_model == 64


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_jax(arch):
    cfg, jcfg = full_head_dims(get_config, arch), full_head_dims(jax_get_config, arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_batch = make_stream(cfg, S, B, seed=0).sample(0)
    jbatch = jax_make_stream(jcfg, S, B, seed=0).sample(0)
    assert sorted(np_batch) == sorted(jbatch)
    assert all(np.array_equal(np_batch[k], jbatch[k]) for k in np_batch)

    @jax.jit
    def run(p, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jax_loss_fn(jcfg, q, batch, remat="full"), has_aux=True)(p)
        return loss, grads

    want_loss, want_grads = run(jparams, {k: jnp.asarray(v) for k, v in np_batch.items()})
    want_grads = dict(tree_paths(jax.tree_util.tree_map(np.asarray, want_grads)))

    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    leaves = {p: t.detach().requires_grad_(True) for p, t in tree_paths(params)}
    loss, _ = loss_fn(cfg, map_with_path(lambda path, _t: leaves[path], params),
                      {k: torch.from_numpy(v) for k, v in np_batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    assert sorted(leaves) == sorted(want_grads)
    for path, g in zip(leaves, grads, strict=True):
        _close(g, want_grads[path], path)
