"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's.

Reduced olmoe-1b-7b (no shared expert) and deepseek-v2-lite-16b (one shared
expert) in fp32, with both dispatch strategies, at the config's capacity
factor (1.25) and at 0.5, where experts overflow and pairs are dropped.
Inputs and parameters are drawn with numpy from a seed and handed to both.

Tolerances. The routing integers (``expert_ids``, ``dest``, ``keep``) are
equal: the router's fp32 probabilities of these draws have no ties. y, aux
and every gradient agree to 1e-5 relative to the largest magnitude of
their tensor: XLA and PyTorch sum the matmuls and reductions in other
orders, and the port adds a token's K = 2 slots in k order where JAX
scatter-adds them (equal sums for two terms).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.layers import rms_norm as jax_rms_norm
from repro_torch.configs import get_config
from repro_torch.interop import to_numpy
from repro_torch.models import moe
from repro_torch.models.layers import rms_norm

B, S = 2, 16
ARCHS = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]
DISPATCH = ["global", "per_row"]
CAPACITY = [1.25, 0.5]


def _configs(arch, dispatch, capacity_factor):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    m = dict(dispatch=dispatch, capacity_factor=capacity_factor)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **m)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **m)))


def _params(cfg, seed=0):
    """numpy parameters of moe_specs' shapes: norm scales near 1, the rest
    at 1/sqrt(fan-in) (the router at 4x, so the probabilities spread)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(moe.moe_specs(cfg).items()):
        if spec.init == "ones":
            out[name] = (1.0 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        else:
            scale = 4.0 if name == "router" else 1.0
            out[name] = (scale * rng.standard_normal(spec.shape)
                         / np.sqrt(spec.shape[-2])).astype(np.float32)
    return out


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return x, r


def _jax_routing(jcfg, p, x):
    """expert_ids, dest and keep as the JAX package's dispatch computes them
    (its own ``_route`` and the lines of ``_dispatch_global`` /
    ``_dispatch_per_row`` that place each pair), one row for global."""
    m = jcfg.moe
    h = jax_rms_norm(jnp.asarray(x), jnp.asarray(p["norm"]), jcfg.rms_eps)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if m.dispatch == "per_row":
        rows, C = h, jax_moe._capacity(S, m)
        _, ids, _ = jax_moe._route(jcfg, jp, h)
    else:
        rows, C = h.reshape(1, B * S, -1), jax_moe._capacity(B * S, m)
        _, ids, _ = jax_moe._route(jcfg, jp, h.reshape(B * S, -1))
        ids = ids[None]
    R, N = rows.shape[:2]
    flat = ids.reshape(R, N * m.top_k)
    oh = jax.nn.one_hot(flat, m.num_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - oh) * oh, axis=-1)
    keep = pos < C
    dest = jnp.where(keep, flat * C + pos, m.num_experts * C)
    return np.asarray(ids), np.asarray(dest), np.asarray(keep)


def _routing(cfg, p, x):
    """The port's expert_ids, dest and keep, as its dispatch computes them."""
    m = cfg.moe
    with torch.no_grad():
        h = rms_norm(x, p["norm"], cfg.rms_eps)
        rows = h if m.dispatch == "per_row" else h.reshape(1, B * S, -1)
        _, ids, _ = moe._route(cfg, p, rows)
        dest, keep, _, _ = moe._slots(ids, m.num_experts, moe._capacity(rows.shape[1], m))
    return ids, dest, keep


def _close(got, want, what, frac=1e-5):
    want = np.asarray(want, dtype=np.float32)
    got = to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, dispatch, capacity_factor):
    jcfg, cfg = _configs(arch, dispatch, capacity_factor)
    p = _params(cfg)
    x, r = _inputs(cfg)

    def jloss(jp, jx):
        y, aux = jax_moe.moe_apply(jcfg, jp, jx)
        return jnp.sum(y * jnp.asarray(r)) + aux, (y, aux)

    (_, (want_y, want_aux)), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))({k: jnp.asarray(v) for k, v in p.items()},
                                              jnp.asarray(x))

    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(cfg, tp, tx)
    loss = torch.sum(y * torch.from_numpy(r)) + aux
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    ids, dest, keep = _routing(cfg, tp, tx)

    want_ids, want_dest, want_keep = _jax_routing(jcfg, p, x)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if capacity_factor < 1:
        assert not keep.all(), "the small capacity should drop pairs"
    _close(y.detach(), want_y, "y")
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=1e-5)
    for name, g in zip(tp, grads, strict=False):
        _close(g, want_g[0][name], f"grad {name}")
    _close(grads[-1], want_g[1], "grad x")


def test_capacity_rounds_like_jax():
    m = get_config("deepseek-v2-lite-16b").moe
    jm = jax_get_config("deepseek-v2-lite-16b").moe
    for n in (1, 7, 8, 100, 1000, 8192, 8 * 1040):
        for cf in (0.5, 1.25, m.num_experts / m.top_k):
            a = moe._capacity(n, dataclasses.replace(m, capacity_factor=cf))
            b = jax_moe._capacity(n, dataclasses.replace(jm, capacity_factor=cf))
            assert a == b, (n, cf)
    assert moe._capacity(8192, m) == 960 and moe._capacity(8, m) == 8


def _plain_scatter(h, dest, E, C, K):
    """The JAX package's forward in plain autograd: each pair's token row
    added into its slot of an (E*C + 1)-row buffer, the last row cut."""
    Bh, Sh, d = h.shape
    token_idx = torch.arange(Sh * K) // K
    rows = torch.arange(Bh)[:, None]
    buf = torch.zeros(Bh, E * C + 1, d, dtype=h.dtype)
    buf = buf.index_put((rows.expand(Bh, Sh * K), dest), h[:, token_idx], accumulate=True)
    return buf[:, :E * C]


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_per_row_vjp_equals_autograd_through_the_plain_scatter(capacity_factor):
    """The hand-written backward of the per-row dispatch (each token's K
    slot cotangents gathered and added in k order) gives autograd's bits
    through the plain scatter, dropped pairs included."""
    _, cfg = _configs("olmoe-1b-7b", "per_row", capacity_factor)
    m = cfg.moe
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    logits = torch.from_numpy(rng.standard_normal((B, S, m.num_experts)).astype(np.float32))
    ids = torch.topk(torch.softmax(logits, -1), m.top_k, dim=-1).indices
    C = moe._capacity(S, m)
    dest, keep, tok_buf, _ = moe._slots(ids, m.num_experts, C)
    g = torch.from_numpy(rng.standard_normal((B, m.num_experts * C, cfg.d_model))
                         .astype(np.float32))

    h1 = h.clone().requires_grad_(True)
    got = moe._ScatterFromTokens.apply(h1, dest, tok_buf, m.top_k)
    (dh_got,) = torch.autograd.grad(got, h1, g)
    h2 = h.clone().requires_grad_(True)
    want = _plain_scatter(h2, dest, m.num_experts, C, m.top_k)
    (dh_want,) = torch.autograd.grad(want, h2, g)
    assert torch.equal(got, want)
    assert torch.equal(dh_got, dh_want)
    assert (capacity_factor < 1) == (not bool(keep.all()))


def test_moe_path_has_no_scatter_add():
    """Two runs on the card give the same bits only without atomics: the
    module moves rows by gathers alone."""
    import ast
    from pathlib import Path
    tree = ast.parse(Path(moe.__file__).read_text())
    called = {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)}
    assert "scatter_" in called  # the integer slot maps; the scan sees methods
    for op in ("index_add", "index_add_", "scatter_add", "scatter_add_", "index_put",
               "index_put_", "scatter_reduce", "put_"):
        assert op not in called, op
