"""Mixture-of-Experts FFN of the port (mirror of ``repro.models.moe``): top-k
routing, capacity-bounded dispatch into an ``(E, C, d)`` buffer (no ``(N, E,
C)`` one-hot), the load-balance and router-z auxiliary losses, and optional
shared experts (DeepSeek-V2 style).

Every move between token order and expert slots is a gather, in both
directions. A kept ``(token, k)`` pair owns exactly one slot and a slot at
most one pair, so the dispatch and its inverse are permutations padded with
a zero row; a token's K slots are summed by gathering them and adding
``k = 0 .. K-1`` in that fixed order (the combine, and the dispatch's
backward). No ``index_add_`` or scatter-add by atomics runs, so two runs on
the card give the same bits. The JAX package scatter-adds instead; for
K = 2 the two orders give equal sums, and for larger K they differ by the
rounding of the order (ROADMAP Queue 3). The expert products are
``torch.bmm`` / ``torch.einsum``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, rms_norm


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    m = cfg.moe
    specs = {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "router": ParamSpec((d, m.num_experts), ("d_in", None)),
        "w_in": ParamSpec((m.num_experts, d, 2 * m.d_ff_expert),
                          ("expert", "d_in", None)),
        "w_out": ParamSpec((m.num_experts, m.d_ff_expert, d),
                           ("expert", None, "d_in")),
    }
    if m.num_shared:
        ffs = m.d_ff_expert * m.num_shared
        specs["w_in_shared"] = ParamSpec((d, 2 * ffs), ("d_in", "mlp"))
        specs["w_out_shared"] = ParamSpec((ffs, d), ("mlp", "d_in"))
    return specs


def _capacity(n_tokens: int, m) -> int:
    c = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor of 8


def _silu(x):
    return x * torch.sigmoid(x)  # jax.nn.silu


def _route(cfg: ModelConfig, p, xf):
    """xf: (..., N, d) -> (gate_vals, expert_ids, aux). The router product
    is taken in the activation type, then cast to fp32."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    logits = (xf @ p["router"]).float()                         # (..., N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)        # (..., N, K)
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)
    # load balance (Switch): E * sum_e mean(route_frac_e) * mean(prob_e)
    onehot = torch.nn.functional.one_hot(expert_ids, E).float()
    route_frac = torch.mean(torch.sum(onehot, dim=-2),
                            dim=tuple(range(onehot.ndim - 2)))  # (E,)
    prob_mean = torch.mean(probs, dim=tuple(range(probs.ndim - 1)))
    aux = m.aux_coef * E * torch.sum(route_frac * prob_mean)
    aux = aux + m.router_z_coef * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    return gate_vals, expert_ids, aux


def _slots(expert_ids, E: int, C: int):
    """Slot bookkeeping of each row of ``expert_ids`` (B, S, K), pairs in
    token-major order. Returns ``dest`` (B, S*K): the pair's slot ``e*C +
    pos``, or ``E*C`` (the zero row) where its expert is full; ``keep``
    (B, S*K); ``tok_buf`` (B, E*C): the token of each slot, ``S`` (the
    zero row) where empty; ``pair_buf`` (B, E*C): the pair of each slot,
    ``S*K`` where empty. Integers only; no gradient."""
    B, S, K = expert_ids.shape
    flat_ids = expert_ids.reshape(B, S * K)
    # each pair's place among the earlier pairs of its expert: an exclusive
    # count along the pairs, taken over the last dim of an (E, S*K) one-hot
    # (a scan over the leading dim of (S*K, E), as JAX lays it out, takes
    # most of a full-width prefill on the card)
    oh = torch.nn.functional.one_hot(flat_ids, E).to(torch.int32).transpose(1, 2).contiguous()
    pos_in_expert = torch.cumsum(oh, dim=-1, dtype=torch.int32) - oh  # (B, E, S*K)
    pos = torch.gather(pos_in_expert, 1, flat_ids[:, None, :])[:, 0].long()  # (B, S*K)
    keep = pos < C
    dest = torch.where(keep, flat_ids * C + pos, torch.full_like(pos, E * C))
    pair = torch.arange(S * K, device=dest.device).expand(B, S * K)
    # the one extra column takes every dropped pair and is cut off
    pair_buf = torch.full((B, E * C + 1), S * K, dtype=torch.long, device=dest.device)
    pair_buf.scatter_(1, dest, pair)
    pair_buf = pair_buf[:, :E * C]
    tok_buf = torch.where(pair_buf < S * K, pair_buf // K, torch.full_like(pair_buf, S))
    return dest, keep, tok_buf, pair_buf


def _gather_rows(x, idx):
    """x (B, n, d), idx (B, m) in [0, n] -> (B, m, d); index n reads a zero row."""
    B, n, d = x.shape
    xp = torch.cat([x, x.new_zeros(B, 1, d)], dim=1)
    return xp[torch.arange(B, device=x.device)[:, None], idx]


def _sum_k(x, K: int):
    """(B, S*K, d) -> (B, S, d): each token's K rows added k = 0 .. K-1."""
    B, SK, d = x.shape
    x = x.reshape(B, SK // K, K, d)
    acc = x[:, :, 0]
    for k in range(1, K):
        acc = acc + x[:, :, k]
    return acc


class _ScatterFromTokens(torch.autograd.Function):
    """(B, S, d) tokens -> (B, E*C, d) expert slots. Forward gathers each
    slot's token (``tok_buf``); backward gathers each token's K slot
    cotangents (``dest``) and adds them in k order. The counterpart of the
    JAX package's ``_scatter_from_tokens`` and its hand-written VJP."""

    @staticmethod
    def forward(ctx, h, dest, tok_buf, K):
        ctx.save_for_backward(dest)
        ctx.K = K
        return _gather_rows(h, tok_buf)

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        return _sum_k(_gather_rows(g, dest), ctx.K), None, None, None


class _GatherSlots(torch.autograd.Function):
    """(B, E*C, d) slot outputs -> (B, S*K, d) in pair order (``dest``; a
    dropped pair reads zeros). Backward is the inverse gather (``pair_buf``):
    each slot takes its pair's cotangent, an empty slot zero."""

    @staticmethod
    def forward(ctx, out, dest, pair_buf):
        ctx.save_for_backward(pair_buf)
        return _gather_rows(out, dest)

    @staticmethod
    def backward(ctx, g):
        (pair_buf,) = ctx.saved_tensors
        return _gather_rows(g, pair_buf), None, None


def _combine(out_flat, dest, pair_buf, weights, K: int):
    """sum_k weights[t, k] * out_flat[dest[t, k]] in k order; out_flat (B,
    E*C, d), weights (B, S*K) fp32, cast to the output's type first."""
    gathered = _GatherSlots.apply(out_flat, dest, pair_buf)
    return _sum_k(gathered * weights[..., None].to(gathered.dtype), K)


def _dispatch(cfg, p, h, x_dtype, per_row: bool):
    """h: (B, S, d). One capacity buffer over all B*S tokens (``global``),
    or one per batch row (``per_row``). Returns ((B*S, d), aux)."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    B, S, d = h.shape
    rows = h if per_row else h.reshape(1, B * S, d)
    R, N = rows.shape[:2]
    C = _capacity(N, m)
    gate_vals, expert_ids, aux = _route(cfg, p, rows)          # (R, N, K)
    dest, keep, tok_buf, pair_buf = _slots(expert_ids, E, C)
    weights = gate_vals.reshape(R, N * K) * keep

    buf = _ScatterFromTokens.apply(rows, dest, tok_buf, K).reshape(R, E, C, d)
    if per_row:
        gu = torch.einsum("becd,edf->becf", buf, p["w_in"])
        gate_h, up = torch.chunk(gu, 2, dim=-1)
        act = (_silu(gate_h) * up).to(x_dtype)
        out = torch.einsum("becf,efd->becd", act, p["w_out"])
    else:
        gu = torch.bmm(buf[0], p["w_in"])
        gate_h, up = torch.chunk(gu, 2, dim=-1)
        act = (_silu(gate_h.float()) * up.float()).to(x_dtype)
        out = torch.bmm(act, p["w_out"])[None]
    y = _combine(out.reshape(R, E * C, d), dest, pair_buf, weights, K).to(x_dtype)
    return y.reshape(B * S, d), aux


def moe_apply(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    m = cfg.moe
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    if m.dispatch not in ("global", "per_row"):
        raise ValueError(f"unknown MoE dispatch {m.dispatch!r}")
    y, aux = _dispatch(cfg, p, h, x.dtype, m.dispatch == "per_row")
    if m.num_shared:
        xf = h.reshape(B * S, d)
        g_s, u_s = torch.chunk(xf @ p["w_in_shared"], 2, dim=-1)
        y = y + (_silu(g_s.float()) * u_s.float()).to(x.dtype) @ p["w_out_shared"]
    return y.reshape(B, S, d), aux
