"""Transformer layer primitives of the port (mirror of
``repro.models.layers``): RMSNorm, RoPE, GQA and MLA attention (dense,
chunked, flash-kernel and KV-cache decode paths) and the SwiGLU FFN.

Shape conventions: activations (B, S, D); per-head tensors (B, S, H, hd); all
matmul weights stored ``(..., d_in, d_out)`` and applied as ``x @ W``.

The JAX package's ``logical(...)`` sharding annotations become the model
axis here (``distributed/tensor_parallel.py``): under an axis, GQA and MLA
attention compute their rank's q heads (or, where the group does not divide
the heads, all of them, as JAX replicates them), the dense FFN its rank's
``[gate_r; up_r]`` columns, the row-split ``wo`` and ``w_out`` products are
summed over the group, and decode attends over the rank's span of a
``kv_seq``-split cache (MLA: of its latent) and merges the spans by
log-sum-exp in rank order.
Without one, every layer is the single-rank code.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.distributed import tensor_parallel as tp

# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple           # logical axis names, len == len(shape)
    init: str = "fan_in"  # fan_in | normal | zeros | ones
    scale: float = 1.0
    dtype: Optional[str] = None  # None => model dtype (caches too)


def materialize(spec: ParamSpec, generator: torch.Generator, dtype: torch.dtype,
                device) -> torch.Tensor:
    """Draw one parameter from ``generator`` (which must live on ``device``).
    The numbers differ from ``jax.random``'s; tests that compare with the JAX
    package load its parameters instead (``repro_torch.interop``)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    noise = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
    if spec.init == "normal":
        std = spec.scale
    else:  # fan_in: last-2 dim is d_in
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / (fan_in ** 0.5)
    # scaled in place: the same fp32 products as ``std * noise`` without a
    # second fp32 copy of the leaf (deepseek-v2-lite's expert stack is 9.6 G
    # elements, 38.4 GB in fp32)
    return noise.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# Norms / RoPE, with the JAX package's hand-written VJPs: reductions in fp32,
# cotangents emitted in the activation dtype, so bf16 gradients round in the
# same places.
# ---------------------------------------------------------------------------

class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.float()
        inv = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, inv, scale)
        return ((xf * inv) * scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, inv, scale = ctx.saved_tensors
        sf = scale.float()
        gf, xf = g.float(), x.float()
        mean_gsx = torch.mean((gf * sf) * xf, dim=-1, keepdim=True)
        c = (inv * inv * inv) * mean_gsx
        dx = (gf * (sf * inv) - xf * c).to(x.dtype)
        dscale = torch.sum(gf * xf * inv, dim=tuple(range(g.ndim - 1))).to(scale.dtype)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _RmsNorm.apply(x, scale, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rope_rotate(x, positions, theta: float, sign: float):
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs           # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = sign * torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, positions, theta):
        ctx.save_for_backward(positions)
        ctx.theta = theta
        return _rope_rotate(x, positions, theta, 1.0)

    @staticmethod
    def backward(ctx, g):
        (positions,) = ctx.saved_tensors
        # RoPE is a rotation: its VJP is the inverse rotation, in g's dtype
        return _rope_rotate(g, positions, ctx.theta, -1.0), None, None


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    return _Rope.apply(x, positions, theta)


# ---------------------------------------------------------------------------
# Attention math
# ---------------------------------------------------------------------------

_FLASH_THRESHOLD = 8192  # "auto" uses chunked attention from this S on
_Q_CHUNK = 2048
_KV_CHUNK = 2048


def _dense_attention(q, k, v, causal: bool, q_offset: int = 0):
    """q: (B,Sq,H,hd); k/v: (B,Skv,K,hd), H % K == 0. Returns (B,Sq,H,hdv).
    Products are taken in fp32 (the JAX package's preferred_element_type)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) / (hd ** 0.5)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _chunked_attention(q, k, v, causal: bool, qc: int, kc: int):
    """Blockwise online-softmax attention at the tensor-op level: a loop
    over q blocks, each scanning only the kv blocks its causal mask reaches;
    probabilities are cast to the value dtype before the PV product."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    hdv = v.shape[-1]
    qc, kc = min(qc, S), min(kc, S)
    if S % qc:
        qc = S
    if S % kc:
        kc = S
    nq, nk = S // qc, S // kc
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    qr = q.reshape(B, nq, qc, H, hd)
    kr = k.reshape(B, nk, kc, H, hd)
    vr = v.reshape(B, nk, kc, H, hdv)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device

    blocks = []
    for qi in range(nq):
        acc = torch.zeros((B, H, qc, hdv), dtype=torch.float32, device=dev)
        m = torch.full((B, H, qc), -1e30, dtype=torch.float32, device=dev)
        ell = torch.zeros((B, H, qc), dtype=torch.float32, device=dev)
        hi = ((qi + 1) * qc + kc - 1) // kc if causal else nk
        qb = qr[:, qi].float()
        for ki in range(hi):
            kb, vb = kr[:, ki], vr[:, ki]
            s = torch.einsum("bqhd,bshd->bhqs", qb, kb.float()) * scale
            if causal:
                qpos = qi * qc + torch.arange(qc, device=dev)
                kpos = ki * kc + torch.arange(kc, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            ell = ell * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / (ell[..., None] + 1e-30)
        blocks.append(out.permute(0, 2, 1, 3))  # (B,qc,H,hdv)
    return torch.cat(blocks, dim=1).to(q.dtype)


def attention(q, k, v, causal=True, q_offset=0, impl: str = "auto",
              chunk_q: int = _Q_CHUNK, chunk_k: int = _KV_CHUNK):
    """impl: auto | dense | chunked | pallas. "auto" = chunked from the S
    threshold on, dense below; "pallas" = the flash-attention kernel (the
    Hopper kernel on CUDA tensors, its plain version on CPU tensors)."""
    S = q.shape[1]
    if impl == "pallas":
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal, min(chunk_q, S), min(chunk_k, S))
    if impl == "chunked" or (impl == "auto" and S >= _FLASH_THRESHOLD
                             and S == k.shape[1]):
        if S == k.shape[1]:  # self-attention only
            return _chunked_attention(q, k, v, causal, chunk_q, chunk_k)
    return _dense_attention(q, k, v, causal, q_offset)


def decode_attention(q, k_cache, v_cache, pos: int):
    """q: (B,1,H,hd); caches (B,S,K,hd); attend to positions <= pos. Scores
    in fp32, masked to -1e30 past ``pos``, probabilities cast to the cache's
    type before the P.V product (fp32 sums), as the JAX package does."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    S = k_cache.shape[1]
    qf = q.reshape(B, K, G, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qf.float(), k_cache.float()) / (hd ** 0.5)
    mask = torch.arange(S, device=q.device) <= pos
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs.float(), v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def decode_attention_span(q, k_span, v_span, pos: int, first: int, axis):
    """Decode attention over a cache split by position over the model group:
    this rank holds positions ``[first, first + S_l)`` of every kv head.
    Each rank forms (max, sum, P.V) of its positions <= ``pos`` (scores in
    fp32, probabilities in the cache's type before the P.V product, as
    :func:`decode_attention`), the group's partials are gathered and merged
    by log-sum-exp in rank order. Returns (B, 1, H, hdv), on every rank."""
    B, _, H, hd = q.shape
    K = k_span.shape[2]
    G = H // K
    S = k_span.shape[1]
    qf = q.reshape(B, K, G, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qf.float(), k_span.float()) / (hd ** 0.5)
    mask = (torch.arange(S, device=q.device) + first) <= pos
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    m = torch.amax(scores, dim=-1)
    p = torch.exp(scores - m[..., None])
    ell = torch.sum(p, dim=-1)
    acc = torch.einsum("bkgs,bskh->bkgh", p.to(v_span.dtype).float(), v_span.float())
    hdv = v_span.shape[-1]
    part = torch.cat([m[..., None], ell[..., None], acc], dim=-1)  # (B,K,G,2+hdv)
    every = axis.comm.all_gather(part[None].contiguous())           # (M,B,K,G,2+hdv)
    m_all = torch.amax(every[..., 0], dim=0)
    ell_t = acc_t = None
    for r in range(every.shape[0]):
        c = torch.exp(every[r, ..., 0] - m_all)
        e_r = every[r, ..., 1] * c
        a_r = every[r, ..., 2:] * c[..., None]
        ell_t = e_r if ell_t is None else ell_t + e_r
        acc_t = a_r if acc_t is None else acc_t + a_r
    out = acc_t / ell_t[..., None]
    return out.reshape(B, 1, H, hdv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "wq": ParamSpec((d, H * hd), ("d_in", "heads")),
        "wk": ParamSpec((d, K * hd), ("d_in", "heads")),
        "wv": ParamSpec((d, K * hd), ("d_in", "heads")),
        "wo": ParamSpec((H * hd, d), ("heads", "d_in")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), (None,), "ones")
        specs["k_norm"] = ParamSpec((hd,), (None,), "ones")
    return specs


def gqa_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    K, hd = cfg.n_kv_heads, cfg.head_dim
    kv_seq = "long_seq" if batch == 1 else "kv_seq"
    return {
        "k": ParamSpec((batch, seq, K, hd), ("batch", kv_seq, "kv_heads", None), "zeros"),
        "v": ParamSpec((batch, seq, K, hd), ("batch", kv_seq, "kv_heads", None), "zeros"),
    }


def gqa_apply(cfg: ModelConfig, p, x, positions, mode: str, cache=None, pos=None):
    """mode: train | prefill | decode. Returns (y, new_cache).

    prefill: causal self-attention over the prompt; new_cache holds its k
    and v after qk-norm and RoPE, in ``x.dtype``. decode: x is one token
    (S = 1); k and v are written into ``cache`` at ``pos`` in place (the
    cache tensors are consumed and come back as new_cache), then the token
    attends to positions <= pos. train: new_cache is None."""
    axis = tp.current()
    if axis is not None:
        return _gqa_apply_axis(cfg, p, x, positions, mode, cache, pos, axis)
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, K, hd)
    v = (h @ p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        if not 0 <= pos <= kc.shape[1] - S:
            raise ValueError(f"decode position {pos} outside the cache's "
                             f"{kc.shape[1]} positions")
        kc[:, pos:pos + S] = k.to(kc.dtype)
        vc[:, pos:pos + S] = v.to(vc.dtype)
        out = decode_attention(q, kc, vc, pos)
        new_cache = {"k": kc, "v": vc}
    else:
        out = attention(q, k, v, causal=True, impl=cfg.attn_impl,
                        chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k)
        if mode == "prefill":
            new_cache = {"k": k.to(x.dtype), "v": v.to(x.dtype)}
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache


def _columns(h, h_mp, w, split: bool, part: bool, axis, full: bool):
    """``h @ w`` over a projection whose columns the rules may split: the
    rank's columns (``full=False``, split only) or all of them, gathered
    where split. ``part`` says each rank's gradient of the result is a part
    of the whole (the computation downstream is split over the group): the
    gather's backward then sums the group's gradients, else it takes the
    rank's span of its whole one. ``h_mp`` is ``h`` through
    ``copy_to_model`` wherever a split projection's gradient reaches it."""
    if split:
        y = h_mp @ w
        return tp.gather_from_model(y, axis, -1, "sum" if part else "slice") if full else y
    y = h @ w
    return tp.copy_to_model(y, axis) if part else y


def _rows_out(out, wo, split: bool, axis):
    """``out @ wo`` where the rules may split ``wo``'s rows over the group:
    each rank multiplies its rows by its span of ``out`` (all of ``out``
    where ``out`` holds the rank's own heads only) and the group sums."""
    if not split:
        return out @ wo
    c = wo.shape[0]
    if out.shape[-1] != c:   # every head on every rank: the rank's span
        out = out[..., axis.rank * c:(axis.rank + 1) * c]
    return tp.reduce_from_model(out @ wo, axis)


def _splits(axis, name: str, dim: int) -> bool:
    """Whether ``axis`` (None: no model axis) splits a dimension of ``dim``
    named ``name``."""
    return axis is not None and axis.splits(name, dim)


def _decode_span(axis, cache, S: int, pos: int):
    """(the rank's first position, split) of a decode step over ``cache``,
    a leaf of the rank's decode cache whose dim 1 holds its positions (a
    span of them where the rules split ``kv_seq``; all of them with no
    ``axis``)."""
    span = cache.shape[1]
    total = span if axis is None else axis.cache_len(span)
    if not 0 <= pos <= total - S:
        raise ValueError(f"decode position {pos} outside the cache's {total} positions")
    split = span != total
    return axis.rank * span if split else 0, split


def _kv_index(h0: int, h1: int, G: int):
    """The kv heads q heads ``[h0, h1)`` read: ``(k0, k1, index)`` with
    ``index`` None where they form equal groups of the kv heads
    ``[k0, k1)`` in order, else each q head's kv head."""
    k0, k1 = h0 // G, (h1 - 1) // G + 1
    want = [h // G - k0 for h in range(h0, h1)]
    n = k1 - k0
    g = (h1 - h0) // n if (h1 - h0) % n == 0 else 0
    if g and want == [j // g for j in range(h1 - h0)]:
        return k0, k1, None
    return k0, k1, want


def _gqa_apply_axis(cfg, p, x, positions, mode, cache, pos, axis):
    """:func:`gqa_apply` on the model axis. Storage follows the rules
    (``wq``/``wk``/``wv`` columns and ``wo`` rows over ``heads`` where the
    group divides ``H hd`` or ``K hd``); the computation takes the rank's q
    heads where the group divides ``H`` (the kv heads they read gathered
    where a rank's ``wk`` columns are not exactly those heads), else every
    head on every rank, and sums the row-split ``wo`` products over the
    group. Decode computes every head on every rank and attends over the
    rank's span of a ``kv_seq``-split cache."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    M, r = axis.size, axis.rank
    q_split = axis.splits("heads", H * hd)      # wq columns and wo rows
    kv_split = axis.splits("heads", K * hd)     # wk and wv columns
    heads_split = q_split and axis.splits("heads", H) and mode != "decode"
    part = q_split and mode != "decode"         # wo's product is summed over the group
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    h_mp = tp.copy_to_model(h, axis) if part else h
    q_norm = k_norm = None
    if cfg.qk_norm:
        q_norm, k_norm = p["q_norm"], p["k_norm"]
        if part:
            q_norm, k_norm = tp.copy_to_model(q_norm, axis), tp.copy_to_model(k_norm, axis)

    def finish_kv(t, heads):
        t = t.reshape(B, S, heads, hd)
        if cfg.qk_norm:
            t = rms_norm(t, k_norm, cfg.rms_eps)
        return t

    k_all = v_all = None
    if heads_split:
        Hl = H // M
        q = (h_mp @ p["wq"]).reshape(B, S, Hl, hd)
        k0, k1, index = _kv_index(r * Hl, (r + 1) * Hl, G)
        aligned = kv_split and K % M == 0 and (k0, k1) == (r * K // M, (r + 1) * K // M)
        if aligned:
            k = finish_kv(h_mp @ p["wk"], k1 - k0)
            v = (h_mp @ p["wv"]).reshape(B, S, k1 - k0, hd)
        else:
            k_all = finish_kv(_columns(h, h_mp, p["wk"], kv_split, True, axis, True), K)
            v_all = _columns(h, h_mp, p["wv"], kv_split, True, axis, True).reshape(B, S, K, hd)
            k, v = k_all[:, :, k0:k1], v_all[:, :, k0:k1]
    else:
        q = _columns(h, h_mp, p["wq"], q_split, part, axis, True).reshape(B, S, H, hd)
        k = finish_kv(_columns(h, h_mp, p["wk"], kv_split, part, axis, True), K)
        v = _columns(h, h_mp, p["wv"], kv_split, part, axis, True).reshape(B, S, K, hd)
        index = None
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        span = kc.shape[1]
        first, seq_split = _decode_span(axis, kc, S, pos)
        if first <= pos < first + span:
            kc[:, pos - first:pos - first + S] = k.to(kc.dtype)
            vc[:, pos - first:pos - first + S] = v.to(vc.dtype)
        if seq_split and M > 1:
            out = decode_attention_span(q, kc, vc, pos, first, axis)
        else:
            out = decode_attention(q, kc, vc, pos)
        new_cache = {"k": kc, "v": vc}
    else:
        if index is not None:
            k, v = k[:, :, index], v[:, :, index]
        out = attention(q, k, v, causal=True, impl=cfg.attn_impl,
                        chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k)
        if mode == "prefill":
            if heads_split and k_all is None:   # the rank's kv heads: gather them all
                k_all = tp.gather_from_model(k.contiguous(), axis, 2, "slice")
                v_all = tp.gather_from_model(v.contiguous(), axis, 2, "slice")
            elif k_all is None:
                k_all, v_all = k, v
            else:
                k_all = apply_rope(k_all, positions, cfg.rope_theta)
            if axis.splits("kv_seq", S):
                n = S // M
                k_all, v_all = k_all[:, r * n:(r + 1) * n], v_all[:, r * n:(r + 1) * n]
            new_cache = {"k": k_all.to(x.dtype).contiguous(), "v": v_all.to(x.dtype).contiguous()}
    out = out.reshape(B, S, out.shape[2] * hd)
    return _rows_out(out, p["wo"], q_split, axis), new_cache


# ---------------------------------------------------------------------------
# MLA attention layer (DeepSeek-V2 style; the cache holds the compressed latent)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H = cfg.d_model, cfg.n_heads
    m: MLAConfig = cfg.mla
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    specs = {"norm": ParamSpec((d,), ("embed",), "ones")}
    if m.q_lora_rank:
        specs["wq_a"] = ParamSpec((d, m.q_lora_rank), ("d_in", "lora"))
        specs["q_a_norm"] = ParamSpec((m.q_lora_rank,), (None,), "ones")
        specs["wq_b"] = ParamSpec((m.q_lora_rank, H * qk_dim), ("lora", "heads"))
    else:
        specs["wq"] = ParamSpec((d, H * qk_dim), ("d_in", "heads"))
    specs["wkv_a"] = ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim), ("d_in", "lora"))
    specs["kv_a_norm"] = ParamSpec((m.kv_lora_rank,), (None,), "ones")
    specs["wkv_b"] = ParamSpec(
        (m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)), ("lora", "heads"))
    specs["wo"] = ParamSpec((H * m.v_head_dim, d), ("heads", "d_in"))
    return specs


def mla_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    m = cfg.mla
    kv_seq = "long_seq" if batch == 1 else "kv_seq"
    return {
        "ckv": ParamSpec((batch, seq, m.kv_lora_rank), ("batch", kv_seq, "lora"), "zeros"),
        "k_rope": ParamSpec((batch, seq, m.qk_rope_head_dim), ("batch", kv_seq, None), "zeros"),
    }


def _mla_q_in(cfg, p, h):
    """What the per-head query projection reads: the normalised low-rank
    query where the config has one (``q_lora_rank``), else ``h``; and that
    projection's weight."""
    if cfg.mla.q_lora_rank:
        return rms_norm(h @ p["wq_a"], p["q_a_norm"], cfg.rms_eps), p["wq_b"]
    return h, p["wq"]


def _mla_rope_q(cfg, q, positions):
    """Per-head queries (B, S, Hc, nope + rope) with RoPE on their rope part."""
    m = cfg.mla
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)], dim=-1)


def _mla_latent(cfg, p, h, positions):
    """(ckv, k_rope): the normalised latent (B, S, r) and its one shared
    RoPE key (B, S, rope)."""
    m = cfg.mla
    ckv, k_rope = torch.split(h @ p["wkv_a"], [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = rms_norm(ckv, p["kv_a_norm"], cfg.rms_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def _mla_kv(cfg, kv, k_rope):
    """The latent's up-projection ``kv`` (B, S, Hc (nope + v)) and the RoPE
    key (B, S, rope) -> per-head k (B, S, Hc, nope + rope), contiguous, and
    v (B, S, Hc, v_head_dim), a strided view into ``kv`` (the flash kernel
    reads it in place)."""
    B, S, _ = kv.shape
    m = cfg.mla
    kv = kv.reshape(B, S, -1, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope_b = k_rope[:, :, None, :].expand(B, S, kv.shape[2], m.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def mla_apply(cfg: ModelConfig, p, x, positions, mode: str, cache=None, pos=None):
    """mode: train | prefill | decode. Returns (y, new_cache).

    prefill: causal self-attention over the prompt (q/k head dim nope +
    rope, v head dim ``v_head_dim``); new_cache holds the latent ``ckv``
    and ``k_rope`` in ``x.dtype``. decode: x is one token; ``ckv`` and
    ``k_rope`` are written into ``cache`` at ``pos`` in place and the whole
    cache is expanded to per-head k and v, as in the JAX package.

    On the model axis (``tp.current()``; None splits nothing) storage
    follows the rules: the per-head projections' columns (``wq`` or
    ``wq_b``, ``wkv_b``) and ``wo``'s rows over ``heads`` where the group
    divides them; ``wq_a``, ``wkv_a``, their norms and the latent are
    replicated. Where the group divides H a rank's columns are exactly its
    heads: it expands the whole latent for them, attends over them and the
    group sums ``wo``'s row-split products. Otherwise each rank computes its
    columns, they are gathered, every head runs on every rank (as JAX
    replicates them) and the rank's rows of ``wo`` read its span of the
    output. Each replicated tensor that feeds split work (``h``, the
    normalised low-rank query, the latent, the RoPE key) enters through
    ``copy_to_model``, so its gradient is summed over the group and the
    replicated weights get whole ones. Decode computes every head on every
    rank over the rank's span of a ``kv_seq``-split latent cache: it
    expands only that span, with ``wkv_b``'s columns gathered whole, and
    the spans merge by log-sum-exp in rank order."""
    axis = tp.current()
    B, S, _ = x.shape
    H, m = cfg.n_heads, cfg.mla
    train = mode != "decode"
    q_split = _splits(axis, "heads", H * (m.qk_nope_head_dim + m.qk_rope_head_dim))
    kv_split = _splits(axis, "heads", H * (m.qk_nope_head_dim + m.v_head_dim))
    o_split = _splits(axis, "heads", H * m.v_head_dim)
    heads_split = train and _splits(axis, "heads", H)
    part = train and (heads_split or o_split)   # the computation downstream is split

    def mp(t, split):   # a replicated tensor entering split work
        return tp.copy_to_model(t, axis) if train and split else t

    h = rms_norm(x, p["norm"], cfg.rms_eps)
    q_in, wq = _mla_q_in(cfg, p, h)
    q = _columns(q_in, mp(q_in, q_split), wq, q_split, part, axis, not heads_split)
    q = _mla_rope_q(cfg, q.reshape(B, S, -1, m.qk_nope_head_dim + m.qk_rope_head_dim),
                    positions)
    ckv, k_rope = _mla_latent(cfg, p, h, positions)

    new_cache = None
    if mode == "decode":
        ckv_c, kr_c = cache["ckv"], cache["k_rope"]
        span = ckv_c.shape[1]
        first, seq_split = _decode_span(axis, ckv_c, S, pos)
        if first <= pos < first + span:
            ckv_c[:, pos - first:pos - first + S] = ckv.to(ckv_c.dtype)
            kr_c[:, pos - first:pos - first + S] = k_rope.to(kr_c.dtype)
        wkv_b = tp.gather_from_model(p["wkv_b"], axis, -1) if kv_split else p["wkv_b"]
        k, v = _mla_kv(cfg, ckv_c @ wkv_b, kr_c)
        if seq_split and axis.size > 1:
            out = decode_attention_span(q, k, v, pos, first, axis)
        else:
            out = decode_attention(q, k, v, pos)
        new_cache = {"ckv": ckv_c, "k_rope": kr_c}
    else:
        kv = _columns(ckv, mp(ckv, kv_split), p["wkv_b"], kv_split, part, axis,
                      not heads_split)
        k, v = _mla_kv(cfg, kv, mp(k_rope, part))
        out = attention(q, k, v, causal=True, impl=cfg.attn_impl,
                        chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k)
        if mode == "prefill":
            if _splits(axis, "kv_seq", S):
                n = S // axis.size
                ckv, k_rope = (t[:, axis.rank * n:(axis.rank + 1) * n] for t in (ckv, k_rope))
            new_cache = {"ckv": ckv.to(x.dtype).contiguous(),
                         "k_rope": k_rope.to(x.dtype).contiguous()}
    out = out.reshape(B, S, out.shape[2] * m.v_head_dim)
    return _rows_out(out, p["wo"], o_split, axis), new_cache


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

def ffn_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "w_in": ParamSpec((d, 2 * ff), ("d_in", "mlp")),   # fused [gate; up]
        "w_out": ParamSpec((ff, d), ("mlp", "d_in")),
    }


def ffn_apply(cfg: ModelConfig, p, x):
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    return swiglu(h, p["w_in"], p["w_out"], cfg.d_ff, _silu_mul, tp.current())


def _silu_mul(gate, up):
    # silu as x * sigmoid(x) in the activation dtype, as jax.nn.silu
    return gate * torch.sigmoid(gate) * up


def swiglu(h, w_in, w_out, ff: int, act, axis=None):
    """``act(gate, up) @ w_out`` with ``[gate; up] = h @ w_in``, for a fused
    ``w_in`` of ``2 ff`` columns and a ``w_out`` of ``ff`` rows named
    ``mlp`` (the dense FFN, the shared experts). On the model ``axis``,
    ``w_in`` split over ``mlp`` holds ``[gate_r; up_r]``
    (``distributed/sharding.shard_leaf``), so each rank forms its span of
    the hidden units and the row-split ``w_out`` products are summed over
    the group. Where the group divides ``2 ff`` but not ``ff``, the stored
    columns are a plain cut: they are gathered and the FFN runs whole on
    every rank beside a replicated ``w_out``."""
    if not _splits(axis, "mlp", 2 * ff):
        gate, up = torch.chunk(h @ w_in, 2, dim=-1)
        return act(gate, up) @ w_out
    out_split = axis.splits("mlp", ff)
    y = tp.copy_to_model(h, axis) @ w_in
    if not out_split:
        y = tp.gather_from_model(y, axis, -1, "slice")
    gate, up = torch.chunk(y, 2, dim=-1)
    y = act(gate, up)
    if not out_split:
        return y @ w_out
    return tp.reduce_from_model(y @ w_out, axis)
