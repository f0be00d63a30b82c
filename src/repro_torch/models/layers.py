"""Transformer layer primitives of the port (mirror of
``repro.models.layers``): RMSNorm, RoPE, GQA and MLA attention (dense,
chunked, flash-kernel and KV-cache decode paths) and the SwiGLU FFN.

Shape conventions: activations (B, S, D); per-head tensors (B, S, H, hd); all
matmul weights stored ``(..., d_in, d_out)`` and applied as ``x @ W``. The
JAX package's ``logical(...)`` sharding annotations are identities here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig

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


def _mla_qkv(cfg, p, h, positions):
    """(q_nope, q_rope, ckv, k_rope): the per-head query split at the RoPE
    part, and the normalised latent with its one shared RoPE key."""
    B, S, _ = h.shape
    m = cfg.mla
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        q = rms_norm(h @ p["wq_a"], p["q_a_norm"], cfg.rms_eps) @ p["wq_b"]
    else:
        q = h @ p["wq"]
    q = q.reshape(B, S, cfg.n_heads, qk_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, k_rope = torch.split(h @ p["wkv_a"], [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = rms_norm(ckv, p["kv_a_norm"], cfg.rms_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def _mla_expand_kv(cfg, p, ckv, k_rope):
    """The latent (B, S, r) and RoPE key (B, S, rope) -> per-head k (B, S, H,
    nope + rope), contiguous, and v (B, S, H, v_head_dim), a strided view
    into the up-projection's output (the flash kernel reads it in place)."""
    B, S, _ = ckv.shape
    H = cfg.n_heads
    m = cfg.mla
    kv = (ckv @ p["wkv_b"]).reshape(B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope_b = k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def mla_apply(cfg: ModelConfig, p, x, positions, mode: str, cache=None, pos=None):
    """mode: train | prefill | decode. Returns (y, new_cache).

    prefill: causal self-attention over the prompt (q/k head dim nope +
    rope, v head dim ``v_head_dim``); new_cache holds the latent ``ckv``
    and ``k_rope`` in ``x.dtype``. decode: x is one token; ``ckv`` and
    ``k_rope`` are written into ``cache`` at ``pos`` in place and the whole
    cache is expanded to per-head k and v, as in the JAX package."""
    B, S, _ = x.shape
    m = cfg.mla
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    q_nope, q_rope, ckv, k_rope = _mla_qkv(cfg, p, h, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)

    new_cache = None
    if mode == "decode":
        ckv_c, kr_c = cache["ckv"], cache["k_rope"]
        if not 0 <= pos <= ckv_c.shape[1] - S:
            raise ValueError(f"decode position {pos} outside the cache's "
                             f"{ckv_c.shape[1]} positions")
        ckv_c[:, pos:pos + S] = ckv.to(ckv_c.dtype)
        kr_c[:, pos:pos + S] = k_rope.to(kr_c.dtype)
        k, v = _mla_expand_kv(cfg, p, ckv_c, kr_c)
        out = decode_attention(q, k, v, pos)
        new_cache = {"ckv": ckv_c, "k_rope": kr_c}
    else:
        k, v = _mla_expand_kv(cfg, p, ckv, k_rope)
        out = attention(q, k, v, causal=True, impl=cfg.attn_impl,
                        chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k)
        if mode == "prefill":
            new_cache = {"ckv": ckv.to(x.dtype), "k_rope": k_rope.to(x.dtype)}
    return out.reshape(B, S, cfg.n_heads * m.v_head_dim) @ p["wo"], new_cache


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
    gate, up = torch.chunk(h @ p["w_in"], 2, dim=-1)
    # silu as x * sigmoid(x) in the activation dtype, as jax.nn.silu
    y = gate * torch.sigmoid(gate) * up
    return y @ p["w_out"]
