"""Sequence-mixing state-space blocks of the port (mirror of
``repro.models.ssm``): Mamba (S6), mLSTM and sLSTM (xLSTM).

Leaf names, shapes and the ``(d_in, d_out)`` storage are the JAX package's,
so tree paths and RMNP buckets match. The reference runs these mixers as
XLA ops, without a Pallas kernel, and so does the port, as torch ops:

  * Mamba's selective scan is chunked: a doubling (Hillis-Steele) scan
    inside chunks of 64 steps with the combine ``(a1*a2, a2*b1 + b2)`` of
    the reference's ``lax.associative_scan``, the state carried across
    chunks by a loop, each chunk under ``torch.utils.checkpoint`` so its
    (B, C, d_inner, d_state) expansion is never kept for the backward.
  * mLSTM is chunkwise parallel: intra-chunk masked attention with
    log-space decay ratios and an inter-chunk (hd x hd) state recurrence,
    each chunk checkpointed.
  * sLSTM is sequential: a Python loop over time.

Decode (S = 1) writes the new state into the cache tensors it is given, in
place, and returns them (a stacked cache's unit slices are views).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, rms_norm


def _silu(x):
    # x * sigmoid(x), as jax.nn.silu
    return x * torch.sigmoid(x)


def _softplus(x):
    # log(1 + e^x) as jax.nn.softplus computes it: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _checkpointed(fn, *args):
    """``fn(*args)``, recomputed in the backward when a gradient is taken
    (the reference's ``jax.checkpoint`` on a chunk body)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Mamba (S6)
# ---------------------------------------------------------------------------

_MAMBA_CHUNK = 64


def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, s.d_state, s.d_conv


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, dt_rank, d_state, d_conv = _mamba_dims(cfg)
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "in_proj": ParamSpec((d, 2 * d_inner), ("d_in", "d_inner")),
        "conv_w": ParamSpec((d_conv, d_inner), (None, "d_inner"), "normal", 0.1),
        "conv_bias": ParamSpec((d_inner,), ("d_inner",), "zeros"),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * d_state), ("d_inner", None)),
        "dt_w": ParamSpec((dt_rank, d_inner), ("lora", "d_inner")),
        "dt_bias": ParamSpec((d_inner,), ("d_inner",), "zeros"),
        "A_log": ParamSpec((d_inner, d_state), ("d_inner", "state"), "normal", 0.5),
        "D_skip": ParamSpec((d_inner,), ("d_inner",), "ones"),
        "out_proj": ParamSpec((d_inner, d), ("d_inner", "d_in")),
    }


def mamba_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    d_inner, _, d_state, d_conv = _mamba_dims(cfg)
    return {
        "h": ParamSpec((batch, d_inner, d_state), ("batch", "d_inner", "state"),
                       "zeros", dtype="float32"),
        "conv": ParamSpec((batch, d_conv - 1, d_inner), ("batch", None, "d_inner"), "zeros"),
    }


def _causal_conv(x, w, b, state=None):
    """x: (B,S,d_inner); w: (k,d_inner) depthwise. state: (B,k-1,d_inner).
    The taps are summed in order from 0, as the reference's ``sum``."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return y, new_state


def doubling_scan(a, b, dim: int = 1):
    """Inclusive scan of the affine maps h -> a*h + b along ``dim``: element
    t becomes the composition of maps 0..t, combined as the reference's
    ``(a1*a2, a2*b1 + b2)`` (earlier map first). Hillis-Steele: at level
    d = 1, 2, 4, ... each element t >= d takes in element t - d, so a
    chunk of C steps takes ceil(log2 C) levels."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_prev, b_prev = a.narrow(dim, 0, n - d), b.narrow(dim, 0, n - d)
        a_cur, b_cur = a.narrow(dim, d, n - d), b.narrow(dim, d, n - d)
        a = torch.cat([a.narrow(dim, 0, d), a_prev * a_cur], dim=dim)
        b = torch.cat([b.narrow(dim, 0, d), a_cur * b_prev + b_cur], dim=dim)
        d *= 2
    return a, b


def _mamba_proj(p, xc, dt_rank, d_state):
    """The input-dependent discretization: (dt (fp32), B, C) of ``xc``."""
    proj = xc @ p["x_proj"]
    dt, Bp, Cp = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = _softplus((dt @ p["dt_w"] + p["dt_bias"]).float())
    return dt, Bp, Cp


def _mamba_chunk(p, A, dt_rank, d_state, h, xck):
    """One chunk: (final state (B,di,ds), y (B,C,di)) from the state ``h``
    entering it and the chunk's conv+silu output ``xck`` (B,C,di)."""
    dt, Bp, Cp = _mamba_proj(p, xck, dt_rank, d_state)
    ac = torch.exp(dt[..., None] * A)                                  # (B,C,di,ds)
    bc = dt[..., None] * Bp[:, :, None, :].float() * xck[..., None].float()
    aa, bb = doubling_scan(ac, bc, dim=1)
    hs = aa * h[:, None] + bb                                          # (B,C,di,ds)
    y = torch.einsum("btds,bts->btd", hs, Cp.float())
    return hs[:, -1], y


def _mamba_scan_chunked(p, xc, dt_rank, d_state, h0):
    """Chunked selective scan. xc: (B,S,d_inner) conv+silu output. The
    (C, d_inner, d_state) expansion, projections and the scan live inside
    the checkpointed chunk body, so only (B,C,d_inner) chunks are kept for
    the backward, never the full (B,S,d_inner,d_state) tensor."""
    B, S, di = xc.shape
    C = min(_MAMBA_CHUNK, S)
    if S % C:
        C = S  # not a multiple (small shapes): a single chunk, as the reference
    A = -torch.exp(p["A_log"].float())                                 # (di,ds)
    h, ys = h0, []
    # chunks by split (its backward is one cat, not a zero-padded gradient
    # per chunk)
    for xck in torch.split(xc, C, dim=1):
        h, y = _checkpointed(
            lambda h_in, x_in: _mamba_chunk(p, A, dt_rank, d_state, h_in, x_in), h, xck)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_apply(cfg: ModelConfig, p, x, positions, mode: str, cache=None, pos=None):
    """mode: train | prefill | decode. Returns (y, new_cache). decode (S = 1)
    advances ``cache["h"]`` and ``cache["conv"]`` in place and returns them."""
    B, S, d = x.shape
    d_inner, dt_rank, d_state, d_conv = _mamba_dims(cfg)
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    xin, z = torch.chunk(h @ p["in_proj"], 2, dim=-1)

    conv_state = cache["conv"] if mode == "decode" else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_bias"], conv_state)
    xc = _silu(xc.float()).to(x.dtype)

    if mode == "decode":
        dt, Bp, Cp = _mamba_proj(p, xc, dt_rank, d_state)
        A = -torch.exp(p["A_log"].float())
        a = torch.exp(dt[..., None] * A)
        bterm = dt[..., None] * Bp[:, :, None, :].float() * xc[..., None].float()
        h_new = a[:, 0] * cache["h"] + bterm[:, 0]     # S == 1
        y = torch.einsum("bds,bs->bd", h_new, Cp[:, 0].float())[:, None]
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        h0 = torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device)
        y, hN = _mamba_scan_chunked(p, xc, dt_rank, d_state, h0)
        new_cache = {"h": hN, "conv": new_conv} if mode == "prefill" else None

    y = (y + p["D_skip"].float() * xc.float()).to(x.dtype)
    y = y * _silu(z.float()).to(x.dtype)
    return y @ p["out_proj"], new_cache


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block, chunkwise-parallel)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    d_inner = int(cfg.ssm.proj_factor * cfg.d_model)
    H = cfg.n_heads
    hd = d_inner // H
    return d_inner, H, hd


def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, H, hd = _mlstm_dims(cfg)
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "in_proj": ParamSpec((d, 2 * d_inner), ("d_in", "d_inner")),  # [x; gate z]
        "wq": ParamSpec((d_inner, d_inner), ("d_inner", None)),
        "wk": ParamSpec((d_inner, d_inner), ("d_inner", None)),
        "wv": ParamSpec((d_inner, d_inner), ("d_inner", None)),
        "w_igate": ParamSpec((d_inner, H), ("d_inner", None), "normal", 0.01),
        "igate_bias": ParamSpec((H,), (None,), "zeros"),
        "w_fgate": ParamSpec((d_inner, H), ("d_inner", None), "normal", 0.01),
        "fgate_bias": ParamSpec((H,), (None,), "ones"),
        "head_norm": ParamSpec((d_inner,), ("d_inner",), "ones"),
        "out_proj": ParamSpec((d_inner, d), ("d_inner", "d_in")),
    }


def mlstm_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    _, H, hd = _mlstm_dims(cfg)
    return {
        "C": ParamSpec((batch, H, hd, hd), ("batch", "heads", None, None),
                       "zeros", dtype="float32"),
        "n": ParamSpec((batch, H, hd), ("batch", "heads", None), "zeros", dtype="float32"),
    }


def _mlstm_chunk(scale, C_prev, n_prev, qc, kc, vc, lf, ig):
    """One chunk. C_prev (B,H,hd,hd), n_prev (B,H,hd); qc, kc, vc
    (B,Cn,H,hd); lf, ig (B,Cn,H). Returns (C_new, n_new, y (B,Cn,H,hd))."""
    Cn = qc.shape[1]
    g = torch.cumsum(lf, dim=1)     # log decay from chunk start, inclusive
    # inter-chunk: q_t decayed by g_t applied to the carried state
    q_dec = qc * torch.exp(g)[..., None] * scale
    y_inter = torch.einsum("bthd,bhde->bthe", q_dec, C_prev)
    den_inter = torch.einsum("bthd,bhd->bth", q_dec, n_prev)
    # intra-chunk: D_ts = exp(g_t - g_s) * i_s, causal
    decay = g[:, :, None, :] - g[:, None, :, :]                       # (B,t,s,H)
    tpos = torch.arange(Cn, device=qc.device)
    causal = tpos[:, None] >= tpos[None, :]
    w = torch.where(causal[None, :, :, None],
                    torch.exp(decay) * torch.exp(ig)[:, None, :, :],
                    torch.zeros((), dtype=decay.dtype, device=decay.device))
    scores = torch.einsum("bthd,bshd->btsh", qc, kc) * scale
    aw = scores * w
    y_intra = torch.einsum("btsh,bshd->bthd", aw, vc)
    # den = q_t . n_t = sum_s w_ts (q_t . k_s) * scale = sum_s aw_ts
    den_intra = aw.sum(dim=2)                                         # (B,t,H)
    # state update: decay to the chunk's end
    gC = g[:, -1]                                                     # (B,H)
    kv_w = torch.exp(gC[:, None] - g + ig)                            # (B,Cn,H)
    C_new = torch.exp(gC)[:, :, None, None] * C_prev + torch.einsum(
        "bthd,bthe,bth->bhde", kc, vc, kv_w)
    n_new = torch.exp(gC)[:, :, None] * n_prev + torch.einsum("bthd,bth->bhd", kc, kv_w)
    y = (y_inter + y_intra) / (torch.abs(den_inter + den_intra)[..., None] + 1.0)
    return C_new, n_new, y


def _mlstm_chunk_scan(q, k, v, log_f, i_gate, C0, n0, chunk: int):
    """q,k,v: (B,S,H,hd); log_f: (B,S,H) log sigmoid forget; i_gate: (B,S,H).
    Returns y (B,S,H,hd) and the final (C, n)."""
    B, S, H, hd = q.shape
    Cn = min(chunk, S)
    if S % Cn:
        Cn = S  # not a multiple (small shapes): a single chunk, as the reference
    scale = 1.0 / (hd ** 0.5)
    Cs, ns, ys = C0, n0, []
    for chunk_in in zip(*(torch.split(t, Cn, dim=1) for t in (q, k, v, log_f, i_gate)),
                        strict=True):
        Cs, ns, y = _checkpointed(lambda *a: _mlstm_chunk(scale, *a), Cs, ns, *chunk_in)
        ys.append(y)
    return torch.cat(ys, dim=1), Cs, ns


def mlstm_apply(cfg: ModelConfig, p, x, positions, mode: str, cache=None, pos=None):
    """mode: train | prefill | decode. Returns (y, new_cache). decode (S = 1)
    advances ``cache["C"]`` and ``cache["n"]`` in place and returns them."""
    B, S, d = x.shape
    d_inner, H, hd = _mlstm_dims(cfg)
    h = rms_norm(x, p["norm"], cfg.rms_eps)
    xin, z = torch.chunk(h @ p["in_proj"], 2, dim=-1)

    q = (xin @ p["wq"]).reshape(B, S, H, hd).float()
    k = (xin @ p["wk"]).reshape(B, S, H, hd).float()
    v = (xin @ p["wv"]).reshape(B, S, H, hd).float()
    log_f = F.logsigmoid((xin @ p["w_fgate"] + p["fgate_bias"]).float())   # (B,S,H)
    ig = F.logsigmoid((xin @ p["w_igate"] + p["igate_bias"]).float())

    if mode == "decode":
        f1 = torch.exp(log_f[:, 0])[..., None, None]
        C_new = f1 * cache["C"] + torch.exp(ig[:, 0])[..., None, None] * (
            k[:, 0][..., :, None] * v[:, 0][..., None, :])
        n_new = f1[..., 0] * cache["n"] + torch.exp(ig[:, 0])[..., None] * k[:, 0]
        qd = q[:, 0] / (hd ** 0.5)
        y = torch.einsum("bhd,bhde->bhe", qd, C_new)
        den = torch.einsum("bhd,bhd->bh", qd, n_new)
        y = (y / (torch.abs(den)[..., None] + 1.0))[:, None]
        cache["C"].copy_(C_new)
        cache["n"].copy_(n_new)
        new_cache = cache
    else:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        y, Cf, nf = _mlstm_chunk_scan(q, k, v, log_f, ig, C0, n0, cfg.ssm.chunk_size)
        new_cache = {"C": Cf, "n": nf} if mode == "prefill" else None

    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y, p["head_norm"], cfg.rms_eps)
    y = y * _silu(z.float()).to(x.dtype)
    return y @ p["out_proj"], new_cache


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, sequential recurrence with per-head recurrent weights)
# ---------------------------------------------------------------------------

def _slstm_dims(cfg: ModelConfig):
    H = cfg.n_heads
    hd = cfg.d_model // H
    return cfg.d_model, H, hd


def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, hd = _slstm_dims(cfg)
    ff = int(cfg.ssm.proj_factor * d)
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "w_gates": ParamSpec((d, 4 * d), ("d_in", "d_inner")),        # z,i,f,o
        "r_gates": ParamSpec((H, hd, 4 * hd), ("heads", None, None),
                             "normal", 0.05),                          # recurrent
        "gate_bias": ParamSpec((4 * d,), ("d_inner",), "zeros"),
        "head_norm": ParamSpec((d,), ("embed",), "ones"),
        "up_proj": ParamSpec((d, 2 * ff), ("d_in", "mlp")),
        "down_proj": ParamSpec((ff, d), ("mlp", "d_in")),
    }


def slstm_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    d, H, hd = _slstm_dims(cfg)
    return {
        "h": ParamSpec((batch, H, hd), ("batch", "heads", None), "zeros", dtype="float32"),
        "c": ParamSpec((batch, H, hd), ("batch", "heads", None), "zeros", dtype="float32"),
    }


def _slstm_step(r_gates, h, c, wx_t):
    """wx_t: (B, 4d) precomputed input contribution; h, c: (B,H,hd) fp32;
    r_gates (H,hd,4hd) fp32. Returns (h_new, c_new)."""
    B, H, hd = h.shape
    rec = torch.einsum("bhd,hde->bhe", h, r_gates)       # (B,H,4hd)
    gates = wx_t.reshape(B, H, 4 * hd) + rec
    z, i, f, o = torch.chunk(gates, 4, dim=-1)
    z = torch.tanh(z)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + 1.0)
    o = torch.sigmoid(o)
    c_new = f * c + i * z
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def slstm_apply(cfg: ModelConfig, p, x, positions, mode: str, cache=None, pos=None):
    """mode: train | prefill | decode. Returns (y, new_cache). decode (S = 1)
    advances ``cache["h"]`` and ``cache["c"]`` in place and returns them."""
    B, S, d = x.shape
    _, H, hd = _slstm_dims(cfg)
    hin = rms_norm(x, p["norm"], cfg.rms_eps)
    wx = (hin @ p["w_gates"] + p["gate_bias"]).float()               # (B,S,4d)
    # the recurrent product is taken in fp32, as JAX promotes bf16 x fp32
    r_gates = p["r_gates"].float()

    if mode == "decode":
        h_new, c_new = _slstm_step(r_gates, cache["h"], cache["c"], wx[:, 0])
        y = h_new[:, None]
        cache["h"].copy_(h_new)
        cache["c"].copy_(c_new)
        new_cache = cache
    else:
        h = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        c = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        ys = []
        # the steps' inputs by unbind: its backward stacks the S gradients
        # once, where indexing wx[:, t] would add a zero-padded (B, S, 4d)
        # gradient per step
        for wx_t in torch.unbind(wx, dim=1):
            h, c = _slstm_step(r_gates, h, c, wx_t)
            ys.append(h)
        y = torch.stack(ys, dim=1)                                     # (B,S,H,hd)
        new_cache = {"h": h, "c": c} if mode == "prefill" else None

    y = y.reshape(B, S, d).to(x.dtype)
    y = rms_norm(y, p["head_norm"], cfg.rms_eps)
    # post up/down projection (the xLSTM block's FFN)
    g, u = torch.chunk(y @ p["up_proj"], 2, dim=-1)
    y = (_silu(g.float()) * u.float()).to(x.dtype)
    return y @ p["down_proj"], new_cache
