"""Plain PyTorch oracles of the port's kernels (mirror of ``repro.kernels.ref``).

Each function repeats its kernel's arithmetic in the same op order with
ordinary tensor ops. The wrappers in ``kernels/ops.py`` and
``kernels/flash_attention.py`` run these on CPU tensors; on the card they are
what the kernels are held against.
"""
from __future__ import annotations

import torch


def rmnp_momentum_rownorm_ref(g, v, *, beta: float, eps: float = 1e-8):
    """Fused RMNP preconditioning: momentum EMA + per-output-neuron l2 norm.

    g: (..., d_in, d_out) fp32; v may be fp32 or bf16 momentum storage.
    Math in fp32; returns (v_new in v.dtype, d fp32) with d = v_new / ||col||.
    """
    v_new = beta * v.float() + (1.0 - beta) * g.float()
    norm = torch.sqrt(torch.sum(torch.square(v_new), dim=-2, keepdim=True))
    return v_new.to(v.dtype), v_new / (norm + eps)


def rmnp_rownorm_apply_ref(g, v, w, scale, wd, *, beta: float,
                           eps: float = 1e-8):
    """Single-pass fused apply: momentum EMA + row normalize + weight update.

    g: (..., d_in, d_out) fp32; v: fp32 or bf16 momentum; w: weights (math
    in fp32, returned in w.dtype); ``scale`` folds lr * rms_lr_scale (float
    or 0-d fp32 tensor). The op order is the two-pass reference's
    (update = -scale*(d + wd*w), then w + update), so fp32 results are
    bit-identical to it.
    """
    w32 = w.float()
    v_new = beta * v.float() + (1.0 - beta) * g.float()
    norm = torch.sqrt(torch.sum(torch.square(v_new), dim=-2, keepdim=True))
    d = v_new / (norm + eps)
    w_new = w32 + (-scale) * (d + wd * w32)
    return v_new.to(v.dtype), w_new.to(w.dtype)


def matmul_ref(a, b):
    """fp32 product ``a @ b`` over the last two dims, batched over leading
    dims one slice at a time: a slice's product is the 2-D product of that
    slice, whatever the stack around it (a batched CPU GEMM may split a
    product across threads by how many slices it holds, and so round it
    differently)."""
    a, b = a.float(), b.float()
    if a.ndim == 2:
        return torch.mm(a, b)
    lead = a.shape[:-2]
    shape = (*lead, a.shape[-2], b.shape[-1])
    af = a.reshape(-1, *a.shape[-2:])
    bf = b.reshape(-1, *b.shape[-2:])
    if af.shape[0] == 0:
        return a.new_zeros(shape)
    return torch.stack([torch.mm(x, y) for x, y in zip(af, bf, strict=True)]).reshape(shape)


def ns_step_ref(x, a: float, b: float, c: float):
    """One quintic Newton-Schulz iteration on (..., m, n) fp32:
    ``a*X + (b*G + c*G@G) @ X`` with ``G = X X^T``."""
    g = matmul_ref(x, x.transpose(-1, -2))
    return a * x + matmul_ref(b * g + c * matmul_ref(g, g), x)


def dominance_ref(v, eps: float = 1e-12):
    """(r_avg, r_min, r_max) of the Gram V^T V for stored (d_in, d_out) V."""
    gram = v.T @ v
    m = gram.shape[-1]
    diag = torch.diagonal(gram)
    off = torch.sum(torch.abs(gram), dim=-1) - torch.abs(diag)
    r = diag / (off / max(1, m - 1) + eps)
    return torch.mean(r), torch.min(r), torch.max(r)


def chunked_attention_ref(q, k, v, *, causal: bool = True,
                          chunk_q: int = 512, chunk_k: int = 512):
    """Memory-efficient (online-softmax) attention oracle.

    q: (B,S,H,hd); k/v: (B,S,K,hd) GQA. Matches dense softmax attention;
    S^2 scores only ever exist as (chunk_q x chunk_k) tiles. Also the
    recompute path of the flash-attention kernel's backward.
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    hdv = v.shape[-1]
    cq = min(chunk_q, S)
    ck = min(chunk_k, S)
    if S % cq:
        cq = S
    if S % ck:
        ck = S
    nq, nk = S // cq, S // ck
    qr = q.reshape(B, nq, cq, K, G, hd)
    kr = k.reshape(B, nk, ck, K, hd)
    vr = v.reshape(B, nk, ck, K, hdv)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device

    outs = []
    for qi in range(nq):
        qb = qr[:, qi].float()
        acc = torch.zeros((B, K, G, cq, hdv), dtype=torch.float32, device=dev)
        m = torch.full((B, K, G, cq), -1e30, dtype=torch.float32, device=dev)
        ell = torch.zeros((B, K, G, cq), dtype=torch.float32, device=dev)
        hi = ((qi + 1) * cq + ck - 1) // ck if causal else nk
        for ki in range(hi):
            kb = kr[:, ki].float()
            vb = vr[:, ki].float()
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb) * scale
            if causal:
                qpos = qi * cq + torch.arange(cq, device=dev)
                kpos = ki * ck + torch.arange(ck, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            ell = ell * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vb)
            m = m_new
        out = acc / (ell[..., None] + 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B,cq,K,G,hdv)
    return torch.cat(outs, dim=1).reshape(B, S, H, hdv).to(q.dtype)
