"""The plain-torch model of the fp32 flash-attention kernel's arithmetic
(``csrc/flash_attention_fwd_tf32.cu``) that
``tests/test_torch_flash_tf32_numerics*.py`` hold to the fp32 limit; the
first of those files says what it models. Here only, never in the package.
"""
import math

import numpy as np
import torch

LOG2E = 1.4426950408889634
NEG = -1e30
RTOL = 1e-5
ATOL_FRAC = 1e-6
TILE_K = 64  # keys per tile, the kernel's BK
KSTEP = 8    # the depth of one tf32 wgmma
SLAB_HD = 32  # S's accumulators: one per 32 of hd (one 128-byte span)


def tf32_rna(x):
    """fp32 -> the nearest tf32 value (ties away from zero), as fp32."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def tf32_read(x):
    """The value the tensor cores read: the top 19 bits of an fp32 operand."""
    return (x.view(torch.int32) & -8192).view(torch.float32).double()


def tc_sum(acc, prods):
    """acc (fp32) plus exact products (float64, last dim): each addend cut
    toward zero at the last fp32 bit of the largest, summed exactly, the sum
    cut toward zero to fp32."""
    a = acc.double()
    mx = torch.maximum(a.abs(), prods.abs().amax(-1))
    e = torch.frexp(mx)[1]
    inv, q = torch.ldexp(torch.ones_like(mx), 24 - e), torch.ldexp(torch.ones_like(mx), e - 24)
    # each addend as a whole number of q (exact: q is a power of 2)
    s = (torch.trunc(a * inv) + torch.trunc(prods * inv[..., None]).sum(-1)) * q
    r = s.float()
    r = torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)
    return torch.where(mx == 0, torch.zeros_like(r), r)


def split(x):
    hi = tf32_rna(x)
    return tf32_read(hi), tf32_read(tf32_rna(x - hi))


def products(a, b, parts, slab):
    """a (..., M, D) @ b (..., D, N) as the kernel's tensor-core sum: for
    each slab of ``slab`` along D, the given (a part, b part) products in
    order over k-steps of 8 into a fresh fp32 accumulator; the slab sums
    added in order in fp32."""
    total = None
    for s0 in range(0, a[0].shape[-1], slab):
        acc = torch.zeros(a[0].shape[:-1] + (b[0].shape[-1],))
        for ia, ib in parts:
            for k0 in range(s0, min(a[0].shape[-1], s0 + slab), KSTEP):
                prods = a[ia][..., :, None, k0:k0 + KSTEP] * b[ib][
                    ..., k0:k0 + KSTEP, :].transpose(-1, -2)[..., None, :, :]
                acc = tc_sum(acc, prods)
        total = acc if total is None else total + acc
    return total


def kernel_model(q, k, v, *, causal, three=True, slab_hd=SLAB_HD):
    """The kernel's arithmetic: q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hdv)
    fp32 -> (B,S,H,hdv) fp32.
    ``three=False``: one TF32 product (hi.hi) for S and for P.V;
    ``slab_hd``: the hd summed in one of S's accumulators."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.permute(0, 2, 1, 3)  # (B, H, S, hd); kv head h // G
    kf = k.repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vf = v.repeat_interleave(G, 2).permute(0, 2, 1, 3)
    parts = ((1, 0), (0, 1), (0, 0)) if three else ((0, 0),)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    m = torch.full((B, H, S), NEG)
    ell = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, v.shape[-1])
    for kv0 in range(0, S, TILE_K):
        kv1 = min(S, kv0 + TILE_K)
        r0 = kv0 if causal else 0  # rows before kv0 see no key of the tile
        rows = torch.arange(r0, S)
        keys = torch.arange(kv0, kv1)
        s = products(split(qf[:, :, r0:]), split(kf[:, :, kv0:kv1].transpose(-1, -2)), parts,
                     slab_hd)
        x = s * scale_log2
        if causal:
            x = torch.where(keys[None, :] > rows[:, None], torch.tensor(NEG), x)
        m_old = m[..., r0:]
        m_new = torch.maximum(m_old, x.amax(-1))
        corr = torch.exp2(m_old - m_new)
        p = torch.exp2(x - m_new[..., None])
        ell[..., r0:] = ell[..., r0:] * corr + p.sum(-1)
        tile = products(split(p), split(vf[:, :, kv0:kv1]), parts, TILE_K)
        acc[..., r0:, :] = (acc[..., r0:, :].double() * corr[..., None].double()
                            + tile.double()).float()
        m[..., r0:] = m_new
    out = acc / (ell[..., None] + 1e-30)
    return out.permute(0, 2, 1, 3)


def exact_attention(q, k, v, *, causal):
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qd = q.double().permute(0, 2, 1, 3)
    kd = k.double().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vd = v.double().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    s = qd @ kd.transpose(-1, -2) / math.sqrt(hd)
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -math.inf)
    return (torch.softmax(s, -1) @ vd).permute(0, 2, 1, 3)


def worst_ratio(got, want):
    """Worst ratio of |got - want| to 1e-5 * |want| + 1e-6 * max|want|."""
    diff = (got.double() - want).abs()
    mag = want.abs()
    return float((diff / (ATOL_FRAC * mag.max() + RTOL * mag)).max())


def _inputs(B, S, H, K, hd, seed, hdv=None):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, d)).astype(np.float32))
            for h, d in ((H, hd), (K, hd), (K, hdv or hd))]


def case_id(c):
    """A CASES entry ``(B, S, H, K, hd, causal[, hdv])`` as a test id."""
    return "B{}_S{}_H{}_K{}_hd{}_{}{}".format(
        *c[:5], f"hdv{c[6]}_" if len(c) > 6 else "", "causal" if c[5] else "noncausal")


def hold_the_fp32_limit(case):
    """The three-product model on ``case``'s inputs (from a seed) within
    the limit of a float64 softmax attention."""
    B, S, H, K, hd, causal, *rest = case
    q, k, v = _inputs(B, S, H, K, hd, seed=S * H + hd + causal, hdv=rest[0] if rest else None)
    got = kernel_model(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape[:3] + v.shape[3:]
    assert torch.isfinite(got).all()
    ratio = worst_ratio(got, exact_attention(q, k, v, causal=causal))
    print(f"model reading {case}: {ratio:.3f} of the limit")
    assert ratio <= 1.0
