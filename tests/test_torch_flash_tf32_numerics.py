"""The arithmetic of the fp32 flash-attention kernel on the tensor cores, on
the CPU.

``csrc/flash_attention_fwd_tf32.cu`` runs both products of fp32 attention,
S = Q.K^T and P.V, on the tensor cores, which read fp32 operands only as
TF32 (10 mantissa bits). The port holds each fp32 output element at
``1e-5 * |want| + 1e-6 * max|want|`` (``chip_smoke.py`` phase B,
``tests/test_torch_gpu.py``). This file models the kernel's arithmetic in
plain torch (here only, never in the package) and holds it to that limit
against a float64 softmax attention:

- every operand split into hi = tf32(x) and lo = tf32(x - hi), each rounded
  to nearest with ties away (the kernel's ``tf32_rna``), read by the tensor
  cores as their top 19 bits;
- per key tile of 64, S as three products lo.hi, hi.lo, hi.hi (the small
  ones first) over k-steps of 8, a fresh accumulator for each 32 of hd
  (hd 64: two; hd 256: eight), added in turn in fp32 (the kernel's ring
  brings K one span at a time in that order), each k-step's
  sum added as the emulation's
  pessimistic model of the tensor cores adds (``_tc_sum`` of
  ``tests/_torch_emulation.py``: every addend cut toward zero at
  the last fp32 bit of the largest, the sum cut toward zero);
- the scores scaled by log2(e)/sqrt(hd), masked to -1e30, a running max,
  p = exp2(s - m) in fp32, l summed from that unrounded p;
- P.V as the three products P_lo.V_hi, P_hi.V_lo, P_hi.V_hi over k-steps of
  8 keys into a fresh tile accumulator, and the running sum
  acc = acc * corr + tile in fp32; out = acc / (l + 1e-30). The kernel
  takes hdv in pieces of 32 columns, each its own accumulator: a cut along
  hdv changes no element's sum, so the model computes all of hdv at once.

Every (hd, hdv) the kernel builds is held here, v at its own width where
hdv != hd (MLA's). Two controls show why: one TF32 product for each of S and
P.V misses the limit by orders of magnitude, and S summed over all of hd in
one accumulator misses it on near-zero elements of non-causal rows (the
truncation of 24 k-steps at the size of the scores at hd 64; 96 at hd 256).
Inputs are fp32, made with numpy from a seed.
"""
import math

import numpy as np
import pytest
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


# (B, S, H, K, hd, causal[, hdv]): phase B's GQA shape with a ragged S at
# batch 1, gpt2-small's head shape (hd 64, G = 1) at S = 1024 with two of its
# heads, both causal and not, and the narrow head dims with G = 4; each wide
# build non-causal over a ragged S of 1000 keys (where near-zero elements
# show), one head (the model computes each head alone; G changes nothing
# here), qwen3-4b's hd 128 also causal, MLA's (96, 64) and (192, 128)
CASES = [(1, 1000, 8, 2, 64, True), (1, 1000, 8, 2, 64, False),
         (1, 1024, 2, 2, 64, True), (1, 1024, 2, 2, 64, False),
         (1, 1000, 4, 1, 32, False), (1, 1000, 4, 1, 16, True),
         (1, 1000, 1, 1, 128, False), (1, 1000, 1, 1, 128, True),
         (1, 1000, 1, 1, 96, False), (1, 1000, 1, 1, 96, False, 64),
         (1, 1000, 1, 1, 192, False, 128), (1, 1000, 1, 1, 256, False)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}_S{}_H{}_K{}_hd{}_{}{}".format(
    *c[:5], f"hdv{c[6]}_" if len(c) > 6 else "", "causal" if c[5] else "noncausal"))
def test_three_tf32_products_hold_the_fp32_limit(case):
    B, S, H, K, hd, causal, *rest = case
    q, k, v = _inputs(B, S, H, K, hd, seed=S * H + hd + causal, hdv=rest[0] if rest else None)
    got = kernel_model(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape[:3] + v.shape[3:]
    assert torch.isfinite(got).all()
    ratio = worst_ratio(got, exact_attention(q, k, v, causal=causal))
    print(f"model reading {case}: {ratio:.3f} of the limit")
    assert ratio <= 1.0


def test_one_tf32_product_misses_the_limit():
    """Control: S and P.V as one TF32 product each (operands rounded once,
    as ``allow_tf32`` would) miss the limit by more than 10x."""
    q, k, v = _inputs(1, 1000, 4, 1, 64, seed=5)
    want = exact_attention(q, k, v, causal=False)
    assert worst_ratio(kernel_model(q, k, v, causal=False, three=False), want) > 10.0
    assert worst_ratio(kernel_model(q, k, v, causal=False), want) <= 1.0


def test_one_accumulator_over_hd_64_misses_the_limit():
    """Control: S's three products over all 64 of hd in one accumulator (24
    k-steps, each cut at the size of the scores) miss the limit on a
    near-zero element of a non-causal row; an accumulator per 32 of hd holds
    it on the same input (a CASES entry)."""
    case = (1, 1024, 2, 2, 64, False)
    q, k, v = _inputs(*case[:5], seed=1024 * 2 + 64 + 0)
    want = exact_attention(q, k, v, causal=False)
    assert worst_ratio(kernel_model(q, k, v, causal=False, slab_hd=64), want) > 1.0
    assert worst_ratio(kernel_model(q, k, v, causal=False), want) <= 1.0


def test_one_accumulator_over_hd_256_misses_the_limit():
    """Control at paligemma's (256, 256): S over all 256 of hd in one
    accumulator (96 k-steps) misses the limit on the non-causal CASES entry
    that eight accumulators of 32, added in turn, hold."""
    case = (1, 1000, 1, 1, 256, False)
    q, k, v = _inputs(*case[:5], seed=1000 * 1 + 256 + 0)
    want = exact_attention(q, k, v, causal=False)
    assert worst_ratio(kernel_model(q, k, v, causal=False, slab_hd=256), want) > 1.0
    assert worst_ratio(kernel_model(q, k, v, causal=False), want) <= 1.0
