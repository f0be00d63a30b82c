"""The arithmetic of the bf16 tensor-core flash-attention kernel, on the CPU.

``csrc/flash_attention_fwd.cu`` runs P.V on the tensor cores, which take
bf16 operands. The TPU kernel (``repro/kernels/flash_attention.py``) does
P.V with P in fp32, and the port holds each bf16 output element of the
kernel at ``1e-6 * max|want| + 2^-7 * |want|`` against its plain version
(``chip_smoke.py`` phase B, ``tests/test_torch_gpu.py``): one bf16 step of
the element. This file models the kernel's arithmetic in plain torch (here
only, never in the package) and holds it to that limit:

- per key tile, scores scaled by log2(e)/sqrt(hd), masked to -1e30, a
  running max, p = exp2(s - m) in fp32 and l summed from that fp32 p;
- P split into three bf16 parts, hi = bf16(p), mid = bf16(p - hi),
  lo = bf16(p - hi - mid), each multiplied by the bf16 V with fp32 sums,
  the smallest first, into a fresh tile sum; the running sum
  acc = acc * corr + tile sum in fp32; out = acc / (l + 1e-30).

Two controls show why P is split so: P rounded once to bf16 misses the
limit by orders of magnitude, and two parts (16 bits of p) land several
times further from the exact result than three, which near-zero elements
of non-causal rows over ~1000 keys do not survive. Inputs are bf16, made
with numpy from a seed; the exact result is a float64 softmax attention.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import chunked_attention_ref

LOG2E = 1.4426950408889634
NEG = -1e30
RTOL_BF16 = 2.0 ** -7
TILE_K = 64  # keys per tile, the kernel's BK


def kernel_model(q, k, v, *, causal, parts=3):
    """The kernel's arithmetic: q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hdv)
    bf16 -> (B,S,H,hdv) bf16. ``parts`` bf16 pieces of P (1: P rounded
    once)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, S, hd); kv head h // G
    kf = k.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    scale_log2 = LOG2E / math.sqrt(hd)
    rows = torch.arange(S)
    m = torch.full((B, H, S), NEG)
    ell = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, v.shape[-1])
    for kv0 in range(0, S, TILE_K):
        keys = torch.arange(kv0, min(S, kv0 + TILE_K))
        kt, vt = kf[:, :, kv0:kv0 + TILE_K], vf[:, :, kv0:kv0 + TILE_K]
        s = (qf @ kt.transpose(-1, -2)) * scale_log2
        if causal:
            s = torch.where(keys[None, :] > rows[:, None], torch.tensor(NEG), s)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        ell = ell * corr + p.sum(-1)
        pieces, rest = [], p
        for _ in range(parts):
            piece = rest.bfloat16().float()
            pieces.append(piece)
            rest = rest - piece
        tile = torch.zeros_like(acc)
        for piece in reversed(pieces):  # smallest part first
            tile = tile + piece @ vt
        acc = acc * corr[..., None] + tile
        m = m_new
    out = acc / (ell[..., None] + 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


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
    """Worst ratio of |got - want| to 1e-6 * max|want| + 2^-7 * |want|."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    return float((diff / (1e-6 * mag.max() + RTOL_BF16 * mag)).max())


def _inputs(B, S, H, K, hd, seed, hdv=None):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, d)).astype(np.float32)).bfloat16()
            for h, d in ((H, hd), (K, hd), (K, hdv or hd))]


# (B, S, H, K, hd, causal): ragged S, on and just past the key tile's edge,
# causal and not, the narrow head dims with G = 4, and hd 128 (qwen3-4b's:
# two 64-column halves of each tile, P.V over 128 columns) with G = 4
CASES = [(1, 1000, 4, 1, 64, True), (1, 1000, 4, 1, 64, False),
         (1, 65, 4, 1, 64, True), (2, 129, 8, 2, 64, False),
         (2, 77, 8, 2, 16, True), (1, 130, 8, 2, 32, False),
         (1, 1000, 4, 1, 128, True), (1, 1000, 4, 1, 128, False),
         (2, 129, 8, 2, 128, True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}_S{}_H{}_K{}_hd{}_{}".format(
    *c[:5], "causal" if c[5] else "noncausal"))
def test_three_part_split_holds_the_bf16_limit(case):
    B, S, H, K, hd, causal = case
    q, k, v = _inputs(B, S, H, K, hd, seed=S * H + hd)
    got = kernel_model(q, k, v, causal=causal)
    want = chunked_attention_ref(q, k, v, causal=causal, chunk_q=512, chunk_k=512)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    assert worst_ratio(got, want) <= 1.0


# MLA's head dims (q/k 192, v 128: deepseek-v2-lite's, H = K): Q.K^T over
# three 64-column sub-tiles, P.V over v's 128 columns
MLA_CASES = [(1, 1000, 4, 4, True), (1, 1000, 4, 4, False), (2, 129, 4, 4, True),
             (1, 65, 2, 2, False)]


@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: "B{}_S{}_H{}_K{}_{}".format(
    *c[:4], "causal" if c[4] else "noncausal"))
def test_three_part_split_holds_the_bf16_limit_at_hd192_hdv128(case):
    B, S, H, K, causal = case
    q, k, v = _inputs(B, S, H, K, 192, seed=S * H + 192, hdv=128)
    got = kernel_model(q, k, v, causal=causal)
    want = chunked_attention_ref(q, k, v, causal=causal, chunk_q=512, chunk_k=512)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, 128)
    assert torch.isfinite(got.float()).all()
    assert worst_ratio(got, want) <= 1.0
    assert worst_ratio(got, exact_attention(q, k, v, causal=causal)) <= 1.0


# hd 96: phi3-mini's (96, 96), H = K, and minicpm3's MLA (q/k 96, v 64);
# Q.K^T over three 32-column sub-tiles, P.V over v's 96 or 64 columns
HD96_CASES = [(1, 1000, 4, 4, 96, True), (1, 1000, 4, 4, 96, False), (2, 129, 4, 2, 96, True),
              (1, 1000, 4, 4, 64, True), (1, 1000, 4, 4, 64, False), (1, 65, 2, 2, 64, False)]


@pytest.mark.parametrize("case", HD96_CASES, ids=lambda c: "B{}_S{}_H{}_K{}_hd96_{}_{}".format(
    *c[:5], "causal" if c[5] else "noncausal"))
def test_three_part_split_holds_the_bf16_limit_at_hd96(case):
    B, S, H, K, hdv, causal = case
    q, k, v = _inputs(B, S, H, K, 96, seed=S * H + 96 + hdv, hdv=hdv)
    got = kernel_model(q, k, v, causal=causal)
    want = chunked_attention_ref(q, k, v, causal=causal, chunk_q=512, chunk_k=512)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hdv)
    assert torch.isfinite(got.float()).all()
    assert worst_ratio(got, want) <= 1.0
    assert worst_ratio(got, exact_attention(q, k, v, causal=causal)) <= 1.0


def test_single_rounding_of_p_misses_the_limit():
    """Control: P rounded once to bf16 (FlashAttention's choice) misses the
    limit by two orders of magnitude at the main path's S."""
    q, k, v = _inputs(1, 1024, 2, 2, 64, seed=5)
    want = chunked_attention_ref(q, k, v, causal=True, chunk_q=512, chunk_k=512)
    once = kernel_model(q, k, v, causal=True, parts=1)
    assert worst_ratio(once, want) > 30.0
    assert worst_ratio(kernel_model(q, k, v, causal=True), want) <= 1.0


def test_two_parts_land_further_from_exact_than_three():
    """Control: with two parts (16 bits of p) the worst error against a
    float64 softmax is several times that of three parts, which stay at the
    fp32 plain version's own level."""
    q, k, v = _inputs(1, 1000, 4, 1, 64, seed=11)
    exact = exact_attention(q, k, v, causal=False)

    def err(fn):
        # the unrounded fp32 result: the same arithmetic on fp32 copies of
        # the bf16 inputs, so no output rounding hides the difference
        out = fn(q.float(), k.float(), v.float())
        return float((out.double() - exact).abs().max())

    plain = err(lambda a, b, c: chunked_attention_ref(a, b, c, causal=False))
    three = err(lambda a, b, c: kernel_model(a, b, c, causal=False))
    two = err(lambda a, b, c: kernel_model(a, b, c, causal=False, parts=2))
    assert three <= 2.0 * plain
    assert two >= 2.0 * three
