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
import pytest

from _torch_tf32_model import (_inputs, case_id, exact_attention, hold_the_fp32_limit,
                               kernel_model, worst_ratio)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (B, S, H, K, hd, causal[, hdv]): phase B's GQA shape with a ragged S at
# batch 1, gpt2-small's head shape (hd 64, G = 1) at S = 1024 with two of its
# heads, both causal and not, and the narrow head dims with G = 4; each wide
# build non-causal over a ragged S of 1000 keys (where near-zero elements
# show), one head (the model computes each head alone; G changes nothing
# here), qwen3-4b's hd 128 also causal, MLA's (96, 64) and (192, 128). Three
# cases run from files of their own (``test_torch_flash_tf32_numerics_b.py``
# and ``_c.py``), so that the test workers share the model's time.
CASES = [(1, 1024, 2, 2, 64, True), (1, 1024, 2, 2, 64, False),
         (1, 1000, 4, 1, 32, False), (1, 1000, 4, 1, 16, True),
         (1, 1000, 1, 1, 128, True),
         (1, 1000, 1, 1, 96, False), (1, 1000, 1, 1, 96, False, 64),
         (1, 1000, 1, 1, 192, False, 128), (1, 1000, 1, 1, 256, False)]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_three_tf32_products_hold_the_fp32_limit(case):
    hold_the_fp32_limit(case)


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
