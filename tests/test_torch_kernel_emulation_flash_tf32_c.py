"""Emulated on the CPU: the fp32 flash-attention kernel
(``csrc/flash_attention_fwd_tf32.cu``), the third part of its cases and its
ring.

The emulation, its headers and models, and the build fixtures are in
``tests/_torch_emulation.py``, which says what they check and cannot check.
"""
import numpy as np
import pytest

from _torch_emulation import (
    _flash, _flash_inputs, _flash_limit, _flash_plain, flash_cases, flash_tf32,
    flash_tf32_lib)


@pytest.mark.parametrize("case", flash_cases("c"), ids=lambda c: "B{}_S{}_H{}_K{}_hd{}_{}{}".format(
    *c[:5], "" if c[5] == c[4] else f"hdv{c[5]}_", "causal" if c[6] else "noncausal"))
def test_emulated_flash_tf32_matches_plain(flash_tf32, case):
    """Against the plain version (torch, CPU) at the fp32 limit of phase B,
    1e-5 * |want| + 1e-6 * max|want| per element."""
    B, S, H, K, hd, hdv, causal = case
    q, k, v = _flash_inputs(B, S, H, K, hd, seed=S * H + hd, hdv=hdv)
    got = _flash(flash_tf32, q, k, v, causal)
    want = _flash_plain(q, k, v, causal)
    assert np.isfinite(got).all()
    ratio = _flash_limit(got, want)
    print(f"emulated {case}: {ratio:.3f} of the limit")
    assert ratio <= 1.0


def test_emulated_flash_tf32_wide_two_launches_and_a_contiguous_v_give_identical_bits(
        flash_tf32):
    """deepseek's (192, 128), v MLA's strided slice: two launches give the
    same bits, and so does v copied into a contiguous array of its own."""
    q, k, v = _flash_inputs(1, 65, 2, 1, 192, seed=11, hdv=128)
    first = _flash(flash_tf32, q, k, v, True)
    assert np.array_equal(first, _flash(flash_tf32, q, k, v, True))
    assert np.array_equal(first, _flash(flash_tf32, q, k, np.ascontiguousarray(v), True))


def test_emulated_flash_tf32_builds_cut_no_bit(flash_tf32):
    """Each output element takes the same operations in the same order in
    every build: hd 64 (two spans, two pieces, 128-row blocks of two
    consumer warpgroups) equals (256, 256) (eight of each, 64-row blocks of
    one) on q, k and v whose columns past 64 are zero (at hd 64's scale),
    in its first 64 columns, and the rest of its output is zero."""
    wide, S = 256, 130
    q, k, v = _flash_inputs(1, S, 2, 1, 64, seed=13)
    want = _flash(flash_tf32, q, k, v, True)
    pad = [np.zeros(x.shape[:3] + (wide,), np.float32) for x in (q, k, v)]
    for z, x in zip(pad, (q, k, v), strict=True):
        z[..., :64] = x
    out = np.full((1, S, 2, wide), np.nan, np.float32)
    err = flash_tf32(*(x.ctypes.data for x in pad), out.ctypes.data, 1, S, 2, 1, wide, wide,
                     wide, wide, S * wide, 1, 1 / 8, None)
    assert err == 0
    assert np.array_equal(out[..., :64], want)
    assert not out[..., 64:].any()


def test_emulated_flash_tf32_ring_waits_for_a_late_consumer(flash_tf32_lib):
    """The second consumer warpgroup held back 50 ms at the start of each
    block, S = 257 causal, at (192, 128), whose ring has 2 slots: in the
    block of query rows 128..255 the first consumer visits key tiles 0..2
    and skips tile 3, whose slots it must release only once they are
    filled; a release made early completes a phase the second consumer has
    not read. The held launch must give the free launch's bits and hold the
    limit."""
    q, k, v = _flash_inputs(1, 257, 1, 1, 192, seed=192, hdv=128)
    free = _flash(flash_tf32_lib.fa_fwd_tf32, q, k, v, True)
    flash_tf32_lib.emulate_hold_second_consumer(50_000)
    try:
        held = _flash(flash_tf32_lib.fa_fwd_tf32, q, k, v, True)
    finally:
        flash_tf32_lib.emulate_hold_second_consumer(0)
    assert _flash_limit(held, _flash_plain(q, k, v, True)) <= 1.0
    assert np.array_equal(held, free)
