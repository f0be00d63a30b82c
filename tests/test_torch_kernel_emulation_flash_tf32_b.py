"""Emulated on the CPU: the fp32 flash-attention kernel
(``csrc/flash_attention_fwd_tf32.cu``), the second part of its cases.

The emulation, its headers and models, and the build fixtures are in
``tests/_torch_emulation.py``, which says what they check and cannot check.
"""
import numpy as np
import pytest

from _torch_emulation import (
    _flash, _flash_inputs, _flash_limit, _flash_plain, flash_cases, flash_tf32,
    flash_tf32_lib)


@pytest.mark.parametrize("case", flash_cases("b"), ids=lambda c: "B{}_S{}_H{}_K{}_hd{}_{}{}".format(
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


def test_emulated_flash_tf32_two_launches_give_identical_bits(flash_tf32):
    q, k, v = _flash_inputs(1, 129, 4, 1, 64, seed=3)
    first = _flash(flash_tf32, q, k, v, True)
    assert np.array_equal(first, _flash(flash_tf32, q, k, v, True))
