"""Emulated on the CPU: the bf16 flash-attention kernel
(``csrc/flash_attention_fwd.cu``) against its plain version at every build
(``_flash_bf16_b.py`` holds its bit equalities and its ring).

The emulation, its headers and models, and the build fixtures are in
``tests/_torch_emulation.py``, which says what they check and cannot check.
"""
import numpy as np
import pytest

from _torch_emulation import (
    BF16_FLASH_CASES, _f32, _flash_bf16, _flash_bf16_inputs, flash_bf16, flash_bf16_lib)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", BF16_FLASH_CASES,
                         ids=lambda c: "S{1}_H{2}_K{3}_hd{4}_{5}_".format(*c)
                         + ("causal" if c[6] else "noncausal"))
def test_emulated_flash_bf16_matches_plain(flash_bf16, case):
    """Against the plain version (torch, CPU, bf16 in and out) at phase B's
    bf16 limit, 2^-7 * |want| + 1e-6 * max|want| per element."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    B, S, H, K, hd, hdv, causal = case
    q, k, v = _flash_bf16_inputs(B, S, H, K, hd, hdv, seed=S * H + hd)
    got = _f32(_flash_bf16(flash_bf16, q, k, v, causal))
    tq, tk, tv = (torch.from_numpy(_f32(x).copy()).to(torch.bfloat16) for x in (q, k, v))
    want = fa.flash_attention_fwd_plain(tq, tk, tv, causal=causal).float().numpy()
    assert np.isfinite(got).all()
    lim = 1e-6 * np.abs(want).max() + 2.0 ** -7 * np.abs(want)
    print(f"emulated bf16 {case}: {float(np.max(np.abs(got - want) / lim)):.3f} of the limit")
    assert np.all(np.abs(got - want) <= lim)
