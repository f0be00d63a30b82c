"""Emulated on the CPU: the bf16 flash-attention kernel
(``csrc/flash_attention_fwd.cu``), two launches and a contiguous v bit for
bit, and its ring with the second consumer held back
(``_flash_bf16_a.py`` holds it against its plain version).

The emulation, its headers and models, and the build fixtures are in
``tests/_torch_emulation.py``, which says what they check and cannot check.
"""
import numpy as np
import pytest

from _torch_emulation import (
    _f32, _flash_bf16, _flash_bf16_inputs, flash_bf16, flash_bf16_lib)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_emulated_flash_bf16_two_launches_and_a_contiguous_v_give_identical_bits(flash_bf16):
    """Two launches give the same bits, and so does MLA's v copied into a
    contiguous array of its own."""
    q, k, v = _flash_bf16_inputs(1, 129, 2, 2, 192, 128, seed=5)
    first = _flash_bf16(flash_bf16, q, k, v, True)
    assert np.array_equal(first, _flash_bf16(flash_bf16, q, k, v, True))
    assert np.array_equal(first, _flash_bf16(flash_bf16, q, k, np.ascontiguousarray(v), True))


def test_emulated_flash_bf16_hd256_two_launches_give_identical_bits(flash_bf16):
    """The (256, 256) build, paligemma's K = 1 and G = 8: two launches give
    the same bits."""
    q, k, v = _flash_bf16_inputs(1, 130, 8, 1, 256, 256, seed=7)
    assert np.array_equal(_flash_bf16(flash_bf16, q, k, v, True),
                          _flash_bf16(flash_bf16, q, k, v, True))


def test_emulated_flash_bf16_hd96_hdv64_two_launches_and_a_contiguous_v_give_identical_bits(
        flash_bf16):
    """minicpm3's (96, 64), v MLA's strided slice: two launches give the
    same bits, and so does v copied into a contiguous array of its own."""
    q, k, v = _flash_bf16_inputs(1, 130, 4, 2, 96, 64, seed=9)
    first = _flash_bf16(flash_bf16, q, k, v, True)
    assert np.array_equal(first, _flash_bf16(flash_bf16, q, k, v, True))
    assert np.array_equal(first, _flash_bf16(flash_bf16, q, k, np.ascontiguousarray(v), True))


@pytest.mark.parametrize("hd, hdv", [(64, 64), (192, 128), (256, 256), (96, 96), (96, 64)])
def test_emulated_flash_bf16_ring_waits_for_a_late_consumer(flash_bf16_lib, hd, hdv):
    """The second consumer warpgroup held back 50 ms at the start of each
    block, S = 257 causal. In the block of query rows 128..255 the first
    consumer visits key tiles 0..2 and skips tile 3, whose stage is tile 0's.
    Its release of that stage must wait for tile 3's load: released at once,
    its arrivals complete tile 0's phase of the ring before the second
    consumer has read tile 0, and the producer overwrites the stage under it.
    The held launch must give the free launch's bits and hold the limit."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_bf16_inputs(1, 257, 2, 1, hd, hdv, seed=hd)
    free = _flash_bf16(flash_bf16_lib.fa_fwd, q, k, v, True)
    flash_bf16_lib.emulate_hold_second_consumer(50_000)
    try:
        held = _flash_bf16(flash_bf16_lib.fa_fwd, q, k, v, True)
    finally:
        flash_bf16_lib.emulate_hold_second_consumer(0)
    tq, tk, tv = (torch.from_numpy(_f32(x).copy()).to(torch.bfloat16) for x in (q, k, v))
    want = fa.flash_attention_fwd_plain(tq, tk, tv, causal=True).float().numpy()
    got = _f32(held)
    lim = 1e-6 * np.abs(want).max() + 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= lim)
    assert np.array_equal(held, free)
