"""Emulated on the CPU: the GEMM kernel (``csrc/matmul.cu``).

The emulation, its headers and models, and the build fixtures are in
``tests/_torch_emulation.py``, which says what they check and cannot check.
"""
import numpy as np
import pytest

from repro_torch.kernels.matmul import K_CHUNK

from _torch_emulation import (
    COEFFS, E_ERR_FACTOR, GEMMS, _chain, _gemm, _model_sum, _operands, gemm_f32)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", GEMMS, ids=lambda c: "x".join(map(str, c[:4]))
                         + ("_bt" if c[4] else "") + ("_c" if c[5] else "")
                         + (f"_k{c[8]}" if c[8] != K_CHUNK else ""))
def test_emulated_kernel_within_the_fp32_sum_bound(gemm_f32, case):
    L, M, N, K, trans_b, with_c, alpha, beta, k_chunk = case
    a, b, c = _operands(case)
    # the wrapper's chunks, or the case's own
    got = _gemm(gemm_f32, a, b, c, alpha, beta, None if k_chunk == K_CHUNK else k_chunk)
    want = alpha * (a.astype(np.float64) @ b.astype(np.float64))
    mag = abs(alpha) * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64))
    chain = np.float32(alpha) * np.stack([_chain(a[i], b[i]) for i in range(L)])
    if with_c:
        want = want + beta * c
        mag = mag + abs(beta) * np.abs(c)
        chain = np.float32(beta) * c + chain
    # a split sum adds the chunks in order: ceil(K / k_chunk) more roundings
    splits = -(-K // k_chunk) if K > k_chunk else 1
    bound = (K + splits + 2) * 2.0 ** -24 * mag + 1e-30
    err, err_chain = np.abs(got - want), np.abs(chain - want)
    print(f"model reading {case[:4]}: {float(np.max(err / bound)):.3f} of the bound, "
          f"{float(err.max() / max(err_chain.max(), 1e-30)):.2f}x a plain fp32 chain")
    assert np.all(err <= bound)
    assert err.max() <= E_ERR_FACTOR * err_chain.max()


def test_emulated_newton_schulz_step_stack_equals_slices(gemm_f32):
    """The three launches of one step (Gram with B = X^T by strides,
    polynomial, apply) on a stack, against float64 and slice by slice."""
    a, b, c = COEFFS
    x = np.random.default_rng(7).standard_normal((3, 40, 136)).astype(np.float32)
    x /= np.linalg.norm(x, axis=(1, 2), keepdims=True)

    def step(x):
        g = _gemm(gemm_f32, x, np.swapaxes(x, 1, 2))
        p = _gemm(gemm_f32, g, g, g, alpha=c, beta=b)
        return _gemm(gemm_f32, p, x, x, alpha=1.0, beta=a)

    y = step(x)
    x64 = x.astype(np.float64)
    g64 = x64 @ np.swapaxes(x64, 1, 2)
    want = a * x64 + (b * g64 + c * (g64 @ g64)) @ x64
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-6
    for i in range(3):
        assert np.array_equal(y[i], step(x[i:i + 1].copy())[0]), i


def test_emulated_split_sum_is_in_chunk_order(gemm_f32):
    """A split tile adds its chunks' sums in chunk order, each chunk the sum
    of its 32-slabs in k order from the chunk's own start, each slab 3xTF32
    products in a fresh accumulator: the result equals that sum computed in
    numpy (``_model_sum``), bit for bit, for each slice of a stack."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((2, 3, 150)).astype(np.float32)
    b = rng.standard_normal((2, 150, 5)).astype(np.float32)
    got = _gemm(gemm_f32, a, b, k_chunk=72, split=True)  # chunks 72, 72, 6: slabs 32, 32, 8
    for i in range(2):
        assert np.array_equal(got[i], _model_sum(a[i], b[i], 72)), i


@pytest.mark.parametrize("k_chunk", [40, 256, K_CHUNK])
def test_emulated_launch_layouts_agree_bitwise(gemm_f32, k_chunk):
    """A block per (tile, chunk) through the workspace and a block per tile
    with the chunks' sum in shared memory give the same bits, with a
    transposed B and a C, over ragged tiles."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((2, 130, 600)).astype(np.float32)
    b = np.swapaxes(rng.standard_normal((2, 140, 600)).astype(np.float32), 1, 2)
    c = rng.standard_normal((2, 130, 140)).astype(np.float32)
    split = _gemm(gemm_f32, a, b, c, 2.0315, -4.7750, k_chunk, split=True)
    one_block = _gemm(gemm_f32, a, b, c, 2.0315, -4.7750, k_chunk, split=False)
    assert np.array_equal(split, one_block)


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A built library is named by the hash of its source and of the
    headers it includes, so an edited shared header rebuilds every library
    that includes it and no other."""
    from repro_torch.kernels import build
    assert [p.name for p in build.sources("matmul")] == ["matmul.cu", "sm90.cuh"]
    (tmp_path / "one.cu").write_text('#include <stdint.h>\n#include "shared.cuh"\nint one;\n')
    (tmp_path / "two.cu").write_text("int two;\n")
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("int inner;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.sources("one") == [tmp_path / n for n in ("one.cu", "shared.cuh", "inner.cuh")]
    before = build.library_path("one"), build.library_path("two")
    (tmp_path / "inner.cuh").write_text("int inner_edited;\n")
    assert build.library_path("one") != before[0]
    assert build.library_path("two") == before[1]
