"""The GEMM kernel's CUDA source (``csrc/matmul.cu``) run on the CPU under an
emulation of the few CUDA features it uses.

There is no ``nvcc`` and no card on a CPU machine, so the source is compiled
with the host C++ compiler against the small header below: each block runs
as ``THREADS`` std::threads that meet at a std::barrier for
``__syncthreads``, ``__shared__`` arrays are static (one block runs at a
time), ``__fmul_rn``/``__fadd_rn`` round each operation on its own, and a
launch ``kernel<<<grid, threads, smem, stream>>>(args)`` becomes a loop over
the grid. This checks the kernel's own index arithmetic, masks, strides,
double buffering and epilogue, and that a stacked launch gives each slice
the bits of a one-slice launch. It cannot check the card's compiler, its
timing or its memory model: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` do that on the card.

Tolerance: each result is held against a float64 product at the classic
bound of a K-term fp32 sum, (K + 2) * 2^-24 * (|alpha| |A| |B| + |beta| |C|)
per element (the two extra terms are the epilogue's roundings).
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.matmul import K_CHUNK

SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "matmul.cu"
COEFFS = (3.4445, -4.7750, 2.0315)

EMULATION_HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__ __restrict
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x, y, z;
              dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline uint3 blockIdx, gridDim;
struct float4 { float x, y, z, w; };
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline float __ldcg(const float* p) { return *p; }
template <class T> T min(T a, T b) { return b < a ? b : a; }
inline std::barrier<>* g_barrier = nullptr;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
template <class Kernel, class Args>
void emulate_launch(Kernel kernel, dim3 grid, int threads, Args args) {
  gridDim = {grid.x, grid.y, grid.z};
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        std::barrier<> barrier(threads);
        g_barrier = &barrier;
        std::vector<std::thread> block;
        for (int t = 0; t < threads; ++t)
          block.emplace_back([&, t] { threadIdx = {unsigned(t), 0, 0}; kernel(args); });
        for (auto& th : block) th.join();
      }
}
"""


@pytest.fixture(scope="module")
def gemm_f32(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emulation")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    src = re.sub(r"(\w+<\w+>)<<<([^,]*), ([^,]*), [^>]*>>>\((\w+)\)",
                 r"emulate_launch(\1, \2, \3, \4)", SOURCE.read_text())
    assert src.count("emulate_launch(") == 2, "the launch sites of matmul.cu changed"
    (out / "matmul.cpp").write_text(src)
    lib = out / "libmatmul_emulated.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-Wno-unknown-pragmas",
                    "-shared", "-fPIC", "-pthread", "-I", str(out), "-o", str(lib),
                    str(out / "matmul.cpp")], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).gemm_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _gemm(fn, a, b, c=None, alpha=1.0, beta=0.0, k_chunk=K_CHUNK):
    """The kernel's C entry on numpy operands of any strides; K is split
    into chunks of ``k_chunk`` (by default the wrapper's)."""
    L, M, K = a.shape
    N = b.shape[2]
    d = np.empty((L, M, N), np.float32)
    splits = -(-K // k_chunk) if K > k_chunk else 1
    work = np.empty(L * splits * M * N, np.float32)
    count = np.zeros(L * -(-M // 128) * -(-N // 128), np.int32)

    def strides(t):
        return [s // t.itemsize for s in t.strides]

    err = fn(a.ctypes.data, b.ctypes.data, None if c is None else c.ctypes.data,
             d.ctypes.data, work.ctypes.data, count.ctypes.data, L, M, N, K, k_chunk,
             *strides(a), *strides(b), *(strides(c) if c is not None else (0, 0, 0)),
             alpha, beta, None)
    assert err == 0
    assert not count.any() or np.all(count == splits)  # every tile counted each chunk
    return d


# (L, M, N, K, B transposed, C given, alpha, beta, k_chunk): tile-sized,
# ragged and degenerate shapes in the three Newton-Schulz launch kinds, and
# K split into chunks (even, ragged, a chunk of one k-tile)
GEMMS = [(1, 128, 128, 128, False, False, 1.0, 0.0, K_CHUNK),
         (3, 100, 300, 77, True, False, 1.0, 0.0, K_CHUNK),
         (2, 129, 129, 129, False, True, 2.0315, -4.7750, K_CHUNK),
         (4, 100, 300, 100, False, True, 1.0, 3.4445, K_CHUNK),
         (2, 7, 5, 3, True, True, -0.5, 2.0, K_CHUNK),
         (1, 64, 260, 33, False, False, 0.25, 0.0, K_CHUNK),
         (1, 20, 20, 0, False, True, 1.0, 2.0, K_CHUNK),
         (2, 130, 40, 300, True, True, 2.0315, -4.7750, 64),
         (1, 33, 140, 100, False, False, 1.0, 0.0, 8),
         (1, 40, 40, 9000, True, False, 1.0, 0.0, K_CHUNK)]


@pytest.mark.parametrize("case", GEMMS, ids=lambda c: "x".join(map(str, c[:4]))
                         + ("_bt" if c[4] else "") + ("_c" if c[5] else "")
                         + (f"_k{c[8]}" if c[8] != K_CHUNK else ""))
def test_emulated_kernel_within_the_fp32_sum_bound(gemm_f32, case):
    L, M, N, K, trans_b, with_c, alpha, beta, k_chunk = case
    rng = np.random.default_rng(M * N + K)
    a = rng.standard_normal((L, M, K)).astype(np.float32)
    b = (np.swapaxes(rng.standard_normal((L, N, K)).astype(np.float32), 1, 2) if trans_b
         else rng.standard_normal((L, K, N)).astype(np.float32))
    c = None
    if with_c:  # with a transposed B, C is a transposed view too
        c = (np.swapaxes(rng.standard_normal((L, N, M)).astype(np.float32), 1, 2) if trans_b
             else rng.standard_normal((L, M, N)).astype(np.float32))
    got = _gemm(gemm_f32, a, b, c, alpha, beta, k_chunk)
    want = alpha * (a.astype(np.float64) @ b.astype(np.float64))
    mag = abs(alpha) * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64))
    if with_c:
        want = want + beta * c
        mag = mag + abs(beta) * np.abs(c)
    # a split sum adds the chunks in order: ceil(K / k_chunk) more roundings
    splits = -(-K // k_chunk) if K > k_chunk else 1
    assert np.all(np.abs(got - want) <= (K + splits + 2) * 2.0 ** -24 * mag + 1e-30)


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
    """A split tile adds its chunks' partial sums in chunk order, and each
    chunk is a serial fp32 FMA chain: the result equals that sum computed
    on the host, bit for bit, for each slice of a stack."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((2, 3, 40)).astype(np.float32)
    b = rng.standard_normal((2, 40, 5)).astype(np.float32)
    got = _gemm(gemm_f32, a, b, k_chunk=16)
    want = np.zeros((2, 3, 5), np.float32)
    for lo in range(0, 40, 16):
        part = np.zeros((2, 3, 5), np.float32)
        for k in range(lo, min(lo + 16, 40)):
            part = (part.astype(np.float64)
                    + a[:, :, k:k + 1].astype(np.float64) * b[:, k:k + 1, :]).astype(np.float32)
        want = part if lo == 0 else (want + part).astype(np.float32)
    assert np.array_equal(got, want)
