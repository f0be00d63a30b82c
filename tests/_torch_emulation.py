"""The emulation of the port's CUDA sources on the CPU, shared by the
``tests/test_torch_kernel_emulation_*.py`` files (one a kernel, the fp32
flash kernel's over three and the bf16 one's over two, so that ``--dist
loadfile`` spreads them): the headers, the C++ models, the build fixtures and the numpy
models. pytest does not collect this module.

The port's CUDA sources run on the CPU under an emulation of the CUDA
features they use: the GEMM kernel (``csrc/matmul.cu``), the RMNP kernel
(``csrc/rmnp_update.cu``) and the fp32 and bf16 flash-attention kernels
(``csrc/flash_attention_fwd_tf32.cu``, ``csrc/flash_attention_fwd.cu``).

There is no ``nvcc`` and no card on a CPU machine, so each source is
compiled with the host C++ compiler against two small headers written below
(the RMNP and flash-attention sections further down say what they add):

- ``cuda_runtime.h``: each block runs as ``THREADS`` std::threads that meet
  at a std::barrier for ``__syncthreads``, ``__shared__`` variables are
  static (one block runs at a time), ``__fmul_rn``/``__fadd_rn`` round each
  operation on its own, and a launch ``kernel<<<grid, threads, smem,
  stream>>>(args)`` becomes a loop over the grid.
- ``sm90.cuh``, in place of the source's own: a C++ model of each Hopper
  helper the kernel calls. ``tf32_rna`` rounds to 10 mantissa bits, to
  nearest with ties away; the dynamic shared memory is one static buffer
  and ``smem_u32`` an offset into it; an mbarrier is a count of pending
  arrivals and a phase in that buffer, and a wait blocks (on a condition
  variable that every completed phase signals) until the phase of its
  parity is over; ``wgmma_tf32_m64n128k8`` decodes its
  two descriptors (start address, stride byte offset, the 128-byte swizzle
  on address bits 4-6 against bits 7-9), reads each K-major operand as the
  PTX ISA lays it out, ignores the low 13 bits of each tf32 operand, and
  writes each thread's own accumulator registers in the m64nNk8 fragment
  layout. The fences, commit and wait are no-ops (the model computes at
  issue).

The model of the tensor cores' addition is pessimistic: the 8 products of
a k-step are exact, and with the accumulator they are cut toward zero at
the last fp32 bit of the largest addend, summed, and the sum cut toward zero
to fp32. (The card keeps a few more bits.) ``_model_sum`` is the same
arithmetic in numpy, independent of the C++.

This checks the kernel's own index arithmetic, masks, strides, thread maps,
swizzle, descriptors, the split into hi and lo, the order of the slab's
products, the slab and chunk order, both launch layouts, and the epilogue,
and that a stacked launch gives each slice the bits of a one-slice launch.
It cannot check the card's compiler, its timing, its memory model or the
tensor cores' exact rounding: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` do that on the card.

Tolerance: each result is held against a float64 product at the classic
bound of a K-term fp32 sum, (K + 2) * 2^-24 * (|alpha| |A| |B| + |beta| |C|)
per element (the two extra terms are the epilogue's roundings), plus one
rounding per chunk of the case's k_chunk. And, as a forecast of
``chip_smoke.py`` phase E, its largest error may be at most E_ERR_FACTOR
times that of a plain serial fp32 chain on the same inputs.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import matmul as mm
from repro_torch.kernels.matmul import K_CHUNK

SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "matmul.cu"
COEFFS = (3.4445, -4.7750, 2.0315)
E_ERR_FACTOR = 8.0  # chip_smoke.py's, for the forecast

EMULATION_HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <optional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
#define __restrict__ __restrict
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x, y, z;
              dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
inline uint3 gridDim, blockDim;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
                         cudaFuncAttributeNonPortableClusterSizeAllowed = 10 };
typedef struct CUstream_st* cudaStream_t;
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute attr, int value) {
  if (attr == cudaFuncAttributeNonPortableClusterSizeAllowed) return cudaSuccess;
  return value <= 232448 ? cudaSuccess : cudaErrorInvalidValue;  // 227 KB a block
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline float __ldcg(const float* p) { return *p; }
template <class T> void __stcs(T* p, T x) { *p = x; }
template <class T> T min(T a, T b) { return b < a ? b : a; }
// this thread's block: its barrier, and (cluster launches) its dynamic shared
// memory, its rank, the cluster's blocks' shared memory and the cluster barrier
inline thread_local std::barrier<>* g_barrier = nullptr;
inline thread_local uint8_t* g_smem = nullptr;
inline thread_local unsigned g_rank = 0, g_cluster_size = 1;
inline thread_local uint8_t* const* g_cluster_smem = nullptr;
inline thread_local std::barrier<>* g_cluster_barrier = nullptr;
inline thread_local std::optional<std::barrier<>::arrival_token> g_cluster_token;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
template <class Kernel, class Args>
void emulate_launch(Kernel kernel, dim3 grid, int threads, Args args) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {unsigned(threads), 1, 1};
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> barrier(threads);
        std::vector<std::thread> block;
        for (int t = 0; t < threads; ++t)
          block.emplace_back([&, t] {
            threadIdx = {unsigned(t), 0, 0};
            blockIdx = {x, y, z};
            g_barrier = &barrier;
            kernel(args);
          });
        for (auto& th : block) th.join();
      }
}
// cudaLaunchKernelEx with a cluster dimension along x: the blocks of one
// cluster run together, each as blockDim.x threads with its own barrier and
// its own dynamic shared memory (filled with NaN bits first); clusters run
// one after another
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...),
                               Act&&... args) {
  unsigned K = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      if (cfg->attrs[i].val.clusterDim.y != 1 || cfg->attrs[i].val.clusterDim.z != 1)
        return cudaErrorInvalidValue;
      K = cfg->attrs[i].val.clusterDim.x;
    }
  const dim3 grid = cfg->gridDim;
  const int threads = cfg->blockDim.x;
  if (K < 1 || K > 16 || grid.x % K || cfg->dynamicSmemBytes > 232448) return cudaErrorInvalidValue;
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {unsigned(threads), 1, 1};
  std::vector<std::vector<uint8_t>> smem(K, std::vector<uint8_t>(cfg->dynamicSmemBytes + 16));
  std::vector<uint8_t*> bases(K);
  for (unsigned r = 0; r < K; ++r) bases[r] = smem[r].data();
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x0 = 0; x0 < grid.x; x0 += K) {
        for (auto& m : smem) std::memset(m.data(), 0xFF, m.size());
        std::barrier<> cluster(K * threads);
        std::vector<std::unique_ptr<std::barrier<>>> blocks;
        for (unsigned r = 0; r < K; ++r) blocks.emplace_back(new std::barrier<>(threads));
        std::vector<std::thread> all;
        for (unsigned r = 0; r < K; ++r)
          for (int t = 0; t < threads; ++t)
            all.emplace_back([&, r, t] {
              threadIdx = {unsigned(t), 0, 0};
              blockIdx = {x0 + r, y, z};
              g_barrier = blocks[r].get();
              g_smem = bases[r];
              g_rank = r;
              g_cluster_size = K;
              g_cluster_smem = bases.data();
              g_cluster_barrier = &cluster;
              kernel(args...);
              if (g_cluster_token) std::abort();  // an arrive without its wait
            });
        for (auto& th : all) th.join();
      }
  return cudaSuccess;
}
template <class F> cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}
"""

BF16_HEADER = r"""
#pragma once
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>
// bf16 storage; conversions as the card's intrinsics: widening is exact,
// narrowing rounds to nearest even
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return {uint16_t((u >> 16) | 0x40)};  // NaN
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
// a pair, the first value in the low half
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__bfloat162float(h.x), __bfloat162float(h.y)};
}
"""

# The helpers of sm90.cuh that csrc/rmnp_update.cu calls. A block's
# shared memory is its own buffer (``g_smem``) and a shared::cta address an
# offset into it; ``dsmem_map`` puts rank + 1 above bit 24 of that offset,
# and ``ld_dsmem_f32`` reads the block of that rank; the cluster barrier is
# a std::barrier over all the cluster's threads, its arrive and wait the two
# halves of one phase; a streaming load is a plain read of an aligned address.
SM90_CLUSTER_MODEL = r"""
#pragma once
#include <cuda_runtime.h>
#include <cstdint>
#include <cstdlib>
#include <cstring>
namespace sm90 {
inline uint8_t* dynamic_smem() { return g_smem; }
inline uint32_t smem_u32(const void* p) {
  return uint32_t(static_cast<const uint8_t*>(p) - g_smem);
}
inline uint32_t cluster_ctarank() { return g_rank; }
inline void cluster_arrive() {
  if (g_cluster_token) std::abort();  // two arrives without a wait
  g_cluster_token.emplace(g_cluster_barrier->arrive());
}
inline void cluster_wait() {
  if (!g_cluster_token) std::abort();  // a wait without an arrive
  g_cluster_barrier->wait(std::move(*g_cluster_token));
  g_cluster_token.reset();
}
inline uint32_t dsmem_map(uint32_t addr, uint32_t rank) {
  if (addr >= (1u << 24) || rank >= g_cluster_size) std::abort();
  return ((rank + 1) << 24) | addr;
}
// a vector load faults on the card unless aligned to its size
inline float4 ld_stream_f4(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) % 16) std::abort();
  float4 r;
  std::memcpy(&r, p, 16);
  return r;
}
inline uint2 ld_stream_u2(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) % 8) std::abort();
  uint2 r;
  std::memcpy(&r, p, 8);
  return r;
}
inline float ld_dsmem_f32(uint32_t addr) {
  if ((addr >> 24) == 0 || (addr & 3)) std::abort();  // not a mapped, aligned address
  float x;
  std::memcpy(&x, g_cluster_smem[(addr >> 24) - 1] + (addr & 0xFFFFFF), 4);
  return x;
}
}  // namespace sm90
"""

SM90_MODEL = r"""
#pragma once
#include <cuda_runtime.h>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
namespace sm90 {
alignas(1024) inline uint8_t smem[232448];
inline uint32_t smem_u32(const void* p) {
  return uint32_t(static_cast<const uint8_t*>(p) - smem);
}
inline uint8_t* dynamic_smem() { return smem; }
inline void fence_proxy_async() {}
// an mbarrier in its 8 bytes: 12 bits each of expected and pending
// arrivals, 8 of the phase, and the transaction bytes still to come, which
// the card counts up to 2^20 - 1 (an hd-256 Q tile is 65536); a phase
// completes once pending arrivals and bytes are both zero
struct Mbar { uint32_t count : 12, pending : 12, phase : 8; uint32_t tx; };
static_assert(sizeof(Mbar) == 8, "an mbarrier is 8 bytes");
inline std::mutex mbar_lock;
inline Mbar* mbar(uint32_t bar) { return reinterpret_cast<Mbar*>(smem + bar); }
inline void mbar_init(uint32_t bar, uint32_t count) {
  std::lock_guard<std::mutex> g(mbar_lock);
  if (count < 1 || count > 0xFFF) std::abort();
  *mbar(bar) = {count, count, 0, 0};
}
inline void mbar_init_fence() {}
// signalled on every completed phase (with mbar_lock held)
inline std::condition_variable mbar_cv;
inline void mbar_complete_if_done(Mbar* m) {
  if (m->pending == 0 && m->tx == 0) {
    m->pending = m->count;
    ++m->phase;
    mbar_cv.notify_all();
  }
}
inline void mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> g(mbar_lock);
  Mbar* m = mbar(bar);
  if (m->pending == 0) std::abort();  // more arrivals than the count
  --m->pending;
  mbar_complete_if_done(m);
}
inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(mbar_lock);
  Mbar* m = mbar(bar);
  if (m->pending == 0 || m->tx + bytes > 0xFFFFF) std::abort();
  m->tx += bytes;
  --m->pending;
  mbar_complete_if_done(m);
}
inline void mbar_complete_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(mbar_lock);
  Mbar* m = mbar(bar);
  if (bytes > m->tx) std::abort();  // more bytes than expected
  m->tx -= bytes;
  mbar_complete_if_done(m);
}
// the phase of the given parity has completed once the current one
// differs; a wait that sees none for 60 s aborts, as the card's wait traps,
// so a broken ring fails instead of hanging. A waiting thread blocks until a
// phase completes somewhere: hundreds of emulated threads wait on a ring at
// once, and spinning kept every core of the machine busy
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  const auto until = std::chrono::steady_clock::now() + std::chrono::seconds(60);
  std::unique_lock<std::mutex> g(mbar_lock);
  if (!mbar_cv.wait_until(g, until, [&] { return (mbar(bar)->phase & 1) != parity; })) {
    std::fprintf(stderr, "mbar_wait: no phase of parity %u in 60 s\n", parity);
    std::abort();
  }
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait_all() {}
template <int N> inline void fence_regs(float (&)[N]) {}
inline void fence_regs(float&) {}
inline uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t swizzle) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}
inline float tf32_rna(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  u = (u + 0x1000u) & ~0x1FFFu;
  std::memcpy(&x, &u, 4);
  return x;
}
// element (row, k) of a K-major operand in the 128-byte swizzle; the tensor
// cores read a tf32 operand's top 19 bits
inline double operand(uint64_t desc, int row, int k) {
  if ((desc >> 62) != 1) std::abort();
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  uint32_t at = start + (row / 8) * sbo + (row % 8) * 128 + k * 4;
  at ^= ((at >> 7) & 7) << 4;
  uint32_t u;
  std::memcpy(&u, smem + at, 4);
  u &= ~0x1FFFu;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// acc plus n exact products: each addend cut toward zero at the last fp32
// bit of the largest, summed exactly, the sum cut toward zero to fp32
inline float tc_sum(float acc, const double* prod, int n) {
  double mx = std::fabs(double(acc));
  for (int i = 0; i < n; ++i) mx = std::fmax(mx, std::fabs(prod[i]));
  if (mx == 0) return 0.f;
  int e;
  std::frexp(mx, &e);
  const double q = std::ldexp(1.0, e - 24);
  double s = std::trunc(double(acc) / q) * q;
  for (int i = 0; i < n; ++i) s += std::trunc(prod[i] / q) * q;
  float r = float(s);
  if (std::fabs(double(r)) > std::fabs(s)) r = std::nextafter(r, 0.f);
  return r;
}
inline void wgmma_tf32_m64n128k8(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  const int t = threadIdx.x % 128, lane = t % 32;
  for (int i = 0; i < 64; ++i) {
    const int row = 16 * (t / 32) + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    double prod[8];
    for (int k = 0; k < 8; ++k) prod[k] = operand(da, row, k) * operand(db, col, k);
    d[i] = tc_sum(scale_d ? d[i] : 0.f, prod, 8);
  }
}
}  // namespace sm90
"""


@pytest.fixture(scope="module")
def gemm_f32(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = tmp_path_factory.mktemp("cuda_emulation")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    (out / "sm90.cuh").write_text(SM90_MODEL)
    src = re.sub(r"(\w+<[\w, ]+>)<<<([^,]*), ([^,]*), [^>]*>>>\((\w+)\)",
                 r"emulate_launch(\1, \2, \3, \4)", SOURCE.read_text())
    assert src.count("emulate_launch(") == 1, "the launch site of matmul.cu changed"
    (out / "matmul.cpp").write_text(src)
    lib = out / "libmatmul_emulated.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-Wno-unknown-pragmas",
                    "-shared", "-fPIC", "-pthread", "-I", str(out), "-o", str(lib),
                    str(out / "matmul.cpp")], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).gemm_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _gemm(fn, a, b, c=None, alpha=1.0, beta=0.0, k_chunk=None, split=None):
    """The kernel's C entry on numpy operands of any strides. K is cut into
    chunks of ``k_chunk`` and the launch laid out as the wrapper would
    (``mm.k_chunk``, ``mm.split_blocks``) unless given."""
    L, M, K = a.shape
    N = b.shape[2]
    k_chunk = mm.k_chunk(M, N, K) if k_chunk is None else k_chunk
    split = mm.split_blocks(L, M, N, K, k_chunk) if split is None else split
    d = np.empty((L, M, N), np.float32)
    chunks = -(-K // k_chunk) if K > k_chunk else 1
    work = np.empty(L * chunks * M * N, np.float32)
    count = np.zeros(L * -(-M // 128) * -(-N // 128), np.int32)

    def strides(t):
        return [s // t.itemsize for s in t.strides]

    err = fn(a.ctypes.data, b.ctypes.data, None if c is None else c.ctypes.data,
             d.ctypes.data, work.ctypes.data, count.ctypes.data, L, M, N, K, k_chunk,
             int(split), *strides(a), *strides(b), *(strides(c) if c is not None else (0, 0, 0)),
             alpha, beta, None)
    assert err == 0
    # with the split layout every tile counts each of its chunks
    assert np.all(count == (chunks if split and chunks > 1 else 0))
    return d


def _tf32(x):
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & ~np.uint64(0x1FFF)).astype(np.uint32).view(np.float32)


def _tc_sum(acc, prods):
    """The model of the tensor cores' k-step, on arrays (see the header)."""
    terms = [acc.astype(np.float64)] + prods
    mx = np.max(np.abs(terms), axis=0)
    q = np.ldexp(1.0, np.frexp(mx)[1] - 24)
    s = sum(np.trunc(t / q) * q for t in terms)
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return np.where(mx == 0, np.float32(0), r)


def _model_sum(a, b, k_chunk):
    """The kernel's sum of one slice, a (M, K) @ b (K, N), in numpy: 3xTF32
    products (lo.hi, hi.lo, hi.hi) in a fresh accumulator per 32-slab,
    slabs added in k order from each chunk's start, chunks in order."""
    (M, K), N = a.shape, b.shape[1]
    ah, bh = _tf32(a), _tf32(b)
    parts_a = [x.astype(np.float64) for x in (ah, _tf32(a - ah))]
    parts_b = [x.astype(np.float64) for x in (bh, _tf32(b - bh))]
    total = np.zeros((M, N), np.float32)
    for c, c0 in enumerate(range(0, K, k_chunk)):
        chunk = np.zeros((M, N), np.float32)
        for s, s0 in enumerate(range(c0, min(K, c0 + k_chunk), 32)):
            s1 = min(K, c0 + k_chunk, s0 + 32)
            acc = np.zeros((M, N), np.float32)
            for ia, ib in ((1, 0), (0, 1), (0, 0)):
                for k0 in range(s0, s1, 8):
                    acc = _tc_sum(acc, [np.outer(parts_a[ia][:, k], parts_b[ib][k])
                                        for k in range(k0, min(s1, k0 + 8))])
            chunk = acc if s == 0 else (chunk + acc).astype(np.float32)
        total = chunk if c == 0 else (total + chunk).astype(np.float32)
    return total


def _chain(a, b):
    """A plain serial fp32 chain, each product and sum rounded."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = acc + np.outer(a[:, k], b[k])
    return acc


# (L, M, N, K, B transposed, C given, alpha, beta, k_chunk): tile-sized,
# ragged and degenerate shapes in the three Newton-Schulz launch kinds, and
# K split into chunks (the wrapper's, several slabs, one masked slab)
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


def _operands(case):
    L, M, N, K, trans_b, with_c = case[:6]
    rng = np.random.default_rng(M * N + K)
    a = rng.standard_normal((L, M, K)).astype(np.float32)
    b = (np.swapaxes(rng.standard_normal((L, N, K)).astype(np.float32), 1, 2) if trans_b
         else rng.standard_normal((L, K, N)).astype(np.float32))
    c = None
    if with_c:  # with a transposed B, C is a transposed view too
        c = (np.swapaxes(rng.standard_normal((L, N, M)).astype(np.float32), 1, 2) if trans_b
             else rng.standard_normal((L, M, N)).astype(np.float32))
    return a, b, c


# ---------------------------------------------------------------- RMNP ---
#
# csrc/rmnp_update.cu under the same emulation: each cluster's blocks run
# together as threads, with the cluster helpers of sm90.cuh modelled above
# (SM90_CLUSTER_MODEL). The numpy model ``_rmnp_model`` is the kernel's own
# order of the sum of squares (a thread's rows in order, the block's threads
# in order, the cluster's blocks in rank order), independent of the C++.

RMNP_SOURCE = SOURCE.with_name("rmnp_update.cu")
BETA, EPS = 0.95, 1e-8


@pytest.fixture(scope="module")
def rmnp_f32(rmnp_lib):
    fn = rmnp_lib.rmnp_update
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def rmnp_split_f32(rmnp_lib):
    """The column-split entry ``rmnp_update_split`` (PARTIAL and FINISH)."""
    fn = rmnp_lib.rmnp_update_split
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def rmnp_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = tmp_path_factory.mktemp("rmnp_emulation")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    (out / "cuda_bf16.h").write_text(BF16_HEADER)
    (out / "sm90.cuh").write_text(SM90_CLUSTER_MODEL)
    src = RMNP_SOURCE.read_text()
    assert "<<<" not in src and src.count("cudaLaunchKernelEx(") == 1
    (out / "rmnp_update.cpp").write_text(src)
    lib = out / "librmnp_emulated.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-Wno-unknown-pragmas",
                    "-shared", "-fPIC", "-pthread", "-I", str(out), "-o", str(lib),
                    str(out / "rmnp_update.cpp")], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _bf16(x):
    """float32 -> bf16 bits (uint16), to nearest even."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _rmnp(fn, g, v, w=None, scalars=(2e-3, 0.1), layout=None, vec=None):
    """The kernel's C entry on numpy operands: g float32; v and w float32 or
    bf16 bits (uint16). Precondition without w -> (v_new, d), else apply ->
    (v_new, w_new), in the operands' types."""
    from repro_torch.kernels.rmnp_update import split
    *lead, d_in, d_out = g.shape
    L = int(np.prod(lead)) if lead else 1
    s = layout or split(d_in, d_out)
    apply = w is not None
    v_out = np.empty_like(v)
    out = np.empty_like(w) if apply else np.empty_like(g)
    sc = np.asarray(scalars, np.float32)
    if vec is None:
        vec = d_out % 4 == 0
    err = fn(g.ctypes.data, v.ctypes.data, w.ctypes.data if apply else None, v_out.ctypes.data,
             out.ctypes.data, sc.ctypes.data, L, d_in, d_out, s.K, s.R, s.C, s.threads,
             int(s.one_read), int(vec), int(v.dtype == np.uint16),
             int(apply and w.dtype == np.uint16), int(apply), BETA, 1.0 - BETA, EPS, None)
    assert err == 0
    return v_out, out


def _rmnp_split(fn, g, v, colsum=None, w=None, scalars=(2e-3, 0.1), layout=None, vec=None):
    """The column-split entry on numpy operands: without ``colsum`` PARTIAL
    -> colsum (L, 1, d_out); with it FINISH -> (v_new, d) or, given ``w``,
    (v_new, w_new)."""
    from repro_torch.kernels.rmnp_update import split
    *lead, d_in, d_out = g.shape
    L = int(np.prod(lead)) if lead else 1
    s = layout or split(d_in, d_out)
    if vec is None:
        vec = d_out % 4 == 0
    sc = np.asarray(scalars, np.float32)
    finish = colsum is not None
    apply = w is not None
    sums = colsum if finish else np.empty(tuple(lead) + (1, d_out), np.float32)
    v_out = np.empty_like(v) if finish else None
    out = (np.empty_like(w) if apply else np.empty_like(g)) if finish else None
    err = fn(g.ctypes.data, v.ctypes.data, w.ctypes.data if apply else None,
             v_out.ctypes.data if finish else None, out.ctypes.data if finish else None,
             sums.ctypes.data, sc.ctypes.data, L, d_in, d_out, s.K, s.R, s.C, s.threads,
             int(vec), int(v.dtype == np.uint16), int(apply and w.dtype == np.uint16),
             2 if finish else 1, int(apply), BETA, 1.0 - BETA, EPS, None)
    assert err == 0
    return (v_out, out) if finish else sums


def _rmnp_model(g, v32, layout):
    """(v_new, d) in float32 as the kernel computes them, the sum of squares
    in the kernel's order."""
    K, R, C, threads, _ = layout
    RT = threads // (C // 4)
    d_in = g.shape[-2]
    vn = np.float32(BETA) * v32 + np.float32(1.0 - BETA) * g
    total = np.zeros(vn[..., 0, :].shape, np.float32)
    for k in range(K):
        part = np.zeros_like(total)
        for rg in range(RT):
            acc = np.zeros_like(total)
            for r in range(k * R + rg, min(d_in, (k + 1) * R), RT):
                acc = acc + vn[..., r, :] * vn[..., r, :]
            part = part + acc
        total = total + part
    return vn, vn / (np.sqrt(total) + np.float32(EPS))[..., None, :]


def _rmnp_operands(shape, v_bf16, w_bf16=None, seed=0):
    rng = np.random.default_rng(seed)
    g = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
    v = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
    w = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    v = _bf16(v) if v_bf16 else v
    if w_bf16 is not None:
        w = _bf16(w) if w_bf16 else w
    return g, v, w


def _as_f32(x):
    return _f32(x) if x.dtype == np.uint16 else x


def _layout(K, R, C, threads, one_read=True):
    from repro_torch.kernels.rmnp_update import Split
    return Split(K, R, C, threads, one_read)


# (shape, (K, R, C, threads[, one_read]) or None for the wrapper's split,
# bf16 momentum): ragged d_in and d_out, K of 1, 2 and 4, every column
# block, a cluster whose last block holds no row, the two-sweep path, 32
# rows a thread, and d_out = 4 in a 64-column block (xlstm-350m's mLSTM
# gate matrices, 2048 x 4)
RMNP_CASES = [((3, 33, 9), (1, 33, 8, 64), False),
              ((2, 250, 20), (1, 250, 16, 32), False),
              ((2, 70, 37), (2, 35, 16, 64), True),
              ((2, 130, 70), (4, 33, 32, 128), False),
              ((2, 100, 64), (4, 25, 64, 128), True),
              ((1, 50, 12), (4, 20, 8, 32), False),
              ((2, 90, 40), (2, 45, 32, 64, False), True),
              ((3, 50, 4), (2, 25, 64, 128), False),
              ((300, 257), None, False)]


def _case_id(case):
    shape, layout, v_bf16 = case
    return ("x".join(map(str, shape)) + ("_wrapper" if layout is None else
            f"_K{layout[0]}C{layout[2]}" + ("" if len(layout) < 5 or layout[4] else "_2sweep"))
            + ("_v16" if v_bf16 else ""))


GPT2_SMALL_BUCKETS = [(48, 768, 768), (12, 768, 6144), (12, 3072, 768), (1, 50432, 768)]


# --------------------------------------------------- flash attention, fp32 ---
#
# csrc/flash_attention_fwd_tf32.cu under the GEMM's emulation and model
# (SM90_MODEL), with the helpers it adds: named barriers (a count and a
# generation each; bar_sync waits for the generation to turn), the tf32
# wgmma forms m64n64k8 (A and B from shared memory, read as the GEMM's) and
# m64n{16,32}k8 with A from registers (the warpgroup's threads put their
# A fragments in a common buffer and meet at a barrier of the warpgroup, so
# each thread reads the rows it needs from the threads that hold them: row g
# and g + 8 of warp w, column c and c + 4, from lane 4 (row % 8) + c % 4),
# ex2 as exp2 in fp32, __shfl_xor_sync and __shfl_sync through a buffer and
# a barrier of the warp; mbar_spin is mbar_wait, and setmaxnreg and
# wait_group are no-ops, since the model computes at issue.
# ``emulate_hold_second_consumer`` holds the second consumer warpgroup
# (threads 128..255) back at its first Q.K^T product of each block, so the
# producer and the first consumer run ahead of it through the ring. Every
# build runs here, (16, 16) to (256, 256), v through its strides (MLA's
# column slice where hdv != hd).

FLASH_SOURCE = SOURCE.with_name("flash_attention_fwd_tf32.cu")

FLASH_MODEL = r"""
#include <atomic>
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <memory>
#include <vector>
// microseconds that each thread of the second consumer warpgroup sleeps
// before its first Q.K^T product of a block
inline std::atomic<int> hold_second_consumer_us{0};
extern "C" void emulate_hold_second_consumer(int us) { hold_second_consumer_us = us; }
namespace sm90 {
// the hold, in the threads of warpgroup wg (the second consumer)
inline void hold_consumer(int wg) {
  thread_local bool held = false;  // a block's threads are made anew
  if (!held && int(threadIdx.x / 128) == wg && hold_second_consumer_us > 0) {
    held = true;
    std::this_thread::sleep_for(std::chrono::microseconds(hold_second_consumer_us.load()));
  }
}
struct GroupBarriers {
  std::vector<std::unique_ptr<std::barrier<>>> warp, warpgroup;
  GroupBarriers() {
    for (int i = 0; i < 32; ++i) warp.emplace_back(new std::barrier<>(32));
    for (int i = 0; i < 8; ++i) warpgroup.emplace_back(new std::barrier<>(128));
  }
};
inline GroupBarriers group_barriers;
// named barriers 0-15: arrivals so far and completed generations
inline std::mutex named_lock;
inline std::condition_variable named_cv;
inline int named_count[16];
inline unsigned named_gen[16];
inline bool named_arrive(int id, int threads) {
  if (id < 0 || id > 15 || threads % 32) std::abort();
  if (++named_count[id] < threads) return false;
  named_count[id] = 0;
  ++named_gen[id];
  named_cv.notify_all();
  return true;
}
inline void bar_sync(int id, int threads) {
  std::unique_lock<std::mutex> g(named_lock);
  const unsigned gen = named_gen[id];
  if (!named_arrive(id, threads)) named_cv.wait(g, [&] { return named_gen[id] != gen; });
}
template <int N> inline void fence_regs(uint32_t (&)[N][4]) {}
inline void fence_regs(uint32_t&) {}
inline float ex2(float x) { return std::exp2(x); }
template <int N> inline void wgmma_wait_group() {}
inline void mbar_spin(uint32_t bar, uint32_t parity) { mbar_wait(bar, parity); }
template <int N> inline void setmaxnreg_inc() {
  static_assert(N % 8 == 0 && N >= 24 && N <= 256, "setmaxnreg takes 24..256 in 8s");
}
template <int N> inline void setmaxnreg_dec() {
  static_assert(N % 8 == 0 && N >= 24 && N <= 256, "setmaxnreg takes 24..256 in 8s");
}
inline void wgmma_tf32_m64n64k8(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  hold_consumer(1);  // the producer is the last warpgroup
  const int t = threadIdx.x % 128, lane = t % 32;
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * (t / 32) + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    double prod[8];
    for (int k = 0; k < 8; ++k) prod[k] = operand(da, row, k) * operand(db, col, k);
    d[i] = tc_sum(scale_d ? d[i] : 0.f, prod, 8);
  }
}
// the warpgroups' A fragments, by warpgroup and thread
inline uint32_t a_frags[8][128][4];
template <int N>
inline void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  std::memcpy(a_frags[wg][t], a, 16);
  group_barriers.warpgroup[wg]->arrive_and_wait();
  auto a_at = [&](int row, int k) {  // element (row, k) of the 64 x 8 A
    const int w = row / 16, r = row % 16;
    uint32_t u = a_frags[wg][32 * w + 4 * (r % 8) + k % 4][2 * (k / 4) + r / 8] & ~0x1FFFu;
    float f;
    std::memcpy(&f, &u, 4);
    return double(f);
  };
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * (t / 32) + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    double prod[8];
    for (int k = 0; k < 8; ++k) prod[k] = a_at(row, k) * operand(db, col, k);
    d[i] = tc_sum(scale_d ? d[i] : 0.f, prod, 8);
  }
  group_barriers.warpgroup[wg]->arrive_and_wait();  // the buffer is free again
}
inline void wgmma_tf32_m64n16k8_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int s) {
  wgmma_tf32_rs<16>(d, a, db, s);
}
inline void wgmma_tf32_m64n32k8_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int s) {
  wgmma_tf32_rs<32>(d, a, db, s);
}
}  // namespace sm90
inline float shfl_buffer[1024];
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x;
  shfl_buffer[t] = v;
  sm90::group_barriers.warp[t / 32]->arrive_and_wait();
  const float r = shfl_buffer[(t & ~31) | ((t % 32) ^ lane_mask)];
  sm90::group_barriers.warp[t / 32]->arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src_lane) {
  const int t = threadIdx.x;
  std::memcpy(&shfl_buffer[t], &v, 4);
  sm90::group_barriers.warp[t / 32]->arrive_and_wait();
  int r;
  std::memcpy(&r, &shfl_buffer[(t & ~31) | src_lane], 4);
  sm90::group_barriers.warp[t / 32]->arrive_and_wait();
  return r;
}
"""


@pytest.fixture(scope="module")
def flash_tf32_lib(tmp_path_factory):
    """The emulated library: ``fa_fwd_tf32`` and ``emulate_hold_second_consumer``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    from repro_torch.kernels import flash_attention as fa
    out = tmp_path_factory.mktemp("flash_emulation")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    (out / "sm90.cuh").write_text(SM90_MODEL + FLASH_MODEL)
    src = re.sub(r"(\w+<[\w, ]+>)<<<(\w+), (\w+), [^>]*>>>\((\w+)\)",
                 r"emulate_launch(\1, \2, \3, \4)", FLASH_SOURCE.read_text())
    assert src.count("emulate_launch(") == 1, "the launch site of flash_attention_fwd_tf32.cu changed"
    (out / "flash.cpp").write_text(src)
    lib = out / "libflash_emulated.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-Wno-unknown-pragmas",
                    "-shared", "-fPIC", "-pthread", "-I", str(out), "-o", str(lib),
                    str(out / "flash.cpp")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.fa_fwd_tf32.argtypes = fa.ARGTYPES
    lib.fa_fwd_tf32.restype = ctypes.c_int
    lib.emulate_hold_second_consumer.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def flash_tf32(flash_tf32_lib):
    return flash_tf32_lib.fa_fwd_tf32


def _flash(fn, q, k, v, causal):
    """The kernel's C entry on numpy fp32 (B, S, heads, hd): q and k
    contiguous, v by its strides."""
    B, S, H, hd = q.shape
    hdv = v.shape[3]
    out = np.full((B, S, H, hdv), np.nan, np.float32)
    vs = [st // 4 for st in v.strides]
    err = fn(q.ctypes.data, k.ctypes.data, v.ctypes.data, out.ctypes.data, B, S, H, k.shape[2],
             hd, hdv, vs[2], vs[1], vs[0], int(causal), 1.0 / hd ** 0.5, None)
    assert err == 0
    return out


def _flash_inputs(B, S, H, K, hd, seed, hdv=None):
    """q, k, v in fp32; with hdv != hd, v is MLA's strided column slice: the
    last hdv columns of a (B, S, K, 2 hdv) array."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, S, h, hd)).astype(np.float32) for h in (H, K))
    if hdv is None or hdv == hd:
        return q, k, rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, k, rng.standard_normal((B, S, K, 2 * hdv)).astype(np.float32)[..., hdv:]


def _flash_limit(got, want):
    """Worst ratio of |got - want| to phase B's fp32 limit,
    1e-5 * |want| + 1e-6 * max|want| per element."""
    lim = 1e-6 * np.abs(want).max() + 1e-5 * np.abs(want)
    return float(np.max(np.abs(got - want) / lim))


def _flash_plain(q, k, v, causal):
    import torch

    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()


# (B, S, H, K, hd, hdv, causal). hd 16, 32 and 64: S of 1, one short of
# and one past the 64-key tile, and past the 128-row query tile; G = 1 and
# 4; causal and not. The wide builds: each pair at S of 1 and past the
# 64-key tile (S = 130 also past the 128-row query tile; S = 65 past hd
# 256's 64-row one), causal and not; G = 1, 2, 4 and 8 (paligemma's K = 1);
# v strided at (96, 64) and (192, 128)
FLASH_CASES = [(1, 1, 4, 1, 64, 64, True), (2, 1, 2, 2, 16, 16, False),
               (2, 63, 2, 2, 64, 64, False), (1, 63, 4, 1, 32, 32, True),
               (1, 65, 4, 1, 32, 32, False), (1, 65, 2, 2, 16, 16, True),
               (1, 129, 2, 2, 64, 64, True), (1, 129, 4, 1, 16, 16, False),
               (1, 129, 4, 1, 64, 64, False)]
FLASH_CASES += [(1, 1, 4, 2, 96, 96, True), (1, 130, 4, 2, 96, 96, True),
                (1, 65, 4, 1, 128, 128, True), (1, 130, 4, 2, 128, 128, False),
                (1, 1, 2, 2, 96, 64, False), (1, 65, 2, 2, 96, 64, True),
                (1, 1, 2, 2, 192, 128, True), (1, 130, 2, 1, 192, 128, True),
                (1, 1, 8, 1, 256, 256, False), (1, 65, 8, 1, 256, 256, True),
                (1, 65, 4, 1, 256, 256, False)]


# --------------------------------------------------- flash attention, bf16 ---
#
# csrc/flash_attention_fwd.cu under the fp32 flash kernel's emulation and
# model (SM90_MODEL + FLASH_MODEL), with what it adds: a ``cuda.h`` whose
# ``CUtensorMap`` records what ``cuTensorMapEncodeTiled`` is given (and
# refuses what the card's encode refuses: strides off 16 bytes, a box over 256 or
# wider than its swizzle span); ``tma_load_4d`` copies the box at issue,
# zeros past the map's edge, into shared memory in the map's 32-, 64- or
# 128-byte swizzle (bits 4.. of the address XOR bits 7..), and completes its
# bytes on the mbarrier, whose phase then needs both its arrivals and its
# bytes; the bf16 wgmma forms read K-major operands (row r, k: 8-row groups
# at the stride byte offset, rows one span apart) and the MN-major B (k, n:
# 8-k groups at the stride byte offset, spans of n at the leading byte
# offset) through the same swizzle, A of the register forms gathered across
# the warpgroup as the fp32 kernel's, with the tensor cores' addition
# modelled as the GEMM's over 16 products a k-step; wait_group and
# setmaxnreg are no-ops, since the model computes at issue, and mbar_spin is
# mbar_wait. ``emulate_hold_second_consumer`` holds the second consumer
# warpgroup back at its first product of each block, so the producer and the
# first consumer run ahead of it through the ring. So this checks the tensor maps, boxes and coordinates, the
# swizzle and descriptor arithmetic, the ring's barriers and parities (the
# producer's watch of the last stages included), the split of P, the masks
# and the epilogue; not the order in which the card completes products,
# which phase B of chip_smoke.py checks.

BF16_FLASH_SOURCE = SOURCE.with_name("flash_attention_fwd.cu")

TENSOR_MAP_HEADER = r"""
#pragma once
#include <cstdint>
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
enum CUresult { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_32B,
                          CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
// what an encoded map holds (the card's is 128 opaque bytes)
struct alignas(64) CUtensorMap {
  const uint8_t* base;
  uint64_t dims[4], strides[3];
  uint32_t box[4], span;  // span: bytes of the swizzle, 0 for none
};
inline CUresult cuTensorMapEncodeTiled(CUtensorMap* map, CUtensorMapDataType type,
                                       cuuint32_t rank, void* base, const cuuint64_t* dims,
                                       const cuuint64_t* strides, const cuuint32_t* box,
                                       const cuuint32_t* elem, CUtensorMapInterleave,
                                       CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
                                       CUtensorMapFloatOOBfill) {
  const uint32_t span = swizzle == CU_TENSOR_MAP_SWIZZLE_128B ? 128
                        : swizzle == CU_TENSOR_MAP_SWIZZLE_64B ? 64
                        : swizzle == CU_TENSOR_MAP_SWIZZLE_32B ? 32 : 0;
  if (type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank != 4 ||
      reinterpret_cast<uintptr_t>(base) % 16 || box[0] * 2 % 16 || (span && box[0] * 2 > span))
    return CUDA_ERROR_INVALID_VALUE;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 16 || strides[i] >= (uint64_t(1) << 40)) return CUDA_ERROR_INVALID_VALUE;
  for (int i = 0; i < 4; ++i)
    if (box[i] < 1 || box[i] > 256 || elem[i] != 1 || dims[i] < 1) return CUDA_ERROR_INVALID_VALUE;
  map->base = static_cast<const uint8_t*>(base);
  for (int i = 0; i < 4; ++i) map->dims[i] = dims[i], map->box[i] = box[i];
  for (int i = 0; i < 3; ++i) map->strides[i] = strides[i];
  map->span = span;
  return CUDA_SUCCESS;
}
"""

BF16_FLASH_MODEL = r"""
#include <cuda.h>
namespace sm90 {
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
constexpr int TENSOR_MAP_ERROR = 100000;
inline cudaError_t encode_fn(EncodeTiled* out) {
  *out = cuTensorMapEncodeTiled;
  return cudaSuccess;
}
// a shared-memory byte address through the swizzle of `span` bytes
inline uint32_t swizzled(uint32_t at, uint32_t span) {
  return span ? at ^ (((at >> 7) & (span / 16 - 1)) << 4) : at;
}
inline void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                        int c2, int c3) {
  if (dst % 128) std::abort();  // TMA writes 128-byte aligned boxes
  const int c[4] = {c0, c1, c2, c3};
  const uint32_t* box = map->box;
  uint32_t n = 0;
  for (uint32_t i3 = 0; i3 < box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < box[0]; ++i0, ++n) {
          const int64_t x[4] = {c[0] + int64_t(i0), c[1] + int64_t(i1), c[2] + int64_t(i2),
                                c[3] + int64_t(i3)};
          uint16_t v = 0;  // zero past the edge
          bool inside = true;
          for (int d = 0; d < 4; ++d) inside = inside && x[d] >= 0 && uint64_t(x[d]) < map->dims[d];
          if (inside)
            std::memcpy(&v, map->base + 2 * x[0] + x[1] * map->strides[0] +
                            x[2] * map->strides[1] + x[3] * map->strides[2], 2);
          std::memcpy(smem + swizzled(dst + 2 * n, map->span), &v, 2);
        }
  mbar_complete_tx(bar, 2 * n);
}
inline uint32_t desc_span(uint64_t desc) {
  const uint32_t mode = uint32_t(desc >> 62);
  if (mode == 0) std::abort();  // every operand here is swizzled
  return 256u >> mode;          // 1: 128, 2: 64, 3: 32
}
inline double bf16_smem(uint32_t at) {
  uint16_t h;
  std::memcpy(&h, smem + at, 2);
  const uint32_t u = uint32_t(h) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// element (row, k) of a K-major operand, (k, n) of an MN-major one
inline double k_major(uint64_t desc, int row, int k) {
  const uint32_t span = desc_span(desc);
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  return bf16_smem(swizzled(start + (row / 8) * sbo + (row % 8) * span + 2 * k, span));
}
inline double mn_major(uint64_t desc, int k, int n) {
  const uint32_t span = desc_span(desc), atom = span / 2;
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t lbo = uint32_t((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  return bf16_smem(swizzled(start + (n / atom) * lbo + (k / 8) * sbo + (k % 8) * span +
                            2 * (n % atom), span));
}
inline void wgmma_bf16_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  hold_consumer(2);  // warpgroup 0 is the producer
  const int t = threadIdx.x % 128, lane = t % 32;
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * (t / 32) + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    double prod[16];
    for (int k = 0; k < 16; ++k) prod[k] = k_major(da, row, k) * k_major(db, col, k);
    d[i] = tc_sum(scale_d ? d[i] : 0.f, prod, 16);
  }
}
inline uint32_t bf16_frags[8][128][4];
template <int N>
inline void wgmma_bf16_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  std::memcpy(bf16_frags[wg][t], a, 16);
  group_barriers.warpgroup[wg]->arrive_and_wait();
  auto a_at = [&](int row, int k) {  // element (row, k) of the 64 x 16 A
    const int w = row / 16, r = row % 16;
    const uint32_t u = bf16_frags[wg][32 * w + 4 * (r % 8) + (k % 8) / 2][2 * (k / 8) + r / 8];
    const uint32_t bits = (k % 2 ? u >> 16 : u & 0xFFFFu) << 16;
    float f;
    std::memcpy(&f, &bits, 4);
    return double(f);
  };
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * (t / 32) + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    double prod[16];
    for (int k = 0; k < 16; ++k) prod[k] = a_at(row, k) * mn_major(db, k, col);
    d[i] = tc_sum(scale_d ? d[i] : 0.f, prod, 16);
  }
  group_barriers.warpgroup[wg]->arrive_and_wait();  // the buffer is free again
}
inline void wgmma_bf16_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int s) {
  wgmma_bf16_rs<16>(d, a, db, s);
}
inline void wgmma_bf16_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int s) {
  wgmma_bf16_rs<32>(d, a, db, s);
}
inline void wgmma_bf16_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int s) {
  wgmma_bf16_rs<64>(d, a, db, s);
}
inline void wgmma_bf16_m64n96k16_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int s) {
  wgmma_bf16_rs<96>(d, a, db, s);
}
inline void wgmma_bf16_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                     int s) {
  wgmma_bf16_rs<128>(d, a, db, s);
}
}  // namespace sm90
"""


@pytest.fixture(scope="module")
def flash_bf16_lib(tmp_path_factory):
    """The emulated library: ``fa_fwd`` and ``emulate_hold_second_consumer``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    from repro_torch.kernels import flash_attention as fa
    out = tmp_path_factory.mktemp("flash_bf16_emulation")
    (out / "cuda_runtime.h").write_text(EMULATION_HEADER)
    (out / "cuda_bf16.h").write_text(BF16_HEADER)
    (out / "cuda.h").write_text(TENSOR_MAP_HEADER)
    (out / "sm90.cuh").write_text(SM90_MODEL + FLASH_MODEL + BF16_FLASH_MODEL)
    src = re.sub(r"(\w+<[\w, ]+>)<<<(\w+), (\w+), [^>]*>>>\((\w+)\)",
                 r"emulate_launch(\1, \2, \3, \4)", BF16_FLASH_SOURCE.read_text())
    assert src.count("emulate_launch(") == 1, "the launch site of flash_attention_fwd.cu changed"
    (out / "flash.cpp").write_text(src)
    lib = out / "libflash_bf16_emulated.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-Wno-unknown-pragmas",
                    "-shared", "-fPIC", "-pthread", "-I", str(out), "-o", str(lib),
                    str(out / "flash.cpp")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.fa_fwd.argtypes = fa.ARGTYPES
    lib.fa_fwd.restype = ctypes.c_int
    lib.emulate_hold_second_consumer.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def flash_bf16(flash_bf16_lib):
    return flash_bf16_lib.fa_fwd


def _flash_bf16_inputs(B, S, H, K, hd, hdv, seed):
    """q, k, v as bf16 bits (uint16), v MLA's strided column slice when
    hdv != hd: the last hdv columns of a (B, S, K, 2 hdv) array."""
    rng = np.random.default_rng(seed)
    q, k = (_bf16(rng.standard_normal((B, S, h, hd))) for h in (H, K))
    if hdv == hd:
        return q, k, _bf16(rng.standard_normal((B, S, K, hd)))
    return q, k, _bf16(rng.standard_normal((B, S, K, 2 * hdv)))[..., hdv:]


def _flash_bf16(fn, q, k, v, causal):
    """The kernel's C entry on bf16 bits: q, k contiguous, v by its strides."""
    B, S, H, hd = q.shape
    hdv = v.shape[3]
    out = np.full((B, S, H, hdv), 0xFFFF, np.uint16)  # NaN bits where nothing is written
    vs = [st // 2 for st in v.strides]
    err = fn(q.ctypes.data, k.ctypes.data, v.ctypes.data, out.ctypes.data, B, S, H,
             k.shape[2], hd, hdv, vs[2], vs[1], vs[0], int(causal), 1.0 / hd ** 0.5, None)
    assert err == 0
    return out


# (B, S, H, K, hd, hdv, causal): every build the port's models use but hd
# 32, each at S of 1, one past the 64-key tile and one past the 128-row
# query tile, causal and not, G = 1, 2 and 4; (192, 128) with MLA's strided v;
# (256, 256) at paligemma's G = 8 (K = 1), its two-stage ring and P.V in
# 64-column pieces, with S = 63 and 130 besides; (96, 96) (phi3-mini) and
# (96, 64) (minicpm3's MLA, v strided): three 32-column sub-tiles under the
# 64-byte swizzle, P.V at hdv 96 as one m64n96 product, G = 1 and 2
BF16_FLASH_CASES = [(1, 1, 2, 2, 16, 16, True), (1, 65, 4, 1, 16, 16, False),
                    (1, 129, 4, 2, 16, 16, True), (1, 129, 2, 1, 64, 64, True),
                    (1, 65, 4, 2, 64, 64, True), (1, 129, 4, 1, 64, 64, False),
                    (1, 1, 4, 1, 128, 128, False), (1, 129, 4, 2, 128, 128, True),
                    (1, 65, 2, 2, 128, 128, False), (1, 129, 2, 2, 192, 128, True),
                    (1, 65, 2, 2, 192, 128, False), (1, 1, 2, 2, 192, 128, True),
                    (1, 1, 8, 1, 256, 256, True), (1, 63, 8, 1, 256, 256, False),
                    (1, 65, 8, 1, 256, 256, True), (1, 130, 8, 1, 256, 256, True),
                    (1, 130, 8, 1, 256, 256, False), (1, 1, 2, 2, 96, 96, True),
                    (1, 1, 4, 2, 96, 96, False), (1, 65, 2, 2, 96, 96, False),
                    (1, 65, 4, 2, 96, 96, True), (1, 129, 4, 2, 96, 96, True),
                    (1, 130, 2, 2, 96, 96, False), (1, 1, 2, 2, 96, 64, False),
                    (1, 1, 4, 2, 96, 64, True), (1, 65, 2, 2, 96, 64, True),
                    (1, 65, 4, 2, 96, 64, False), (1, 129, 2, 2, 96, 64, True),
                    (1, 130, 4, 2, 96, 64, False)]


# the fp32 flash cases in three parts of about equal time, one a file
# (indices into FLASH_CASES)
FLASH_CASE_PARTS = {"a": (18, 0, 6, 9, 13, 15, 1, 3), "b": (12, 19, 7, 2, 5),
                    "c": (17, 16, 11, 10, 8, 4, 14)}
assert sorted(i for part in FLASH_CASE_PARTS.values() for i in part) == list(
    range(len(FLASH_CASES)))


def flash_cases(part):
    return [FLASH_CASES[i] for i in FLASH_CASE_PARTS[part]]
