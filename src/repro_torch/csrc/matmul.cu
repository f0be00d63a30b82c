// Batched fp32 GEMM with an epilogue, for Hopper (sm_90a), CUDA C++.
//
//     D[l] = alpha * (A[l] @ B[l]) + beta * C[l]        l = blockIdx.z
//
// Replaces four TPU kernels, the tiled matmul and the Newton-Schulz
// polynomial, in both their 2-D and stacked forms:
//   repro/kernels/matmul.py::_kernel          (2-D matmul, L = 1 here)
//   repro/kernels/matmul.py::_kernel3         (stacked (L, m, k) @ (L, k, n))
//   repro/kernels/newton_schulz.py::_poly_kernel   P = b*G + c*(G@G)
//   repro/kernels/newton_schulz.py::_poly_kernel3  the same over L
// The polynomial is this GEMM's epilogue (A = B = C = G, alpha = c,
// beta = b), so G@G never goes to device memory on its own; a Newton-Schulz
// step is three launches: Gram (B = X^T by strides), polynomial, and apply
// (A = P, B = C = X, alpha = 1, beta = a).
//
// Every operand is addressed through the strides the caller passes, so
// op(B) is B or B^T with no copy: B[l][k][j] sits at l*sbl + k*sbk + j*sbn.
// C is read only when its pointer is not null (the wrapper passes null when
// beta = 0). Ragged edges (M, N, K not multiples of the tile) are masked,
// never padded.
//
// Numbers. Operands, products and sums are fp32 and the products run as
// FFMA on the CUDA cores: no TF32 (Hopper's tensor cores take fp32 only as
// TF32, a 10-bit mantissa), no library call. The epilogue rounds where the
// plain version rounds, products then add, with __fmul_rn / __fadd_rn so
// that nvcc contracts nothing into an FMA:
//     D = __fadd_rn(__fmul_rn(beta, C), __fmul_rn(alpha, acc)).
// The tile is the same for every shape and a slice's arithmetic depends only
// on (M, N, K) and its own data, never on L or on the slice's place in the
// stack: a stacked launch gives each slice the bits a 2-D launch gives it.
//
// What bounds it on this card: operations. One Newton-Schulz iteration on
// an (m, n) slice costs 4*m^2*n + 2*m^3 FLOP on 8*m*n + 8*m^2 bytes, far
// above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP a byte),
// so the least time is FLOP over 67 TFLOP/s.
//
// Design, simple first. One block of 256 threads per 128 x 128 output tile
// of one slice and one chunk of K; k-tiles of 8 are staged through shared
// memory (A stored k-major, so a thread reads its 8 rows as two float4),
// double-buffered with a register prefetch of the next tile; each thread
// keeps an 8 x 8 block of fp32 accumulators, rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise, so a quarter-warp's float4 reads of
// B hit 8 consecutive 16-byte words. Global loads are scalar and masked; the
// thread map of a B tile follows B's unit stride (k for X^T, n for G and X),
// so loads stay coalesced either way.
//
// Split-K. K is cut into chunks of k_chunk (a multiple of 8; the wrapper
// passes 2048), one block each. The embedding's Gram, (768 x 50432) @
// (50432 x 768), has only 36 output tiles: unsplit it ran 36 blocks on 132
// SMs, and each output summed 50432 products in one serial FMA chain, 10x
// further from the exact sum than cuBLAS (measured on the H100). Split, it
// runs 25 chunks per tile and no chain is longer than 2048. Each block of a
// split tile writes its partial sums to a workspace; the block that arrives
// last at the tile's counter (atomicAdd after a __threadfence) adds the
// partials in chunk order 0, 1, ... from the workspace, whichever block that
// is, and runs the epilogue. The order of every sum is thus fixed by
// (M, N, K, k_chunk) alone, never by L or by the order blocks finish.
//
// What the simple design leaves on the table (ROADMAP Queue 2):
//   * split-precision TF32 on the tensor cores (three TF32 products per fp32
//     product recover fp32 accuracy) and wgmma with TMA-fed tiles;
//   * a persistent kernel or stream-K instead of fixed chunks, so that the
//     workspace round trip of split tiles goes away.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // shared rows of BM + PAD floats: conflict-free stores

struct Args {
  const float* a;
  const float* b;
  const float* c;  // null: C is not read
  float* d;        // contiguous (L, M, N)
  float* work;     // split partials, (L, splits, M, N); null when splits == 1
  int* count;      // per (l, output tile) arrivals, zeroed; null when splits == 1
  int M, N, K;
  int k_chunk, splits;
  int64_t sal, sam, sak;
  int64_t sbl, sbk, sbn;
  int64_t scl, scm, scn;
  float alpha, beta;
};

// B_KMAJOR: B's unit stride runs along k (B = X^T), so a thread's loads step
// along k; otherwise along n.
template <bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS, 2) gemm_kernel(const Args p) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  __shared__ int last_block;

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int split = blockIdx.x % p.splits;
  const int tiles_n = gridDim.x / p.splits;
  const int tile = blockIdx.y * tiles_n + blockIdx.x / p.splits;
  const int m0 = blockIdx.y * BM;
  const int n0 = (blockIdx.x / p.splits) * BN;
  const int64_t l = blockIdx.z;
  const float* __restrict__ A = p.a + l * p.sal;
  const float* __restrict__ B = p.b + l * p.sbl;
  const int k_lo = split * p.k_chunk;
  const int k_hi = min(p.K, k_lo + p.k_chunk);

  // this thread's share of a k-tile: 4 elements of A and 4 of B
  const int a_k = t % BK;
  const int a_r = t / BK;  // + 32 * i
  const int b_k = B_KMAJOR ? t % BK : t / BN;  // + (B_KMAJOR ? 0 : 2 * i)
  const int b_c = B_KMAJOR ? t / BK : t % BN;  // + (B_KMAJOR ? 32 * i : 0)
  float ra[4], rb[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + a_r + 32 * i;
      const int k = k0 + a_k;
      ra[i] = (r < p.M && k < k_hi) ? A[r * p.sam + k * p.sak] : 0.f;
      const int kb = k0 + b_k + (B_KMAJOR ? 0 : 2 * i);
      const int cb = n0 + b_c + (B_KMAJOR ? 32 * i : 0);
      rb[i] = (kb < k_hi && cb < p.N) ? B[kb * p.sbk + cb * p.sbn] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][a_k][a_r + 32 * i] = ra[i];
      Bs[buf][b_k + (B_KMAJOR ? 0 : 2 * i)][b_c + (B_KMAJOR ? 32 * i : 0)] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  if (nk > 0) {
    load(k_lo);
    store(0);
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(k_lo + (kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  const int64_t MN = static_cast<int64_t>(p.M) * p.N;
  if (p.splits > 1) {
    // park the partial sums, then let the last block of the tile finish it
    float* __restrict__ W = p.work + (l * p.splits + split) * MN;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (r < p.M && col < p.N) W[static_cast<int64_t>(r) * p.N + col] = acc[i][j];
      }
    }
    __threadfence();  // the partials are visible before the arrival is counted
    __syncthreads();
    if (t == 0) {
      const int64_t counter = l * (gridDim.y * tiles_n) + tile;
      last_block = atomicAdd(&p.count[counter], 1) == p.splits - 1;
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
  }

  float* __restrict__ D = p.d + l * MN;
  const float* __restrict__ C = p.c ? p.c + l * p.scl : nullptr;
  const float* __restrict__ W0 = p.splits > 1 ? p.work + l * p.splits * MN : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col >= p.N) continue;
      const int64_t at = static_cast<int64_t>(r) * p.N + col;
      float sum = acc[i][j];
      if (W0) {  // chunk order, read past L1 (other SMs wrote the partials)
        sum = __ldcg(W0 + at);
        for (int s = 1; s < p.splits; ++s) sum = __fadd_rn(sum, __ldcg(W0 + s * MN + at));
      }
      float out = __fmul_rn(p.alpha, sum);
      if (C) out = __fadd_rn(__fmul_rn(p.beta, C[r * p.scm + col * p.scn]), out);
      D[at] = out;
    }
  }
}

}  // namespace

// D (contiguous (L, M, N)) = alpha * A @ B + beta * C over L slices; every
// stride is in elements. c may be null (C not read). K is cut into
// ceil(K / k_chunk) chunks (k_chunk a multiple of 8); with more than one,
// work must hold L * chunks * M * N floats and count L * ceil(M / 128) *
// ceil(N / 128) zeroed ints. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int gemm_f32(const float* a, const float* b, const float* c, float* d,
                        float* work, int* count, int L, int M, int N, int K, int k_chunk,
                        long long sal, long long sam, long long sak,
                        long long sbl, long long sbk, long long sbn,
                        long long scl, long long scm, long long scn,
                        float alpha, float beta, void* stream) {
  if (L < 0 || M < 0 || N < 0 || K < 0 || L > 65535) return cudaErrorInvalidValue;
  if (k_chunk <= 0 || k_chunk % BK != 0) return cudaErrorInvalidValue;
  if (L == 0 || M == 0 || N == 0) return cudaSuccess;
  const int splits = K > k_chunk ? (K + k_chunk - 1) / k_chunk : 1;
  if (splits > 1 && (work == nullptr || count == nullptr)) return cudaErrorInvalidValue;
  const Args p{a, b, c, d, work, count, M, N, K, k_chunk, splits,
               sal, sam, sak, sbl, sbk, sbn, scl, scm, scn, alpha, beta};
  const long long grid_x = static_cast<long long>((N + BN - 1) / BN) * splits;
  const dim3 grid(static_cast<unsigned>(grid_x), (M + BM - 1) / BM, L);
  if (grid_x > 2147483647LL || grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sbn == 1 && sbk != 1)
    gemm_kernel<false><<<grid, THREADS, 0, st>>>(p);
  else
    gemm_kernel<true><<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

extern "C" const char* gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
