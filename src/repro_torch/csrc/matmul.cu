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
// What bounds it on this card: operations. One Newton-Schulz iteration on
// an (m, n) slice costs 4*m^2*n + 2*m^3 FLOP on 8*m*n + 8*m^2 bytes. The
// products run on the tensor cores as 3xTF32: three TF32 products per fp32
// product, so the least time is 3 x FLOP over the 495 TFLOP/s TF32 peak
// (an fp32 rate of 165 TFLOP/s, 2.5x the 67 of FFMA on the CUDA cores).
//
// Numbers: fp32 accuracy from TF32 products. Each operand element x is
// split into hi = tf32(x) and lo = tf32(x - hi), each rounded to nearest
// with ties away as cvt.rna.tf32.f32 rounds (x - hi is exact); together
// they hold x to 2^-22 of itself, and each product is lo.hi + hi.lo + hi.hi
// (lo.lo, below 2^-22 of the product, is dropped). hi and lo are stored
// with their low 13 bits zero, the bits the tensor cores do not read
// (CUTLASS's tfloat32_t calls them don't-care bits). The tensor cores round
// each k-step's sum at the size of the largest addend, accumulator
// included (PERF.md), so a long sum in their accumulator loses most
// where it is largest. So the accumulator
// never carries more than one k-slab of 32: each slab's 12 products go into
// a fresh accumulator, smallest first (the 8 cross products, while it is
// small, then the 4 hi.hi), and the slab sum is added to the chunk's running
// sum on the CUDA cores with __fadd_rn, slab by slab in k order. The
// epilogue rounds where the plain version rounds, products then add, with
// __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA:
//     D = __fadd_rn(__fmul_rn(beta, C), __fmul_rn(alpha, sum)).
//
// Chunks of K. K is cut into chunks of k_chunk (the wrapper's choice, a
// function of (M, N, K) alone); each chunk's sum starts from 0 and the
// chunks are added in order 0, 1, ... So the order of every sum is fixed by
// (M, N, K, k_chunk) and not by L, by the launch's layout or by the order
// in which blocks finish: a stacked launch gives each slice the bits of a
// one-slice launch, and two launches give the same bits. The layout is the
// caller's choice (split):
//   * one block per output tile runs all of the tile's chunks and keeps
//     the sum of the finished chunks in shared memory (stacks that fill the
//     card on their own, no device-memory round trip);
//   * one block per (tile, chunk) writes its chunk's sum to a workspace,
//     and the block that arrives last at the tile's counter (atomicAdd after
//     a __threadfence) adds the chunks in order from the workspace and runs
//     the epilogue (a 2-D 768 x 768 product has 36 output tiles on 132 SMs).
//
// Design, simple first. One block of two warpgroups (256 threads) per
// 128 x 128 output tile; each warpgroup owns 64 rows and issues
// wgmma.m64n128k8 on tf32 operands, which take A and B only K-major from
// shared memory. The slabs go through a two-stage shared-memory ring,
// guarded by full and empty mbarriers (every thread arrives on both). While
// the tensor cores run slab j, every thread splits its share of slab j + 1
// (loaded one iteration earlier) into hi and lo, written K-major in the
// 128-byte swizzle that the wgmma descriptors name, and loads its share of
// slab j + 2 into registers. Loads are 16 bytes along the operand's unit
// stride (k for X and for the Gram's B = X^T, n for G and X as B), so every
// launch kind reads whole lines; a view whose strides or base are not
// 16-byte multiples, and a ragged edge, take masked 4-byte loads. The split
// transposes an n-contiguous B in registers, 4 x 4 values at a time. No
// TMA: the split needs the values in registers anyway, and plain loads take
// any stride and alignment. One block runs per SM (193 KB of shared memory:
// the ring and the chunk sums).
//
// What holds it back: the split's stores and the ring's hand-off at every
// slab, not the products or the loads (PERF.md, from tools/gemm_ablation.py,
// which times this source with parts of its work taken out).
//
// Every inline-PTX operation sits behind a helper in sm90.cuh, shared with
// the flash-attention kernel; tests/test_torch_kernel_emulation.py runs this
// source on the CPU against a C++ model of those helpers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 128;      // output tile rows (two warpgroups of 64)
constexpr int BN = 128;      // output tile columns (wgmma n128)
constexpr int BK = 32;       // k-slab: 32 fp32 are one 128-byte swizzled row
constexpr int THREADS = 256;  // two warpgroups
constexpr int NSTAGE = 2;     // slabs in the shared-memory ring
constexpr int ACC = BN / 2;   // accumulator registers a thread of m64n128
constexpr int QUADS = BM * BK / (4 * THREADS);  // a thread's 4-value groups of a tile
constexpr int TILE_BYTES = BM * BK * 4;   // one of A hi, A lo, B hi, B lo (BN = BM)
constexpr int STAGE_BYTES = 4 * TILE_BYTES;
constexpr int FOLD_OFF = NSTAGE * STAGE_BYTES;  // finished chunks' sum, ACC floats a thread
constexpr int BAR_OFF = FOLD_OFF + ACC * THREADS * 4;  // full[NSTAGE], empty[NSTAGE]
constexpr int SMEM_BYTES = BAR_OFF + 2 * NSTAGE * 8 + 1024;  // + aligning the base
constexpr uint64_t SWIZZLE_128B = 1;

struct Args {
  const float* a;
  const float* b;
  const float* c;  // null: C is not read
  float* d;        // contiguous (L, M, N)
  float* work;     // chunk sums, (L, chunks, M, N); used when split
  int* count;      // per (l, output tile) arrivals, zeroed; used when split
  int M, N, K;
  int k_chunk, chunks;
  int split;         // 1: a block per (tile, chunk); 0: a block per tile
  int a_vec, b_vec;  // 16-byte loads along the operand's unit stride
  int64_t sal, sam, sak;
  int64_t sbl, sbk, sbn;
  int64_t scl, scm, scn;
  float alpha, beta;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// byte offset of element (r, k) of a BM x BK K-major tile in the 128-byte
// swizzle: 16-byte chunk k / 4 of row r lands at chunk (k / 4) ^ (r % 8)
__device__ __forceinline__ int swizzled(int r, int k) {
  return r * (BK * 4) + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return sm90::make_desc(addr, 16, 8 * BK * 4, SWIZZLE_128B);
}

// A thread's share of a 128-row (m of A, n of B) by BK tile: QUADS groups
// of 4 values along the operand's unit stride, so that a warp's 16-byte
// loads cover whole 128-byte lines (w = t / 32, lane = t % 32). K_UNIT (k
// runs along the unit stride): group i is row t / 8 + 32 i, k 4 (t % 8) ..
// + 3. Otherwise the groups are one 4 x 4 block: rows 4 g .. 4 g + 3
// (g = lane % 8 + 8 (w % 4)) at k 4 h + i (h = lane / 8 + 4 (w / 4)).
template <bool K_UNIT>
__device__ __forceinline__ void quad_at(int t, int i, int& r, int& k) {
  if (K_UNIT) {
    r = t / 8 + (THREADS / 8) * i;
    k = 4 * (t % 8);
  } else {
    r = 4 * (t % 8 + 8 * ((t / 32) % 4));
    k = 4 * ((t % 32) / 8 + 4 * (t / 128)) + i;
  }
}

// src points at (row 0, k 0) of the tile, rows and ks count the rows and
// k's inside the operand. When vec and the whole tile lies inside, every
// group is one 16-byte load at a fixed step from the first; otherwise a
// group wholly inside is one 16-byte load when vec, else four masked loads.
template <bool K_UNIT>
__device__ __forceinline__ void load_tile(float4 (&v)[QUADS], const float* __restrict__ src,
                                          int64_t s_row, int64_t s_k, int rows, int ks, bool vec,
                                          int t) {
  if (vec && rows >= BM && ks == BK) {
    int r, k;
    quad_at<K_UNIT>(t, 0, r, k);
    const float* q = src + r * s_row + k * s_k;
    const int64_t step = K_UNIT ? (THREADS / 8) * s_row : s_k;
#pragma unroll
    for (int i = 0; i < QUADS; ++i) v[i] = *reinterpret_cast<const float4*>(q + i * step);
    return;
  }
#pragma unroll
  for (int i = 0; i < QUADS; ++i) {
    int r, k;
    quad_at<K_UNIT>(t, i, r, k);
    const float* q = src + r * s_row + k * s_k;
    const int64_t step = K_UNIT ? s_k : s_row;
    const bool inside = K_UNIT ? (r < rows && k + 3 < ks) : (r + 3 < rows && k < ks);
    if (vec && inside) {
      v[i] = *reinterpret_cast<const float4*>(q);
    } else {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        e[u] = (K_UNIT ? (r < rows && k + u < ks) : (r + u < rows && k < ks)) ? q[u * step] : 0.f;
      v[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

// hi = tf32(x) and lo = tf32(x - hi), 16 bytes each into the two tiles at
// byte offset off
__device__ __forceinline__ void split_store(float x0, float x1, float x2, float x3, uint8_t* hi,
                                            uint8_t* lo, int off) {
  const float h0 = sm90::tf32_rna(x0), h1 = sm90::tf32_rna(x1);
  const float h2 = sm90::tf32_rna(x2), h3 = sm90::tf32_rna(x3);
  *reinterpret_cast<float4*>(hi + off) = make_float4(h0, h1, h2, h3);
  *reinterpret_cast<float4*>(lo + off) =
      make_float4(sm90::tf32_rna(x0 - h0), sm90::tf32_rna(x1 - h1), sm90::tf32_rna(x2 - h2),
                  sm90::tf32_rna(x3 - h3));
}

// the groups' values split into hi and lo, written K-major: a K_UNIT group
// is one 16-byte chunk of its row; otherwise the 4 x 4 block is transposed
// into four chunks, one per row
template <bool K_UNIT>
__device__ __forceinline__ void store_tile(const float4 (&v)[QUADS], uint8_t* hi, uint8_t* lo,
                                           int t) {
  int r, k;
  if (K_UNIT) {
#pragma unroll
    for (int i = 0; i < QUADS; ++i) {
      quad_at<K_UNIT>(t, i, r, k);
      split_store(v[i].x, v[i].y, v[i].z, v[i].w, hi, lo, swizzled(r, k));
    }
  } else {
    quad_at<K_UNIT>(t, 0, r, k);
    const float4 &k0 = v[0], &k1 = v[1], &k2 = v[2], &k3 = v[3];
    split_store(k0.x, k1.x, k2.x, k3.x, hi, lo, swizzled(r, k));
    split_store(k0.y, k1.y, k2.y, k3.y, hi, lo, swizzled(r + 1, k));
    split_store(k0.z, k1.z, k2.z, k3.z, hi, lo, swizzled(r + 2, k));
    split_store(k0.w, k1.w, k2.w, k3.w, hi, lo, swizzled(r + 3, k));
  }
}

// A_K / B_K: the operand's unit stride runs along k (A = X, G, P; B = X^T),
// else along m or n (B = G, X)
template <bool A_K, bool B_K>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const Args p) {
  __shared__ int last_block;
  uint8_t* const raw = sm90::dynamic_smem();
  // swizzled tiles start on a 1024-byte boundary, where the swizzle pattern
  // of the stores and of the wgmma descriptors lines up
  uint8_t* const smem = raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
  float* const fold = reinterpret_cast<float*>(smem + FOLD_OFF);
  const uint32_t bars = sm90::smem_u32(smem + BAR_OFF);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NSTAGE + st); };

  const int t = threadIdx.x;
  const int per_tile = p.split ? p.chunks : 1;
  const int tiles_n = gridDim.x / per_tile;
  const int tile = blockIdx.y * tiles_n + blockIdx.x / per_tile;
  const int m0 = blockIdx.y * BM;
  const int n0 = (blockIdx.x / per_tile) * BN;
  const int64_t l = blockIdx.z;
  const int c_lo = p.split ? blockIdx.x % per_tile : 0;
  const int c_hi = p.split ? c_lo + 1 : p.chunks;

  // the block's slabs: spc to a chunk, each chunk's from its own start; the
  // last chunk may be short, and K = 0 has none
  const int spc = (p.k_chunk + BK - 1) / BK;
  const int64_t last_lo = static_cast<int64_t>(c_hi - 1) * p.k_chunk;
  const int last_ks = static_cast<int>(min64(p.K, last_lo + p.k_chunk) - last_lo);
  const int nslab = (c_hi - 1 - c_lo) * spc + (last_ks + BK - 1) / BK;

  if (t == 0) {
    for (int st = 0; st < NSTAGE; ++st) {
      sm90::mbar_init(full(st), THREADS);
      sm90::mbar_init(empty(st), THREADS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // Every thread loads and splits its share of each slab, and issues its
  // warpgroup's products. Slab j + 1 is split into the other stage while
  // the tensor cores run slab j, and slab j + 2 is loaded into registers.
  // A stage is full once all threads have written it (fence.proxy.async,
  // then an arrival), and empty once all threads' products on it are done.
  const float* __restrict__ A = p.a + l * p.sal + m0 * p.sam;
  const float* __restrict__ B = p.b + l * p.sbl + n0 * p.sbn;
  float4 va[QUADS], vb[QUADS];
  auto fetch = [&](int j) {
    const int64_t c = c_lo + j / spc;
    const int64_t k0 = c * p.k_chunk + (j % spc) * BK;
    const int ks = static_cast<int>(min64(BK, min64(p.K, (c + 1) * p.k_chunk) - k0));
    load_tile<A_K>(va, A + k0 * p.sak, p.sam, p.sak, p.M - m0, ks, p.a_vec, t);
    load_tile<B_K>(vb, B + k0 * p.sbk, p.sbn, p.sbk, p.N - n0, ks, p.b_vec, t);
  };
  auto put = [&](int j) {
    const int st = j % NSTAGE;
    if (j >= NSTAGE) sm90::mbar_wait(empty(st), ((j / NSTAGE) & 1) ^ 1);
    uint8_t* s = smem + st * STAGE_BYTES;
    store_tile<A_K>(va, s, s + TILE_BYTES, t);
    store_tile<B_K>(vb, s + 2 * TILE_BYTES, s + 3 * TILE_BYTES, t);
    sm90::fence_proxy_async();
    sm90::mbar_arrive(full(st));
  };

  // warpgroup wg: rows 64 wg .. + 63 of the tile
  const uint32_t rows = (t / 128) * 64 * (BK * 4);
  float acc[ACC], part[ACC];  // part: the chunk's sum, then the tile's
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;
  if (nslab > 0) {
    fetch(0);
    put(0);
    if (nslab > 1) fetch(1);
  }
  for (int j = 0; j < nslab; ++j) {
    const int st = j % NSTAGE;
    sm90::mbar_wait(full(st), (j / NSTAGE) & 1);
    const uint32_t s = sm90::smem_u32(smem + st * STAGE_BYTES);
    const uint64_t a_hi = desc(s + rows), a_lo = desc(s + TILE_BYTES + rows);
    const uint64_t b_hi = desc(s + 2 * TILE_BYTES), b_lo = desc(s + 3 * TILE_BYTES);
    // the slab's sum in a fresh accumulator, smallest products first; a
    // k-step of 8 is 32 bytes along the swizzled row, 2 descriptor units
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      sm90::wgmma_tf32_m64n128k8(acc, a_lo + 2 * kk, b_hi + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      sm90::wgmma_tf32_m64n128k8(acc, a_hi + 2 * kk, b_lo + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      sm90::wgmma_tf32_m64n128k8(acc, a_hi + 2 * kk, b_hi + 2 * kk, 1);
    sm90::wgmma_commit();
    if (j + 1 < nslab) {
      put(j + 1);
      if (j + 2 < nslab) fetch(j + 2);
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(empty(st));

    // the chunk's sum, slab by slab in k order
    if (j % spc == 0) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) part[i] = acc[i];
    } else {
#pragma unroll
      for (int i = 0; i < ACC; ++i) part[i] = __fadd_rn(part[i], acc[i]);
    }
    // at a chunk's end, the finished chunks' sum in chunk order (each
    // thread reads and writes only its own words)
    if (c_hi - c_lo > 1 && (j % spc == spc - 1 || j == nslab - 1)) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        float* f = fold + i * THREADS + t;
        if (j >= spc) part[i] = __fadd_rn(*f, part[i]);
        if (j + 1 < nslab) *f = part[i];
      }
    }
  }

  // register 4 jn + 2 h + c holds row 16 (warp % 4) + lane / 4 + 8 h and
  // column 8 jn + 2 (lane % 4) + c of the warpgroup's 64 x 128 block
  const int lane = t % 32;
  const int row0 = m0 + 64 * (t / 128) + 16 * ((t % 128) / 32) + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  // element i's row, column and offset in an (M, N) matrix: two row
  // offsets and a constant, so no address is kept per element
  auto row = [&](int i) { return row0 + 8 * ((i >> 1) & 1); };
  auto col = [&](int i) { return col0 + 8 * (i >> 2) + (i & 1); };
  auto inside = [&](int i) { return row(i) < p.M && col(i) < p.N; };
  const int64_t at0 = static_cast<int64_t>(row0) * p.N + col0, at8 = at0 + 8 * p.N;
  auto at = [&](int i) { return ((i >> 1) & 1 ? at8 : at0) + 8 * (i >> 2) + (i & 1); };
  const int64_t MN = static_cast<int64_t>(p.M) * p.N;
  const bool parked = p.split && p.chunks > 1;
  if (parked) {
    // park the chunk's sum, then let the last block of the tile finish it
    float* __restrict__ W = p.work + (l * p.chunks + c_lo) * MN;
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      if (inside(i)) W[at(i)] = part[i];
    __threadfence();  // the sums are visible before the arrival is counted
    __syncthreads();
    if (t == 0) {
      const int64_t counter = l * (gridDim.y * tiles_n) + tile;
      last_block = atomicAdd(&p.count[counter], 1) == p.chunks - 1;
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
  }

  if (parked) {
    // the tile's sum in chunk order, read past L1 (other SMs wrote the
    // sums): one chunk at a time, so each chunk's loads go out together
    const float* __restrict__ W0 = p.work + l * p.chunks * MN;
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      if (inside(i)) part[i] = __ldcg(W0 + at(i));
#pragma unroll 1
    for (int s = 1; s < p.chunks; ++s) {
      const float* __restrict__ W = W0 + s * MN;
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        if (inside(i)) part[i] = __fadd_rn(part[i], __ldcg(W + at(i)));
    }
  }
  float* __restrict__ D = p.d + l * MN;
  const float* __restrict__ C = p.c ? p.c + l * p.scl : nullptr;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    if (!inside(i)) continue;
    float out = __fmul_rn(p.alpha, part[i]);
    if (C) out = __fadd_rn(__fmul_rn(p.beta, C[row(i) * p.scm + col(i) * p.scn]), out);
    D[at(i)] = out;
  }
}

template <bool A_K, bool B_K>
cudaError_t launch(const Args& p, dim3 grid, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<A_K, B_K>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_kernel<A_K, B_K><<<grid, THREADS, SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

// 16-byte loads along the unit stride: the base and every other stride are
// multiples of 16 bytes, and so is each slab's first k when k runs along it
bool vectorizable(const void* base, bool k_unit, long long s_l, long long s_row, long long s_k,
                  int L, int k_chunk) {
  const long long unit = k_unit ? s_k : s_row, other = k_unit ? s_row : s_k;
  return unit == 1 && other % 4 == 0 && (L == 1 || s_l % 4 == 0) &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0 && (!k_unit || k_chunk % 4 == 0);
}

}  // namespace

// D (contiguous (L, M, N)) = alpha * A @ B + beta * C over L slices; every
// stride is in elements. c may be null (C not read). K is cut into
// ceil(K / k_chunk) chunks (any k_chunk > 0), summed apart and added in
// order. split != 0 runs a block per (output tile, chunk); then, with more
// than one chunk, work must hold L * chunks * M * N floats and count
// L * ceil(M / 128) * ceil(N / 128) zeroed ints. Otherwise a block runs all
// chunks of its tile, with the same result bit for bit. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int gemm_f32(const float* a, const float* b, const float* c, float* d,
                        float* work, int* count, int L, int M, int N, int K, int k_chunk,
                        int split, long long sal, long long sam, long long sak,
                        long long sbl, long long sbk, long long sbn,
                        long long scl, long long scm, long long scn,
                        float alpha, float beta, void* stream) {
  if (L < 0 || M < 0 || N < 0 || K < 0 || L > 65535 || k_chunk <= 0)
    return cudaErrorInvalidValue;
  if (L == 0 || M == 0 || N == 0) return cudaSuccess;
  const int chunks = K > k_chunk ? (K - 1) / k_chunk + 1 : 1;
  split = split && chunks > 1;
  if (split && (work == nullptr || count == nullptr)) return cudaErrorInvalidValue;
  const bool a_k = !(sam == 1 && sak != 1);
  const bool b_k = !(sbn == 1 && sbk != 1);
  const Args p{a, b, c, d, work, count, M, N, K, k_chunk, chunks, split,
               vectorizable(a, a_k, sal, sam, sak, L, k_chunk),
               vectorizable(b, b_k, sbl, sbn, sbk, L, k_chunk),
               sal, sam, sak, sbl, sbk, sbn, scl, scm, scn, alpha, beta};
  const long long grid_x = static_cast<long long>((N - 1) / BN + 1) * (split ? chunks : 1);
  const dim3 grid(static_cast<unsigned>(grid_x), (M - 1) / BM + 1, L);
  if (grid_x > 2147483647LL || grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_k) return b_k ? launch<true, true>(p, grid, st) : launch<true, false>(p, grid, st);
  return b_k ? launch<false, true>(p, grid, st) : launch<false, false>(p, grid, st);
}

extern "C" const char* gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
