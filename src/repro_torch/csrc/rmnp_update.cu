// The RMNP update for Hopper (sm_90a), CUDA C++: precondition and apply.
//
// Per contiguous stacked bucket (L, d_in, d_out), the norm over d_in for
// each column:
//
//     v_new = beta * v + (1 - beta) * g
//     d     = v_new / (||v_new||_col + eps)          precondition: v_new, d
//     w_new = w + (-scale) * (d + wd * w)            APPLY: v_new, w_new
//
// Replaces the TPU kernels repro/kernels/rmnp_update.py::_kernel3d
// (precondition) and ::_kernel3d_apply (single-pass apply); a compile-time
// APPLY selects the form. g is fp32; v (momentum) fp32 or bf16; w (weights)
// fp32 or bf16; every element's math is fp32. [scale, wd] are read from a
// device pointer, so a step reads nothing back to the host.
//
// What bounds it on this card: bytes. A few fp32 operations per element and
// no tensor core; at the main path's types (fp32 g and v, bf16 w) it must
// read g, v and w and write v and w once, 16 B per element.
//
// Design: each byte moves once. A column's norm needs all of d_in before the
// first output of that column can be written, and a column block of the
// 50432-row embedding is larger than one SM's shared memory. So a
// thread-block cluster of K blocks shares a column block: block rank r of
// the cluster that takes item (slice l, column block y) owns C columns and
// rows [r R, (r + 1) R) of slice l, with K R >= d_in.
//   1. Each block reads its slab of g and v once (16-byte loads, evict-first,
//      asking L2 for the whole 128-byte line; in batches of UNROLL rows a
//      thread, the next batch in flight while one is used), forms v_new in
//      fp32, keeps it in shared memory and sums its squares per column. The
//      first batch of w is loaded before step 2, so that it arrives while
//      the cluster reduces.
//   2. The block's per-column partial sums go to its shared memory; after a
//      cluster barrier every block reads all K partials through
//      distributed shared memory (mapa + ld.shared::cluster) and adds them
//      in rank order 0 .. K-1, so every block of the cluster holds the same
//      norm bits.
//   3. Each block writes v_new from shared memory and d, or reads w and
//      writes w_new. A second cluster barrier, arrived at after the reads
//      and waited on before the next item, keeps a block's shared memory
//      alive until its peers have read it.
// The grid's clusters take the (slice, column block) items in order, as
// many clusters as items up to 65535, each then every 65535th item after.
// Where no cluster can hold the column block (the wrapper decides), the same
// kernel with ONE_READ false keeps no slab and reads g and v a second time
// in step 3 (24 B per element); the gpt2-small buckets never take it.
//
// The split (K, R, C, threads) is the wrapper's (kernels/rmnp_update.py::
// split), a function of (d_in, d_out) alone: the order of every sum is fixed
// by it and never by L, so a stacked launch gives each slice the bits of a
// one-slice launch, and the precondition and APPLY forms give the same norm.
// The order: thread (rg, cg) of a block (cg = t % (C / 4) owns columns
// 4 cg .. 4 cg + 3, rg = t / (C / 4)) sums its rows r0 + rg + i RT
// (RT = threads / (C / 4)) in increasing i; the block adds its threads'
// sums in rg order; the cluster adds the blocks' sums in rank order.
//
// Rounding by hand, in the plain version's op order (kernels/ref.py), with
// the _rn intrinsics so that nvcc contracts nothing into an FMA:
//     v_new = __fadd_rn(__fmul_rn(beta, v), __fmul_rn(1 - beta, g))
//     d     = __fdiv_rn(v_new, __fadd_rn(__fsqrt_rn(sumsq), eps))
//     w_new = __fadd_rn(w, __fmul_rn(-scale, __fadd_rn(d, __fmul_rn(wd, w))))
// So in fp32 the APPLY form equals the precondition form followed by the
// two-pass engine's eager ops bit for bit; the sum of squares has its own
// fixed order, so d matches the plain version within rounding.
//
// What holds it back (PERF.md, from tools/rmnp_ablation.py): the reads of w
// in step 3, most of all on the embedding, whose 16-column blocks (one block
// an SM) read bf16 w in 32-byte pieces.
//
// Ragged edges (d_in, d_out, L) are masked, never padded. Loads and stores
// are 16 bytes (fp32) or 8 bytes (bf16) when the wrapper says every base is
// aligned and d_out % 4 == 0, else masked element by element; both give the
// same bits. Every inline-PTX operation sits behind a helper in sm90.cuh;
// tests/test_torch_kernel_emulation.py runs this source on the CPU with a
// cluster's blocks as threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int UNROLL = 2;        // rows of a batch; two batches in registers
constexpr int MAX_THREADS = 512;  // a block's threads
constexpr int MAX_CLUSTER = 16;   // above 8 only with the non-portable attribute

struct Args {
  const float* g;
  const void* v;
  const void* w;
  void* v_out;
  void* out;              // d (fp32) or w_new (w's type)
  const float* scalars;   // [scale, wd], read by APPLY
  int d_in, d_out;
  int rows;               // R, a block's share of d_in
  int blocks;             // column blocks of a slice, ceil(d_out / C)
  int items;              // L * blocks: the (slice, column block) pairs
  int vec;                // aligned: 16-byte (fp32) and 8-byte (bf16) accesses
  float beta, one_minus_beta, eps;
};

// four consecutive columns as fp32; n of them inside the matrix (n <= 0: none)
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float (&x)[4]) {
  if (vec && n >= 4) {
    const float4 q = sm90::ld_stream_f4(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = j < n ? p[j] : 0.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec, float (&x)[4]) {
  if (vec && n >= 4) {
    const uint2 q = sm90::ld_stream_u2(p);
    x[0] = __uint_as_float(q.x << 16);
    x[1] = __uint_as_float(q.x & 0xFFFF0000u);
    x[2] = __uint_as_float(q.y << 16);
    x[3] = __uint_as_float(q.y & 0xFFFF0000u);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = j < n ? __bfloat162float(p[j]) : 0.f;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4], int n, bool vec) {
  if (vec && n >= 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[j] = x[j];
}

// rounded to nearest even, as PyTorch's .to(torch.bfloat16)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4], int n, bool vec) {
  if (vec && n >= 4) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(bf16_bits(x[0]) | (bf16_bits(x[1]) << 16),
                                                   bf16_bits(x[2]) | (bf16_bits(x[3]) << 16)));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[j] = __float2bfloat16_rn(x[j]);
}

__device__ __forceinline__ float ema(float beta, float v, float one_minus_beta, float g) {
  return __fadd_rn(__fmul_rn(beta, v), __fmul_rn(one_minus_beta, g));
}

// dynamic shared memory, in floats: red[RT][C] (the threads' partial sums),
// part[C] (the block's, read by the cluster), den[C] (norm + eps), then
// slab[R][C] (v_new) on the one-read path
__host__ __device__ constexpr int64_t smem_bytes(int threads, int C, int rows, bool one_read) {
  return 4 * (4 * int64_t(threads) + 2 * C + (one_read ? int64_t(rows) * C : 0));
}

// One block's share of one (slice l, column block y) item.
template <int C, bool APPLY, bool ONE_READ, class TV, class TW>
__device__ __forceinline__ void update_block(const Args& a, int l, int y) {
  constexpr int TC = C / 4;  // threads across the block's columns
  const int threads = blockDim.x;
  const int RT = threads / TC;  // rows the block takes at a time
  const int t = threadIdx.x;
  const int rg = t / TC, cg = t % TC;
  const uint32_t rank = sm90::cluster_ctarank();
  const uint32_t ranks = gridDim.x;  // the cluster spans the grid's x
  const int c0 = y * C + 4 * cg;
  const int ncol = a.d_out - c0;  // this thread's columns inside the matrix (>= 4: all)
  const int r0 = static_cast<int>(rank) * a.rows;
  const int r1 = min(a.d_in, r0 + a.rows);
  const int first = r0 + rg;  // this thread's rows: first + i RT, i < n
  const int n = first < r1 ? (r1 - first + RT - 1) / RT : 0;
  const int64_t base = (static_cast<int64_t>(l) * a.d_in + first) * a.d_out + c0;
  const int64_t step = static_cast<int64_t>(RT) * a.d_out;
  const bool vec = a.vec;
  const TV* __restrict__ v = static_cast<const TV*>(a.v);
  TV* __restrict__ v_out = static_cast<TV*>(a.v_out);

  float* red = reinterpret_cast<float*>(sm90::dynamic_smem());
  float* part = red + 4 * threads;
  float* den = part + C;
  float* slab = den + C + (rg * C + 4 * cg);  // this thread's first row; + i RT C

  // Rows go in batches of UNROLL, two batches in registers: while one is
  // used, the next one's loads are in flight.
  auto load_gv = [&](float (&gq)[UNROLL][4], float (&vq)[UNROLL][4], int i0) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u < n) {
        const int64_t at = base + (i0 + u) * step;
        load4(a.g + at, ncol, vec, gq[u]);
        load4(v + at, ncol, vec, vq[u]);
      }
    }
  };

  // 1. read g and v once, form v_new, keep it, sum its squares
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  auto form = [&](const float (&gq)[UNROLL][4], const float (&vq)[UNROLL][4], int i0) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u < n) {
        float vn[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          vn[j] = ema(a.beta, vq[u][j], a.one_minus_beta, gq[u][j]);
          s[j] = __fadd_rn(s[j], __fmul_rn(vn[j], vn[j]));
        }
        if (ONE_READ)
          *reinterpret_cast<float4*>(slab + (i0 + u) * RT * C) =
              make_float4(vn[0], vn[1], vn[2], vn[3]);
      }
    }
  };
  {
    float ga[UNROLL][4], va[UNROLL][4], gb[UNROLL][4], vb[UNROLL][4];
    load_gv(ga, va, 0);
    for (int i0 = 0; i0 < n; i0 += 2 * UNROLL) {
      load_gv(gb, vb, i0 + UNROLL);
      form(ga, va, i0);
      load_gv(ga, va, i0 + 2 * UNROLL);
      form(gb, vb, i0 + UNROLL);
    }
  }

  // 3 (issued early): the first batch of w, and on the two-sweep path of g
  // and v, in flight while the cluster reduces
  const TW* __restrict__ w = static_cast<const TW*>(a.w);
  auto load3 = [&](float (&wq)[UNROLL][4], float (&gq)[UNROLL][4], float (&vq)[UNROLL][4],
                   int i0) {
    if (APPLY) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i0 + u < n) load4(w + base + (i0 + u) * step, ncol, vec, wq[u]);
    }
    if (!ONE_READ) load_gv(gq, vq, i0);
  };
  float wa[UNROLL][4], ga[UNROLL][4], va[UNROLL][4];
  load3(wa, ga, va, 0);

  // 2. the norm: the block's threads in rg order, the cluster's blocks in
  // rank order
#pragma unroll
  for (int j = 0; j < 4; ++j) red[rg * C + 4 * cg + j] = s[j];
  __syncthreads();
  if (t < C) {
    float p = 0.f;
    for (int r = 0; r < RT; ++r) p = __fadd_rn(p, red[r * C + t]);
    part[t] = p;
  }
  sm90::cluster_arrive();  // part[] released to the cluster
  sm90::cluster_wait();
  if (t < C) {
    const uint32_t addr = sm90::smem_u32(part + t);
    float peer[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < static_cast<int>(ranks)) peer[k] = sm90::ld_dsmem_f32(sm90::dsmem_map(addr, k));
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < static_cast<int>(ranks)) total = __fadd_rn(total, peer[k]);
    den[t] = __fadd_rn(__fsqrt_rn(total), a.eps);
  }
  sm90::cluster_arrive();  // done with the peers' part[]; waited on before exit
  __syncthreads();         // den[] to the block

  // 3. write v_new and d, or w_new
  float dn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) dn[j] = den[4 * cg + j];
  float neg_scale = 0.f, wd = 0.f;
  if (APPLY) {
    neg_scale = -a.scalars[0];
    wd = a.scalars[1];
  }
  auto write = [&](const float (&wq)[UNROLL][4], const float (&gq)[UNROLL][4],
                   const float (&vq)[UNROLL][4], int i0) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u < n) {
        const int64_t at = base + (i0 + u) * step;
        float vn[4], o[4];
        if (ONE_READ) {
          const float4 q = *reinterpret_cast<const float4*>(slab + (i0 + u) * RT * C);
          vn[0] = q.x;
          vn[1] = q.y;
          vn[2] = q.z;
          vn[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) vn[j] = ema(a.beta, vq[u][j], a.one_minus_beta, gq[u][j]);
        }
        store4(v_out + at, vn, ncol, vec);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float d = __fdiv_rn(vn[j], dn[j]);
          o[j] = APPLY ? __fadd_rn(wq[u][j],
                                   __fmul_rn(neg_scale, __fadd_rn(d, __fmul_rn(wd, wq[u][j]))))
                       : d;
        }
        if (APPLY)
          store4(static_cast<TW*>(a.out) + at, o, ncol, vec);
        else
          store4(static_cast<float*>(a.out) + at, o, ncol, vec);
      }
    }
  };
  {
    float wb[UNROLL][4], gb[UNROLL][4], vb[UNROLL][4];
    for (int i0 = 0; i0 < n; i0 += 2 * UNROLL) {
      load3(wb, gb, vb, i0 + UNROLL);
      write(wa, ga, va, i0);
      load3(wa, ga, va, i0 + 2 * UNROLL);
      write(wb, gb, vb, i0 + UNROLL);
    }
  }
  sm90::cluster_wait();  // no block goes on while a peer may read its part[]
}

// Cluster y of the grid takes items y, y + gridDim.y, ...; which cluster
// takes an item changes no bit of its result.
template <int C, bool APPLY, bool ONE_READ, class TV, class TW>
__global__ void __launch_bounds__(MAX_THREADS) rmnp_kernel(const Args a) {
  for (int item = blockIdx.y; item < a.items; item += gridDim.y)
    update_block<C, APPLY, ONE_READ, TV, TW>(a, item / a.blocks, item % a.blocks);
}

using Kernel = void (*)(const Args);

// precondition: 2 momentum types (w unused, TW float); apply: 2 x 2
template <int C, bool APPLY, bool ONE_READ>
Kernel pick(int v_bf16, int w_bf16) {
  if constexpr (APPLY) {
    if (v_bf16)
      return w_bf16 ? rmnp_kernel<C, APPLY, ONE_READ, __nv_bfloat16, __nv_bfloat16>
                    : rmnp_kernel<C, APPLY, ONE_READ, __nv_bfloat16, float>;
    return w_bf16 ? rmnp_kernel<C, APPLY, ONE_READ, float, __nv_bfloat16>
                  : rmnp_kernel<C, APPLY, ONE_READ, float, float>;
  }
  return v_bf16 ? rmnp_kernel<C, APPLY, ONE_READ, __nv_bfloat16, float>
                : rmnp_kernel<C, APPLY, ONE_READ, float, float>;
}

template <bool APPLY>
Kernel pick(int C, int one_read, int v_bf16, int w_bf16) {
  if (!one_read) return C == 32 ? pick<32, APPLY, false>(v_bf16, w_bf16) : nullptr;
  switch (C) {
    case 8: return pick<8, APPLY, true>(v_bf16, w_bf16);
    case 16: return pick<16, APPLY, true>(v_bf16, w_bf16);
    case 32: return pick<32, APPLY, true>(v_bf16, w_bf16);
    case 64: return pick<64, APPLY, true>(v_bf16, w_bf16);
    default: return nullptr;
  }
}

// the kernel and launch configuration of a split, with its attributes set;
// attr must outlive cfg
cudaError_t configure(int L, int d_in, int d_out, int K, int R, int C, int threads, int one_read,
                      int v_bf16, int w_bf16, int apply, cudaStream_t stream, Kernel* kernel,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int TC = C / 4;
  const int64_t items = static_cast<int64_t>(L) * ((d_out - 1) / C + 1);
  if (L < 1 || d_in < 1 || d_out < 1 || K < 1 || K > MAX_CLUSTER || R < 1 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || TC < 1 || threads % TC ||
      static_cast<int64_t>(K) * R < d_in || items > 2147483647LL)
    return cudaErrorInvalidValue;
  const int64_t grid_y = items < 65535 ? items : 65535;
  *kernel = apply ? pick<true>(C, one_read, v_bf16, w_bf16)
                  : pick<false>(C, one_read, v_bf16, w_bf16);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(threads, C, R, one_read);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (K > 8) {
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(K, static_cast<unsigned>(grid_y), 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// One launch over a contiguous (L, d_in, d_out) bucket: g fp32; v and v_out
// of the momentum's type (v_bf16); w and, when apply, out of the weights'
// type (w_bf16); without apply out is d (fp32) and w is not read. scalars
// [scale, wd] on the device (read when apply). The split: clusters of K
// blocks along d_in, R rows and C columns (8, 16, 32 or 64) a block,
// `threads` a block; one_read 0 (C = 32 only) reads g and v twice and keeps
// no slab. vec: every base is 16-byte aligned and d_out % 4 == 0. The
// outputs may not alias the inputs (the loads are ordered as reads of
// memory no one writes). Launches on `stream` and returns the cudaError_t
// of the launch (0 on success).
extern "C" int rmnp_update(const float* g, const void* v, const void* w, void* v_out, void* out,
                           const float* scalars, int L, int d_in, int d_out, int K, int R, int C,
                           int threads, int one_read, int vec, int v_bf16, int w_bf16,
                           int apply, float beta, float one_minus_beta, float eps,
                           void* stream) {
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(L, d_in, d_out, K, R, C, threads, one_read, v_bf16, w_bf16, apply,
                              static_cast<cudaStream_t>(stream), &kernel, &cfg, &attr);
  if (err != cudaSuccess) return err;
  const int blocks = (d_out - 1) / C + 1;
  const Args args{g, v, w, v_out, out, scalars, d_in, d_out, R, blocks, L * blocks, vec,
                  beta, one_minus_beta, eps};
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of this split the card can hold at once
// (cudaOccupancyMaxActiveClusters); 0 means none can be scheduled.
extern "C" int rmnp_max_active_clusters(int L, int d_in, int d_out, int K, int R, int C,
                                        int threads, int one_read, int v_bf16, int w_bf16,
                                        int apply, int* clusters) {
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(L, d_in, d_out, K, R, C, threads, one_read, v_bf16, w_bf16, apply,
                              nullptr, &kernel, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

extern "C" const char* rmnp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
