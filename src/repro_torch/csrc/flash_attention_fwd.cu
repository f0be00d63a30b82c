// Causal GQA flash-attention forward in bf16 for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (entry flash_attention_fwd) for bf16 q, k, v; fp32 runs on the tensor
// cores too, as 3xTF32, in csrc/flash_attention_fwd_tf32.cu. Same function:
// q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hdv) with H % K == 0, kv head
// h / (H/K) read in place; fp32 online softmax; masked scores are -1e30
// after the 1/sqrt(hd) scale; l is summed from the unrounded fp32 p; out
// (B,S,H,hdv) = acc / (l + 1e-30) in bf16. Any S: the ragged edge is masked,
// not padded. (hd, hdv) is (16, 16), (32, 32), (64, 64), (128, 128)
// (qwen3-4b's and yi-9b's) or (192, 128): MLA's q/k at nope 128 + rope 64
// against its v at 128 (deepseek-v2-lite). v may be a strided view (MLA's v
// is a column slice of the latent's up-projection): its head, row and batch
// strides go into its tensor map.
//
// What bounds it on this card. At the main path's shape (B=8, S=1024,
// H=12, hd=64, causal) the function reads 37.7 MB of q/k/v and writes 12.6
// MB of output (0.015 ms at 3.35 TB/s) and does 4*B*H*hd*S(S+1)/2 = 12.9
// GFLOP (0.013 ms at the 989 TFLOP/s bf16 peak): bytes and operations are
// about even, so the tensor cores are what a kernel has to reach.
//
// The tensor-core kernel (fa_fwd_tc). One block per (128-row query
// tile, query head, batch): two consumer warpgroups of 64 rows each and one
// producer warp. The producer issues TMA loads: Q once, and K/V tiles of 64
// keys into a ring of 2 stages guarded by full/empty mbarriers. The
// tensor maps are 4-D over (hd, heads, S, B), so the query head and the kv
// head are coordinates (no repeat or transpose is materialised) and the
// hardware's zero fill past S serves the ragged edge. Tiles are swizzled in
// shared memory (128 B for hd 64 and up, 64 B for hd 32, 32 B for hd 16);
// the wgmma descriptors name the same swizzle. A swizzle span holds at most
// 64 bf16 values, and TMA's box is at most one span wide, so an hd-128 tile
// is two column halves of 64, each its own swizzled sub-tile loaded by its
// own box (coordinate 0 or 64 along hd), and an hd-192 tile three. Each
// consumer computes S = Q.K^T with wgmma (Q and K K-major from shared memory, fp32
// accumulators; bf16 x bf16 products are exact in fp32), applies the scale
// and the masks (the causal mask only on tiles that cross the diagonal, the
// key mask only past S), and runs the online softmax in registers, with
// row maxima and sums over the 4 lanes of a quad; l is summed from the
// fp32 p. The exponentials are exp2 of scores scaled by log2(e) along with
// 1/sqrt(hd).
//
// P.V keeps p to fp32 accuracy, as the TPU kernel's fp32 P.V does: P is
// split into three bf16 parts, hi = bf16(p), mid = bf16(p - hi) and
// lo = bf16(p - hi - mid), and P.V runs as three bf16 wgmma. Each output
// element is held to 2^-7 of itself plus 1e-6 of the largest element:
// rounded once to bf16, P misses that by two orders of magnitude at
// S = 1024, and two parts (16 bits of p) still miss it on near-zero
// elements of non-causal rows over ~1000 keys; three parts do not. A
// tile's three products go into a fresh accumulator, smallest part first,
// and the running sum is kept on the CUDA cores (acc = acc * corr + pv in
// fp32): the tensor cores' own rounding of each k-step scales with the
// accumulator's size, and adding every tile's products into the running
// sum put the error of near-zero elements over that limit. The fp32
// accumulator layout of the first wgmma is the A-register layout of the
// second, so P never goes to shared memory; V is the MN-major B operand
// (the transpose bit). The split makes the kernel's own operation floor
// 2 x 12.9 = 25.8 GFLOP, 0.026 ms at the bf16 peak.
//
// hd 128 (qwen3-4b's prefill: B=8, S=1024, H=32, K=8, causal) does
// 4*B*H*hd*S(S+1)/2 = 68.8 GFLOP (0.070 ms at the bf16 peak; 137.5 with P
// in three parts, 0.139 ms) and moves 168 MB (0.050 ms): the tensor cores
// bound it. Per consumer thread it holds acc[64], S's fragment s[32], P's
// three parts (48 registers) and a P.V tile sum of 32 (one atom of V) against a
// cap of 168 registers a thread: the block's 9 warps leave 3 on one of the
// SM's four sub-partitions, whose 16384 registers give 170 a thread (the
// card refuses a launch at 175). ptxas spills 108 bytes a thread; the
// report is printed by phase B of chip_smoke.py.
//
// (192, 128) (deepseek-v2-lite's prefill: B=8, S=1024, H=K=16, causal)
// moves 167.8 MB (0.050 ms) and does 43.0 GFLOP, 25.8 of them in Q.K^T
// (0.043 ms at the bf16 peak; 77.4 GFLOP, 0.078 ms, with P in three parts):
// bytes bound it. Q.K^T runs 12 k-steps over three 64-column sub-tiles; the
// O accumulator, P and the P.V products follow hdv = 128 exactly as the
// hd-128 build, so its registers are that build's. Q takes 48 KB of shared
// memory, a K stage 24 KB and a V stage 16 KB: 128 KB with two stages.
//
// The two consumer warpgroups take turns at issuing their products
// (named barriers), so one's softmax overlaps the other's products.
// Causal blocks are ordered heaviest query tile first, so the last wave is
// short; key tiles after the query tile are never loaded, and a warpgroup
// skips the tiles past its last row. The first visited tile always holds
// key 0, which every row sees, so no row meets a fully masked tile before
// its running max is finite.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float NEG = -1e30f;

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;     // query rows per block
constexpr int BK = 64;      // keys per K/V tile (128 measured slower, PERF.md)
constexpr int NSTAGE = 2;   // K/V stages in the ring
constexpr int PARTS = 3;    // bf16 parts of P (fewer miss the accuracy limit)
constexpr int CONSUMERS = 256;         // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

// Turns of the two consumer warpgroups at the tensor cores (named barriers
// 1 and 2, 256 threads each): warpgroup wg waits for its turn before it
// issues a product and passes the turn on after, so the products are
// issued S0 S1 PV0 PV1 ... and one warpgroup's softmax runs while the
// other's products do. Both wait on the same K/V tiles, and without the
// turns they run in step: both in softmax while the tensor cores idle.
__device__ __forceinline__ void turn_wait(int wg) { bar_sync(1 + wg, CONSUMERS); }
__device__ __forceinline__ void turn_pass(int wg) { bar_arrive(2 - wg, CONSUMERS); }

// N bf16x2 pairs that sum to two fp32 values: part 0 = bf16(x), part i
// = bf16(x - parts 0..i-1) (each difference is exact in fp32), so three
// parts hold 24 bits; the first value goes to the low half, as the A
// fragment wants it
template <int N>
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    part[i] = *reinterpret_cast<const uint32_t*>(&h);
    if (i + 1 < N) {
      const float2 hf = __bfloat1622float2(h);
      x0 -= hf.x;
      x1 -= hf.y;
    }
  }
}

// Shared-memory matrix descriptor of a wgmma operand: start address, leading
// and stride byte offsets (16-byte units) and the swizzle (1: 128 B, 2: 64
// B, 3: 32 B), chosen by the span. A tile of HD columns is stored as HD /
// SPAN sub-tiles of SPAN columns, each row of a sub-tile exactly one swizzle
// span (SPAN = hd up to 64, else 64), so a sub-tile's layout repeats every 8
// rows. K-major operands (Q, K) step 8 rows by SBO and ignore LBO; a k-step
// of 16 columns adds 32 bytes inside a sub-tile, and the step into the next
// sub-tile adds the sub-tile's bytes. The MN-major V steps 8 keys by SBO; no
// P.V product's N spans more than one atom (hdv 128 runs two 64-column
// products, one per atom), so LBO is not followed.
template <int SPAN>
struct Swizzle;
template <>
struct Swizzle<64> {
  static constexpr uint64_t desc = 1;
  static constexpr CUtensorMapSwizzle tma = CU_TENSOR_MAP_SWIZZLE_128B;
};
template <>
struct Swizzle<32> {
  static constexpr uint64_t desc = 2;
  static constexpr CUtensorMapSwizzle tma = CU_TENSOR_MAP_SWIZZLE_64B;
};
template <>
struct Swizzle<16> {
  static constexpr uint64_t desc = 3;
  static constexpr CUtensorMapSwizzle tma = CU_TENSOR_MAP_SWIZZLE_32B;
};

template <int SPAN>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return sm90::make_desc(addr, lbo, sbo, Swizzle<SPAN>::desc);
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] (+)= A[64 x 16] . B[16 x 16], A in registers, B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A in registers, B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers, B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "a P.V product spans one atom of V");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
  else wgmma_rs_n64(d, a, db, scale_d);
}

// the columns of one operand's tile: HD / span sub-tiles of span columns
template <int HD>
struct Cols {
  static constexpr int span = HD < 64 ? HD : 64;  // columns of a sub-tile
  static constexpr int nsub = HD / span;           // sub-tiles of a tile
  static constexpr uint32_t row = span * 2;        // bytes of a sub-tile row
  static_assert(HD % span == 0 && HD % 16 == 0, "whole sub-tiles of whole k-steps");
};

// Q and K have HDQ columns, V and the output HDV
template <int HDQ, int HDV>
struct Layout {
  using QK = Cols<HDQ>;
  using V = Cols<HDV>;
  static constexpr int q_sub = BQ * QK::span * 2;  // bytes of a Q sub-tile
  static constexpr int k_sub = BK * QK::span * 2;  // bytes of a K sub-tile
  static constexpr int v_sub = BK * V::span * 2;   // bytes of a V sub-tile
  static constexpr int q_bytes = BQ * HDQ * 2;
  static constexpr int k_bytes = BK * HDQ * 2;     // a K stage
  static constexpr int v_bytes = BK * HDV * 2;     // a V stage
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + NSTAGE * k_bytes;
  static constexpr int bar_off = v_off + NSTAGE * v_bytes;
  // q_full, k_full[NSTAGE], v_full[NSTAGE], empty[NSTAGE]
  static constexpr int bytes = bar_off + (1 + 3 * NSTAGE) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base to 1024
};

template <int HDQ, int HDV>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int S, int H, int KH,
          int B, int nq, int causal, float scale_log2) {
  using L = Layout<HDQ, HDV>;
  using QK = typename L::QK;
  using V = typename L::V;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on a 1024-byte boundary, where the swizzle pattern
  // of TMA and of the wgmma descriptors lines up
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::k_off, v_s = base + L::v_off;
  const uint32_t bars = base + L::bar_off;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + NSTAGE + st); };
  auto empty_bar = [&](int st) { return bars + 8 * (1 + 2 * NSTAGE + st); };

  // heaviest causal query tiles first: the tile index is the slow one
  const int hb_count = H * B;
  int qt = blockIdx.x / hb_count;
  const int hb = blockIdx.x % hb_count;
  if (causal) qt = nq - 1 - qt;
  const int h = hb % H, b = hb / H;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty_bar(st), CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= CONSUMERS / 32) {
    // producer warp: one lane keeps the ring full
    // each tile as its sub-tiles, one box of span columns each
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int c = 0; c < QK::nsub; ++c)
        tma_load_4d(q_s + c * L::q_sub, &qmap, q_full, c * QK::span, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NSTAGE;
        if (t >= NSTAGE) mbar_wait(empty_bar(st), ((t / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(k_full(st), L::k_bytes);
        for (int c = 0; c < QK::nsub; ++c)
          tma_load_4d(k_s + st * L::k_bytes + c * L::k_sub, &kmap, k_full(st),
                      c * QK::span, kh, t * BK, b);
        mbar_expect_tx(v_full(st), L::v_bytes);
        for (int c = 0; c < V::nsub; ++c)
          tma_load_4d(v_s + st * L::v_bytes + c * L::v_sub, &vmap, v_full(st),
                      c * V::span, kh, t * BK, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63. Thread layout of
  // the m64nN fragments: warp w of the group holds rows 16 w + g and
  // 16 w + g + 8 (g = lane / 4), and in each block j of 8 columns the
  // columns 8 j + 2 (lane % 4) + {0, 1}: registers 4 j + {0, 1} for the
  // first row, 4 j + {2, 3} for the second.
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int row_a = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int row_b = row_a + 8;
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;

  constexpr uint32_t ROW = QK::row;  // bytes per row of a Q or K sub-tile
  constexpr uint32_t VROW = V::row;  // bytes per row of a V sub-tile
  const uint64_t q_desc = make_desc<QK::span>(q_s + 64 * wg * ROW, 16, 8 * ROW);
  // the descriptor offset (16-byte units) of k-step kk of 16 columns in a
  // K-major tile whose sub-tiles are sub_bytes apart
  auto kstep = [](int kk, int sub_bytes) {
    constexpr int per_sub = QK::span / 16;
    return static_cast<uint64_t>(((kk / per_sub) * sub_bytes + (kk % per_sub) * 32) >> 4);
  };

  float acc[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) acc[i] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;  // l: this thread's share

  mbar_wait(q_full, 0);
  if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % NSTAGE;
    const uint32_t ph = (t / NSTAGE) & 1;
    const int kv0 = t * BK;
    mbar_wait(k_full(st), ph);
    if (causal && kv0 > wg_last) {  // every key of the tile is after every row
      mbar_wait(v_full(st), ph);
      mbar_arrive(empty_bar(st));
      turn_wait(wg);  // its two turns, so the other warpgroup's go on
      turn_pass(wg);
      turn_wait(wg);
      turn_pass(wg);
      continue;
    }

    // S = Q . K^T over hd in steps of 16 (32 bytes along the swizzled row)
    float s[BK / 2];
    const uint64_t k_desc = make_desc<QK::span>(k_s + st * L::k_bytes, 16, 8 * ROW);
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDQ / 16; ++kk)
      wgmma_ss_n64(s, q_desc + kstep(kk, L::q_sub), k_desc + kstep(kk, L::k_sub), kk);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait_all();
    fence_regs(s);

    // scale (with log2 e, for exp2), masks, running max over the quad
    const bool masked = (causal && kv0 + BK - 1 > wg_first) || kv0 + BK > S;
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float xa = s[4 * j + c] * scale_log2;
        float xb = s[4 * j + 2 + c] * scale_log2;
        if (masked) {
          const int key = kv0 + 8 * j + 2 * t4 + c;
          if (key >= S || (causal && key > row_a)) xa = NEG;
          if (key >= S || (causal && key > row_b)) xb = NEG;
        }
        s[4 * j + c] = xa;
        s[4 * j + 2 + c] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = ex2(m_a - mn_a), corr_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // p in fp32, l summed from it, then P as (hi, lo) A fragments: k-step
    // kk covers keys 16 kk .. 16 kk + 15, column blocks 2 kk and 2 kk + 1
    float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[4 * j + c] = ex2(s[4 * j + c] - mn_a);
        s[4 * j + 2 + c] = ex2(s[4 * j + 2 + c] - mn_b);
        ls_a += s[4 * j + c];
        ls_b += s[4 * j + 2 + c];
      }
    }
    l_a = l_a * corr_a + ls_a;
    l_b = l_b * corr_b + ls_b;
    uint32_t p[PARTS][BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int off = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        uint32_t part[PARTS];
        split_bf16x2<PARTS>(s[off], s[off + 1], part);
#pragma unroll
        for (int i = 0; i < PARTS; ++i) p[i][kk][r] = part[i];
      }
    }
    // pv = P_lo . V + P_mid . V + P_hi . V in a fresh accumulator, smallest
    // part first: the tensor cores add each k-step to the accumulator with
    // their own alignment and rounding, whose error scales with the
    // accumulator's size, so no product is added into the running sum of
    // earlier tiles and the small parts meet a small accumulator. V is the
    // MN-major B operand; a k-step of 16 keys is 16 of its rows.
    // At hdv 128 the columns go in two products, one per atom of V, each
    // finished and added before the next is issued, so only half the tile
    // sum is live at once (one m64n128 product over both atoms spilled twice
    // as much and ran 2-3 % slower, PERF.md).
    mbar_wait(v_full(st), ph);
    constexpr int PV_N = HDV <= 64 ? HDV : 64;
    const uint64_t v_desc = make_desc<V::span>(v_s + st * L::v_bytes, L::v_sub, 8 * VROW);
#pragma unroll
    for (int i = 0; i < PARTS; ++i) fence_regs(p[i]);
    turn_wait(wg);
#pragma unroll
    for (int c = 0; c < HDV / PV_N; ++c) {
      float pv[PV_N / 2];
      wgmma_fence();
#pragma unroll
      for (int i = PARTS - 1; i >= 0; --i) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<PV_N>(pv, p[i][kk],
                         v_desc + ((c * L::v_sub + 16 * kk * VROW) >> 4),
                         i < PARTS - 1 || kk > 0);
      }
      wgmma_commit();
      if (c == HDV / PV_N - 1) turn_pass(wg);
      wgmma_wait_all();
      fence_regs(pv);
      if (c == HDV / PV_N - 1) mbar_arrive(empty_bar(st));

      // the running sum in fp32 on the CUDA cores: acc = acc * corr + pv
#pragma unroll
      for (int j = 0; j < PV_N / 8; ++j) {
        const int a = 4 * (c * PV_N / 8 + j);
        acc[a + 0] = fmaf(acc[a + 0], corr_a, pv[4 * j + 0]);
        acc[a + 1] = fmaf(acc[a + 1], corr_a, pv[4 * j + 1]);
        acc[a + 2] = fmaf(acc[a + 2], corr_b, pv[4 * j + 2]);
        acc[a + 3] = fmaf(acc[a + 3], corr_b, pv[4 * j + 3]);
      }
    }
  }

  if (wg == 0) turn_wait(wg);  // the turn warpgroup 1 passed at the start

  // epilogue: l over the quad, out = acc / (l + 1e-30), rows < S only
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float den_a = l_a + 1e-30f, den_b = l_b + 1e-30f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= S) continue;
    const float den = half ? den_b : den_a;
    bf16* orow = o + ((static_cast<int64_t>(b) * S + row) * H + h) * HDV + 2 * t4;
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] / den, acc[4 * j + 2 * half + 1] / den);
    }
  }
}

// a 4-D map over (hd, heads, S, B) of a (B, S, heads, hd) bf16 tensor whose
// head, row and batch strides (elements) are hs, ss and bs; the box is
// (span, 1, rows, 1), one sub-tile, past S the hardware fills zeros
template <int HD>
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int heads, int S, int B,
                int rows, int64_t hs, int64_t ss, int64_t bs) {
  const cuuint64_t dims[4] = {HD, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hs * 2, (cuuint64_t)ss * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {Cols<HD>::span, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, Swizzle<Cols<HD>::span>::tma,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HDQ, int HDV>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KH,
              int64_t vhs, int64_t vss, int64_t vbs, int causal, float scale,
              cudaStream_t stream) {
  EncodeTiled fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  CUresult rc = encode<HDQ>(fn, &qm, q, H, S, B, BQ, HDQ, (int64_t)H * HDQ,
                            (int64_t)S * H * HDQ);
  if (rc == CUDA_SUCCESS)
    rc = encode<HDQ>(fn, &km, k, KH, S, B, BK, HDQ, (int64_t)KH * HDQ, (int64_t)S * KH * HDQ);
  if (rc == CUDA_SUCCESS) rc = encode<HDV>(fn, &vm, v, KH, S, B, BK, vhs, vss, vbs);
  if (rc != CUDA_SUCCESS) return TENSOR_MAP_ERROR + rc;
  using L = Layout<HDQ, HDV>;
  err = cudaFuncSetAttribute(fa_fwd_tc<HDQ, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::alloc);
  if (err != cudaSuccess) return err;
  const int nq = (S + BQ - 1) / BQ;
  const int64_t blocks = static_cast<int64_t>(nq) * H * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fa_fwd_tc<HDQ, HDV><<<static_cast<unsigned>(blocks), THREADS, L::alloc, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), S, H, KH, B, nq, causal, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B,S,H,hd) and k (B,S,K,hd), contiguous; v (B,S,K,hdv) with unit
// stride along hdv and head, row and batch strides vhs, vss, vbs (elements,
// multiples of 8); o (B,S,H,hdv) contiguous; every base 16-byte aligned.
// (hd, hdv) is (16, 16), (32, 32), (64, 64), (128, 128) or (192, 128); fp32
// is csrc/flash_attention_fwd_tf32.cu. Returns the cudaError_t of the launch,
// or TENSOR_MAP_ERROR + a CUresult (0 on success); the caller raises on
// anything else, an unbuilt (hd, hdv) included.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int H, int K, int hd, int hdv, long long vhs, long long vss,
                      long long vbs, int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  if (vhs % 8 || vss % 8 || vbs % 8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 16 && hdv == 16)
    return launch_tc<16, 16>(q, k, v, o, B, S, H, K, vhs, vss, vbs, causal, scale, st);
  if (hd == 32 && hdv == 32)
    return launch_tc<32, 32>(q, k, v, o, B, S, H, K, vhs, vss, vbs, causal, scale, st);
  if (hd == 64 && hdv == 64)
    return launch_tc<64, 64>(q, k, v, o, B, S, H, K, vhs, vss, vbs, causal, scale, st);
  if (hd == 128 && hdv == 128)
    return launch_tc<128, 128>(q, k, v, o, B, S, H, K, vhs, vss, vbs, causal, scale, st);
  if (hd == 192 && hdv == 128)
    return launch_tc<192, 128>(q, k, v, o, B, S, H, K, vhs, vss, vbs, causal, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int err) {
  if (err >= sm90::TENSOR_MAP_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - sm90::TENSOR_MAP_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
