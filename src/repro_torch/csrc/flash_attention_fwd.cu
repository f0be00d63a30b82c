// Causal GQA flash-attention forward in bf16 for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (entry flash_attention_fwd) for bf16 q, k, v; fp32 runs on the tensor
// cores too, as 3xTF32, in csrc/flash_attention_fwd_tf32.cu. Same function:
// q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hdv) with H % K == 0, kv head
// h / (H/K) read in place; fp32 online softmax; masked scores are -1e30
// after the 1/sqrt(hd) scale; l is summed from the unrounded fp32 p; out
// (B,S,H,hdv) = acc / (l + 1e-30) in bf16. Any S: the ragged edge is masked,
// not padded. (hd, hdv) is (16, 16), (32, 32), (64, 64), (96, 96)
// (phi3-mini-3.8b's), (128, 128) (qwen3-4b's and yi-9b's), (96, 64) and
// (192, 128): MLA's q/k at nope 64 + rope 32 against its v at 64
// (minicpm3-4b) and at nope 128 + rope 64 against v at 128
// (deepseek-v2-lite), or (256, 256) (paligemma-3b's 8 query heads on one kv
// head). v may be a strided view (MLA's v is a column slice of the latent's
// up-projection): its head, row and batch strides go into its tensor map.
//
// Numbers. P.V keeps p to fp32 accuracy, as the TPU kernel's fp32 P.V does:
// P is split into three bf16 parts, hi = bf16(p), mid = bf16(p - hi) and
// lo = bf16(p - hi - mid), and P.V runs as three bf16 products. Each output
// element is held to 2^-7 of itself plus 1e-6 of the largest element:
// rounded once to bf16, P misses that by two orders of magnitude at
// S = 1024, and two parts (16 bits of p) still miss it on near-zero
// elements of non-causal rows over ~1000 keys; three parts do not
// (tests/test_torch_flash_numerics.py). A tile's three products go into a
// fresh accumulator, smallest part first, and the running sum is kept on
// the CUDA cores (acc = acc * corr + pv in fp32): the tensor cores' own
// rounding of each k-step scales with the accumulator's size, and adding
// every tile's products into the running sum put the error of near-zero
// elements over that limit. The exponentials are exp2 of scores scaled by
// log2(e) along with 1/sqrt(hd). Every build computes the same products in
// the same order as the design before it, so its outputs are the same bits.
//
// What bounds each build on this card (bf16 peak 989 TFLOP/s, 3.35 TB/s;
// "three-part" counts P.V three times, the kernel's own floor):
//   hd 64, B=8 S=1024 H=12 causal: 12.9 GFLOP (0.013 ms) against 50.3 MB
//     (0.015 ms); three-part 25.8 GFLOP, 0.026 ms.
//   hd 128, qwen3-4b's prefill (B=8 S=1024 H=32 K=8 causal): 68.8 GFLOP
//     (0.070 ms) against 168 MB (0.050 ms); three-part 137.6 GFLOP, 0.139 ms.
//   (192, 128), deepseek-v2-lite's prefill (B=8 S=1024 H=K=16 causal): 43.0
//     GFLOP (0.043 ms) against 167.8 MB (0.050 ms); three-part 77.4 GFLOP,
//     0.078 ms.
//   hd 256, paligemma-3b's prefill (B=8 S=1024 H=8 K=1 causal): 34.4 GFLOP
//     (0.035 ms) against 75.5 MB (0.023 ms); three-part 68.8 GFLOP, 0.070 ms.
//   hd 96, phi3-mini-3.8b's prefill (B=8 S=1024 H=K=32 causal): 51.5 GFLOP
//     (0.052 ms) against 201 MB (0.060 ms); three-part 103.1 GFLOP, 0.104 ms.
//   (96, 64), minicpm3-4b's prefill (B=8 S=1024 H=K=40 causal): 53.7 GFLOP
//     (0.054 ms) against 210 MB (0.063 ms); three-part 96.6 GFLOP, 0.098 ms.
// The tensor cores bound every build that keeps the three parts.
//
// Layout. One block per (128-row query tile, query head, batch), three
// warpgroups. The tensor maps are 4-D over (hd, heads, S, B), so the query
// head and the kv head are coordinates (no repeat or transpose is
// materialised) and the hardware's zero fill past S serves the ragged edge.
// Tiles are swizzled in shared memory (128 B for hd 64, 128, 192 and 256,
// 64 B for hd 32 and 96, 32 B for hd 16); the wgmma descriptors name the
// same swizzle. A swizzle span holds at most 64 bf16 values and TMA's box is
// at most one span wide, so an hd-128 tile is two column halves of 64, each
// its own swizzled sub-tile loaded by its own box, an hd-192 tile three and
// an hd-256 tile four. A 192-byte row of hd 96 is no whole number of
// 128-byte spans: its tile is three 32-column sub-tiles under the 64-byte
// swizzle, as hd 32's one (Cols), each k-step of Q.K^T 32 bytes along a
// sub-tile's row, and at hdv 96 P.V is one m64n96 product across the three
// sub-tiles of V. S =
// Q.K^T takes Q and K K-major from shared memory (bf16 x bf16 products are
// exact in fp32); the fp32 accumulator layout of S is the A-register layout
// of P.V, so P never goes to shared memory, and V is the MN-major B operand
// (the transpose bit).
//
// What held the previous design back (two consumer warpgroups and one
// producer warp), and what this one does about it:
//  1. Registers. 9 warps put 3 on one of the SM's four sub-partitions of
//     16384 registers, so every thread was capped at 168 and the hd-128 and
//     (192, 128) builds spilled 108 bytes a thread. Now warpgroup 0 is the
//     producer and drops to PRODUCER_REGS (24) with setmaxnreg.dec, and
//     warpgroups 1 and 2 are the consumers and rise to CONSUMER_REGS (240)
//     with setmaxnreg.inc: 128 x 24 + 256 x 240 = 64512 of the SM's 65536,
//     one warp of each warpgroup on each sub-partition (768 + 2 x 7680 =
//     16128 of 16384). ptxas gives each role its budget only when the branch
//     that picks it is warp-uniform (the role is read from lane 0), and a
//     trap on the consumers' path (the ring's timeout) held their main loop
//     near 174 registers whatever setmaxnreg granted: the consumers wait
//     with mbar_spin, and the producer watches the ring to its end with the
//     trapping wait. A consumer thread at hdv 128 holds acc[64], S's
//     fragment s[32], P's three parts (48) and the tile's P.V sum pv[64]:
//     208 of its 240. No build spills.
//  2. Serialised products. Each product was followed by a wait for all of
//     them, and at hdv 128 P.V ran as two 64-column halves with a wait and
//     the running-sum FMAs between them, so inside a warpgroup the tensor
//     cores, the softmax and the running sum never overlapped. Now a
//     consumer issues S_t = Q.K_t^T and then P_{t-1}.V_{t-1} (one m64n128
//     product per part and k-step at hdv 128) as two commit groups, waits
//     for S_t alone (wgmma.wait_group 1) and runs tile t's softmax while
//     the tensor cores work on tile t - 1's P.V; then it
//     waits for P.V, adds it into acc with tile t - 1's correction, and
//     splits tile t's p into the P parts that the next issue takes. The
//     softmax's results are pinned before the wait (fence_regs), which the
//     compiler would otherwise sink past it. The two consumers no longer
//     take turns at issuing: with the overlap inside each warpgroup the
//     turns gained nothing measurable (PERF.md).
//  3. Loads late. With two stages a K/V tile was reloaded only after its
//     P.V, and the next tile waited on it. Three stages (Layout::nstage)
//     keep a load one tile ahead: 32 + 3 x 32 = 128 KB at hd 128, 48 + 3 x
//     40 = 168 KB at (192, 128).
//
// hd 256 (paligemma-3b) on the same design, and what it changes. Shared
// memory: a 512-byte row is four swizzled sub-tiles; the Q tile is 64 KB
// and a K/V stage 64 KB, so three stages (256 KB) exceed the 227 KB a block
// may use and the ring has two: 64 + 2 x 64 = 192 KB. Registers: a consumer
// thread's running sum acc[] alone is 128 of its 240. The overlap of 2. holds
// S_t (32) beside P_{t-1}'s three parts (48), and a whole-width P.V sum
// would be 128 more: 336. So at hdv 256 P.V runs in four 64-column pieces
// (Layout::pv_n), each into a fresh 32-register accumulator that is added
// into acc before the next piece is issued, and each tile's S, softmax and
// P.V run in turn (Layout::overlap off): 128 + 48 + 32 = 208, and S's 32
// are dead while P.V runs. The overlap inside a warpgroup is given up; the
// other consumer warpgroup's products fill the tensor cores meanwhile. A
// split along hdv changes no element's order of sums. Alternatives timed
// with tools/flash_hd128_variants.py at paligemma's prefill shape (PERF.md):
// the overlap kept with 64-column pieces (240 registers of arrays) spills
// 300 bytes and runs 10 % slower; P.V in halves in turn (240) spills 132
// bytes, 3 % slower; 32-key tiles with the overlap and three stages (200)
// spill nothing but run 8 % slower (m64n32 products, twice the softmax
// passes a key); P's parts staged in shared memory do not fit beside two
// stages (48 KB more).
// What bounds it now (a clock64 trace of the main loop at hd 128, PERF.md):
// a tile takes a consumer warpgroup about 3200 cycles against 2048 of the
// block's tensor-core work at the peak rate; the issue of S and P.V waits on
// the tensor cores, and the split of P (48 bf16 packs) and the softmax (34
// exp2) share the SM's quarter-rate units with the other warpgroup's.
// tools/flash_hd128_variants.py times the alternatives of each choice
// (two stages, P.V at hdv 128 as two 64-column products in turn,
// PRODUCER_REGS 40 with consumers at 232) at qwen3-4b's and
// deepseek-v2-lite's prefill shapes, and hd 256's candidates above.
//
// Causal blocks are ordered heaviest query tile first, so the last wave is
// short; key tiles after the query tile are never loaded, and a consumer
// skips the tiles past its last row (it still releases their stage, once
// loaded: the ring counts both consumers' arrivals in each phase). The
// first visited tile always holds key 0, which every row sees, so no row
// meets a fully masked tile before its running max is finite. No atomics:
// two launches give the same bits.
//
// Every inline-PTX operation sits behind a helper in sm90.cuh;
// tests/test_torch_kernel_emulation.py runs this source on the CPU against a
// C++ model of those helpers.
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
constexpr int PARTS = 3;    // bf16 parts of P (fewer miss the accuracy limit)
constexpr int SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a block may use
constexpr int WARPGROUP = 128;
constexpr int CONSUMERS = 2 * WARPGROUP;       // two warpgroups of 64 rows
constexpr int THREADS = WARPGROUP + CONSUMERS;  // and the producer warpgroup
// registers a thread: the producer's, and the consumers' from what is left
// of the SM's 65536 (a multiple of 8)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = (65536 / WARPGROUP - PRODUCER_REGS) / 2 / 8 * 8;
static_assert(WARPGROUP * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= 65536, "registers");
constexpr float LOG2E = 1.4426950408889634f;

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
// span (SPAN = 64, 32 or 16, the widest that divides hd), so a sub-tile's
// layout repeats every 8 rows. K-major operands (Q, K) step 8 rows by SBO and ignore LBO; a k-step
// of 16 columns adds 32 bytes inside a sub-tile, and the step into the next
// sub-tile adds the sub-tile's bytes. The MN-major V steps 8 keys by SBO and
// one sub-tile of columns by LBO (the sub-tile's bytes), which an m64n128
// product over both sub-tiles of hdv 128 follows (m64n96 over the three of
// hdv 96).
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

// D[64 x N] (+)= P[64 x 16] . V[16 x N], P in registers, V MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 96 || N == 128, "a P.V product's width");
  if constexpr (N == 16) wgmma_bf16_m64n16k16_rs(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_bf16_m64n32k16_rs(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_bf16_m64n64k16_rs(d, a, db, scale_d);
  else if constexpr (N == 96) wgmma_bf16_m64n96k16_rs(d, a, db, scale_d);
  else wgmma_bf16_m64n128k16_rs(d, a, db, scale_d);
}

// the columns of one operand's tile: HD / span sub-tiles of span columns,
// span the widest swizzle span (64, 32 or 16 columns) that divides HD: hd
// 96 is three 32-column sub-tiles under the 64-byte swizzle
template <int HD>
struct Cols {
  static constexpr int span = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int nsub = HD / span;     // sub-tiles of a tile
  static constexpr uint32_t row = span * 2;  // bytes of a sub-tile row
  static_assert(HD % 16 == 0, "whole sub-tiles of whole k-steps");
};

// Q and K have HDQ columns, V and the output HDV
template <int HDQ, int HDV>
struct Layout {
  using QK = Cols<HDQ>;
  using V = Cols<HDV>;
  // hdv 256: the running sum alone is 128 registers a consumer thread
  static constexpr bool wide = HDV > 128;
  static constexpr int bk = 64;  // keys per K/V tile (128 measured slower, PERF.md)
  // columns of one P.V product: the whole of hdv up to 128; at hdv 256 P.V
  // runs in pieces, each added into acc before the next is issued
  static constexpr int pv_n = wide ? 64 : HDV;
  // S_t issued beside P_{t-1}.V_{t-1}, tile t's softmax under that P.V; at
  // hdv 256 a tile's S, softmax and P.V run in turn (PERF.md)
  static constexpr bool overlap = !wide;
  static constexpr int q_sub = BQ * QK::span * 2;  // bytes of a Q sub-tile
  static constexpr int k_sub = bk * QK::span * 2;  // bytes of a K sub-tile
  static constexpr int v_sub = bk * V::span * 2;   // bytes of a V sub-tile
  static constexpr int q_bytes = BQ * HDQ * 2;
  static constexpr int k_bytes = bk * HDQ * 2;     // a K stage
  static constexpr int v_bytes = bk * HDV * 2;     // a V stage
  // the Q tile, n K/V stages, their barriers and the base's alignment
  static constexpr int alloc_for(int n) {
    return q_bytes + n * (k_bytes + v_bytes) + (1 + 3 * n) * 8 + 1024;
  }
  // K/V stages in the ring: 3, or 2 where 3 do not fit (hd 256)
  static constexpr int nstage = alloc_for(3) <= SMEM_LIMIT ? 3 : 2;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + nstage * k_bytes;
  static constexpr int bar_off = v_off + nstage * v_bytes;
  // q_full, k_full[nstage], v_full[nstage], empty[nstage]
  static constexpr int bytes = bar_off + (1 + 3 * nstage) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base to 1024
  static_assert(alloc == alloc_for(nstage) && alloc <= SMEM_LIMIT, "shared memory");
  static_assert(HDV % pv_n == 0 && pv_n % V::span == 0, "P.V in whole sub-tiles");
};

struct Args {
  CUtensorMap qmap, kmap, vmap;
  bf16* o;
  int S, H, KH, B, nq, causal;
  float scale_log2;
};

template <int HDQ, int HDV>
__global__ void __launch_bounds__(THREADS, 1) fa_fwd_tc(const __grid_constant__ Args p) {
  using L = Layout<HDQ, HDV>;
  using QK = typename L::QK;
  using V = typename L::V;
  constexpr int BK = L::bk, NSTAGE = L::nstage, PN = L::pv_n;
  const int S = p.S, H = p.H, causal = p.causal;
  // swizzled tiles start on a 1024-byte boundary, where the swizzle pattern
  // of TMA and of the wgmma descriptors lines up
  const uint32_t base = (smem_u32(dynamic_smem()) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::k_off, v_s = base + L::v_off;
  const uint32_t bars = base + L::bar_off;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + NSTAGE + st); };
  auto empty_bar = [&](int st) { return bars + 8 * (1 + 2 * NSTAGE + st); };

  // heaviest causal query tiles first: the tile index is the slow one
  const int hb_count = H * p.B;
  int qt = blockIdx.x / hb_count;
  const int hb = blockIdx.x % hb_count;
  if (causal) qt = p.nq - 1 - qt;
  const int h = hb % H, b = hb / H;
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

  // the warpgroup, read from lane 0 so that the compiler sees one value in
  // every lane of a warp: each role then gets its own register budget
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WARPGROUP, 0);
  if (role == 0) {
    // the producer warpgroup: its registers go to the consumers, and one
    // lane keeps the ring full, each tile as its sub-tiles, one box of span
    // columns each
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int kh = h / (H / p.KH);
      mbar_expect_tx(q_full, L::q_bytes);
      for (int c = 0; c < QK::nsub; ++c)
        tma_load_4d(q_s + c * L::q_sub, &p.qmap, q_full, c * QK::span, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NSTAGE;
        if (t >= NSTAGE) mbar_wait(empty_bar(st), ((t / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(k_full(st), L::k_bytes);
        for (int c = 0; c < QK::nsub; ++c)
          tma_load_4d(k_s + st * L::k_bytes + c * L::k_sub, &p.kmap, k_full(st),
                      c * QK::span, kh, t * BK, b);
        mbar_expect_tx(v_full(st), L::v_bytes);
        for (int c = 0; c < V::nsub; ++c)
          tma_load_4d(v_s + st * L::v_bytes + c * L::v_sub, &p.vmap, v_full(st),
                      c * V::span, kh, t * BK, b);
      }
      // the consumers wait without a timeout (mbar_spin), so this lane
      // watches the ring to its end: the last stages' releases, with the
      // trapping wait, so that a broken ring fails the launch
      for (int t = ntiles > NSTAGE ? ntiles - NSTAGE : 0; t < ntiles; ++t)
        mbar_wait(empty_bar(t % NSTAGE), (t / NSTAGE) & 1);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63. Thread layout of
    // the m64nN fragments: warp w of the group holds rows 16 w + g and
    // 16 w + g + 8 (g = lane / 4), and in each block j of 8 columns the
    // columns 8 j + 2 (lane % 4) + {0, 1}: registers 4 j + {0, 1} for the
    // first row, 4 j + {2, 3} for the second.
    const int wg = role - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int row_a = q0 + 64 * wg + 16 * warp + lane / 4;
    const int row_b = row_a + 8;
    const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
    // the key tiles this warpgroup visits: causal, none past its last row
    const int nvisit = causal ? min(ntiles, wg_last / BK + 1) : ntiles;

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
    float corr_a = 1.f, corr_b = 1.f;  // the correction of the tile in P.V
    float s[BK / 2];                   // S of one tile, then its p
    uint32_t pp[PARTS][BK / 16][4];    // P's parts as A fragments
    float pv[PN / 2];                  // a piece of a tile's P.V

    // S_t = Q . K_t^T over hd in steps of 16 (32 bytes along the swizzled
    // row), one commit group
    auto issue_qk = [&](int t) {
      const uint64_t k_desc =
          make_desc<QK::span>(k_s + (t % NSTAGE) * L::k_bytes, 16, 8 * ROW);
#pragma unroll
      for (int kk = 0; kk < HDQ / 16; ++kk)
        wgmma_bf16_m64n64k16_ss(s, q_desc + kstep(kk, L::q_sub),
                                k_desc + kstep(kk, L::k_sub), kk);
      wgmma_commit();
    };
    // scale (with log2 e, for exp2), masks, running max over the quad, then
    // p in fp32 in place of S, l summed from it; returns tile t's
    // corrections of the running sums through ca, cb
    auto softmax = [&](int t, float& ca, float& cb) {
      const int kv0 = t * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= p.scale_log2;
      // masked: a key past S, or (causal) past the row; one uniform branch,
      // and selects inside it
      if ((causal && kv0 + BK - 1 > wg_first) || kv0 + BK > S) {
        const int last_a = causal ? min(row_a, S - 1) : S - 1;
        const int last_b = causal ? min(row_b, S - 1) : S - 1;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = kv0 + 8 * j + 2 * t4 + c;
            s[4 * j + c] = key > last_a ? NEG : s[4 * j + c];
            s[4 * j + 2 + c] = key > last_b ? NEG : s[4 * j + 2 + c];
          }
        }
      }
      float mx_a = NEG, mx_b = NEG;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          mx_a = fmaxf(mx_a, s[4 * j + c]);
          mx_b = fmaxf(mx_b, s[4 * j + 2 + c]);
        }
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      ca = ex2(m_a - mn_a);
      cb = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
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
      l_a = l_a * ca + ls_a;
      l_b = l_b * cb + ls_b;
      // done here, under the P.V in flight, not after its wait
      fence_regs(s);
      fence_regs(m_a);
      fence_regs(m_b);
      fence_regs(l_a);
      fence_regs(l_b);
      fence_regs(ca);
      fence_regs(cb);
    };
    // p as P's parts, A fragments: k-step kk covers keys 16 kk .. 16 kk +
    // 15, column blocks 2 kk and 2 kk + 1
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int off = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
          uint32_t part[PARTS];
          split_bf16x2<PARTS>(s[off], s[off + 1], part);
#pragma unroll
          for (int i = 0; i < PARTS; ++i) pp[i][kk][r] = part[i];
        }
      }
#pragma unroll
      for (int i = 0; i < PARTS; ++i) fence_regs(pp[i]);
    };
    // pv = P_lo . V + P_mid . V + P_hi . V of tile t's columns PN c .. PN c
    // + PN - 1 in a fresh accumulator, smallest part first: the tensor cores
    // add each k-step to the accumulator with their own alignment and
    // rounding, whose error scales with the accumulator's size, so no
    // product is added into the running sum of earlier tiles and the small
    // parts meet a small accumulator. A k-step of 16 keys is 16 rows of V; at
    // hdv 128 one m64n128 product spans both sub-tiles of V. One commit group.
    auto issue_pv = [&](int t, int c) {
      const uint64_t v_desc = make_desc<V::span>(
          v_s + (t % NSTAGE) * L::v_bytes + c * (PN / V::span) * L::v_sub, L::v_sub,
          8 * VROW);
#pragma unroll
      for (int i = PARTS - 1; i >= 0; --i) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<PN>(pv, pp[i][kk], v_desc + ((16 * kk * VROW) >> 4),
                       i < PARTS - 1 || kk > 0);
      }
      wgmma_commit();
    };
    // tile t's P.V retired, piece by piece (the first piece issued by the
    // caller, each later one once the piece before is added): the running
    // sum in fp32 on the CUDA cores, acc = acc * corr + pv; then tile t's
    // stage released
    auto finish_pv = [&](int t) {
#pragma unroll
      for (int c = 0; c < HDV / PN; ++c) {
        if (c > 0) {
          wgmma_fence();
          issue_pv(t, c);
        }
        wgmma_wait_group<0>();
        fence_regs(pv);
#pragma unroll
        for (int j = 0; j < PN / 8; ++j) {
          const int a = 4 * (c * (PN / 8) + j);
          acc[a + 0] = fmaf(acc[a + 0], corr_a, pv[4 * j + 0]);
          acc[a + 1] = fmaf(acc[a + 1], corr_a, pv[4 * j + 1]);
          acc[a + 2] = fmaf(acc[a + 2], corr_b, pv[4 * j + 2]);
          acc[a + 3] = fmaf(acc[a + 3], corr_b, pv[4 * j + 3]);
        }
        fence_regs(acc);
      }
#pragma unroll
      for (int i = 0; i < PARTS; ++i) fence_regs(pp[i]);  // P was read until now
      mbar_arrive(empty_bar(t % NSTAGE));
    };
    auto full_parity = [](int t) { return static_cast<uint32_t>((t / NSTAGE) & 1); };

    mbar_spin(q_full, 0);
    if constexpr (L::overlap) {
      // tile 0: S alone
      mbar_spin(k_full(0), 0);
      wgmma_fence();
      issue_qk(0);
      wgmma_wait_group<0>();
      fence_regs(s);
      softmax(0, corr_a, corr_b);
      split_p();
      // tile t's S and tile t - 1's P.V in flight together; t's softmax runs
      // under t - 1's P.V
      for (int t = 1; t < nvisit; ++t) {
        mbar_spin(k_full(t % NSTAGE), full_parity(t));
        mbar_spin(v_full((t - 1) % NSTAGE), full_parity(t - 1));
        wgmma_fence();
        issue_qk(t);
        issue_pv(t - 1, 0);
        wgmma_wait_group<1>();  // S_t
        fence_regs(s);
        float ca, cb;
        softmax(t, ca, cb);
        finish_pv(t - 1);
        corr_a = ca;
        corr_b = cb;
        split_p();
      }
      // the last visited tile's P.V
      const int last = nvisit - 1;
      mbar_spin(v_full(last % NSTAGE), full_parity(last));
      wgmma_fence();
      issue_pv(last, 0);
      finish_pv(last);
    } else {
      // each tile's S, softmax and P.V in turn: S is not held beside P's
      // parts, the P.V piece and acc (the other consumer warpgroup fills the
      // tensor cores meanwhile)
      for (int t = 0; t < nvisit; ++t) {
        mbar_spin(k_full(t % NSTAGE), full_parity(t));
        wgmma_fence();
        issue_qk(t);
        wgmma_wait_group<0>();
        fence_regs(s);
        softmax(t, corr_a, corr_b);
        split_p();
        mbar_spin(v_full(t % NSTAGE), full_parity(t));
        wgmma_fence();
        issue_pv(t, 0);
        finish_pv(t);
      }
    }
    // tiles past this warpgroup's last row: their stage, released once the
    // tile is in it. An arrival names no phase, and empty_bar counts both
    // warpgroups' arrivals: one made before the tile's load could complete
    // the phase of the tile NSTAGE before it, which the other warpgroup may
    // still be reading, and let the producer overwrite that stage.
    for (int t = nvisit; t < ntiles; ++t) {
      mbar_spin(k_full(t % NSTAGE), full_parity(t));
      mbar_spin(v_full(t % NSTAGE), full_parity(t));
      mbar_arrive(empty_bar(t % NSTAGE));
    }

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
      bf16* orow = p.o + ((static_cast<int64_t>(b) * S + row) * H + h) * HDV + 2 * t4;
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] / den, acc[4 * j + 2 * half + 1] / den);
      }
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
  Args args;
  CUresult rc = encode<HDQ>(fn, &args.qmap, q, H, S, B, BQ, HDQ, (int64_t)H * HDQ,
                            (int64_t)S * H * HDQ);
  using L = Layout<HDQ, HDV>;
  if (rc == CUDA_SUCCESS)
    rc = encode<HDQ>(fn, &args.kmap, k, KH, S, B, L::bk, HDQ, (int64_t)KH * HDQ,
                     (int64_t)S * KH * HDQ);
  if (rc == CUDA_SUCCESS) rc = encode<HDV>(fn, &args.vmap, v, KH, S, B, L::bk, vhs, vss, vbs);
  if (rc != CUDA_SUCCESS) return TENSOR_MAP_ERROR + rc;
  err = cudaFuncSetAttribute(fa_fwd_tc<HDQ, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::alloc);
  if (err != cudaSuccess) return err;
  const int nq = (S + BQ - 1) / BQ;
  const int64_t blocks = static_cast<int64_t>(nq) * H * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  args.o = static_cast<bf16*>(o);
  args.S = S;
  args.H = H;
  args.KH = KH;
  args.B = B;
  args.nq = nq;
  args.causal = causal;
  args.scale_log2 = scale * LOG2E;
  const unsigned grid = static_cast<unsigned>(blocks);
  fa_fwd_tc<HDQ, HDV><<<grid, THREADS, L::alloc, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B,S,H,hd) and k (B,S,K,hd), contiguous; v (B,S,K,hdv) with unit
// stride along hdv and head, row and batch strides vhs, vss, vbs (elements,
// multiples of 8); o (B,S,H,hdv) contiguous; every base 16-byte aligned.
// (hd, hdv) is (16, 16), (32, 32), (64, 64), (96, 96), (128, 128), (96, 64),
// (192, 128) or (256, 256); fp32 is csrc/flash_attention_fwd_tf32.cu. Returns the cudaError_t of the launch,
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
  if (hd == 256 && hdv == 256)
    return launch_tc<256, 256>(q, k, v, o, B, S, H, K, vhs, vss, vbs, causal, scale, st);
  if (hd == 96 && hdv == 96)
    return launch_tc<96, 96>(q, k, v, o, B, S, H, K, vhs, vss, vbs, causal, scale, st);
  if (hd == 96 && hdv == 64)
    return launch_tc<96, 64>(q, k, v, o, B, S, H, K, vhs, vss, vbs, causal, scale, st);
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
