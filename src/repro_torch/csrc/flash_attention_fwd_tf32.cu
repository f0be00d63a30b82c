// Causal GQA flash-attention forward in fp32 on Hopper's tensor cores
// (sm_90a), CUDA C++: 3xTF32 on wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (entry flash_attention_fwd) for fp32 q, k, v; csrc/flash_attention_fwd.cu
// holds the bf16 kernel. Same function: q (B,S,H,hd), k (B,S,K,hd), v
// (B,S,K,hdv) with H % K == 0, kv head h / (H/K) read in place; fp32 online
// softmax; masked scores are -1e30 after the 1/sqrt(hd) scale; l is summed
// from the unrounded fp32 p; out (B,S,H,hdv) = acc / (l + 1e-30). Any S: the
// ragged edge is masked, not padded. (hd, hdv) is (16, 16), (32, 32),
// (64, 64), (96, 96) (phi3-mini-3.8b), (128, 128) (qwen3-4b, yi-9b,
// olmoe-1b-7b, jamba), (96, 64) and (192, 128) (MLA: minicpm3-4b and
// deepseek-v2-lite-16b) or (256, 256) (paligemma-3b). v is read through its
// head, row and batch strides (16-byte multiples), so MLA's v, a column
// slice of the up-projection, is read in place, with no copy.
//
// What bounds it on this card: operations. The tensor cores take fp32 only
// as TF32 (10 mantissa bits), and fp32 callers are held at 1e-5 of each
// element, so every product here is three TF32 products (3xTF32), whose floor
// is 3 x 2 B H S(S+1)/2 (hd + hdv) FLOP (causal) over the 495 TFLOP/s TF32
// peak. At B=8, S=1024, causal: gpt2-small (H=12, 64/64) 12.9 GFLOP, 0.078
// ms (100 MB of q/k/v/out, 0.030 ms at 3.35 TB/s; on the CUDA cores' FFMA,
// 67 TFLOP/s, 0.19 ms); qwen3-4b (H=32 K=8, 128/128) 0.417 ms; phi3-mini
// (H=K=32, 96/96) 0.313 ms; minicpm3-4b (H=K=40, 96/64) 0.326 ms;
// deepseek-v2-lite (H=K=16, 192/128) 0.261 ms; paligemma-3b (H=8 K=1,
// 256/256) 0.209 ms. Each moves at most 210 MB (0.063 ms).
//
// Numbers. Each operand x is split into hi = tf32(x) and lo = tf32(x - hi),
// each rounded to nearest with ties away (x - hi is exact), and each product
// is lo.hi + hi.lo + hi.hi (lo.lo, below 2^-22 of the product, is dropped),
// the small products first into a fresh accumulator. The tensor cores round
// each k-step of 8 at the size of the largest addend, accumulator included,
// so no accumulator carries a long sum: S = Q.K^T takes one accumulator per
// 32 of hd, added in turn in fp32 on the CUDA cores (hd 256: eight; one
// accumulator over all 64 of hd 64 already misses the limit on near-zero
// outputs of non-causal rows), and each key tile's P.V starts a fresh
// accumulator that the running sum takes on the CUDA cores,
// acc = acc * corr + pv in fp32 (tests/test_torch_flash_tf32_numerics.py
// models this arithmetic and both controls). The exponentials are exp2 of
// scores scaled by log2(e) along with 1/sqrt(hd). Every build computes each
// output element with the same operations in the same order, so how a build
// cuts the work (by span, by piece of hdv) changes no bit.
//
// Every inline-PTX operation sits behind a helper in sm90.cuh;
// tests/test_torch_kernel_emulation.py runs this source on the CPU against a
// C++ model of those helpers.
//
// Layout. One block per (query tile of Layout::bq rows, query head,
// batch): Layout::cw consumer warpgroups of 64 rows each and one producer
// warpgroup. Every operand is K-major in the 128-byte swizzle that the wgmma
// descriptors name, one span of at most 32 values of a row at a time (hd 16
// uses half of each 128-byte row). The consumers split their Q rows into Q hi
// and Q lo in shared memory once; Q stays there. tf32 has no transposed
// form, so V cannot be the MN-major B operand the bf16 kernel uses: the
// producer transposes V, 4 x 4 values in registers, into V^T, whose rows
// are hdv and whose columns are keys. Keys come in tiles of 64, and a tile
// reaches the consumers through a ring of 16 KB slots guarded by full/empty
// mbarriers, each slot one span of the tile's K (64 keys x min(hd, 32)
// columns, hi and lo) or one piece of its V^T (min(hdv, 32) rows x 64 keys,
// hi and lo): hd / 32 K slots and then hdv / 32 V^T slots (hd 16: one of
// each). The producer loads a slot's values into registers (16-byte loads;
// zeros past S), splits them and stores them, with two slots' loads in
// flight. A consumer warpgroup takes the K slots one at a time into a fresh
// accumulator each (wgmma m64n64k8 from shared memory; span 0 straight into
// S's sum) and adds each into S on the CUDA cores after its wait; it
// applies the scale and the masks (the causal mask only on tiles that cross
// the diagonal, the key mask only past S) and runs the online softmax in
// registers, with row maxima and sums over the 4 lanes of a quad; then it
// takes each V^T piece as three m64n{min(hdv, 32)}k8 products a k-step of 8
// keys, P from registers, into a fresh piece of pv, adds it into its
// columns of acc (acc = acc * corr + pv) and releases the slot. The
// accumulator of S gives a thread keys 2c and 2c + 1 of each 8, where the
// tf32 A fragment wants c and c + 4, so the producer stores each 8 keys of
// V^T in the order 0 2 4 6 1 3 5 7 and P's registers are the A fragment as
// they are, no shuffle. The two consumer warpgroups wait on their own
// products, and the other's fill the tensor cores meanwhile.
//
// Why a ring of spans. Whole tiles would hold Q hi+lo of 128 rows (hd KB)
// and two stages of K and V^T hi/lo ((hd + hdv) KB each): 192 KB at hd 64
// but 384 KB at (128, 128), of the 227 KB a block may use. Slots of
// one span keep Q resident at every build; the same products in the same
// order keep every element's bits (and hd 64's time: tools/
// flash_tf32_variants.py, PERF.md). Query rows per block (Layout::cw
// consumer warpgroups of 64), slots in the ring (Layout::nslot) and bytes:
//   (16, 16), (32, 32)   2 warpgroups, Q 32 KB + 12 slots = 224 KB
//   (64, 64)             2 warpgroups, Q 64 KB + 10 slots = 224 KB
//   (96, 96), (96, 64)   2 warpgroups, Q 96 KB + 8 slots = 224 KB
//   (128, 128)           2 warpgroups, Q 128 KB + 6 slots = 224 KB
//   (192, 128)           2 warpgroups, Q 192 KB + 2 slots = 224 KB
//   (256, 256)           1 warpgroup,  Q 128 KB + 6 slots = 224 KB
// (plus 8 bytes an mbarrier, twice a slot, and 1 KB to align the base);
// hd 256 at 128 rows would need 256 KB for Q alone. Registers: a consumer
// thread holds acc[hdv / 2], S's sum and one span's accumulator (64), or
// P's hi and lo A fragments (64) and a piece of pv (16): 144 values at hdv
// 128, 208 at hdv 256. With two consumer warpgroups the producer warpgroup
// drops to PRODUCER_REGS with setmaxnreg.dec and the consumers rise to
// CONSUMER_REGS (.inc): 128 x 96 + 256 x 200 = 63488 of the SM's 65536;
// fewer for the producer spill it and slow every build (PERF.md). With one
// (hd 256) a block is 256 threads and every thread may take 255 registers,
// no setmaxnreg. The role comes from lane 0 (__shfl_sync), so ptxas sees a
// warp-uniform branch and budgets each role on its own. The consumers wait
// on the ring with mbar_spin (a trap on their path holds ptxas's allocation
// below what setmaxnreg grants, as in the bf16 kernel), and the producer
// watches the ring to its end with the trapping mbar_wait, so a broken ring
// fails its launch instead of hanging the card. Causal blocks run heaviest
// query tile first; key tiles after the query tile are never loaded, and a
// consumer warpgroup skips the tiles past its last row (releasing their
// slots once filled). The first visited tile always holds key 0, which
// every row sees, so no row meets a fully masked tile before its running
// max is finite. No atomics: two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BK = 64;         // keys per K/V tile
constexpr int WARPGROUP = 128;
constexpr int PRODUCERS = WARPGROUP;
constexpr int SPAN = 128;      // bytes of a swizzled row: 32 fp32
constexpr int SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a block may use
constexpr int SLOT = 2 * BK * SPAN;     // a slot: hi and lo of 64 rows of 128 bytes
constexpr int SPAN_COLS = 32;           // columns of a K span, rows of a V^T piece
// with two consumer warpgroups: registers a producer thread and a consumer
// thread (multiples of 8; 128 x (P + 2 C) within the SM's 65536)
constexpr int PRODUCER_REGS = 96;
constexpr int CONSUMER_REGS = 200;
static_assert(WARPGROUP * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= 65536, "registers");
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint64_t SWIZZLE_128B = 1;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t vhs, vss, vbs;  // v's head, row and batch strides (floats)
  int S, H, KH, B, nq, causal;
  float scale_log2;
};

// Shared memory, every tile on a 1024-byte boundary: Q hi, Q lo, then the
// ring's slots, then the mbarriers, full[] and empty[].
template <int HD, int HDV>
struct Layout {
  static constexpr int kw = HD < SPAN_COLS ? HD : SPAN_COLS;    // columns of a K span
  static constexpr int pw = HDV < SPAN_COLS ? HDV : SPAN_COLS;  // rows of a V^T piece
  static constexpr int spans = HD / kw;              // K slots of a key tile, Q's spans
  static constexpr int pieces = HDV / pw;            // V^T slots of a key tile
  static constexpr int per_tile = spans + pieces;
  // consumer warpgroups of 64 query rows: 2, or 1 where Q hi+lo of 128 rows
  // leaves no room for two slots
  static constexpr int cw = 2 * spans * 128 * SPAN + 2 * SLOT + 256 + 1024 <= SMEM_LIMIT ? 2 : 1;
  static constexpr int bq = 64 * cw;                 // query rows per block
  static constexpr int consumers = WARPGROUP * cw;
  static constexpr int threads = consumers + PRODUCERS;
  static constexpr int q_part = spans * bq * SPAN;   // Q hi or Q lo
  static constexpr int ring = 2 * q_part;            // the slots' offset
  // slots, up to what fits beside Q (256 bytes of mbarriers, 1 KB of
  // alignment)
  static constexpr int nslot = (SMEM_LIMIT - 1024 - 256 - ring) / SLOT;
  static constexpr int bars = ring + nslot * SLOT;
  static constexpr int alloc = bars + 2 * nslot * 8 + 1024;  // + aligning the base
  static_assert(alloc <= SMEM_LIMIT && nslot >= 2 && nslot <= 16, "shared memory");
  static_assert(HD % kw == 0 && HDV % pw == 0 && kw % 8 == 0 && pw % 16 == 0,
                "whole spans of whole k-steps, and pieces a P.V product can take");
};

// byte offset of element (r, c), c < 32, of a K-major tile of 128-byte rows
// in the 128-byte swizzle: 16-byte chunk c / 4 of row r lands at chunk
// (c / 4) ^ (r % 8)
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * SPAN + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

// a K-major operand in the 128-byte swizzle: 8 rows a 1024-byte step; a
// k-step of 8 values is 32 bytes along the row
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return sm90::make_desc(addr, 16, 8 * SPAN, SWIZZLE_128B);
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// hi = tf32(x) and lo = tf32(x - hi) of four values, 16 bytes each at byte
// offset off of the hi and lo tiles
__device__ __forceinline__ void split_store(const float4& x, uint8_t* hi, uint8_t* lo, int off) {
  const float h0 = sm90::tf32_rna(x.x), h1 = sm90::tf32_rna(x.y);
  const float h2 = sm90::tf32_rna(x.z), h3 = sm90::tf32_rna(x.w);
  *reinterpret_cast<float4*>(hi + off) = make_float4(h0, h1, h2, h3);
  *reinterpret_cast<float4*>(lo + off) =
      make_float4(sm90::tf32_rna(x.x - h0), sm90::tf32_rna(x.y - h1), sm90::tf32_rna(x.z - h2),
                  sm90::tf32_rna(x.w - h3));
}

// four keys' 4 values (x[u]: key u) as the four rows of V^T they make, each
// split and stored at V^T row r0 + u, stored key column col (a multiple of
// 4), in tiles whose 32-key spans are v_span bytes apart
__device__ __forceinline__ void transpose_store(const float4 (&x)[4], uint8_t* hi, uint8_t* lo,
                                                int r0, int col, int v_span) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 y =
        make_float4(lane_of(x[0], u), lane_of(x[1], u), lane_of(x[2], u), lane_of(x[3], u));
    split_store(y, hi, lo, (col / 32) * v_span + swizzled(r0 + u, col % 32));
  }
}

__device__ __forceinline__ float4 load_row(const float* p, bool inside) {
  return inside ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// P.V's product for N columns of V^T
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 16 || N == 32, "a P.V product's width");
  if constexpr (N == 16) sm90::wgmma_tf32_m64n16k8_rs(d, a, db, scale_d);
  else sm90::wgmma_tf32_m64n32k8_rs(d, a, db, scale_d);
}

// S = Q . K^T of one span: Q lo.K hi, Q hi.K lo, Q hi.K hi in k-steps of 8
// (32 bytes) into d, a fresh accumulator; KS k-steps (hd 16: 2), Q and K
// each hi and lo
template <int KS>
__device__ __forceinline__ void issue_qk(float (&d)[BK / 2], uint32_t q_hi, uint32_t q_lo,
                                         uint32_t k_hi, uint32_t k_lo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    sm90::wgmma_tf32_m64n64k8(d, desc(q_lo + 32 * kk), desc(k_hi + 32 * kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    sm90::wgmma_tf32_m64n64k8(d, desc(q_hi + 32 * kk), desc(k_lo + 32 * kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    sm90::wgmma_tf32_m64n64k8(d, desc(q_hi + 32 * kk), desc(k_hi + 32 * kk), 1);
}

// pv = P lo.V^T hi + P hi.V^T lo + P hi.V^T hi of one key tile's N columns
// of V^T in a fresh accumulator, a k-step of 8 keys being 32 bytes along
// V^T's rows, whose 32-key spans are v_span bytes apart
template <int N>
__device__ __forceinline__ void issue_pv(float (&pv)[N / 2], const uint32_t (&phi)[BK / 8][4],
                                         const uint32_t (&plo)[BK / 8][4], uint32_t v_hi,
                                         uint32_t v_lo, int v_span) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_pv<N>(pv, plo[kk], desc(v_hi + (kk / 4) * v_span + 32 * (kk % 4)), kk > 0);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_pv<N>(pv, phi[kk], desc(v_lo + (kk / 4) * v_span + 32 * (kk % 4)), 1);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_pv<N>(pv, phi[kk], desc(v_hi + (kk / 4) * v_span + 32 * (kk % 4)), 1);
}

// a consumer thread's rows and its online softmax. Thread layout of the
// m64nN fragments: warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8 (g = lane / 4), and in each block j of 8 columns the columns
// 8 j + 2 (lane % 4) + {0, 1}: registers 4 j + {0, 1} for the first row,
// 4 j + {2, 3} for the second.
struct Rows {
  int row_a, row_b, t4, first;  // first: the warpgroup's first row
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;  // l: this thread's share

  // S of the key tile at kv0 (sc, summed over hd) -> the scale (with log2
  // e, for exp2), the masks, the running max over the quad, p in fp32 and l
  // summed from it; P hi and P lo as A fragments: in column block kk the
  // thread holds keys 2 t4 and 2 t4 + 1 of rows g and g + 8, which are the
  // A fragment's columns t4 and t4 + 4 in V^T's stored key order. Returns
  // the running sums' corrections through corr_a, corr_b.
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], int kv0, const Args& p,
                                          uint32_t (&phi)[BK / 8][4], uint32_t (&plo)[BK / 8][4],
                                          float& corr_a, float& corr_b) {
    const bool masked = (p.causal && kv0 + BK - 1 > first) || kv0 + BK > p.S;
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int jb = 0; jb < BK / 8; ++jb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float xa = sc[4 * jb + c] * p.scale_log2;
        float xb = sc[4 * jb + 2 + c] * p.scale_log2;
        if (masked) {
          const int key = kv0 + 8 * jb + 2 * t4 + c;
          if (key >= p.S || (p.causal && key > row_a)) xa = NEG;
          if (key >= p.S || (p.causal && key > row_b)) xb = NEG;
        }
        sc[4 * jb + c] = xa;
        sc[4 * jb + 2 + c] = xb;
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
    corr_a = sm90::ex2(m_a - mn_a);
    corr_b = sm90::ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float x[4] = {sm90::ex2(sc[4 * kk] - mn_a), sm90::ex2(sc[4 * kk + 2] - mn_b),
                          sm90::ex2(sc[4 * kk + 1] - mn_a), sm90::ex2(sc[4 * kk + 3] - mn_b)};
      ls_a += x[0] + x[2];
      ls_b += x[1] + x[3];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float hi = sm90::tf32_rna(x[r]);
        phi[kk][r] = __float_as_uint(hi);
        plo[kk][r] = __float_as_uint(sm90::tf32_rna(x[r] - hi));
      }
    }
    l_a = l_a * corr_a + ls_a;
    l_b = l_b * corr_b + ls_b;
  }

  // the running sum in fp32 on the CUDA cores, acc = acc * corr + pv, of
  // acc's registers from a0 on (column block a0 / 4 on)
  template <int N, int M>
  __device__ __forceinline__ void add(float (&acc)[M], int a0, const float (&pv)[N / 2],
                                      float corr_a, float corr_b) {
#pragma unroll
    for (int jb = 0; jb < N / 8; ++jb) {
      acc[a0 + 4 * jb + 0] = fmaf(acc[a0 + 4 * jb + 0], corr_a, pv[4 * jb + 0]);
      acc[a0 + 4 * jb + 1] = fmaf(acc[a0 + 4 * jb + 1], corr_a, pv[4 * jb + 1]);
      acc[a0 + 4 * jb + 2] = fmaf(acc[a0 + 4 * jb + 2], corr_b, pv[4 * jb + 2]);
      acc[a0 + 4 * jb + 3] = fmaf(acc[a0 + 4 * jb + 3], corr_b, pv[4 * jb + 3]);
    }
  }

  // epilogue: l over the quad, out = acc / (l + 1e-30), rows < S only
  template <int HDV>
  __device__ __forceinline__ void store(const float (&acc)[HDV / 2], const Args& p, int h,
                                        int b) {
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
    }
    const float den_a = l_a + 1e-30f, den_b = l_b + 1e-30f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_b : row_a;
      if (row >= p.S) continue;
      const float den = half ? den_b : den_a;
      float* orow = p.o + ((static_cast<int64_t>(b) * p.S + row) * p.H + h) * HDV + 2 * t4;
#pragma unroll
      for (int jb = 0; jb < HDV / 8; ++jb) {
        *reinterpret_cast<float2*>(orow + 8 * jb) =
            make_float2(acc[4 * jb + 2 * half] / den, acc[4 * jb + 2 * half + 1] / den);
      }
    }
  }
};

// a consumer warpgroup's Q rows, split into Q hi and Q lo once (zeros past
// S): span sp of row r at sp * bq * SPAN of each part
template <int HD, int BQ>
__device__ __forceinline__ void load_q(const Args& p, uint8_t* smem, int q_part, int wg,
                                       int first, int h, int b) {
  constexpr int CH = HD / 4;  // 16-byte chunks of a q row
  const int64_t q_row = static_cast<int64_t>(p.H) * HD;
  const float* __restrict__ qb =
      p.q + static_cast<int64_t>(b) * p.S * q_row + static_cast<int64_t>(h) * HD;
#pragma unroll 4
  for (int i = 0; i < 64 * CH / WARPGROUP; ++i) {
    const int idx = threadIdx.x % WARPGROUP + WARPGROUP * i, r = idx / CH, c = 4 * (idx % CH);
    const int row = first + r;
    split_store(load_row(qb + row * q_row + c, row < p.S), smem, smem + q_part,
                (c / 32) * (BQ * SPAN) + swizzled(64 * wg + r, c % 32));
  }
  sm90::fence_proxy_async();
}

template <int HD, int HDV>
__global__ void __launch_bounds__(Layout<HD, HDV>::threads, 1) fa_fwd_tf32_kernel(const Args p) {
  using L = Layout<HD, HDV>;
  constexpr int BQ = L::bq, CONSUMERS = L::consumers, NSLOT = L::nslot;
  constexpr int NK = L::spans, PER_TILE = L::per_tile, KW = L::kw, PW = L::pw;
  constexpr int HALF = SLOT / 2;                 // a slot's hi, then its lo
  constexpr int V_SPAN = PW * SPAN;              // 32 keys of a V^T piece's rows
  constexpr int KC = KW / 4;                     // 16-byte chunks of a K span's row
  constexpr int KQ = BK * KC / PRODUCERS;        // a K span's chunks a producer thread
  constexpr int VC = PW / 4;                     // 16-byte chunks of a V piece's key
  uint8_t* const raw = sm90::dynamic_smem();
  uint8_t* const smem = raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t bars = base + L::bars;
  auto full = [&](int n) { return bars + 8 * (n % NSLOT); };
  auto empty = [&](int n) { return bars + 8 * (NSLOT + n % NSLOT); };
  // slot use n fills the slot for the (n / NSLOT)-th time
  auto parity = [](int n) { return static_cast<uint32_t>((n / NSLOT) & 1); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < NSLOT; ++i) {
      sm90::mbar_init(full(i), PRODUCERS);
      sm90::mbar_init(empty(i), CONSUMERS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so that the compiler sees one value in
  // every lane of a warp: each role then gets its own register budget
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WARPGROUP, 0);
  // the block's query tile, head and key tiles, computed in each role after
  // its setmaxnreg: computed before, they live across it and ptxas spills
  // them to fit the consumers' budget
  auto tile = [&](int& h, int& b, int& kh, int& q0, int& ntiles) {
    uint32_t block = blockIdx.x;
    sm90::fence_regs(block);
    const int hb_count = p.H * p.B;
    int qt = static_cast<int>(block) / hb_count;
    const int hb = static_cast<int>(block) % hb_count;
    if (p.causal) qt = p.nq - 1 - qt;
    h = hb % p.H;
    b = hb / p.H;
    kh = h / (p.H / p.KH);
    q0 = qt * BQ;
    const int kv_end = p.causal ? min(p.S, q0 + BQ) : p.S;
    ntiles = (kv_end + BK - 1) / BK;
  };
  int h, b, kh, q0, ntiles;
  if (role == L::cw) {
    // the producer warpgroup. A K span: 64 keys x KC chunks, KQ a thread,
    // consecutive threads along a key's row. A V^T piece: blocks of 4 keys
    // (8 m + par + 2 u, u = 0..3) by 4 of hdv, at most one a thread (hdv
    // 16: 64 blocks), transposed into one 16-byte chunk of V^T per hdv row,
    // at keys 8 m + 4 par .. + 3 of the stored order 0 2 4 6 1 3 5 7
    if constexpr (L::cw == 2) sm90::setmaxnreg_dec<PRODUCER_REGS>();
    tile(h, b, kh, q0, ntiles);
    const int total = ntiles * PER_TILE;  // slot uses of the block
    const int pt = threadIdx.x - CONSUMERS;
    const int64_t k_row = static_cast<int64_t>(p.KH) * HD;  // floats from key to key
    const float* __restrict__ kb =
        p.k + static_cast<int64_t>(b) * p.S * k_row + static_cast<int64_t>(kh) * HD;
    const float* __restrict__ vb = p.v + b * p.vbs + kh * p.vhs;
    const int chunk = pt % VC, grp = pt / VC;  // a V^T block's 4 columns and 4 keys
    // a thread with a V^T block: hdv 16 has 64 for 128 threads; at wider
    // pieces every thread has one, and a test here (not folded away) costs
    // the span ring 12 % (tools/flash_tf32_variants.py)
    const bool v_block = VC * (BK / 4) == PRODUCERS || grp < BK / 4;
    auto fetch = [&](int n, float4 (&x)[4]) {
      const int i = n % PER_TILE, kv0 = (n / PER_TILE) * BK;
      if (i < NK) {
#pragma unroll
        for (int u = 0; u < KQ; ++u) {
          const int idx = pt + PRODUCERS * u, key = kv0 + idx / KC;
          x[u] = load_row(kb + key * k_row + KW * i + 4 * (idx % KC), key < p.S);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = kv0 + 8 * (grp / 2) + grp % 2 + 2 * u;
          x[u] = load_row(vb + key * p.vss + PW * (i - NK) + 4 * chunk, v_block && key < p.S);
        }
      }
    };
    auto put = [&](int n, const float4 (&x)[4]) {
      if (n >= NSLOT) sm90::mbar_wait(empty(n), parity(n) ^ 1);
      uint8_t* const hi = smem + L::ring + (n % NSLOT) * SLOT;
      if (n % PER_TILE < NK) {
#pragma unroll
        for (int u = 0; u < KQ; ++u) {
          const int idx = pt + PRODUCERS * u;
          split_store(x[u], hi, hi + HALF, swizzled(idx / KC, 4 * (idx % KC)));
        }
      } else if (v_block) {
        transpose_store(x, hi, hi + HALF, 4 * chunk, 8 * (grp / 2) + 4 * (grp % 2), V_SPAN);
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(full(n));
    };
    // two slots' loads in flight: slot n + 2's issued once slot n is stored
    float4 xa[4], xb[4];
    fetch(0, xa);
    if (total > 1) fetch(1, xb);
    for (int n = 0; n < total; n += 2) {
      put(n, xa);
      if (n + 2 < total) fetch(n + 2, xa);
      if (n + 1 < total) {
        put(n + 1, xb);
        if (n + 3 < total) fetch(n + 3, xb);
      }
    }
    // the consumers wait without a timeout (mbar_spin), so the producer
    // watches the ring to its end: the last slots' releases, with the
    // trapping wait, so that a broken ring fails the launch
    for (int n = total > NSLOT ? total - NSLOT : 0; n < total; ++n)
      sm90::mbar_wait(empty(n), parity(n));
    return;
  }

  if constexpr (L::cw == 2) sm90::setmaxnreg_inc<CONSUMER_REGS>();
  tile(h, b, kh, q0, ntiles);
  const int total = ntiles * PER_TILE;
  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int wg = role;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  Rows rows;
  rows.first = q0 + 64 * wg;
  rows.row_a = rows.first + 16 * warp + lane / 4;
  rows.row_b = rows.row_a + 8;
  rows.t4 = lane % 4;
  const int wg_last = rows.first + 63;
  // the key tiles this warpgroup visits: causal, none past its last row
  const int nvisit = p.causal ? min(ntiles, wg_last / BK + 1) : ntiles;

  load_q<HD, BQ>(p, smem, L::q_part, wg, rows.first, h, b);
  sm90::bar_sync(1 + wg, WARPGROUP);
  const uint32_t q_hi = base + 64 * wg * SPAN, q_lo = q_hi + L::q_part;

  float acc[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) acc[i] = 0.f;

  int n = 0;  // slot use
  for (int j = 0; j < nvisit; ++j) {
    // S = Q . K^T: per span of 32 of hd a fresh accumulator (span 0 S's sum
    // itself), each added into the sum in fp32 after its wait, in span order
    float sc[BK / 2];
#pragma unroll
    for (int sp = 0; sp < NK; ++sp, ++n) {
      sm90::mbar_spin(full(n), parity(n));
      const uint32_t k_hi = base + L::ring + (n % NSLOT) * SLOT, k_lo = k_hi + HALF;
      // Q's span, its descriptors made here: hoisted out of the tile loop,
      // the 8 hd/32 of them would hold 16 hd/32 registers throughout
      uint32_t qs_hi = q_hi + sp * BQ * SPAN, qs_lo = q_lo + sp * BQ * SPAN;
      sm90::fence_regs(qs_hi);
      sm90::fence_regs(qs_lo);
      float st[BK / 2];
      sm90::wgmma_fence();
      if (sp == 0) issue_qk<KW / 8>(sc, qs_hi, qs_lo, k_hi, k_lo);
      else issue_qk<KW / 8>(st, qs_hi, qs_lo, k_hi, k_lo);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      if (sp > 0) {
        sm90::fence_regs(st);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = __fadd_rn(sc[i], st[i]);
      }
      sm90::mbar_arrive(empty(n));
    }

    uint32_t phi[BK / 8][4], plo[BK / 8][4];
    float corr_a, corr_b;
    rows.softmax(sc, j * BK, p, phi, plo, corr_a, corr_b);
    sm90::fence_regs(phi);
    sm90::fence_regs(plo);

    // P.V a piece of PW columns of hdv at a time, each a fresh accumulator
    // added into its columns of acc
#pragma unroll
    for (int c = 0; c < L::pieces; ++c, ++n) {
      sm90::mbar_spin(full(n), parity(n));
      const uint32_t v_hi = base + L::ring + (n % NSLOT) * SLOT, v_lo = v_hi + HALF;
      float pv[PW / 2];
      sm90::wgmma_fence();
      issue_pv<PW>(pv, phi, plo, v_hi, v_lo, V_SPAN);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(pv);
      sm90::mbar_arrive(empty(n));
      rows.add<PW>(acc, c * (PW / 2), pv, corr_a, corr_b);
    }
    sm90::fence_regs(phi);  // P was read until now
    sm90::fence_regs(plo);
  }
  // tiles past this warpgroup's last row: their slots, each released once
  // it is filled. An arrival names no phase, and empty counts both
  // warpgroups' arrivals: one made before the slot's fill could complete the
  // phase of the use NSLOT before it, which the other warpgroup may still be
  // reading, and let the producer overwrite that slot.
  for (; n < total; ++n) {
    sm90::mbar_spin(full(n), parity(n));
    sm90::mbar_arrive(empty(n));
  }
  rows.store<HDV>(acc, p, h, b);
}

template <int HD, int HDV>
int launch(Args p, cudaStream_t stream) {
  using L = Layout<HD, HDV>;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_tf32_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return err;
  p.nq = (p.S + L::bq - 1) / L::bq;
  const int64_t blocks = static_cast<int64_t>(p.nq) * p.H * p.B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const int threads = L::threads;
  fa_fwd_tf32_kernel<HD, HDV><<<grid, threads, L::alloc, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// fp32 q (B,S,H,hd) and k (B,S,K,hd), contiguous; v (B,S,K,hdv) with unit
// stride along hdv and head, row and batch strides vhs, vss, vbs (floats,
// multiples of 4); o (B,S,H,hdv) contiguous; every base 16-byte aligned.
// (hd, hdv) is (16, 16), (32, 32), (64, 64), (96, 96), (128, 128), (96, 64),
// (192, 128) or (256, 256). Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); the caller raises on anything
// else, an unbuilt (hd, hdv) included.
extern "C" int fa_fwd_tf32(const float* q, const float* k, const float* v, float* o, int B,
                           int S, int H, int K, int hd, int hdv, long long vhs, long long vss,
                           long long vbs, int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  if (vhs % 4 || vss % 4 || vbs % 4) return cudaErrorInvalidValue;
  const Args p{q, k, v, o, vhs, vss, vbs, S, H, K, B, 0, causal, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 16 && hdv == 16) return launch<16, 16>(p, st);
  if (hd == 32 && hdv == 32) return launch<32, 32>(p, st);
  if (hd == 64 && hdv == 64) return launch<64, 64>(p, st);
  if (hd == 96 && hdv == 96) return launch<96, 96>(p, st);
  if (hd == 128 && hdv == 128) return launch<128, 128>(p, st);
  if (hd == 96 && hdv == 64) return launch<96, 64>(p, st);
  if (hd == 192 && hdv == 128) return launch<192, 128>(p, st);
  if (hd == 256 && hdv == 256) return launch<256, 256>(p, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* fa_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
