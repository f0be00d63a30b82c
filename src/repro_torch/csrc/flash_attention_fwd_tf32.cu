// Causal GQA flash-attention forward in fp32 on Hopper's tensor cores
// (sm_90a), CUDA C++: 3xTF32 on wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (entry flash_attention_fwd) for fp32 q, k, v; csrc/flash_attention_fwd.cu
// holds the bf16 kernel. Same function: q (B,S,H,hd), k/v (B,S,K,hd) with
// H % K == 0, kv head h / (H/K) read in place; fp32 online softmax; masked
// scores are -1e30 after the 1/sqrt(hd) scale; l is summed from the
// unrounded fp32 p; out = acc / (l + 1e-30). Any S: the ragged edge is
// masked, not padded. hd is 16, 32 or 64.
//
// What bounds it on this card: operations. At gpt2-small's shape (B=8,
// S=1024, H=12, hd=64, causal) the function does 4*B*H*hd*S(S+1)/2 = 12.9
// GFLOP on 100 MB of q/k/v/out (0.030 ms at 3.35 TB/s). On the CUDA cores
// (FFMA, 67 TFLOP/s) that is 0.19 ms; the tensor cores take fp32 only as
// TF32 (10 mantissa bits), and fp32 callers are held at 1e-5 of each
// element, so every product here is three TF32 products (3xTF32), whose
// floor is 3 x 12.9 GFLOP over the 495 TFLOP/s TF32 peak, 0.078 ms.
//
// Numbers. Each operand x is split into hi = tf32(x) and lo = tf32(x - hi),
// each rounded to nearest with ties away (x - hi is exact), and each product
// is lo.hi + hi.lo + hi.hi (lo.lo, below 2^-22 of the product, is dropped),
// the small products first into a fresh accumulator. The tensor cores round
// each k-step of 8 at the size of the largest addend, accumulator included,
// so no accumulator carries a long sum: S = Q.K^T takes one accumulator per
// 32 of hd (hd 64: two, added in fp32 on the CUDA cores; one accumulator
// over all 64 misses the limit on near-zero outputs of non-causal rows), and
// each key tile's P.V starts a fresh accumulator that the running sum takes
// on the CUDA cores, acc = acc * corr + pv in fp32
// (tests/test_torch_flash_tf32_numerics.py models this arithmetic and both
// controls). The exponentials are exp2 of scores scaled by log2(e) along
// with 1/sqrt(hd).
//
// Design. One block per (128-row query tile, query head, batch): two
// consumer warpgroups of 64 rows each and one producer warpgroup. The
// consumers split their Q rows into Q hi and Q lo in shared memory once.
// The producer loads K/V tiles of 64 keys into registers (16-byte loads
// along hd; zeros past S), splits them and writes K hi, K lo, V^T hi and
// V^T lo into a ring of 2 stages guarded by full/empty mbarriers, and loads
// the next tile while it waits for a free stage. Every operand is K-major
// in the 128-byte swizzle that the wgmma descriptors name, one 32-value
// span of a row at a time: a q or k row of hd 64 is two spans, stored as two
// tiles (hd 16 uses half of each 128-byte row), and V^T's 64 keys are two
// spans of 32. tf32 has no transposed form, so V cannot be the MN-major B
// operand the bf16 kernel uses: the producer transposes V, 4 x 4 values in
// registers. Each consumer computes S on wgmma m64n64k8 from shared memory,
// applies the scale and the masks (the causal mask only on tiles that cross
// the diagonal, the key mask only past S) and runs the online softmax in
// registers, with row maxima and sums over the 4 lanes of a quad. P.V takes
// P from registers: the accumulator of S gives a thread keys 2c and 2c + 1
// of each 8, where the tf32 A fragment wants c and c + 4, so the producer
// stores each 8 keys of V^T in the order 0 2 4 6 1 3 5 7 and P's registers
// are the A fragment as they are, no shuffle. The two consumer warpgroups
// take turns at issuing their products (named barriers), so one's softmax
// overlaps the other's products. Causal blocks run heaviest query tile
// first; key tiles after the query tile are never loaded, and a warpgroup
// skips the tiles past its last row. The first visited tile always holds
// key 0, which every row sees, so no row meets a fully masked tile before
// its running max is finite. No atomics: two launches give the same bits.
//
// Every inline-PTX operation sits behind a helper in sm90.cuh;
// tests/test_torch_kernel_emulation.py runs this source on the CPU against a
// C++ model of those helpers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;        // query rows per block (two warpgroups of 64)
constexpr int BK = 64;         // keys per K/V tile
constexpr int NSTAGE = 2;      // K/V stages in the ring
constexpr int CONSUMERS = 256;
constexpr int PRODUCERS = 128;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int SPAN = 128;      // bytes of a swizzled row: 32 fp32
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint64_t SWIZZLE_128B = 1;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int S, H, KH, B, nq, causal;
  float scale_log2;
};

// Shared memory, every tile on a 1024-byte boundary: Q hi, Q lo, then per
// stage K hi, K lo, V^T hi, V^T lo, then the mbarriers.
template <int HD>
struct Layout {
  static constexpr int spans = HD == 64 ? 2 : 1;     // 128-byte spans of a q or k row
  static constexpr int q_part = spans * BQ * SPAN;   // Q hi or Q lo
  static constexpr int k_part = spans * BK * SPAN;   // K hi or K lo
  static constexpr int v_span = HD * SPAN;           // 32 keys of V^T's hd rows
  static constexpr int v_part = (BK / 32) * v_span;  // V^T hi or V^T lo
  static constexpr int stage = 2 * k_part + 2 * v_part;
  static constexpr int ring = 2 * q_part;
  static constexpr int bars = ring + NSTAGE * stage;  // full[NSTAGE], empty[NSTAGE]
  static constexpr int alloc = bars + 2 * NSTAGE * 8 + 1024;  // + aligning the base
};

// Turns of the two consumer warpgroups at the tensor cores (named barriers
// 1 and 2, 256 threads each): warpgroup wg waits for its turn before it
// issues a product and passes the turn on after, so the products are issued
// S0 S1 PV0 PV1 ... and one warpgroup's softmax runs while the other's
// products do.
__device__ __forceinline__ void turn_wait(int wg) { sm90::bar_sync(1 + wg, CONSUMERS); }
__device__ __forceinline__ void turn_pass(int wg) { sm90::bar_arrive(2 - wg, CONSUMERS); }

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

__device__ __forceinline__ float4 load_row(const float* p, bool inside) {
  return inside ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// P.V's product for hd = N
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (HD == 16) sm90::wgmma_tf32_m64n16k8_rs(d, a, db, scale_d);
  else if constexpr (HD == 32) sm90::wgmma_tf32_m64n32k8_rs(d, a, db, scale_d);
  else sm90::wgmma_tf32_m64n64k8_rs(d, a, db, scale_d);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1) fa_fwd_tf32_kernel(const Args p) {
  using L = Layout<HD>;
  constexpr int CH = HD / 4;                      // 16-byte chunks of a q/k/v row
  constexpr int KS = (HD < 32 ? HD : 32) / 8;     // k-steps of S in one span
  uint8_t* const raw = sm90::dynamic_smem();
  // swizzled tiles start on a 1024-byte boundary, where the swizzle pattern
  // of the stores and of the wgmma descriptors lines up
  uint8_t* const smem = raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t bars = base + L::bars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NSTAGE + st); };

  // heaviest causal query tiles first: the tile index is the slow one
  const int hb_count = p.H * p.B;
  int qt = blockIdx.x / hb_count;
  const int hb = blockIdx.x % hb_count;
  if (p.causal) qt = p.nq - 1 - qt;
  const int h = hb % p.H, b = hb / p.H;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * BQ;
  const int kv_end = p.causal ? min(p.S, q0 + BQ) : p.S;
  const int ntiles = (kv_end + BK - 1) / BK;
  const int t = threadIdx.x;

  if (t == 0) {
    for (int st = 0; st < NSTAGE; ++st) {
      sm90::mbar_init(full(st), PRODUCERS);
      sm90::mbar_init(empty(st), CONSUMERS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (t >= CONSUMERS) {
    // the producer warpgroup. K: KQ chunks a thread, consecutive threads
    // along a row. V: blocks of 4 keys (8 m + par + 2 u, u = 0..3) by 4 of
    // hd, transposed into one 16-byte chunk of V^T per hd row, at keys
    // 8 m + 4 par .. + 3 of the stored order 0 2 4 6 1 3 5 7
    constexpr int KQ = BK * CH / PRODUCERS;
    constexpr int VBLOCKS = (BK / 4) * CH;
    constexpr int VB = (VBLOCKS + PRODUCERS - 1) / PRODUCERS;
    const int pt = t - CONSUMERS;
    const int64_t kv_row = static_cast<int64_t>(p.KH) * HD;  // floats from key to key
    const int64_t kv_head = static_cast<int64_t>(b) * p.S * kv_row + static_cast<int64_t>(kh) * HD;
    const float* __restrict__ kb = p.k + kv_head;
    const float* __restrict__ vb = p.v + kv_head;
    float4 kx[KQ], vx[VB][4];
    auto fetch = [&](int j) {
      const int kv0 = j * BK;
#pragma unroll
      for (int i = 0; i < KQ; ++i) {
        const int idx = pt + PRODUCERS * i, key = kv0 + idx / CH;
        kx[i] = load_row(kb + key * kv_row + 4 * (idx % CH), key < p.S);
      }
#pragma unroll
      for (int i = 0; i < VB; ++i) {
        const int blk = pt + PRODUCERS * i, grp = blk / CH;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = kv0 + 8 * (grp / 2) + grp % 2 + 2 * u;
          vx[i][u] = load_row(vb + key * kv_row + 4 * (blk % CH), blk < VBLOCKS && key < p.S);
        }
      }
    };
    auto put = [&](int j) {
      const int st = j % NSTAGE;
      if (j >= NSTAGE) sm90::mbar_wait(empty(st), ((j / NSTAGE) & 1) ^ 1);
      uint8_t* const ks = smem + L::ring + st * L::stage;
      uint8_t* const vs = ks + 2 * L::k_part;
#pragma unroll
      for (int i = 0; i < KQ; ++i) {
        const int idx = pt + PRODUCERS * i, c = 4 * (idx % CH);
        split_store(kx[i], ks, ks + L::k_part,
                    (c / 32) * (BK * SPAN) + swizzled(idx / CH, c % 32));
      }
#pragma unroll
      for (int i = 0; i < VB; ++i) {
        const int blk = pt + PRODUCERS * i, grp = blk / CH;
        if (blk >= VBLOCKS) continue;
        const int col = 8 * (grp / 2) + 4 * (grp % 2);  // stored key of the chunk
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 x = make_float4(lane_of(vx[i][0], u), lane_of(vx[i][1], u),
                                       lane_of(vx[i][2], u), lane_of(vx[i][3], u));
          split_store(x, vs, vs + L::v_part,
                      (col / 32) * L::v_span + swizzled(4 * (blk % CH) + u, col % 32));
        }
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(full(st));
    };
    fetch(0);
    for (int j = 0; j < ntiles; ++j) {
      put(j);
      if (j + 1 < ntiles) fetch(j + 1);
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63. Thread layout of
  // the m64nN fragments: warp w of the group holds rows 16 w + g and
  // 16 w + g + 8 (g = lane / 4), and in each block j of 8 columns the
  // columns 8 j + 2 (lane % 4) + {0, 1}: registers 4 j + {0, 1} for the
  // first row, 4 j + {2, 3} for the second.
  const int wg = t / 128;
  const int warp = t / 32, lane = t % 32, t4 = lane % 4;
  const int row_a = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int row_b = row_a + 8;
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;

  // the warpgroup's Q rows, split into Q hi and Q lo once (zeros past S)
  {
    constexpr int QQ = 64 * CH / 128;
    const int64_t q_row = static_cast<int64_t>(p.H) * HD;
    const float* __restrict__ qb =
        p.q + static_cast<int64_t>(b) * p.S * q_row + static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int i = 0; i < QQ; ++i) {
      const int idx = t % 128 + 128 * i, r = idx / CH, c = 4 * (idx % CH);
      const int row = wg_first + r;
      split_store(load_row(qb + row * q_row + c, row < p.S), smem, smem + L::q_part,
                  (c / 32) * (BQ * SPAN) + swizzled(64 * wg + r, c % 32));
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(3 + wg, 128);
  }
  const uint32_t q_hi = base + 64 * wg * SPAN, q_lo = q_hi + L::q_part;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;  // l: this thread's share

  if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % NSTAGE;
    const int kv0 = j * BK;
    sm90::mbar_wait(full(st), (j / NSTAGE) & 1);
    if (p.causal && kv0 > wg_last) {  // every key of the tile is after every row
      sm90::mbar_arrive(empty(st));
      turn_wait(wg);  // its two turns, so the other warpgroup's go on
      turn_pass(wg);
      turn_wait(wg);
      turn_pass(wg);
      continue;
    }
    const uint32_t k_hi = base + L::ring + st * L::stage, k_lo = k_hi + L::k_part;
    const uint32_t v_hi = k_hi + 2 * L::k_part, v_lo = v_hi + L::v_part;

    // S = Q . K^T: per span of 32 of hd a fresh accumulator, the products
    // Q lo.K hi, Q hi.K lo, Q hi.K hi in k-steps of 8 (32 bytes)
    float s[L::spans][BK / 2];
    turn_wait(wg);
    sm90::wgmma_fence();
#pragma unroll
    for (int sp = 0; sp < L::spans; ++sp) {
      const uint32_t qo = sp * BQ * SPAN, ko = sp * BK * SPAN;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        sm90::wgmma_tf32_m64n64k8(s[sp], desc(q_lo + qo + 32 * kk), desc(k_hi + ko + 32 * kk),
                                  kk > 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        sm90::wgmma_tf32_m64n64k8(s[sp], desc(q_hi + qo + 32 * kk), desc(k_lo + ko + 32 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        sm90::wgmma_tf32_m64n64k8(s[sp], desc(q_hi + qo + 32 * kk), desc(k_hi + ko + 32 * kk), 1);
    }
    sm90::wgmma_commit();
    turn_pass(wg);
    sm90::wgmma_wait_all();
#pragma unroll
    for (int sp = 0; sp < L::spans; ++sp) sm90::fence_regs(s[sp]);
    float* const sc = s[0];
#pragma unroll
    for (int sp = 1; sp < L::spans; ++sp)
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = __fadd_rn(sc[i], s[sp][i]);

    // scale (with log2 e, for exp2), masks, running max over the quad
    const bool masked = (p.causal && kv0 + BK - 1 > wg_first) || kv0 + BK > p.S;
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
    const float corr_a = sm90::ex2(m_a - mn_a), corr_b = sm90::ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // p in fp32, l summed from it, then P hi and P lo as A fragments: in
    // column block kk the thread holds keys 2 t4 and 2 t4 + 1 of rows g and
    // g + 8, which are the A fragment's columns t4 and t4 + 4 in V^T's
    // stored key order
    float ls_a = 0.f, ls_b = 0.f;
    uint32_t phi[BK / 8][4], plo[BK / 8][4];
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

    // pv = P lo.V^T hi + P hi.V^T lo + P hi.V^T hi in a fresh accumulator,
    // a k-step of 8 keys being 32 bytes along V^T's rows
    float pv[HD / 2];
    sm90::fence_regs(phi);
    sm90::fence_regs(plo);
    turn_wait(wg);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_pv<HD>(pv, plo[kk], desc(v_hi + (kk / 4) * L::v_span + 32 * (kk % 4)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_pv<HD>(pv, phi[kk], desc(v_lo + (kk / 4) * L::v_span + 32 * (kk % 4)), 1);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_pv<HD>(pv, phi[kk], desc(v_hi + (kk / 4) * L::v_span + 32 * (kk % 4)), 1);
    sm90::wgmma_commit();
    turn_pass(wg);
    sm90::wgmma_wait_all();
    sm90::fence_regs(pv);
    sm90::mbar_arrive(empty(st));

    // the running sum in fp32 on the CUDA cores: acc = acc * corr + pv
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb) {
      acc[4 * jb + 0] = fmaf(acc[4 * jb + 0], corr_a, pv[4 * jb + 0]);
      acc[4 * jb + 1] = fmaf(acc[4 * jb + 1], corr_a, pv[4 * jb + 1]);
      acc[4 * jb + 2] = fmaf(acc[4 * jb + 2], corr_b, pv[4 * jb + 2]);
      acc[4 * jb + 3] = fmaf(acc[4 * jb + 3], corr_b, pv[4 * jb + 3]);
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
    if (row >= p.S) continue;
    const float den = half ? den_b : den_a;
    float* orow = p.o + ((static_cast<int64_t>(b) * p.S + row) * p.H + h) * HD + 2 * t4;
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb) {
      *reinterpret_cast<float2*>(orow + 8 * jb) =
          make_float2(acc[4 * jb + 2 * half] / den, acc[4 * jb + 2 * half + 1] / den);
    }
  }
}

template <int HD>
int launch(const Args& p, cudaStream_t stream) {
  using L = Layout<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(p.nq) * p.H * p.B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  fa_fwd_tf32_kernel<HD><<<grid, THREADS, L::alloc, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// fp32 q (B,S,H,hd), k/v (B,S,K,hd), o (B,S,H,hd), all contiguous and
// 16-byte aligned; hd 16, 32 or 64. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); the caller raises on anything
// else.
extern "C" int fa_fwd_tf32(const float* q, const float* k, const float* v, float* o, int B,
                           int S, int H, int K, int hd, int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  const Args p{q, k, v, o, S, H, K, B, (S + BQ - 1) / BQ, causal, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, st);
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* fa_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
