// Causal GQA flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (entry flash_attention_fwd). Same function: q (B,S,H,hd), k/v (B,S,K,hd)
// with H % K == 0; fp32 online softmax; masked scores are -1e30 after the
// 1/sqrt(hd) scale; out = acc / (l + 1e-30) in q's type.
//
// What bounds it on this card: operations. Causal attention at the main
// path's shape (B=8, S=1024, H=12, hd=64) does about 4*B*H*S*S/2*hd = 12.9
// GFLOP against 3*8*1024*12*64*2 B = 37.7 MB of q/k/v reads and 12.6 MB of
// output, so the tensor cores would bound it. This first kernel does its
// products on the CUDA cores in fp32 (67 TFLOP/s peak), which is what bounds
// it now; wgmma and TMA are later work.
//
// Design. One block of BQ threads per (q tile, h, b); each thread owns one
// query row and keeps that row of q and its fp32 accumulator in registers.
// K and V tiles of BK rows are staged in shared memory as fp32, read
// straight from the (B,S,K,hd) layout at kv head h / G: no repeat of k and
// v per query head and no transpose copy. Scores of a tile go to shared
// memory transposed ([key][row]), so a warp's stores and loads hit
// consecutive banks. Key tiles after the q tile are never visited (causal
// skip), keys past S are masked, rows past S are computed but not stored, so
// any S works. The first tile always holds key 0, which every row sees, so
// no row meets a fully masked tile before its running max is finite.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block, one thread each
constexpr int BK = 64;  // keys per shared-memory tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int S, int H, int K, int causal, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][HD]
  float* Vs = Ks + BK * HD;      // [BK][HD]
  float* Ps = Vs + BK * HD;      // [BK][BQ], scores then probabilities

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int qpos = q0 + t;
  const bool row_ok = qpos < S;

  float qr[HD];
  float acc[HD];
  const T* qrow = q + ((static_cast<int64_t>(b) * S + qpos) * H + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = row_ok ? to_f(qrow[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG;
  float l = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = t; e < BK * HD; e += BQ) {
      const int r = e / HD, c = e % HD;
      const int kpos = kv0 + r;
      float kx = 0.f, vx = 0.f;
      if (kpos < S) {
        const int64_t off = ((static_cast<int64_t>(b) * S + kpos) * K + kh) * HD + c;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[e] = kx;
      Vs[e] = vx;
    }
    __syncthreads();

    float mt = NEG;
    for (int j = 0; j < BK; ++j) {
      const float4* k4 = reinterpret_cast<const float4*>(Ks + j * HD);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kk = k4[d4];
        s = fmaf(qr[4 * d4 + 0], kk.x, s);
        s = fmaf(qr[4 * d4 + 1], kk.y, s);
        s = fmaf(qr[4 * d4 + 2], kk.z, s);
        s = fmaf(qr[4 * d4 + 3], kk.w, s);
      }
      s *= scale;
      const int kpos = kv0 + j;
      if (kpos >= S || (causal && kpos > qpos)) s = NEG;
      Ps[j * BQ + t] = s;
      mt = fmaxf(mt, s);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
    for (int j = 0; j < BK; ++j) {
      const float p = expf(Ps[j * BQ + t] - m_new);
      Ps[j * BQ + t] = p;
      lsum += p;
    }
    l = l * corr + lsum;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[j * BQ + t];
      const float4* v4 = reinterpret_cast<const float4*>(Vs + j * HD);
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 vv = v4[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    T* orow = o + ((static_cast<int64_t>(b) * S + qpos) * H + h) * HD;
    const float den = l + 1e-30f;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = from_f<T>(acc[d] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int K, int causal, float scale, cudaStream_t stream) {
  const size_t smem = (2 * BK * HD + BK * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, HD><<<grid, BQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, K, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, int K, int hd, int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, K, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, K, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, K, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int H, int K, int hd, int dtype, int causal, float scale,
                      void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(q, k, v, o, B, S, H, K, hd, causal, scale, st);
    case 1: return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, K, hd, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
