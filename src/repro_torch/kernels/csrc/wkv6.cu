// K6: the WKV6 recurrence (RWKV6 "Finch" time mix) for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel `wkv6_chunked` (pallas_call at
// src/repro/kernels/wkv6.py:62).  Same function, per (batch, head), with
// the (hd, hd) fp32 state S carried across T:
//   y_t = sum_k r_t[k] * (S[k, :] + u[k] * k_t[k] * v_t[:])
//   S   = diag(w_t) S + k_t v_t^T
// The TPU kernel's "chunk" is a VMEM blocking of T on a sequential grid;
// here one block walks all of T for its (b, h), so the state never leaves
// registers between steps.
//
// What bounds it on the card: bytes.  Each element of r, k, v, w is read
// once and each of y written once (2 flops per state element and step,
// 4 * hd^2 per (b, h, t): about 0.2 flop per byte moved at bf16 inputs),
// plus the state read and written once.  At decode (T = 1) the state is
// the whole traffic.
//
// What the design does about it:
//  * one block of hd = 64 threads per (b, h); thread j owns column j of S
//    in 64 registers, so the state is read once and written once;
//  * r, k, v (bf16 or fp32) and w (fp32) are read strided in place from
//    the (B, T, H, hd) projections layout, 32 timesteps per pass staged in
//    shared memory with one coalesced 64-element load per tensor and step
//    (no transposed copies), converted to fp32 as they are staged (exact);
//  * y_t is written in the inputs' dtype from an fp32 sum (the reference
//    rounds its fp32 y once, to the compute dtype, at the same point);
//  * sT may alias s0: a thread reads its whole column before the loop
//    and writes it after, and no other block touches that (b, h), so the
//    decode tick updates its state in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;   // head dim: one thread per state column
constexpr int TC = 32;   // timesteps staged per pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(HD) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, T* __restrict__ y,
    float* sT, int n_t, int H) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  __shared__ __align__(16) float rs[TC][HD];
  __shared__ __align__(16) float ks[TC][HD];
  __shared__ __align__(16) float ws[TC][HD];
  __shared__ __align__(16) float vs[TC][HD];
  __shared__ __align__(16) float us[HD];
  float S[HD];
  const float* s_in = s0 + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s_in[i * HD + j];
  us[j] = u[h * HD + j];
  for (int t0 = 0; t0 < n_t; t0 += TC) {
    const int tc = min(TC, n_t - t0);
    __syncthreads();  // the previous pass's reads of the stage are done
    for (int tt = 0; tt < tc; ++tt) {
      const size_t off = (((size_t)b * n_t + t0 + tt) * H + h) * HD + j;
      rs[tt][j] = to_f(r[off]);
      ks[tt][j] = to_f(k[off]);
      vs[tt][j] = to_f(v[off]);
      ws[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < tc; ++tt) {
      const float vj = vs[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(rs[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[tt]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[tt]);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float acc = 0.f;
#pragma unroll
      for (int i4 = 0; i4 < HD / 4; ++i4) {
        const float4 rr = r4[i4], kk = k4[i4], ww = w4[i4], uu = u4[i4];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv_[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
        const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i4 * 4 + e;
          const float kv = kv_[e] * vj;
          acc += (S[i] + uv[e] * kv) * rv[e];
          S[i] = wv[e] * S[i] + kv;
        }
      }
      store(y + (((size_t)b * n_t + t0 + tt) * H + h) * HD + j, acc);
    }
  }
  float* s_out = sT + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[i * HD + j] = S[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int B,
           int n_t, int H, cudaStream_t stream) {
  wkv6_kernel<T><<<B * H, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sT), n_t, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v (B, T, H, 64) contiguous, bf16 (in_bf16 = 1) or fp32; w (B, T,
// H, 64) fp32; u (H, 64) fp32; s0 (B, H, 64, 64) fp32.  Writes y (B, T,
// H, 64) in the dtype of r and sT (B, H, 64, 64) fp32; sT may be s0.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s0, void* y,
                    void* sT, int B, int n_t, int H, int hd, int in_bf16,
                    void* stream) {
  if (hd != HD || B <= 0 || n_t <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, n_t,
                                         H, st)
                 : launch<float>(r, k, v, w, u, s0, y, sT, B, n_t, H, st);
}
