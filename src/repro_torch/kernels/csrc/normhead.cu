// K5: fused NormHead logits for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `normhead_matmul` (pallas_call at
// src/repro/kernels/normhead.py:54).  Same function:
//   out[t, v] = (x[t] . W[v]) / max(||W[v]||, eps)        (fp32 (T, V))
// with the row's squared norm accumulated beside the dot products while
// W is read, and the division after the accumulation, as the TPU kernel
// does (normhead.py:38-42).  No normalized copy of W is ever written.
//
// What bounds it on the card: bytes.  Serving calls it with T <= 8 rows
// of x against the whole head (Ling-Lite 126464 x 2048 fp32, 1.04 GB;
// rwkv6-3b 65536 x 2560 fp32, 0.67 GB): 2 * T flops per weight element
// against 4 bytes, far below the tensor cores' ridge point.
//
// What the design does about it:
//  * one warp per vocab row: the warp streams the row once, 16 bytes a
//    lane per load (4 fp32 or 8 bf16 weights), coalesced, and accumulates
//    the squared norm and the row's dot products with up to 8 rows of x
//    in registers; a warp reduce and one division end the row.  A block
//    of 8 warps owns 32 consecutive rows;
//  * the x rows (bf16 or fp32, converted to fp32) are staged once per
//    block in shared memory, up to 8 rows per pass.  T > 8 takes several
//    passes over the block's rows; the block's 32 rows (<= 320 KB) are
//    read again right after the first pass, mostly from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int TT = 8;               // rows of x per pass
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of a weight row as fp32: 4 fp32 or 8 bf16 values.
template <typename W>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename X, typename W>
__global__ void __launch_bounds__(NT) normhead_kernel(
    const X* __restrict__ x, const W* __restrict__ w, float* __restrict__ out,
    int n_t, int V, int d, float eps) {
  extern __shared__ __align__(16) float xs[];  // [min(n_t, TT)][d]
  constexpr int VN = Vec<W>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;
  for (int t0 = 0; t0 < n_t; t0 += TT) {
    const int tt = min(TT, n_t - t0);
    __syncthreads();  // the previous pass's reads of xs are done
    for (int i = threadIdx.x; i < tt * d; i += NT)
      xs[i] = to_f(x[(size_t)t0 * d + i]);
    __syncthreads();
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int row = row0 + rr;
      if (row >= V) break;
      const W* wr = w + (size_t)row * d;
      float acc[TT];
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = 0.f;
      float nrm = 0.f;
#pragma unroll 4
      for (int c = lane * VN; c < d; c += 32 * VN) {
        float wv[VN];
        Vec<W>::load(wr + c, wv);
#pragma unroll
        for (int e = 0; e < VN; ++e) nrm += wv[e] * wv[e];
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t < tt) {
            // t * d + c is a multiple of 4 (d % 4 == 0, c % VN == 0)
            const float4* xr = reinterpret_cast<const float4*>(xs + t * d + c);
            float s = 0.f;
#pragma unroll
            for (int q = 0; q < VN / 4; ++q) {
              const float4 a = xr[q];
              s += a.x * wv[4 * q] + a.y * wv[4 * q + 1] +
                   a.z * wv[4 * q + 2] + a.w * wv[4 * q + 3];
            }
            acc[t] += s;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        nrm += __shfl_xor_sync(0xffffffffu, nrm, off);
#pragma unroll
        for (int t = 0; t < TT; ++t)
          acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
      }
      const float den = fmaxf(sqrtf(nrm), eps);
#pragma unroll
      for (int t = 0; t < TT; ++t)
        if (t < tt && lane == t)
          out[(size_t)(t0 + t) * V + row] = acc[t] / den;
    }
  }
}

template <typename X, typename W>
int launch(const void* x, const void* w, void* out, int n_t, int V, int d,
           float eps, cudaStream_t stream) {
  const size_t smem = (size_t)(n_t < TT ? n_t : TT) * d * sizeof(float);
  auto kern = normhead_kernel<X, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(V + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, NT, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const W*>(w),
      static_cast<float*>(out), n_t, V, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, d) contiguous, bf16 (x_bf16 = 1) or fp32; w (V, d) contiguous,
// bf16 (w_bf16 = 1) or fp32, rows 16-byte aligned (d * sizeof(w) % 16 ==
// 0); out (T, V) fp32.  Needs min(T, 8) * d * 4 bytes of shared memory.
extern "C" int normhead_matmul(const void* x, const void* w, void* out,
                               int n_t, int V, int d, int x_bf16, int w_bf16,
                               float eps, void* stream) {
  const int vn = w_bf16 ? 8 : 4;
  if (n_t <= 0 || V <= 0 || d <= 0 || d % vn != 0 ||
      (size_t)(n_t < TT ? n_t : TT) * d * sizeof(float) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, n_t, V,
                                                         d, eps, st)
                  : launch<__nv_bfloat16, float>(x, w, out, n_t, V, d, eps,
                                                 st);
  return w_bf16 ? launch<float, __nv_bfloat16>(x, w, out, n_t, V, d, eps, st)
                : launch<float, float>(x, w, out, n_t, V, d, eps, st);
}
