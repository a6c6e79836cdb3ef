// K1: fused MoE FFN for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `fused_moe_ffn` in
// src/repro/kernels/grouped_matmul.py (`_fused_kernel`, pallas_call at
// :264).  Same function: for every expert-aligned row tile (layout from
// kernels/ops.py::_fused_layout) gather the tile's token rows from the
// unsorted activations x, compute FFN_e = act(x w1_e) * (x w3_e) w2_e with
// fp32 accumulation and an fp32 hidden, scale each row by its router gate,
// and sum each token's gated rows into out (T, d) fp32.
//
// What bounds it on the card: the expert weights.  At serving batch sizes
// (T = 8 decode slots, T = 64 prefill rows) every routed expert's w1/w3/w2
// (3 * d * ff bf16 = 17.3 MB at Ling-Lite) is read once per tile while the
// tile holds a handful of rows, so the kernel is bound by device-memory
// bytes, far below the ridge point of the tensor cores.
//
// What the design does about it:
//  * a tile whose tile_group == G (no expert) returns at once, and a live
//    tile computes only its leading rows that carry a non-zero gate (the
//    layout puts an expert's rows first in its tile), in chunks of 16 rows,
//    so the weight tiles are streamed once per tile rather than once per
//    padding row;
//  * rows are gathered from x by index (no one-hot matmul, which was a
//    Mosaic workaround on the TPU);
//  * products run on CUDA cores in fp32 from bf16 operands, which keeps the
//    reference's fp32 numerics (bf16 x bf16 products are exact in fp32);
//  * three passes: up (grid n_m x ff/64) writes the fp32 hidden h to device
//    memory, down (grid n_m x d/64) writes the gated rows y, and combine
//    (grid T) sums each token's rows in ascending row order, the order the
//    reference's scatter-add uses.  The combine is deterministic: no
//    atomics.  Writing h and y to device memory is a cost the TPU kernel
//    avoided (it kept them in VMEM); at these sizes they are small next to
//    the weights, and fusing them away is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RM = 16;   // rows per row chunk
constexpr int BK = 32;   // contraction tile
constexpr int BN = 64;   // output columns per block
constexpr int NT = 256;  // threads per block: RM rows x (BN / 4) column quads

enum Act { SWIGLU = 0, GEGLU = 1, GELU = 2, SQUARED_RELU = 3 };

// The reference computes the activation in fp32 (jax.nn.silu / gelu with
// approximate=True / relu**2 on fp32 values).
__device__ __forceinline__ float act_fn(int act, float x) {
  if (act == SWIGLU) return x * (1.0f / (1.0f + expf(-x)));
  if (act == GEGLU || act == GELU) {
    const float c = 0.5f * (1.0f + tanhf(0.7978845608028654f *
                                         (x + 0.044715f * (x * x * x))));
    return x * c;
  }
  const float r = fmaxf(x, 0.0f);
  return r * r;
}

// Rows [0, n) of the tile carry every non-zero gate: n is one past the last
// row whose gate is non-zero (0 for a tile that holds no routed row).
__device__ int tile_rows(const float* __restrict__ gates, int bm) {
  __shared__ int n;
  if (threadIdx.x == 0) n = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < bm; r += blockDim.x)
    if (gates[r] != 0.0f) atomicMax(&n, r + 1);
  __syncthreads();
  return n;
}

__device__ __forceinline__ void load_bf16x4(float* dst,
                                            const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
}

// h[tile rows, n0:n0+BN] = act(x_rows w1_e) (* x_rows w3_e), fp32.
__global__ void __launch_bounds__(NT) moe_up_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ w3, const int* __restrict__ row_idx,
    const float* __restrict__ gates, const int* __restrict__ tile_group,
    float* __restrict__ h, int d, int ff, int G, int bm, int act, int gated) {
  const int tile = blockIdx.x;
  const int e = tile_group[tile];
  if (e >= G) return;                       // all-padding tile
  const int n_rows = tile_rows(gates + (size_t)tile * bm, bm);
  if (n_rows == 0) return;
  const int n0 = blockIdx.y * BN;

  __shared__ float xs[RM][BK + 1];
  __shared__ __align__(16) float w1s[BK][BN];
  __shared__ __align__(16) float w3s[BK][BN];
  const int tid = threadIdx.x;
  const int r = tid / (BN / 4);
  const int c = (tid % (BN / 4)) * 4;
  const __nv_bfloat16* w1e = w1 + (size_t)e * d * ff;
  const __nv_bfloat16* w3e = gated ? w3 + (size_t)e * d * ff : nullptr;
  const int* rows = row_idx + (size_t)tile * bm;

  for (int r0 = 0; r0 < n_rows; r0 += RM) {
    float a1[4] = {0.f, 0.f, 0.f, 0.f};
    float a3[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int i = tid; i < RM * BK; i += NT) {
        const int rr = i / BK, kk = i % BK;
        float v = 0.f;
        if (r0 + rr < n_rows)
          v = __bfloat162float(x[(size_t)rows[r0 + rr] * d + k0 + kk]);
        xs[rr][kk] = v;
      }
      for (int i = tid; i < BK * BN / 4; i += NT) {
        const int kk = i / (BN / 4), nn = (i % (BN / 4)) * 4;
        const size_t off = (size_t)(k0 + kk) * ff + n0 + nn;
        load_bf16x4(&w1s[kk][nn], w1e + off);
        if (gated) load_bf16x4(&w3s[kk][nn], w3e + off);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float xv = xs[r][kk];
        const float4 u = *reinterpret_cast<const float4*>(&w1s[kk][c]);
        a1[0] += xv * u.x; a1[1] += xv * u.y;
        a1[2] += xv * u.z; a1[3] += xv * u.w;
        if (gated) {
          const float4 v = *reinterpret_cast<const float4*>(&w3s[kk][c]);
          a3[0] += xv * v.x; a3[1] += xv * v.y;
          a3[2] += xv * v.z; a3[3] += xv * v.w;
        }
      }
      __syncthreads();
    }
    if (r0 + r < n_rows) {
      float* hr = h + ((size_t)tile * bm + r0 + r) * ff + n0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = act_fn(act, a1[j]);
        hr[j] = gated ? a * a3[j] : a;
      }
    }
  }
}

// y[tile rows, n0:n0+BN] = gate * (h_rows w2_e), fp32.
__global__ void __launch_bounds__(NT) moe_down_kernel(
    const float* __restrict__ h, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ gates, const int* __restrict__ tile_group,
    float* __restrict__ y, int d, int ff, int G, int bm) {
  const int tile = blockIdx.x;
  const int e = tile_group[tile];
  if (e >= G) return;
  const float* g = gates + (size_t)tile * bm;
  const int n_rows = tile_rows(g, bm);
  if (n_rows == 0) return;
  const int n0 = blockIdx.y * BN;

  __shared__ float hs[RM][BK + 1];
  __shared__ __align__(16) float w2s[BK][BN];
  const int tid = threadIdx.x;
  const int r = tid / (BN / 4);
  const int c = (tid % (BN / 4)) * 4;
  const __nv_bfloat16* w2e = w2 + (size_t)e * ff * d;
  const float* ht = h + (size_t)tile * bm * ff;

  for (int r0 = 0; r0 < n_rows; r0 += RM) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < ff; k0 += BK) {
      for (int i = tid; i < RM * BK; i += NT) {
        const int rr = i / BK, kk = i % BK;
        hs[rr][kk] = (r0 + rr < n_rows)
                         ? ht[(size_t)(r0 + rr) * ff + k0 + kk] : 0.f;
      }
      for (int i = tid; i < BK * BN / 4; i += NT) {
        const int kk = i / (BN / 4), nn = (i % (BN / 4)) * 4;
        load_bf16x4(&w2s[kk][nn], w2e + (size_t)(k0 + kk) * d + n0 + nn);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float hv = hs[r][kk];
        const float4 u = *reinterpret_cast<const float4*>(&w2s[kk][c]);
        acc[0] += hv * u.x; acc[1] += hv * u.y;
        acc[2] += hv * u.z; acc[3] += hv * u.w;
      }
      __syncthreads();
    }
    if (r0 + r < n_rows) {
      const float gate = g[r0 + r];
      float* yr = y + ((size_t)tile * bm + r0 + r) * d + n0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) yr[j] = acc[j] * gate;
    }
  }
}

// out[t] = sum of y over token t's live rows, ascending row order.
__global__ void moe_combine_kernel(const float* __restrict__ y,
                                   const int* __restrict__ order,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ counts,
                                   float* __restrict__ out, int d) {
  const int t = blockIdx.x;
  const int beg = offsets[t], n = counts[t];
  for (int col = threadIdx.x * 4; col < d; col += blockDim.x * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          y + (size_t)order[beg + j] * d + col);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    *reinterpret_cast<float4*>(out + (size_t)t * d + col) = acc;
  }
}

}  // namespace

// Launches up, down and combine on `stream`.  Scratch h (n_m*bm, ff) and
// y (n_m*bm, d) and the combine index arrays come from the caller.
// Returns the first CUDA launch error (0 = none).
extern "C" int fused_moe_ffn(const void* x, const void* w1, const void* w3,
                             const void* w2, const void* row_idx,
                             const void* gates, const void* tile_group,
                             const void* order, const void* offsets,
                             const void* counts, void* h, void* y, void* out,
                             int T, int d, int ff, int G, int n_m, int bm,
                             int act, int gated, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  moe_up_kernel<<<dim3(n_m, ff / BN), NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w3),
      static_cast<const int*>(row_idx), static_cast<const float*>(gates),
      static_cast<const int*>(tile_group), static_cast<float*>(h), d, ff, G,
      bm, act, gated);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_down_kernel<<<dim3(n_m, d / BN), NT, 0, s>>>(
      static_cast<const float*>(h), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(gates), static_cast<const int*>(tile_group),
      static_cast<float*>(y), d, ff, G, bm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_combine_kernel<<<T, 128, 0, s>>>(
      static_cast<const float*>(y), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<const int*>(counts),
      static_cast<float*>(out), d);
  return static_cast<int>(cudaGetLastError());
}
