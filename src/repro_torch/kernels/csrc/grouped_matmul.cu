// K2: grouped matmul over group-aligned rows, and the grouped weight
// gradient that goes with it, for Hopper (sm_90a), CUDA C++.
//
// grouped_matmul_aligned replaces the TPU kernel `grouped_matmul_aligned`
// in src/repro/kernels/grouped_matmul.py (`_kernel`, pallas_call at :124).
// Same function and tile ownership: the rows of lhs (M_pad, K) are laid out
// by kernels/ops.py::_align_groups so that every bm-row tile belongs to one
// group, tile_group[t] names it, and out[tile rows] = lhs[tile rows] @
// rhs[tile_group[t]] with fp32 accumulation; a tile whose tile_group is G
// (past the last group) is written as zeros.  Where the TPU kernel needed
// operands of one dtype, this one reads lhs in fp32 or bf16 and rhs in bf16
// and converts in registers: bf16 -> fp32 is exact, so the products equal
// the reference's fp32 ragged_dot on rhs.astype(float32) up to summation
// order, and the MoE backward never makes an fp32 copy of the expert
// weights.  `trans_b` reads rhs stored as (G, N, K) as its transpose, for
// the backward's products with W^T: each such product would otherwise copy
// the expert weights (G * d * ff bf16, 370 MB at Ling-Lite) into a
// transposed layout first.
//
// grouped_matmul_wgrad computes, per group g, lhs_rows^T @ rhs_rows over
// the rows [off_g, off_g + size_g) of the row-sorted operands, the offsets
// cumulated on the device by the caller: the (G, K, N) weight gradient of
// a ragged dot (the transpose jax.vjp takes of jax.lax.ragged_dot, which
// the reference leaves to XLA outside any Pallas kernel).  Rows past the
// last group contribute nothing.  One launch covers every group: no
// per-group host loop and no read of group_sizes on the host.
//
// What bounds them on the card: operations.  At the training shapes of a
// Ling-Lite MoE layer (12288 routed rows, K and N of 2048 and 1408) each
// product is ~70 GFLOP against ~0.3 GB of operands, far above the ridge
// point.  This first version runs fp32 FMAs on CUDA cores (67 TFLOP/s
// peak, not the tensor cores' 989), in the classic shared-memory tiling:
// a 128 x 128 output tile per 256-thread block, 8 x 8 outputs per thread
// in registers, K streamed in steps of 8 through shared memory (the A tile
// stored k-major so each thread reads its 8 rows as two float4s).  Tensor
// cores (wgmma), TMA and double buffering are later work.  Both kernels
// are deterministic: no atomics, every output element summed in one
// thread in ascending k or row order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 8;    // contraction step
constexpr int NT = 256;  // threads: 16 x 16, each 8 rows x 8 columns

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc[i][j] += As[kk][ty*8 + i] * Bs[kk][tx*8 + j] over one BK step.
__device__ __forceinline__ void mma_tile(const float (*As)[BM],
                                         const float (*Bs)[BN], int ty,
                                         int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
  }
}

// Rows [r_beg, r_end) and columns [n0, n0 + BN) of out (ld = N) from acc;
// columns past N are not written (N is a multiple of 4).
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[8][8],
                                           int r_beg, int r_end, int n0,
                                           int N, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r_beg + ty * 8 + i;
    if (r >= r_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + tx * 8 + h * 4;
      if (c < N)
        *reinterpret_cast<float4*>(out + (size_t)r * N + c) = make_float4(
            acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
            acc[i][h * 4 + 3]);
    }
  }
}

// out (M_pad, N) fp32 = per bm-row tile, lhs_tile @ rhs[tile_group[tile]].
// Grid: (n_m * ceil(bm / BM), ceil(N / BN)); block x covers the rows
// [tile * bm + chunk * BM, min(+BM, (tile + 1) * bm)) of one tile.
template <typename TA, bool TRANS_B>
__global__ void __launch_bounds__(NT) grouped_mm_kernel(
    const TA* __restrict__ lhs, const __nv_bfloat16* __restrict__ rhs,
    const int* __restrict__ tile_group, float* __restrict__ out, int K,
    int N, int G, int bm) {
  const int chunks = (bm + BM - 1) / BM;
  const int tile = blockIdx.x / chunks;
  const int r_beg = tile * bm + (blockIdx.x % chunks) * BM;
  const int r_end = min(r_beg + BM, (tile + 1) * bm);
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int g = tile_group[tile];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (g < G) {
    __shared__ __align__(16) float As[BK][BM];
    __shared__ __align__(16) float Bs[BK][BN];
    const __nv_bfloat16* rg = rhs + (size_t)g * K * N;
    // A: thread -> (row tid / 2, k quad (tid % 2) * 4)
    const int a_row = tid / 2, a_k = (tid % 2) * 4;
    // B as (K, N): thread -> (k tid / 32, n quad (tid % 32) * 4);
    // B as (N, K): thread -> (n tid / 2, k quad (tid % 2) * 4)
    const int b_k = TRANS_B ? (tid % 2) * 4 : tid / 32;
    const int b_n = TRANS_B ? tid / 2 : (tid % 32) * 4;
    for (int k0 = 0; k0 < K; k0 += BK) {
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
      const int ar = r_beg + a_row, ak = k0 + a_k;
      if (ar < r_end && ak < K) va = load4(lhs + (size_t)ar * K + ak);
      As[a_k][a_row] = va.x;
      As[a_k + 1][a_row] = va.y;
      As[a_k + 2][a_row] = va.z;
      As[a_k + 3][a_row] = va.w;
      float4 vb = make_float4(0.f, 0.f, 0.f, 0.f);
      const int bk = k0 + b_k, bn = n0 + b_n;
      if (TRANS_B) {
        if (bn < N && bk < K) vb = load4(rg + (size_t)bn * K + bk);
        Bs[b_k][b_n] = vb.x;
        Bs[b_k + 1][b_n] = vb.y;
        Bs[b_k + 2][b_n] = vb.z;
        Bs[b_k + 3][b_n] = vb.w;
      } else {
        if (bk < K && bn < N) vb = load4(rg + (size_t)bk * N + bn);
        *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = vb;
      }
      __syncthreads();
      mma_tile(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }
  store_tile(out, acc, r_beg, r_end, n0, N, ty, tx);
}

// out (G, K, N) fp32: out[g] = sum over rows r of group g of
// lhs[r, :]^T rhs[r, :].  Grid: (ceil(K / BM), ceil(N / BN), G).
template <typename TA, typename TB>
__global__ void __launch_bounds__(NT) grouped_wgrad_kernel(
    const TA* __restrict__ lhs, const TB* __restrict__ rhs,
    const int* __restrict__ offsets, const int* __restrict__ sizes,
    float* __restrict__ out, int M, int K, int N) {
  const int g = blockIdx.z;
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r_beg = min(offsets[g], M);
  const int r_end = min(r_beg + sizes[g], M);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // both tiles: thread -> (row tid / 32, column quad (tid % 32) * 4)
  const int t_r = tid / 32, t_c = (tid % 32) * 4;
  for (int r0 = r_beg; r0 < r_end; r0 += BK) {
    const int r = r0 + t_r;
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < r_end) {
      if (k0 + t_c < K) va = load4(lhs + (size_t)r * K + k0 + t_c);
      if (n0 + t_c < N) vb = load4(rhs + (size_t)r * N + n0 + t_c);
    }
    *reinterpret_cast<float4*>(&As[t_r][t_c]) = va;
    *reinterpret_cast<float4*>(&Bs[t_r][t_c]) = vb;
    __syncthreads();
    mma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  store_tile(out + (size_t)g * K * N, acc, k0, K, n0, N, ty, tx);
}

}  // namespace

// lhs (M_pad, K) fp32 (lhs_bf16 = 0) or bf16 (1); rhs bf16 (G, K, N), or
// (G, N, K) read transposed when trans_b = 1; tile_group (M_pad / bm,)
// int32; out (M_pad, N) fp32.  K and N must be multiples of 4.  Returns
// the CUDA launch error (0 = none).
extern "C" int grouped_matmul_aligned(const void* lhs, const void* rhs,
                                      const void* tile_group, void* out,
                                      int M_pad, int K, int N, int G, int bm,
                                      int lhs_bf16, int trans_b,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_m = M_pad / bm;
  const dim3 grid(n_m * ((bm + BM - 1) / BM), (N + BN - 1) / BN);
  const auto* b = static_cast<const __nv_bfloat16*>(rhs);
  const auto* tg = static_cast<const int*>(tile_group);
  auto* o = static_cast<float*>(out);
  if (lhs_bf16) {
    const auto* a = static_cast<const __nv_bfloat16*>(lhs);
    if (trans_b)
      grouped_mm_kernel<__nv_bfloat16, true><<<grid, NT, 0, s>>>(
          a, b, tg, o, K, N, G, bm);
    else
      grouped_mm_kernel<__nv_bfloat16, false><<<grid, NT, 0, s>>>(
          a, b, tg, o, K, N, G, bm);
  } else {
    const auto* a = static_cast<const float*>(lhs);
    if (trans_b)
      grouped_mm_kernel<float, true><<<grid, NT, 0, s>>>(a, b, tg, o, K, N,
                                                         G, bm);
    else
      grouped_mm_kernel<float, false><<<grid, NT, 0, s>>>(a, b, tg, o, K,
                                                          N, G, bm);
  }
  return static_cast<int>(cudaGetLastError());
}

// lhs (M, K) fp32 or bf16 (lhs_bf16); rhs (M, N) fp32 or bf16 (rhs_bf16);
// offsets / sizes (G,) int32 row range of each group; out (G, K, N) fp32.
// K and N must be multiples of 4.  Returns the CUDA launch error.
extern "C" int grouped_matmul_wgrad(const void* lhs, const void* rhs,
                                    const void* offsets, const void* sizes,
                                    void* out, int M, int K, int N, int G,
                                    int lhs_bf16, int rhs_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, G);
  const auto* off = static_cast<const int*>(offsets);
  const auto* sz = static_cast<const int*>(sizes);
  auto* o = static_cast<float*>(out);
  using bf = __nv_bfloat16;
  if (lhs_bf16 && rhs_bf16)
    grouped_wgrad_kernel<bf, bf><<<grid, NT, 0, s>>>(
        static_cast<const bf*>(lhs), static_cast<const bf*>(rhs), off, sz, o,
        M, K, N);
  else if (lhs_bf16)
    grouped_wgrad_kernel<bf, float><<<grid, NT, 0, s>>>(
        static_cast<const bf*>(lhs), static_cast<const float*>(rhs), off, sz,
        o, M, K, N);
  else if (rhs_bf16)
    grouped_wgrad_kernel<float, bf><<<grid, NT, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const bf*>(rhs), off, sz,
        o, M, K, N);
  else
    grouped_wgrad_kernel<float, float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs), off,
        sz, o, M, K, N);
  return static_cast<int>(cudaGetLastError());
}
