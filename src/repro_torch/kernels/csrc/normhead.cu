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
// against 4 bytes.  Even at T = 64 the three-piece products below take
// less time on the tensor cores than the head's bytes take from HBM.
//
// What the design does about it:
//  * W streams once, onto the tensor cores ("swap AB"): vocab rows are
//    the M side of mma.sync m16n8k16, rows of x the N side in tiles of 8,
//    up to 64 rows (8 tiles) in one pass over W; T > 64 takes several
//    passes (grid.y).  A warp owns 16 vocab rows, a block 128.
//  * fp32 W is read straight from HBM, 16 bytes a lane per load (streaming
//    loads, a 64-column stage in flight while the previous one is
//    computed), and cut in registers into three exact bf16 pieces
//    (hopper_mma.cuh `split3`).  The k positions inside each k16 step are
//    permuted so that a lane's 16 bytes of a row (columns 4q..4q+3, q =
//    lane % 4) are its A-fragment slots (2q, 2q+1, 2q+8, 2q+9); x's B
//    fragment is read in the same permutation, so only a sum's order
//    changes.  x is bf16 on every serving path and exact as a B
//    fragment; an fp32 x (tests only) comes as its three bf16 pieces,
//    cut by the wrapper, and fp32 x fp32 runs the six piece products with
//    i + j <= 2, as K2's weight gradient does.  A bf16 W is one piece.
//  * The tensor cores truncate their sums (hopper_mma.cuh `promote`):
//    each 64-column stage (4 k16 steps) adds into fresh registers, which
//    are then added to the fp32 accumulators; the leading piece product
//    and the smaller ones go to separate registers, so a large partial
//    sum is truncated at most 4 times before it is promoted.
//  * The squared norm is summed from the fp32 (or bf16) values on the
//    CUDA cores beside the products, a stage at a time, and reduced over
//    the quad at the end; one division per output.
//  * x goes to shared memory in slices of 128 columns (every piece, every
//    row of the pass), double-buffered by cp.async, which every warp of
//    the block walks together: x at T = 64 and d = 2560 (320 KB in bf16)
//    does not fit whole.  Rows are padded by 32 bytes, so a warp's B
//    fragments hit distinct banks.
#include <math.h>

#include "hopper_mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int NTH = WARPS * 32;
constexpr int ROWS_W = 16;              // vocab rows a warp (mma M)
constexpr int ROWS_B = WARPS * ROWS_W;  // vocab rows a block
constexpr int KST = 64;                 // columns a stage: 4 k16 steps
constexpr int KSL = 2 * KST;            // columns of an x slice
constexpr int XLD = KSL + 16;           // x slice row stride (bf16)
constexpr int PASS_ROWS = 64;           // rows of x a pass, at most

// one stage of a lane's W: rows g and g + 8, columns 16 kk + 4q .. + 3
template <typename W>
struct Stage;
template <>
struct Stage<float> {
  float4 v[4][2];
};
template <>
struct Stage<bf16> {
  uint2 v[4][2];
};

__device__ __forceinline__ float4 ld_w(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 ld_w(const bf16* p) {
  return __ldcs(reinterpret_cast<const uint2*>(p));
}

template <typename W>
__device__ __forceinline__ void load_stage(Stage<W>& s, const W* wa,
                                           const W* wb, int st) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    s.v[kk][0] = ld_w(wa + st * KST + 16 * kk);
    s.v[kk][1] = ld_w(wb + st * KST + 16 * kk);
  }
}

__device__ __forceinline__ float sq4(float4 p, float n) {
  return fmaf(p.w, p.w, fmaf(p.z, p.z, fmaf(p.y, p.y, fmaf(p.x, p.x, n))));
}

// The A fragments (NPW pieces) of k16 step kk, and the rows' squared norms
__device__ __forceinline__ void frags(const Stage<float>& s, int kk,
                                      uint32_t (&a)[3][4], float& n0,
                                      float& n1) {
  const float4 p = s.v[kk][0], q = s.v[kk][1];
  n0 = sq4(p, n0);
  n1 = sq4(q, n1);
  const float v[8] = {p.x, p.y, q.x, q.y, p.z, p.w, q.z, q.w};
  split_frag(v, a);
}
__device__ __forceinline__ void frags(const Stage<bf16>& s, int kk,
                                      uint32_t (&a)[1][4], float& n0,
                                      float& n1) {
  const uint2 p = s.v[kk][0], q = s.v[kk][1];
  const auto f4 = [](uint2 u) {
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  };
  n0 = sq4(f4(p), n0);
  n1 = sq4(f4(q), n1);
  a[0][0] = p.x;
  a[0][1] = q.x;
  a[0][2] = p.y;
  a[0][3] = q.y;
}

// acc += one stage (4 k16 steps) of the warp's 16 rows of W against the
// pass's rows of x (slice columns c0 .. c0 + 63).  The stage sums in fresh
// registers first: the leading piece product in `part`, the smaller ones
// (i + j >= 1) in `tail`, so the truncation of the large partial sums
// happens 4 times a stage, not up to 24.  The stage's squared norms are
// summed apart as well, then added to n0, n1.
template <int NTL, int NPW, int NPX, typename W>
__device__ __forceinline__ void stage_mma(float (&acc)[NTL][4],
                                          const Stage<W>& s,
                                          const bf16* xs, int c0, int g,
                                          int q, float& n0, float& n1) {
  constexpr bool TAIL = NPW * NPX > 1;
  float part[NTL][4], tail[NTL][4];
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    zero(part[nt]);
    zero(tail[nt]);
  }
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[NPW][4];
    frags(s, kk, a, m0, m1);
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
#pragma unroll
      for (int px = 0; px < NPX; ++px) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            xs + (px * NTL * 8 + nt * 8 + g) * XLD + c0 + 16 * kk + 4 * q);
#pragma unroll
        for (int pw = 0; pw < NPW; ++pw) {
          if (pw + px == 0)
            mma16816(part[nt], a[pw], b.x, b.y);
          else if (pw + px <= 2)
            mma16816(tail[nt], a[pw], b.x, b.y);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    promote(acc[nt], part[nt]);
    if constexpr (TAIL) promote(acc[nt], tail[nt]);
  }
  n0 += m0;
  n1 += m1;
}

template <int NTL, int NPX>
struct XSmem {
  static constexpr int BUF = NPX * NTL * 8 * XLD;  // bf16 of one slice
  static constexpr int BYTES = 2 * BUF * 2;
};

// Grid (vocab blocks, passes): block (bx, p) computes rows 128 bx .. of
// the vocabulary against rows 8 NTL p .. of x.  x: NPX bf16 planes (T,
// d); W: fp32 (NPW = 3) or bf16 (NPW = 1), (V, d).
template <int NTL, int NPW, int NPX>
__global__ void __launch_bounds__(NTH, NTL <= 2 ? 2 : 1) normhead_kernel(
    const bf16* __restrict__ x,
    const typename std::conditional<NPW == 3, float, bf16>::type* __restrict__ w,
    float* __restrict__ out, int n_t, int V, int d, float eps) {
  using W = typename std::conditional<NPW == 3, float, bf16>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int v0 = blockIdx.x * ROWS_B + warp * ROWS_W;
  const int t0 = blockIdx.y * NTL * 8;
  // rows past V read row V - 1 and are never stored
  const W* wa = w + (size_t)min(v0 + g, V - 1) * d + 4 * q;
  const W* wb = w + (size_t)min(v0 + g + 8, V - 1) * d + 4 * q;
  const int n_st = d / KST, n_sl = (d + KSL - 1) / KSL;

  // slice sl of every piece and row of the pass -> buffer sl & 1, zero
  // past T and past d
  auto load_x = [&](int sl) {
    bf16* buf = xs + (sl & 1) * XSmem<NTL, NPX>::BUF;
    constexpr int CPR = KSL / 8, ROWS = NTL * 8;
    for (int i = tid; i < NPX * ROWS * CPR; i += NTH) {
      const int pr = i / CPR, c = (i % CPR) * 8;
      const int t = t0 + pr % ROWS, col = sl * KSL + c;
      const bool ok = t < n_t && col < d;
      const bf16* src = ok ? x + ((size_t)(pr / ROWS) * n_t + t) * d + col : x;
      cp_async<16>(smem_u32(buf + pr * XLD + c), src, ok);
    }
    cp_async_commit();
  };

  float acc[NTL][4];
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) zero(acc[nt]);
  float n0 = 0.f, n1 = 0.f;
  Stage<W> A, B;
  load_stage(A, wa, wb, 0);
  load_x(0);
  for (int sl = 0; sl < n_sl; ++sl) {
    if (sl + 1 < n_sl) {
      load_x(sl + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice sl is in place
    const bf16* buf = xs + (sl & 1) * XSmem<NTL, NPX>::BUF;
    const int s0 = 2 * sl;
    // the next stage's loads are in flight while this one computes
    if (s0 + 1 < n_st) load_stage(B, wa, wb, s0 + 1);
    stage_mma<NTL, NPW, NPX>(acc, A, buf, 0, g, q, n0, n1);
    if (s0 + 1 < n_st) {
      if (s0 + 2 < n_st) load_stage(A, wa, wb, s0 + 2);
      stage_mma<NTL, NPW, NPX>(acc, B, buf, KST, g, q, n0, n1);
    }
    __syncthreads();  // every warp is done with buffer sl & 1
  }

  n0 += __shfl_xor_sync(0xffffffffu, n0, 1);
  n0 += __shfl_xor_sync(0xffffffffu, n0, 2);
  n1 += __shfl_xor_sync(0xffffffffu, n1, 1);
  n1 += __shfl_xor_sync(0xffffffffu, n1, 2);
  const float d0 = fmaxf(sqrtf(n0), eps), d1 = fmaxf(sqrtf(n1), eps);
  const int va = v0 + g, vb = v0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    const int t = t0 + nt * 8 + 2 * q;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (t + e >= n_t) continue;
      if (va < V) out[(size_t)(t + e) * V + va] = acc[nt][e] / d0;
      if (vb < V) out[(size_t)(t + e) * V + vb] = acc[nt][2 + e] / d1;
    }
  }
}

template <int NTL, int NPW, int NPX>
int launch(const void* x, const void* w, void* out, int n_t, int V, int d,
           float eps, cudaStream_t stream) {
  using W = typename std::conditional<NPW == 3, float, bf16>::type;
  constexpr int smem = XSmem<NTL, NPX>::BYTES;
  static bool granted[MAX_DEVICES] = {};
  const int err = opt_in_smem(normhead_kernel<NTL, NPW, NPX>, smem, granted);
  if (err) return err;
  const dim3 grid((V + ROWS_B - 1) / ROWS_B, (n_t + NTL * 8 - 1) / (NTL * 8));
  normhead_kernel<NTL, NPW, NPX><<<grid, NTH, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const W*>(w),
      static_cast<float*>(out), n_t, V, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int NPW, int NPX>
int launch_rows(const void* x, const void* w, void* out, int n_t, int V,
                int d, float eps, cudaStream_t st) {
  const int n = n_t < PASS_ROWS ? n_t : PASS_ROWS;
  if (n <= 8) return launch<1, NPW, NPX>(x, w, out, n_t, V, d, eps, st);
  if (n <= 16) return launch<2, NPW, NPX>(x, w, out, n_t, V, d, eps, st);
  if (n <= 32) return launch<4, NPW, NPX>(x, w, out, n_t, V, d, eps, st);
  return launch<8, NPW, NPX>(x, w, out, n_t, V, d, eps, st);
}

}  // namespace

// x: x_pieces (1 or 3) bf16 planes (T, d), contiguous (an fp32 x is cut
// into its three pieces by the caller); w (V, d) contiguous, bf16
// (w_bf16 = 1) or fp32; d a multiple of 64; x and w 16-byte aligned; out
// (T, V) fp32.
extern "C" int normhead_matmul(const void* x, const void* w, void* out,
                               int n_t, int V, int d, int x_pieces,
                               int w_bf16, float eps, void* stream) {
  if (n_t <= 0 || V <= 0 || d <= 0 || d % KST != 0 ||
      (x_pieces != 1 && x_pieces != 3) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_pieces == 1)
    return w_bf16 ? launch_rows<1, 1>(x, w, out, n_t, V, d, eps, st)
                  : launch_rows<3, 1>(x, w, out, n_t, V, d, eps, st);
  return w_bf16 ? launch_rows<1, 3>(x, w, out, n_t, V, d, eps, st)
                : launch_rows<3, 3>(x, w, out, n_t, V, d, eps, st);
}
