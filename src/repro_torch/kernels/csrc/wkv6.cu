// K6: the WKV6 recurrence (RWKV6 "Finch" time mix) for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel `wkv6_chunked` (pallas_call at
// src/repro/kernels/wkv6.py:62).  Same function, per (batch, head), with
// the (hd, hd) fp32 state S carried across T:
//   y_t = sum_i r_t[i] * (S[i, :] + u[i] * k_t[i] * v_t[:])
//   S   = diag(w_t) S + k_t v_t^T
// The TPU kernel's "chunk" is a VMEM blocking of T on a sequential grid;
// here a block walks all of T for its (b, h, column half), so the state
// never leaves registers between steps.
//
// What bounds it on the card: operations at prefill, bytes at decode.
// Each element of r, k, v, w is read once and each of y written once,
// plus the state read and written once: 40.7 us of HBM traffic for
// rwkv6-3b's 8 x 512-token prefill.  But every state element takes three
// fp32 instructions a step (y's FMA, k*v, the decayed FMA): 671 M
// element-steps, ~60 us on all 16896 fp32 lanes at ~2 GHz, and the
// recurrence is sequential in t, so only (b, h) pairs and the state's
// elements give parallelism.  At decode (T = 1) the 5.2 MB state is the
// whole traffic.
//
// What the design does about it:
//  * Two blocks of 64 threads per (b, h), one per half of the state's
//    64 columns (B * H * 2 = 640 blocks at rwkv6-3b: ~5 a SM, all
//    resident, against 320 whole blocks before), so an SM's critical
//    path is 5 half-blocks instead of 3 whole ones.  Thread (g, c) of a
//    block holds S[8g:8g+8, 4c:4c+4] of its half in 32 registers: each
//    step reads r, k, w of its 8 rows and v of its 4 columns from shared
//    memory, 28 values for 96 FP32 instructions; the step loop is ~120
//    instructions for 32 elements.  (2 or 8 columns a thread, or 4 rows,
//    ran 0.175-0.22 ms against 0.163 at rwkv6-3b's prefill on an H100.)
//  * Short chains.  y_j = sum_i r_i S_ij + v_j * ruk with ruk = sum_i
//    r_i u_i k_i (exact algebra: the bonus term leaves the inner loop and
//    only fp32 summation order changes).  A thread sums its 8 rows of
//    r_i S_ij for each of its 4 columns in two chains (even and odd
//    rows), writes the group's partial to shared memory, and after the
//    chunk the 8 groups' partials are added in the fixed order g = 0..7,
//    then v_j * ruk, so y is deterministic.  ruk is computed once per
//    step (8 lanes a step, a 3-level butterfly).
//  * Overlapped staging, one barrier a chunk.  8 timesteps a chunk; the
//    r, k, v (this block's 32 columns) and w of chunk c + 2 go to shared
//    memory by 16-byte cp.async, strided in place from the (B, T, H, hd)
//    layout (no transposed copies), while chunk c is computed.  Beside
//    that chunk's recurrence, and with no barrier between them, each
//    thread sums one (step, 4-column) slice of chunk c - 1's y and
//    converts one slice of chunk c + 1 to fp32 (r, k, v: exact), with
//    its ruk; w is fp32 as given.  (16-step chunks with the y sums and
//    conversions in phases of their own, between two barriers a chunk,
//    ran 0.167 ms; two chunks in flight there needed 52 KB of shared
//    memory, 4 blocks a SM, and ran 0.24 ms.)
//  * y_t is written in the inputs' dtype from an fp32 sum (the reference
//    rounds its fp32 y once, to the compute dtype, at the same point).
//  * sT may alias s0: a thread reads its 32 state elements before the
//    loop and writes them after, and no other thread touches them, so the
//    decode tick updates its state in place.
//  * The tensor cores stay out: a chunked matmul form with a per-channel
//    data-dependent decay needs cumulative decays in log space, which
//    overflow where w is near 0.
#include "hopper_mma.cuh"

namespace {

constexpr int HD = 64;             // head dim
constexpr int HALF = HD / 2;       // state columns a block owns
constexpr int RG = 8;              // state rows a thread owns
constexpr int CW = 4;              // state columns a thread owns
constexpr int NG = HD / RG;        // row groups: 8
constexpr int NCQ = HALF / CW;     // column groups a block owns: 8
constexpr int NTH = NG * NCQ;      // 64 threads
constexpr int TC = 8;              // timesteps a chunk
static_assert(TC * 8 == NTH, "one convert and one ysum task a thread");
static_assert(RG % 4 == 0 && CW % 4 == 0, "float4 loads");

// Dynamic shared memory, by chunk c: three raw chunks (cp.async targets:
// r, k, v as given, w fp32; c is computed, c + 1 converted, c + 2
// loading), r and k in fp32 for c and c + 1, v in fp32 and ruk for c - 1
// (summed), c and c + 1, the groups' partial y for c - 1 and c, and u.
template <typename T>
struct Smem {
  static constexpr int R_B = TC * HD * sizeof(T);     // raw r (or k)
  static constexpr int V_B = TC * HALF * sizeof(T);   // raw v, this half
  static constexpr int W_B = TC * HD * 4;             // w, fp32
  static constexpr int RAW = 2 * R_B + V_B + W_B;
  static constexpr int RK = 2 * TC * HD;              // floats: rf, kf
  static constexpr int VF = TC * HALF;                // floats: vf
  static constexpr int YP = TC * NG * HALF;           // floats: partial y
  static constexpr int TOTAL =
      3 * RAW + 4 * (2 * RK + 3 * VF + 2 * YP + HD + 3 * TC);
};

__device__ __forceinline__ void to_f8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void to_f8(const bf16* p, float (&o)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float4 to_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 to_f4(const bf16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// N consecutive values as fp32, and N fp32 stores (N a multiple of 4)
template <int N, typename T>
__device__ __forceinline__ void ld_n(const T* p, float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = to_f4(p + i);
    o[i] = q.x; o[i + 1] = q.y; o[i + 2] = q.z; o[i + 3] = q.w;
  }
}
template <int N>
__device__ __forceinline__ void st_n(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// The first `steps` timesteps of a chunk, N 16-byte pieces each, of src
// (timestep s at src + s * ld) -> dst (rows of N pieces), shared by the
// block.  Rows past `steps` are left as they are: nothing reads them
// into a result.
template <int N, typename E>
__device__ __forceinline__ void copy_steps(uint8_t* dst, const E* src,
                                           size_t ld, int steps, int tid) {
  constexpr int PER = 16 / sizeof(E), M = (TC * N + NTH - 1) / NTH;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = tid + m * NTH, s = i / N, q = i % N;
    if ((TC * N % NTH == 0 || i < TC * N) && s < steps)
      cp_async<16>(smem_u32(dst + i * 16), src + s * ld + q * PER, true);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTH, 6) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, T* __restrict__ y,
    float* sT, int n_t, int H) {
  using S = Smem<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* const fbase = reinterpret_cast<float*>(smem + 3 * S::RAW);
  float* const vfb = fbase + 2 * S::RK;
  float* const ypb = vfb + 3 * S::VF;
  float* const us = ypb + 2 * S::YP;
  float* const rukb = us + HD;       // [3][TC]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x >> 1, j0 = (blockIdx.x & 1) * HALF;
  const int b = bh / H, h = bh % H;
  const int g = tid / NCQ, c4 = CW * (tid % NCQ), row0 = g * RG;
  const size_t ld = (size_t)H * HD;                   // one timestep
  const size_t base = ((size_t)b * n_t * H + h) * HD;  // (b, 0, h, 0)
  const int n_c = (n_t + TC - 1) / TC;

  // the thread's RG x CW state elements: rows row0.., columns j0 + c4..
  float st[RG][CW];
  const size_t s_off = (size_t)bh * HD * HD + (size_t)row0 * HD + j0 + c4;
#pragma unroll
  for (int i = 0; i < RG; ++i) ld_n(s0 + s_off + i * HD, st[i]);
  for (int i = tid; i < HD; i += NTH) us[i] = u[h * HD + i];

  auto raw = [&](int c) { return smem + (c % 3) * S::RAW; };
  auto rf = [&](int c) { return fbase + (c & 1) * S::RK; };  // kf: + TC HD
  auto vf = [&](int c) { return vfb + (c % 3) * S::VF; };
  auto yp = [&](int c) { return ypb + (c & 1) * S::YP; };    // [TC][NG][HALF]
  auto ruk = [&](int c) { return rukb + (c % 3) * TC; };

  // chunk c's r, k, v (this half's columns), w -> its raw buffer by
  // 16-byte copies; one commit group a chunk (empty past the last)
  auto load = [&](int c) {
    if (c < n_c) {
      uint8_t* buf = raw(c);
      const size_t off = base + (size_t)c * TC * ld;
      const int steps = min(TC, n_t - c * TC);
      constexpr int PR = HD * sizeof(T) / 16, PV = HALF * sizeof(T) / 16;
      copy_steps<PR>(buf, r + off, ld, steps, tid);
      copy_steps<PR>(buf + S::R_B, k + off, ld, steps, tid);
      copy_steps<PV>(buf + 2 * S::R_B, v + off + j0, ld, steps, tid);
      copy_steps<HD / 4>(buf + 2 * S::R_B + S::V_B, w + off, ld, steps,
                         tid);
    }
    cp_async_commit();
  };

  // raw chunk c -> r, k (rows 8p..8p+7) and v (columns 4p..4p+3) of
  // timestep s in fp32 (exact), and ruk(c)[s] = sum_i r_i u_i k_i: the 8
  // lanes of a timestep add their partials in a butterfly
  auto convert = [&](int c) {
    const uint8_t* buf = raw(c);
    const int s = tid >> 3, p = tid & 7;
    float rv[8], kv[8], vv[4];
    to_f8(reinterpret_cast<const T*>(buf) + s * HD + 8 * p, rv);
    to_f8(reinterpret_cast<const T*>(buf + S::R_B) + s * HD + 8 * p, kv);
    ld_n(reinterpret_cast<const T*>(buf + 2 * S::R_B) + s * HALF + 4 * p,
         vv);
    st_n(rf(c) + s * HD + 8 * p, rv);
    st_n(rf(c) + TC * HD + s * HD + 8 * p, kv);
    st_n(vf(c) + s * HALF + 4 * p, vv);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) part = fmaf(rv[e] * us[8 * p + e], kv[e], part);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    if (p == 0) ruk(c)[s] = part;
  };

  // y of chunk c: thread (s, q) adds timestep s's 8 partials of columns
  // 4q..4q+3 in the order g = 0..7, then v * ruk, and stores them
  auto ysum = [&](int c) {
    const int s = tid >> 3, q = 4 * (tid & 7), t = c * TC + s;
    if (t >= n_t) return;
    const float* ys = yp(c) + s * NG * HALF + q;
    float4 acc = to_f4(ys);
#pragma unroll
    for (int gg = 1; gg < NG; ++gg) {
      const float4 p = to_f4(ys + gg * HALF);
      acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
    }
    const float4 vv = to_f4(vf(c) + s * HALF + q);
    const float rk = ruk(c)[s];
    acc.x = fmaf(vv.x, rk, acc.x);
    acc.y = fmaf(vv.y, rk, acc.y);
    acc.z = fmaf(vv.z, rk, acc.z);
    acc.w = fmaf(vv.w, rk, acc.w);
    store4(y + base + (size_t)t * ld + j0 + q, acc);
  };

  load(0);
  load(1);
  cp_async_wait<1>();
  __syncthreads();
  convert(0);
  for (int c = 0; c < n_c; ++c) {
    cp_async_wait<0>();
    // chunk c is converted, chunk c + 1 has landed, yp(c - 1) is
    // complete, and every reader of raw(c + 2), rf(c + 1) and yp(c) is
    // done
    __syncthreads();
    load(c + 2);
    // beside this chunk's recurrence: the previous chunk's y and the next
    // chunk's conversion, one task a thread each, no barrier between
    if (c > 0) ysum(c - 1);
    if (c + 1 < n_c) convert(c + 1);
    {  // the recurrence over chunk c: each step's group partial of y to
       // yp(c), then the state update (inline: st stays in registers)
      const float* rr_ = rf(c) + row0;
      const float* kk_ = rf(c) + TC * HD + row0;
      const float* vr = vf(c) + c4;
      const float* wr = reinterpret_cast<const float*>(
                            raw(c) + 2 * S::R_B + S::V_B) + row0;
      float* yo = yp(c) + g * HALF + c4;
      const int tc = min(TC, n_t - c * TC);
#pragma unroll 2
      for (int s = 0; s < tc; ++s) {
        float rr[RG], kk[RG], ww[RG], vv[CW], a0[CW], a1[CW];
        ld_n(rr_ + s * HD, rr);
        ld_n(kk_ + s * HD, kk);
        ld_n(wr + s * HD, ww);
        ld_n(vr + s * HALF, vv);
#pragma unroll
        for (int j = 0; j < CW; ++j) a0[j] = a1[j] = 0.f;
#pragma unroll
        for (int i = 0; i < RG; i += 2) {
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            a0[j] = fmaf(rr[i], st[i][j], a0[j]);
            a1[j] = fmaf(rr[i + 1], st[i + 1][j], a1[j]);
          }
        }
#pragma unroll
        for (int i = 0; i < RG; ++i) {
#pragma unroll
          for (int j = 0; j < CW; ++j)
            st[i][j] = fmaf(ww[i], st[i][j], kk[i] * vv[j]);
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) a0[j] += a1[j];
        st_n(yo + s * NG * HALF, a0);
      }
    }
  }
  __syncthreads();  // yp of the last chunk is complete
  ysum(n_c - 1);
#pragma unroll
  for (int i = 0; i < RG; ++i) st_n(sT + s_off + i * HD, st[i]);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int B,
           int n_t, int H, cudaStream_t stream) {
  constexpr int smem = Smem<T>::TOTAL;
  static bool granted[MAX_DEVICES] = {};
  const int err = opt_in_smem(wkv6_kernel<T>, smem, granted);
  if (err) return err;
  wkv6_kernel<T><<<B * H * 2, NTH, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sT), n_t, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v (B, T, H, 64) contiguous, bf16 (in_bf16 = 1) or fp32; w (B, T,
// H, 64) fp32; u (H, 64) fp32; s0 (B, H, 64, 64) fp32; every pointer
// 16-byte aligned.  Writes y (B, T, H, 64) in the dtype of r and sT (B,
// H, 64, 64) fp32; sT may be s0.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s0, void* y,
                    void* sT, int B, int n_t, int H, int hd, int in_bf16,
                    void* stream) {
  const void* ptrs[] = {r, k, v, w, u, s0, y, sT};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  if (hd != HD || B <= 0 || n_t <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch<bf16>(r, k, v, w, u, s0, y, sT, B, n_t, H, st)
                 : launch<float>(r, k, v, w, u, s0, y, sT, B, n_t, H, st);
}
