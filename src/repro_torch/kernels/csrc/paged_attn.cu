// K3 / K4: two-pass paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels `paged_attn_scores_max` (pass 1, pallas_call at
// src/repro/kernels/paged_attn.py:182) and `paged_attn_accumulate`
// (pass 2, pallas_call at :229).  Same functions:
//   pass 1: m[b, kv, r]   = max over valid positions s of q[r].k[s] * hd^-1/2
//                           (-inf where no position is valid);
//   pass 2: p             = exp(score - m_safe[r]) in fp32, rounded to bf16
//                           before the PV product (the gathered oracle's
//                           `p.astype(cdt)`), num = sum p_bf16 * v and
//                           den = sum p (unrounded fp32).
// q is grouped per kv head, g-major: row r of a (b, kv) block is query
// r % Q of group head r / Q (kernels/ops.py::_pa_group_q).  Page 0 is the
// scratch page; the caller's mask covers unallocated and future positions.
//
// What bounds it on the card: bytes.  Each (slot, kv head) reads its K
// (and in pass 2 V) pages once per row tile and does 2*hd flops per score,
// far below the tensor cores' ridge point; at decode the work is a few
// hundred KB per layer, so launch and latency dominate before bandwidth.
//
// What the design does about it:
//  * grid (slot, kv head, tile of up to 16 query rows): the prefill's
//    g*Q = 4*64 rows split into 16 tiles, so fp32 accumulators stay in
//    registers and enough blocks exist to spread over the SMs;
//  * one block walks its slot's logical pages in order, reading
//    table[b, i] itself (the TPU kernel's sequential grid axis becomes this
//    loop), and skips a page whose mask is false for every row of the
//    tile: unallocated pages at decode and future pages in prefill cost no
//    bytes;
//  * scores are fp32 dots of bf16 operands, scaled after the dot, exactly
//    the reference's order of operations, so the two passes agree with the
//    gathered path up to fp32 summation order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block (>= head_dim)
constexpr int RT = 16;       // query rows per block
constexpr int HD_MAX = 128;  // head_dim limit
constexpr int PS_MAX = 32;   // page_size limit

struct Shapes {
  int KV, GQ, hd, ps, n_lp, Q;
  float scale;
};

// Loads the tile's query rows as fp32; returns the row count of the tile.
__device__ int load_q(float (*qs)[HD_MAX + 1], const __nv_bfloat16* q,
                      const Shapes& sh, int b, int kv, int r0) {
  const int rt = min(RT, sh.GQ - r0);
  const __nv_bfloat16* qb = q + (((size_t)b * sh.KV + kv) * sh.GQ + r0) * sh.hd;
  for (int i = threadIdx.x; i < rt * sh.hd; i += NT)
    qs[i / sh.hd][i % sh.hd] = __bfloat162float(qb[i]);
  return rt;
}

__device__ __forceinline__ bool valid_at(const uint8_t* mask, const Shapes& sh,
                                         int b, int row, int i, int j) {
  const int qi = row % sh.Q;
  return mask[(((size_t)b * sh.Q + qi) * sh.n_lp + i) * sh.ps + j] != 0;
}

// True if any (row, position) of logical page i is valid for this tile.
// Also a block-wide barrier.
__device__ bool page_live(const uint8_t* mask, const Shapes& sh, int b,
                          int r0, int rt, int i) {
  int any = 0;
  for (int idx = threadIdx.x; idx < rt * sh.ps; idx += NT)
    any |= valid_at(mask, sh, b, r0 + idx / sh.ps, i, idx % sh.ps);
  return __syncthreads_or(any) != 0;
}

// Loads one page row-block (ps, hd) of kv head `kv` as fp32.
__device__ void load_page(float (*dst)[HD_MAX + 1],
                          const __nv_bfloat16* pool, const Shapes& sh,
                          int page, int kv) {
  for (int idx = threadIdx.x; idx < sh.ps * sh.hd; idx += NT) {
    const int j = idx / sh.hd, dd = idx % sh.hd;
    dst[j][dd] = __bfloat162float(
        pool[(((size_t)page * sh.ps + j) * sh.KV + kv) * sh.hd + dd]);
  }
}

// sc[r][j] = masked, scaled score of tile row r against page position j.
__device__ void page_scores(float (*sc)[PS_MAX], float (*qs)[HD_MAX + 1],
                            float (*ks)[HD_MAX + 1], const uint8_t* mask,
                            const Shapes& sh, int b, int r0, int rt, int i) {
  for (int idx = threadIdx.x; idx < rt * sh.ps; idx += NT) {
    const int r = idx / sh.ps, j = idx % sh.ps;
    float s = 0.f;
    for (int dd = 0; dd < sh.hd; ++dd) s += qs[r][dd] * ks[j][dd];
    s *= sh.scale;
    sc[r][j] = valid_at(mask, sh, b, r0 + r, i, j) ? s : -INFINITY;
  }
}

__global__ void __launch_bounds__(NT) scores_max_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool, const int* __restrict__ table,
    const uint8_t* __restrict__ mask, float* __restrict__ m_out, Shapes sh) {
  const int b = blockIdx.x, kv = blockIdx.y, r0 = blockIdx.z * RT;
  __shared__ float qs[RT][HD_MAX + 1];
  __shared__ float ks[PS_MAX][HD_MAX + 1];
  __shared__ float sc[RT][PS_MAX];
  const int rt = load_q(qs, q, sh, b, kv, r0);
  float m = -INFINITY;                       // thread r < rt owns row r
  for (int i = 0; i < sh.n_lp; ++i) {
    // page_live is a barrier: the previous page's reads of ks/sc are done
    if (!page_live(mask, sh, b, r0, rt, i)) continue;
    load_page(ks, k_pool, sh, table[(size_t)b * sh.n_lp + i], kv);
    __syncthreads();
    page_scores(sc, qs, ks, mask, sh, b, r0, rt, i);
    __syncthreads();
    if (threadIdx.x < rt)
      for (int j = 0; j < sh.ps; ++j) m = fmaxf(m, sc[threadIdx.x][j]);
  }
  if (threadIdx.x < rt)
    m_out[((size_t)b * sh.KV + kv) * sh.GQ + r0 + threadIdx.x] = m;
}

__global__ void __launch_bounds__(NT) accumulate_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ table,
    const uint8_t* __restrict__ mask, const float* __restrict__ m_safe,
    float* __restrict__ num, float* __restrict__ den, Shapes sh) {
  const int b = blockIdx.x, kv = blockIdx.y, r0 = blockIdx.z * RT;
  __shared__ float qs[RT][HD_MAX + 1];
  __shared__ float ks[PS_MAX][HD_MAX + 1];
  __shared__ float vs[PS_MAX][HD_MAX + 1];
  __shared__ float sc[RT][PS_MAX];     // p in fp32 (den)
  __shared__ float pb[RT][PS_MAX];     // p rounded to bf16 (num)
  __shared__ float ms[RT];
  const int rt = load_q(qs, q, sh, b, kv, r0);
  const size_t row0 = ((size_t)b * sh.KV + kv) * sh.GQ + r0;
  if (threadIdx.x < rt) ms[threadIdx.x] = m_safe[row0 + threadIdx.x];
  const int dd = threadIdx.x;                // thread dd owns column dd
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  float dsum = 0.f;                          // thread r < rt owns row r
  for (int i = 0; i < sh.n_lp; ++i) {
    if (!page_live(mask, sh, b, r0, rt, i)) continue;
    const int page = table[(size_t)b * sh.n_lp + i];
    load_page(ks, k_pool, sh, page, kv);
    load_page(vs, v_pool, sh, page, kv);
    __syncthreads();
    page_scores(sc, qs, ks, mask, sh, b, r0, rt, i);
    __syncthreads();
    for (int idx = threadIdx.x; idx < rt * sh.ps; idx += NT) {
      const int r = idx / sh.ps, j = idx % sh.ps;
      const float s = sc[r][j];
      const float p = (s == -INFINITY) ? 0.f : expf(s - ms[r]);
      sc[r][j] = p;
      pb[r][j] = __bfloat162float(__float2bfloat16_rn(p));
    }
    __syncthreads();
    if (threadIdx.x < rt) {
      float part = 0.f;
      for (int j = 0; j < sh.ps; ++j) part += sc[threadIdx.x][j];
      dsum += part;
    }
    if (dd < sh.hd) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < rt) {
          float part = 0.f;
          for (int j = 0; j < sh.ps; ++j) part += pb[r][j] * vs[j][dd];
          acc[r] += part;
        }
      }
    }
  }
  if (dd < sh.hd) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < rt) num[(row0 + r) * sh.hd + dd] = acc[r];
  }
  if (threadIdx.x < rt) den[row0 + threadIdx.x] = dsum;
}

bool shapes_ok(const Shapes& sh) {
  return sh.hd > 0 && sh.hd <= HD_MAX && sh.ps > 0 && sh.ps <= PS_MAX &&
         sh.Q > 0 && sh.GQ > 0;
}

}  // namespace

// Pass 1.  q (B, KV, GQ, hd) bf16; k_pool (n_pages, ps, KV, hd) bf16;
// table (B, n_lp) int32; mask (B, Q, n_lp, ps) bool; m (B, KV, GQ) fp32.
extern "C" int paged_attn_scores_max(const void* q, const void* k_pool,
                                     const void* table, const void* mask,
                                     void* m, int B, int KV, int GQ, int hd,
                                     int ps, int n_lp, int Q, float scale,
                                     void* stream) {
  const Shapes sh{KV, GQ, hd, ps, n_lp, Q, scale};
  if (!shapes_ok(sh)) return static_cast<int>(cudaErrorInvalidValue);
  scores_max_kernel<<<dim3(B, KV, (GQ + RT - 1) / RT), NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const int*>(table), static_cast<const uint8_t*>(mask),
      static_cast<float*>(m), sh);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  As pass 1 plus v_pool and m_safe (B, KV, GQ) fp32; writes
// num (B, KV, GQ, hd) and den (B, KV, GQ), both fp32.
extern "C" int paged_attn_accumulate(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* mask, const void* m_safe,
                                     void* num, void* den, int B, int KV,
                                     int GQ, int hd, int ps, int n_lp, int Q,
                                     float scale, void* stream) {
  const Shapes sh{KV, GQ, hd, ps, n_lp, Q, scale};
  if (!shapes_ok(sh)) return static_cast<int>(cudaErrorInvalidValue);
  accumulate_kernel<<<dim3(B, KV, (GQ + RT - 1) / RT), NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(table), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(m_safe), static_cast<float*>(num),
      static_cast<float*>(den), sh);
  return static_cast<int>(cudaGetLastError());
}
