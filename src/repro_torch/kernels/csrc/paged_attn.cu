// K3 / K4: two-pass paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels `paged_attn_scores_max` (pass 1, pallas_call at
// src/repro/kernels/paged_attn.py:182) and `paged_attn_accumulate`
// (pass 2, pallas_call at :229).  Same functions:
//   pass 1: m[b, kv, r]   = max over valid positions s of q[r].k[s] * hd^-1/2
//                           (an fp32 dot of bf16 operands, scaled after the
//                           dot; -inf where no position is valid);
//   pass 2: p             = exp(score - m_safe[r]) in fp32 against the
//                           caller's global safe max, rounded to bf16
//                           before the PV product (the gathered oracle's
//                           `p.astype(cdt)`), num = sum p_bf16 * v and
//                           den = sum p (unrounded), both fp32; an
//                           all-masked row gives num = den = 0.
// q is grouped per kv head, g-major: row r of a (b, kv) pair is query
// r % Q of group head r / Q (kernels/ops.py::_pa_group_q).  Page 0 is the
// scratch page; the caller's mask covers unallocated and future positions,
// and a masked position never reaches a result.  The passes stay two
// passes: a single-pass online softmax would round p against a running
// max, and the rounding point is what keeps the paged and gathered greedy
// streams identical.
//
// What bounds it on the card: latency.  A decode tick of Ling-Lite reads
// ~0.6 MB of K and V over all slots and does ~0.5 MFLOP per pass; the
// least time for the bytes is under a microsecond, so the cost is how many
// dependent trips to memory the longest block makes, and how few blocks
// share the work.  The design, against each cause that held the first
// port (one block per slot and kv head walking its pages in order, a
// barrier and synchronous 2-byte loads per page, a serial 128-long dot per
// thread, and prefill tiles of 16 rows that each re-read the pages):
//
//  * Split the page walk across blocks.  Grid (split, kv head x row
//    group, slot): a block owns P consecutive logical pages (P * ps <= 64
//    positions; the wrapper passes P) and up to 64 query rows of its
//    (slot, kv head).  At decode that is every row (4 at Ling-Lite), so K
//    and V are read once per (slot, kv head, split); chip_smoke's decode
//    case has 84 blocks with a live page instead of 32 walks of up to 19
//    pages.  A 64-token prefill chunk has 256 rows per kv head in 4
//    groups: with all 256 in one block (measured on the H100) its 16 row
//    tiles queued on 8 warps and the last block's combine of 128 KB
//    partials per split ran at one SM's bandwidth, so K4 took 36 us;
//    each group reads the split's pages again, from L2, and both costs
//    fall by 4.  A split whose pages hold no valid position does no
//    loads.
//  * A few dependent trips per block, no barrier per page.  One pass over
//    the split's mask (16-byte loads where the page allows) finds its live
//    pages; their K (and V) rows then go to shared memory by 16-byte
//    cp.async, all in flight at once, while each warp loads its query
//    fragments; one barrier, and the scores.
//  * Scores on the tensor cores: mma.sync m16n8k16 (bf16 in, fp32
//    accumulate) for q.k^T, fragments by ldmatrix, the products exact; p
//    goes from the score fragments straight into the A fragments of p.v
//    (ldmatrix.trans on V), rounded to bf16 to nearest even as the
//    reference rounds it.  A block's rows make at most four 16-row
//    tiles; 4 warps (one or two tiles: decode, verify) or 8 (prefill)
//    share them, a tile's 16-position chunks taken in turn by 2 warps,
//    whose partials are added in warp order through shared memory: the
//    same order at every shape, so a query row's result does not depend
//    on the other rows of its block (at decode two of the 4 warps idle).
//    Each accumulator sums at most 4 k16 steps (q.k over head_dim in
//    head_dim / 64 interleaved accumulators; p.v over a split's <= 4
//    chunks), so the tensor cores' truncating adds (see hopper_mma.cuh
//    `promote`) cost at most a few ulps of a score; the rest is fp32.
//  * head_dim is a template parameter: HDM = 128 takes head_dim <= 128,
//    HDM = 256 the rest up to 256 (recurrentgemma's heads).  At 256 a
//    warp's q fragments are 64 registers, and pass 2's fp32 output for
//    all 256 columns would be 128 more: there the two warps of a tile
//    split p.v by columns instead of by chunks (each takes every chunk,
//    computing its scores again, and half the columns: 64 registers of
//    output), so nothing spills; a row's chunks are then added in one
//    mma chain in chunk order, again the same order at every shape.
//  * The combine inside the same launch.  Each block writes its split's
//    partial (pass 1: the rows' max; pass 2: fp32 num and den) and a
//    live flag, and takes a ticket on its (slot, kv head, row group); the
//    last block reduces the live splits in ascending split order and
//    resets the ticket, so the ticket buffer (kept by the wrapper per
//    device and stream) needs no clearing per call.  The max is order-free,
//    so pass 1 is bitwise the max of one serial walk given the same
//    scores; pass 2 differs from one walk in fp32 summation order only,
//    and both passes are deterministic.  One launch per pass, no host
//    sync, no allocation.
#include <math.h>

#include "hopper_mma.cuh"

namespace {

constexpr int SPLIT = 64;                 // positions per split, at most
constexpr int ROWS = 64;                  // query rows per block, at most
constexpr int HD_MAX = 256;               // head_dim limit
constexpr int PS_MAX = 32;                // page_size limit
constexpr int CG = 8;                     // the combine: splits loaded at
constexpr int U = 4;                      // once, float4 columns a thread

// What follows from HDM, the head_dim bound of one instantiation (128 or
// 256).
template <int HDM>
struct Dm {
  // K / V row stride in shared memory (272 or 528 B: the 8 rows of an
  // ldmatrix fall in distinct banks)
  static constexpr int KLD = HDM + 8;
  static constexpr int KV_BYTES = SPLIT * KLD * 2;  // one split's K or V
  static constexpr int NACC = HDM / 64;   // q.k accumulators, <= 4 k16 each
  // pass 2 at 256: the tile's two warps split p.v by columns
  static constexpr bool COLSPLIT = HDM > 128;
  static constexpr int OT = COLSPLIT ? HDM / 16 : HDM / 8;  // 8-column
                                                            // tiles of o
  // pass 2 at 128: the warps past a tile's first stash their num and den
  // in the K / V rows' shared memory, one stash a tile
  static constexpr int STASH_LD = HDM + 4;          // floats a stashed row
  static constexpr int STASH = 16 * STASH_LD + 16;  // num rows, then den
};
static_assert(4 * Dm<128>::STASH * 4 <= 2 * Dm<128>::KV_BYTES,
              "four stashes fit K and V");

struct Shapes {
  int B, KV, GQ, hd, ps, n_lp, Q, P, n_split;
  int n_rg;  // groups of ROWS query rows: blocks per (slot, kv head, split)
  int vec;   // pools 16-byte aligned and hd % 8 == 0: 16-byte copies
  int q32;   // q 4-byte aligned and hd even: 4-byte fragment loads
  float scale;
};

// 16 bytes global -> shared, zero fill when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// bf16x2 of two fp32 values rounded to nearest even, a in the low half
__device__ __forceinline__ uint32_t pack_rn(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Elements c and c + 1 of a q row as bf16x2 (zero past hd or past the
// rows).
__device__ __forceinline__ uint32_t q_pair(const bf16* row, int c,
                                           const Shapes& sh, bool in_rows) {
  if (!in_rows || c >= sh.hd) return 0u;
  if (sh.q32) return *reinterpret_cast<const uint32_t*>(row + c);
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
  const uint32_t hi = c + 1 < sh.hd ? r[c + 1] : 0u;
  return r[c] | (hi << 16);
}

// The A fragments of the 16-row tile mt of q for every k16 step of
// head_dim (mma.m16n8k16 layout: rows lane / 4 and + 8, columns
// 2 (lane % 4) + {0, 1} and + 8).
template <int HDM>
__device__ __forceinline__ void load_q(uint32_t (&qa)[HDM / 16][4],
                                       const bf16* qb, const Shapes& sh,
                                       int mt, int lane) {
  const int r0 = mt * 16 + (lane >> 2), r1 = r0 + 8;
  const bf16* q0 = qb + (size_t)r0 * sh.hd;
  const bf16* q1 = qb + (size_t)r1 * sh.hd;
  const bool in0 = r0 < sh.GQ, in1 = r1 < sh.GQ;
#pragma unroll
  for (int kk = 0; kk < HDM / 16; ++kk) {
    const int c = 16 * kk + 2 * (lane & 3);
    qa[kk][0] = q_pair(q0, c, sh, in0);
    qa[kk][1] = q_pair(q1, c, sh, in1);
    qa[kk][2] = q_pair(q0, c + 8, sh, in0);
    qa[kk][3] = q_pair(q1, c + 8, sh, in1);
  }
}

// Scaled scores of the 16-row tile against chunk c (16 positions of the
// split's compacted live positions): sc[t][e] is row lane / 4 + 8 (e / 2),
// position 16 c + 8 t + 2 (lane % 4) + e % 2.  The k16 steps of head_dim
// go to NACC interleaved accumulators (step kk to kk % NACC), added at the
// end in fp32 in order: chains of at most 4 mma.
template <int HDM>
__device__ __forceinline__ void chunk_scores(
    float (&sc)[2][4], const uint32_t (&qa)[HDM / 16][4], const bf16* kS,
    int c, int ks, int lane, float scale) {
  constexpr int NACC = Dm<HDM>::NACC;
  float acc[2][NACC][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int h = 0; h < NACC; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][h][e] = 0.f;
  const bf16* row = kS + (16 * c + 8 * (lane >> 4) + (lane & 7)) *
                             Dm<HDM>::KLD +
                    8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < HDM / 16; ++kk) {
    if (kk < ks) {
      uint32_t b[4];
      ldsm_x4(b, row + 16 * kk);
      mma16816(acc[0][kk % NACC], qa[kk], b[0], b[1]);
      mma16816(acc[1][kk % NACC], qa[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a = acc[t][0][e];
#pragma unroll
      for (int h = 1; h < NACC; ++h) a += acc[t][h][e];
      sc[t][e] = a * scale;
    }
}

// The staged mask row of row r's query, or null past the rows.
__device__ __forceinline__ const uint8_t* mask_row(const uint8_t* maskS,
                                                   const Shapes& sh, int r) {
  return r < sh.GQ ? maskS + (r % sh.Q) * SPLIT : nullptr;
}

// Is the query of mask row mr valid at compacted position j?
__device__ __forceinline__ bool valid_at(const uint8_t* mr, const int* poff,
                                         int j) {
  const int o = poff[j];
  return mr != nullptr && o >= 0 && mr[o] != 0;
}

// Copies the vw-byte vector at src to dst; true if any byte is non-zero.
__device__ __forceinline__ bool copy_mask(uint8_t* dst, const uint8_t* src,
                                          int vw) {
  if (vw == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(dst) = x;
    return (x.x | x.y | x.z | x.w) != 0u;
  }
  if (vw == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    *reinterpret_cast<uint2*>(dst) = x;
    return (x.x | x.y) != 0u;
  }
  if (vw == 4) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(src);
    *reinterpret_cast<uint32_t*>(dst) = x;
    return x != 0u;
  }
  if (vw == 2) {
    const uint16_t x = *reinterpret_cast<const uint16_t*>(src);
    *reinterpret_cast<uint16_t*>(dst) = x;
    return x != 0u;
  }
  *dst = *src;
  return *src != 0;
}

// The partial buffer of one pass: per split and row the max (pass 1) or
// num (R x hd) and den (pass 2), then per split and (slot, kv head, row
// group) a live flag.
struct Parts {
  float* val;    // pass 1: m [n_split][R]; pass 2: num [n_split][R][hd]
  float* den;    // pass 2: [n_split][R]
  float* flag;   // [n_split][B * KV * n_rg]
};

__device__ __forceinline__ Parts parts_of(float* part, const Shapes& sh,
                                          bool pass2) {
  const size_t R = (size_t)sh.B * sh.KV * sh.GQ;
  Parts p;
  p.val = part;
  p.den = part + (pass2 ? (size_t)sh.n_split * R * sh.hd : 0);
  p.flag = p.den + (size_t)sh.n_split * R;
  return p;
}

// Writes a 16-row tile's partial of this split: pass 1 the rows' max,
// pass 2 their num (OT 8-column tiles from column col0 on) and, with
// `rows`, den (rows of the pair from row_base on).
template <int OT, bool PASS2>
__device__ __forceinline__ void write_partial(
    const Parts& pt, const Shapes& sh, size_t row_base, int mt, int lane,
    const float (&mx)[2], const float (&o)[OT][4], const float (&dn)[2],
    int col0, bool rows) {
  const int r0 = mt * 16 + (lane >> 2);
  if ((lane & 3) == 0 && rows) {
    float* dst = PASS2 ? pt.den : pt.val;
    if (r0 < sh.GQ) dst[row_base + r0] = PASS2 ? dn[0] : mx[0];
    if (r0 + 8 < sh.GQ) dst[row_base + r0 + 8] = PASS2 ? dn[1] : mx[1];
  }
  if (!PASS2) return;
#pragma unroll
  for (int t = 0; t < OT; ++t) {
    const int col = col0 + 8 * t + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= sh.GQ || col >= sh.hd) continue;
      float* dst = pt.val + (row_base + r) * sh.hd + col;
      if (sh.hd % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[t][2 * h],
                                                      o[t][2 * h + 1]);
      } else {
        dst[0] = o[t][2 * h];
        if (col + 1 < sh.hd) dst[1] = o[t][2 * h + 1];
      }
    }
  }
}

// The last block's reduction of its rows [r_lo, r_hi) of a (slot, kv
// head) over the n_sp live splits (ascending in lsp): pass 1 the max,
// pass 2 num and den added in ascending split order.  CG splits' loads,
// U columns each, are in flight at once.
template <int NT, bool PASS2>
__device__ __forceinline__ void combine(const Parts& pt, const Shapes& sh,
                                        const int* lsp, int n_sp, size_t rb,
                                        int r_lo, int r_hi, float* out_m,
                                        float* out_num, float* out_den) {
  const int tid = threadIdx.x;
  const size_t R = (size_t)sh.B * sh.KV * sh.GQ;
  // pass 1's max and pass 2's den: one value a row and split
  const float* rows = PASS2 ? pt.den : pt.val;
  float* out_rows = PASS2 ? out_den : out_m;
  for (int r = r_lo + tid; r < r_hi; r += NT) {
    float a = PASS2 ? 0.f : -INFINITY;
    for (int i0 = 0; i0 < n_sp; i0 += CG) {
      float v[CG];
#pragma unroll
      for (int k = 0; k < CG; ++k)
        v[k] = i0 + k < n_sp ? __ldcg(rows + lsp[i0 + k] * R + rb + r)
                             : (PASS2 ? 0.f : -INFINITY);
#pragma unroll
      for (int k = 0; k < CG; ++k) a = PASS2 ? a + v[k] : fmaxf(a, v[k]);
    }
    out_rows[rb + r] = a;
  }
  if (!PASS2) return;
  const int n_el = r_hi * sh.hd;
  const int w = sh.hd % 4 == 0 ? 4 : 1;         // elements a load
  for (int e0 = r_lo * sh.hd + w * tid; e0 < n_el; e0 += w * NT * U) {
    float4 a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < n_sp; i0 += CG) {
      float4 v[CG][U];
#pragma unroll
      for (int k = 0; k < CG; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + w * NT * u;
          v[k][u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i0 + k < n_sp && e < n_el) {
            const float* src = pt.val + (lsp[i0 + k] * R + rb) * sh.hd + e;
            if (w == 4)
              v[k][u] = __ldcg(reinterpret_cast<const float4*>(src));
            else
              v[k][u].x = __ldcg(src);
          }
        }
#pragma unroll
      for (int k = 0; k < CG; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          a[u].x += v[k][u].x;
          a[u].y += v[k][u].y;
          a[u].z += v[k][u].z;
          a[u].w += v[k][u].w;
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + w * NT * u;
      if (e >= n_el) continue;
      float* dst = out_num + rb * sh.hd + e;
      if (w == 4)
        *reinterpret_cast<float4*>(dst) = a[u];
      else
        *dst = a[u].x;
    }
  }
}

// One block's work: (split, kv head x row group, slot) = blockIdx.
template <int HDM, int NT, bool PASS2>
__device__ __forceinline__ void split_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ table,
    const uint8_t* __restrict__ mask, const float* __restrict__ m_safe,
    float* __restrict__ out_m, float* __restrict__ out_num,
    float* __restrict__ out_den, float* __restrict__ part,
    int* __restrict__ tickets, const Shapes& sh) {
  using D = Dm<HDM>;
  constexpr int NW = NT / 32;
  constexpr int KLD = D::KLD, OT = D::OT;
  // pass 2 at 256: the tile's two warps split the columns, not the chunks
  constexpr bool COLS = PASS2 && D::COLSPLIT;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* kS = reinterpret_cast<bf16*>(smem);
  bf16* vS = kS + SPLIT * KLD;
  uint8_t* maskS = smem + (PASS2 ? 2 : 1) * D::KV_BYTES;
  __shared__ int page_s[SPLIT];   // physical page of each split page
  __shared__ int live_s[SPLIT];   // split page holds a valid position
  __shared__ int list_s[SPLIT];   // live split pages, ascending
  __shared__ int poff_s[SPLIT];   // compacted position -> mask byte, or -1
  __shared__ float red_s[NW][16];  // pass 1: the warps' row maxima
  __shared__ int n_live_s, last_s;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / sh.n_rg, rg = blockIdx.y % sh.n_rg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bk = b * sh.KV + kv;
  const int pair = bk * sh.n_rg + rg;     // the block's ticket and flag
  const int t0 = rg * (ROWS / 16);        // its first 16-row tile
  const int lp0 = split * sh.P;
  const int p_eff = max(0, min(sh.P, sh.n_lp - lp0));
  const size_t R = (size_t)sh.B * sh.KV * sh.GQ;
  const Parts pt = parts_of(part, sh, PASS2);
  const bf16* qb = q + (size_t)bk * sh.GQ * sh.hd;
  const size_t rb = (size_t)bk * sh.GQ;   // the pair's first row

  // -- 1. the split's page ids and mask; which of its pages are live -----
  for (int p = tid; p < SPLIT; p += NT) live_s[p] = 0;
  __syncthreads();
  for (int p = tid; p < p_eff; p += NT)
    page_s[p] = table[(size_t)b * sh.n_lp + lp0 + p];
  const size_t rstride = (size_t)sh.n_lp * sh.ps;   // one query's mask row
  const uint8_t* mrow =
      mask + (size_t)b * sh.Q * rstride + (size_t)lp0 * sh.ps;
  int vw = 16;
  while (vw > 1 && (sh.ps % vw || reinterpret_cast<uintptr_t>(mrow) % vw))
    vw >>= 1;
  const int per_row = p_eff * sh.ps / vw;
  for (int i = tid; i < sh.Q * per_row; i += NT) {
    const int qi = i / per_row, off = (i % per_row) * vw;
    if (copy_mask(maskS + qi * SPLIT + off, mrow + qi * rstride + off, vw))
      live_s[off / sh.ps] = 1;                  // one vector, one page
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int p0 = 0; p0 < p_eff; p0 += 32) {
      const int p = p0 + lane;
      const bool lv = p < p_eff && live_s[p];
      const unsigned bal = __ballot_sync(0xffffffffu, lv);
      if (lv) list_s[n + __popc(bal & ((1u << lane) - 1u))] = p;
      n += __popc(bal);
    }
    __syncwarp();
    for (int j = lane; j < SPLIT; j += 32) {
      const int li = j / sh.ps;
      poff_s[j] = li < n ? list_s[li] * sh.ps + j % sh.ps : -1;
    }
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;

  if (n_live > 0) {
    const int n_pos = n_live * sh.ps, n_ch = (n_pos + 15) / 16;
    const int hdp = (sh.hd + 15) & ~15, ks = hdp / 16;
    const int MT = min(ROWS / 16, (sh.GQ + 15) / 16 - t0);   // its tiles
    // Two warps a tile at every shape: a row's chunks are then added in
    // one order (sub 0 takes chunks 0, 2, sub 1 chunks 1, 3, then sub 0
    // adds sub 1's partial) whatever its block's rows, so a decode tick,
    // a verify pass and a prefill chunk give a query row the same bits.
    // Four warps a tile at decode summed the chunks in another order.
    const int G = 2;                            // warps a tile

    // -- 2. the live pages' K (and V) rows, all in flight ----------------
    const int vpr = hdp / 8;                    // 8-element vectors a row
    for (int i = tid; i < n_ch * 16 * vpr; i += NT) {
      const int j = i / vpr, c = (i % vpr) * 8;
      const bool in = j < n_pos && c < sh.hd;
      size_t src = 0;
      if (in) {
        const int page = page_s[list_s[j / sh.ps]];
        src = (((size_t)page * sh.ps + j % sh.ps) * sh.KV + kv) * sh.hd + c;
      }
      bf16* kd = kS + j * KLD + c;
      bf16* vd = vS + j * KLD + c;
      if (sh.vec) {
        cp_async16(kd, k_pool + src, in);
        if (PASS2) cp_async16(vd, v_pool + src, in);
      } else {
        for (int e = 0; e < 8; ++e) {
          const bool ok = in && c + e < sh.hd;
          kd[e] = ok ? k_pool[src + e] : __float2bfloat16(0.f);
          if (PASS2) vd[e] = ok ? v_pool[src + e] : __float2bfloat16(0.f);
        }
      }
    }
    // the tile's q fragments (and safe maxima) load meanwhile
    const int lt = warp / G, sub = warp % G;    // tile t0 + lt, chunks sub,
    const bool active = lt < MT;                // sub + G, ...
    const int mt = t0 + lt;
    const int r0 = mt * 16 + (lane >> 2), r1 = r0 + 8;
    uint32_t qa[HDM / 16][4];
    float ms[2] = {0.f, 0.f};
    if (active) {
      load_q<HDM>(qa, qb, sh, mt, lane);
      if (PASS2) {
        ms[0] = r0 < sh.GQ ? m_safe[rb + r0] : 0.f;
        ms[1] = r1 < sh.GQ ? m_safe[rb + r1] : 0.f;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // -- 3. each warp: its tile against its chunks of the positions ------
    float mx[2] = {-INFINITY, -INFINITY};  // pass 1
    float o[OT][4], dn[2] = {0.f, 0.f};   // pass 2: columns tc0 * 8 on
    const int tc0 = COLS ? sub * OT : 0;
#pragma unroll
    for (int t = 0; t < OT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    if (active) {
      const uint8_t* mr[2] = {mask_row(maskS, sh, r0),
                              mask_row(maskS, sh, r1)};
      for (int c = COLS ? 0 : sub; c < n_ch; c += COLS ? 1 : G) {
        float sc[2][4];
        chunk_scores<HDM>(sc, qa, kS, c, ks, lane, sh.scale);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * c + 8 * t + 2 * (lane & 3) + (e & 1);
            const bool v = valid_at(mr[e >> 1], poff_s, j);
            if (!PASS2) {
              if (v) mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
            } else {
              const float p = v ? expf(sc[t][e] - ms[e >> 1]) : 0.f;
              sc[t][e] = p;
              dn[e >> 1] += p;
            }
          }
        if (PASS2) {
          // the score fragments of positions 0-7 and 8-15 of the chunk
          // are the A fragment of p (16 rows x 16 positions)
          const uint32_t pa[4] = {pack_rn(sc[0][0], sc[0][1]),
                                  pack_rn(sc[0][2], sc[0][3]),
                                  pack_rn(sc[1][0], sc[1][1]),
                                  pack_rn(sc[1][2], sc[1][3])};
          const bf16* vrow =
              vS + (16 * c + 8 * ((lane >> 3) & 1) + (lane & 7)) * KLD +
              8 * (lane >> 4);
#pragma unroll
          for (int t = 0; t < OT; t += 2) {
            if (tc0 + t < 2 * ks) {
              uint32_t bv[4];
              ldsm_x4_t(bv, vrow + 8 * (tc0 + t));
              mma16816(o[t], pa, bv[0], bv[1]);
              mma16816(o[t + 1], pa, bv[2], bv[3]);
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!PASS2) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        } else {
          dn[h] += __shfl_xor_sync(0xffffffffu, dn[h], 1);
          dn[h] += __shfl_xor_sync(0xffffffffu, dn[h], 2);
        }
      }
    }

    // -- 3b. each tile's G warps: add their chunks in order (or, split by
    // columns, write their own) -------------------------------------------
    const int rr = lane >> 2;
    constexpr int STASH_LD = D::STASH_LD;
    float* stash = reinterpret_cast<float*>(smem) +
                   (lt * (G - 1) + max(sub, 1) - 1) * D::STASH;
    __syncthreads();                    // every warp is done with K and V
    if (COLS && active)
      write_partial<OT, PASS2>(pt, sh, split * R + rb, mt, lane, mx, o, dn,
                               8 * tc0, sub == 0);
    if (!COLS && active && sub > 0) {
      if (!PASS2) {
        if ((lane & 3) == 0) {
          red_s[warp][rr] = mx[0];
          red_s[warp][rr + 8] = mx[1];
        }
      } else {
#pragma unroll
        for (int t = 0; t < OT; ++t) {
          const int col = 8 * t + 2 * (lane & 3);
          *reinterpret_cast<float2*>(stash + rr * STASH_LD + col) =
              make_float2(o[t][0], o[t][1]);
          *reinterpret_cast<float2*>(stash + (rr + 8) * STASH_LD + col) =
              make_float2(o[t][2], o[t][3]);
        }
        if ((lane & 3) == 0) {
          stash[16 * STASH_LD + rr] = dn[0];
          stash[16 * STASH_LD + rr + 8] = dn[1];
        }
      }
    }
    __syncthreads();
    if (!COLS && active && sub == 0) {
      for (int s2 = 1; s2 < G; ++s2) {
        if (!PASS2) {
          mx[0] = fmaxf(mx[0], red_s[warp + s2][rr]);
          mx[1] = fmaxf(mx[1], red_s[warp + s2][rr + 8]);
        } else {
          const float* st = stash + (s2 - 1) * D::STASH;
#pragma unroll
          for (int t = 0; t < OT; ++t) {
            const int col = 8 * t + 2 * (lane & 3);
            const float2 a =
                *reinterpret_cast<const float2*>(st + rr * STASH_LD + col);
            const float2 c2 = *reinterpret_cast<const float2*>(
                st + (rr + 8) * STASH_LD + col);
            o[t][0] += a.x;
            o[t][1] += a.y;
            o[t][2] += c2.x;
            o[t][3] += c2.y;
          }
          dn[0] += st[16 * STASH_LD + rr];
          dn[1] += st[16 * STASH_LD + rr + 8];
        }
      }
      write_partial<OT, PASS2>(pt, sh, split * R + rb, mt, lane, mx, o, dn,
                               0, true);
    }
  }
  const size_t n_pairs = (size_t)sh.B * sh.KV * sh.n_rg;
  if (tid == 0) pt.flag[split * n_pairs + pair] = n_live > 0;

  // -- 4. the last block of (slot, kv head) combines the splits ------------
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(&tickets[pair], 1) == sh.n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  int* lsp = reinterpret_cast<int*>(smem);     // live splits, ascending
  if (warp == 0) {
    int n = 0;
    for (int s0 = 0; s0 < sh.n_split; s0 += 32) {
      const int s = s0 + lane;
      const bool lv = s < sh.n_split &&
                      __ldcg(pt.flag + s * n_pairs + pair) != 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, lv);
      if (lv) lsp[n + __popc(bal & ((1u << lane) - 1u))] = s;
      n += __popc(bal);
    }
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  combine<NT, PASS2>(pt, sh, lsp, n_live_s, rb, rg * ROWS,
                     min(sh.GQ, (rg + 1) * ROWS), out_m, out_num, out_den);
  if (tid == 0) tickets[pair] = 0;             // ready for the next call
}

// The two passes as kernels of their own names (the profiler's K3 and K4).
template <int HDM, int NT>
__global__ void __launch_bounds__(NT) pa_scores_max_kernel(
    const bf16* q, const bf16* k_pool, const bf16* v_pool, const int* table,
    const uint8_t* mask, const float* m_safe, float* out_m, float* out_num,
    float* out_den, float* part, int* tickets, Shapes sh) {
  split_walk<HDM, NT, false>(q, k_pool, v_pool, table, mask, m_safe, out_m,
                             out_num, out_den, part, tickets, sh);
}
template <int HDM, int NT>
__global__ void __launch_bounds__(NT) pa_accumulate_kernel(
    const bf16* q, const bf16* k_pool, const bf16* v_pool, const int* table,
    const uint8_t* mask, const float* m_safe, float* out_m, float* out_num,
    float* out_den, float* part, int* tickets, Shapes sh) {
  split_walk<HDM, NT, true>(q, k_pool, v_pool, table, mask, m_safe, out_m,
                            out_num, out_den, part, tickets, sh);
}

// Checks the shapes and fills the derived fields; 0 or a CUDA error.
int prepare(Shapes& sh, const void* q, const void* k_pool,
            const void* v_pool) {
  if (sh.hd <= 0 || sh.hd > HD_MAX || sh.ps <= 0 || sh.ps > PS_MAX ||
      sh.Q <= 0 || sh.GQ <= 0 || sh.P <= 0 || sh.P * sh.ps > SPLIT ||
      sh.n_lp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  sh.n_split = max(1, (sh.n_lp + sh.P - 1) / sh.P);
  sh.n_rg = (sh.GQ + ROWS - 1) / ROWS;
  // the combine lists the live splits in the K rows' shared memory
  if (sh.n_split > Dm<128>::KV_BYTES / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  sh.vec = sh.hd % 8 == 0 && a16(k_pool) && (v_pool == nullptr || a16(v_pool));
  sh.q32 = sh.hd % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  return 0;
}

template <int HDM, int NT, bool PASS2>
int launch_nt(const Shapes& sh, size_t smem, cudaStream_t stream,
              const void* q, const void* k_pool, const void* v_pool,
              const void* table, const void* mask, const void* m_safe,
              void* m, void* num, void* den, void* part, void* tickets) {
  auto kern = PASS2 ? pa_accumulate_kernel<HDM, NT>
                    : pa_scores_max_kernel<HDM, NT>;
  // The opt-in above the default 48 KB holds per device: remember what
  // each device (the current one, where the launch goes) was granted.
  constexpr int kDevices = 64;
  static size_t granted[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024 && (dev >= kDevices || smem > granted[dev])) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kDevices) granted[dev] = smem;
  }
  kern<<<dim3(sh.n_split, sh.KV * sh.n_rg, sh.B), NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(table),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(m_safe),
      static_cast<float*>(m), static_cast<float*>(num),
      static_cast<float*>(den), static_cast<float*>(part),
      static_cast<int*>(tickets), sh);
  return static_cast<int>(cudaGetLastError());
}

// 128 threads where a block's rows make at most two 16-row tiles (decode,
// verify: the chunks spread over the warps, and more blocks share an SM),
// 256 otherwise (prefill: four tiles, each over two warps).
template <int HDM, bool PASS2>
int launch_hd(const Shapes& sh, const void* q, const void* k_pool,
              const void* v_pool, const void* table, const void* mask,
              const void* m_safe, void* m, void* num, void* den, void* part,
              void* tickets, cudaStream_t s) {
  const size_t smem =
      (PASS2 ? 2 : 1) * Dm<HDM>::KV_BYTES + (size_t)sh.Q * SPLIT;
  return (min(sh.GQ, ROWS) + 15) / 16 <= 2
             ? launch_nt<HDM, 128, PASS2>(sh, smem, s, q, k_pool, v_pool,
                                          table, mask, m_safe, m, num, den,
                                          part, tickets)
             : launch_nt<HDM, 256, PASS2>(sh, smem, s, q, k_pool, v_pool,
                                          table, mask, m_safe, m, num, den,
                                          part, tickets);
}

// head_dim <= 128 on the HDM = 128 kernels, up to 256 on the HDM = 256 ones
template <bool PASS2>
int launch(const Shapes& sh, const void* q, const void* k_pool,
           const void* v_pool, const void* table, const void* mask,
           const void* m_safe, void* m, void* num, void* den, void* part,
           void* tickets, void* stream) {
  if (sh.B == 0 || sh.KV == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return sh.hd <= 128
             ? launch_hd<128, PASS2>(sh, q, k_pool, v_pool, table, mask,
                                     m_safe, m, num, den, part, tickets, s)
             : launch_hd<256, PASS2>(sh, q, k_pool, v_pool, table, mask,
                                     m_safe, m, num, den, part, tickets, s);
}

}  // namespace

// Pass 1.  q (B, KV, GQ, hd) bf16; k_pool (n_pages, ps, KV, hd) bf16;
// table (B, n_lp) int32; mask (B, Q, n_lp, ps) bool; m (B, KV, GQ) fp32.
// part: fp32 scratch of n_split * 2 B KV GQ with n_split = max(1,
// ceil(n_lp / P)); tickets: B * KV * GQ int32, zero (left zero).  P
// logical pages per split, P * ps <= 64.
extern "C" int paged_attn_scores_max(const void* q, const void* k_pool,
                                     const void* table, const void* mask,
                                     void* m, void* part, void* tickets,
                                     int B, int KV, int GQ, int hd, int ps,
                                     int n_lp, int Q, int P, float scale,
                                     void* stream) {
  Shapes sh{B, KV, GQ, hd, ps, n_lp, Q, P, 0, 0, 0, 0, scale};
  const int err = prepare(sh, q, k_pool, nullptr);
  if (err) return err;
  return launch<false>(sh, q, k_pool, nullptr, table, mask, nullptr, m,
                       nullptr, nullptr, part, tickets, stream);
}

// Pass 2.  As pass 1 plus v_pool and m_safe (B, KV, GQ) fp32; writes
// num (B, KV, GQ, hd) and den (B, KV, GQ), both fp32.  part: fp32 scratch
// of n_split * B KV GQ (hd + 2).
extern "C" int paged_attn_accumulate(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* mask, const void* m_safe,
                                     void* num, void* den, void* part,
                                     void* tickets, int B, int KV, int GQ,
                                     int hd, int ps, int n_lp, int Q, int P,
                                     float scale, void* stream) {
  Shapes sh{B, KV, GQ, hd, ps, n_lp, Q, P, 0, 0, 0, 0, scale};
  const int err = prepare(sh, q, k_pool, v_pool);
  if (err) return err;
  return launch<true>(sh, q, k_pool, v_pool, table, mask, m_safe, nullptr,
                      num, den, part, tickets, stream);
}
