// K1: fused MoE FFN for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `fused_moe_ffn` in
// src/repro/kernels/grouped_matmul.py (`_fused_kernel`, pallas_call at
// :264).  Same function: for every expert-aligned row tile (layout from
// kernels/ops.py::_fused_layout) gather the tile's token rows from the
// unsorted activations x, compute FFN_e = act(x w1_e) * (x w3_e) w2_e with
// fp32 products, an fp32 hidden and fp32 accumulation, scale each row by
// its router gate, and sum each token's gated rows into out (T, d) fp32.
//
// Three passes, as the TPU kernel's VMEM-resident (bm, d) accumulator does
// not fit a block here ((128 x 2048) fp32 is 1 MB): up writes the fp32
// hidden h (n_m * bm, ff) to device memory, down writes the gated rows y
// (n_m * bm, d), and combine (grid T) sums each token's live rows in
// ascending row order, the order of the reference's scatter-add, with no
// atomics in the sum (deterministic).  The combine's index arrays (each
// token's rows) come from three small passes in the same entry point:
// count, scan, place; place's atomics fix only the order in which a
// token's rows are listed, and the combine ranks them before adding.
// Only a tile's live rows are computed and stored: a tile whose
// tile_group is G returns at once, and rows past the last row with a
// non-zero gate (the layout puts an expert's rows first in its tile) are
// zero-filled and never stored.
//
// Products run on the tensor cores (bf16 wgmma, fp32 accumulators; each
// stage's wgmmas add into fresh registers that are then added to the
// accumulators in fp32, since the tensor cores truncate their sums:
// hopper_mma.cuh `promote`).  x and
// the weights are bf16, so x W1 and x W3 are exact bf16 products in one
// pass; h is fp32 and is cut exactly into three bf16 pieces (hi, mid, lo;
// hopper_mma.cuh `split3`), so h W2 takes three passes and equals the fp32
// product up to summation order.
//
// Two paths, chosen by the wrapper (kernels/grouped_matmul.py `k1_path`)
// from the static shapes: the mean routed rows per expert, cap / G, read
// off the layout's size.  At or below 32 rows per expert (Ling-Lite's
// decode ticks, 0.75, and 64-row prefill chunks, 6) the weights stream;
// above it (training, 192) the tiles are full enough for 128-row tensor-
// core tiles.
//
//  * Tensor-core path (what bounds it: operations and bytes alike; at
//    Ling-Lite's training shapes each product is ~71 GFLOP beside ~0.2-0.9
//    GB).  K2's pipelined 128 x 128 tile (hopper_mma.cuh `mm_tile`: two
//    warpgroups of wgmma m64n128k16, A from registers, B by TMA into a
//    128-byte-swizzled ring) with A gathered: the up pass copies the
//    tile's x rows by 16-byte cp.async from x + row_idx[r] * d, and B's two
//    64-column halves are the same 64 columns of W1 and of W3 (one wgmma
//    computes both; without W3, 128 columns of W1).  The epilogue computes
//    act(a1) * a3 in fp32 and stores h.  The down pass is K2's h W2 form
//    (fp32 rows, three passes) with the gate applied to the accumulators.
//  * Weight-streaming path (what bounds it: the routed experts' bytes,
//    3 d ff bf16 = 17.3 MB each at Ling-Lite, while a tile holds a few
//    rows).  "Swap AB": a block of one warpgroup owns 64 weight columns of
//    one tile (grid n_m x ff / 64 up; 128 columns as two halves, n_m x d /
//    128, down) and computes
//    out^T = W^T x^T with wgmma m64n32k16: the weight tile (64 columns x
//    64 k, by TMA) is the M = 64 operand, MN-major from shared memory, and
//    up to 32 live rows are the narrow N side, K-major and swizzled
//    (cp.async, zero past the live rows).  Rings of 5 (up) and 4 (down)
//    stages of 16 KB of weights, two blocks per SM, keep ~100-128 KB of
//    weights in flight on each SM.  Tiles with
//    more than 32 live rows take further 32-row passes.  The down pass
//    splits each stage's fp32 h rows into three swizzled bf16 pieces in
//    shared memory.
#include "hopper_mma.cuh"

namespace {

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

__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  return raw + ((SWZ - (smem_u32(raw) & (SWZ - 1))) & (SWZ - 1));
}

// ---------------------------------------------------------------------------
// tensor-core path
// ---------------------------------------------------------------------------

// The block's row range of a 1-D grid, column tile fastest (K2's raster):
// block b covers column tile b % n_col and rows [r_beg, r_end) of tile
// b / n_col / chunks, cut to the tile's live rows.
struct TcBlock {
  int n0, tile, r_beg, r_end;
};

__device__ __forceinline__ TcBlock tc_block(int n_col, int bn, int bm,
                                            int n_live) {
  const int chunks = (bm + BM - 1) / BM;
  const int rb = blockIdx.x / n_col, tile = rb / chunks;
  const int r_beg = tile * bm + (rb % chunks) * BM;
  return {(int)(blockIdx.x % n_col) * bn, tile, r_beg,
          min(r_beg + BM, tile * bm + n_live)};
}

// h[tile rows, n0 : n0 + BNU] = act(x_rows W1) (* x_rows W3), fp32.
// Gated: BNU = 64 columns of W1 and the same of W3 side by side in one
// 128-column wgmma tile; otherwise 128 columns of W1.
template <bool GATED>
__global__ void __launch_bounds__(NT, 1) moe_up_tc_kernel(
    const bf16* __restrict__ x, const int* __restrict__ row_idx,
    const float* __restrict__ gates, const int* __restrict__ tile_group,
    float* __restrict__ h, int d, int ff, int G, int bm, int act,
    const __grid_constant__ CUtensorMap w1_map,
    const __grid_constant__ CUtensorMap w3_map) {
  constexpr int BNU = GATED ? 64 : BN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = align_smem(smem_raw);
  const int n_col = (ff + BNU - 1) / BNU;
  const int tile = blockIdx.x / n_col / ((bm + BM - 1) / BM);
  const int e = tile_group[tile];
  if (e >= G) return;                       // all-padding tile
  const TcBlock blk =
      tc_block(n_col, BNU, bm, tile_rows(gates + (size_t)tile * bm, bm));
  if (blk.r_beg >= blk.r_end) return;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const TileB b{nullptr, &w1_map, GATED ? &w3_map : &w1_map, blk.n0,
                GATED ? blk.n0 : blk.n0 + 64};
  mm_tile<false, false>(
      acc, base, [=](int r) { return x + (size_t)row_idx[r] * d; }, x, b, e,
      d, ff, blk.r_beg, blk.r_end, blk.n0, 1, 1);
  if constexpr (GATED) {
    // columns 8 i + ... of W1 (i < 8) meet the same of W3 (i + 8)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = act_fn(act, acc[i]) * acc[i + 32];
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = act_fn(act, acc[i]);
  }
  store_tile<false>(acc, reinterpret_cast<float*>(base),
                    h + (size_t)blk.r_beg * ff + blk.n0, ff,
                    blk.r_end - blk.r_beg, min(BNU, ff - blk.n0), row0,
                    lane, tid);
}

// y[tile rows, n0 : n0 + BN] = gate * (h_rows W2), fp32; h in three pieces.
__global__ void __launch_bounds__(NT, 1) moe_down_tc_kernel(
    const float* __restrict__ h, const float* __restrict__ gates,
    const int* __restrict__ tile_group, float* __restrict__ y, int d, int ff,
    int G, int bm, const __grid_constant__ CUtensorMap w2_map) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = align_smem(smem_raw);
  const int n_col = (d + BN - 1) / BN;
  const int tile = blockIdx.x / n_col / ((bm + BM - 1) / BM);
  const int e = tile_group[tile];
  if (e >= G) return;
  const TcBlock blk =
      tc_block(n_col, BN, bm, tile_rows(gates + (size_t)tile * bm, bm));
  if (blk.r_beg >= blk.r_end) return;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const TileB b{nullptr, &w2_map, &w2_map, blk.n0, blk.n0 + 64};
  mm_tile<true, false>(
      acc, base, [=](int r) { return h + (size_t)r * ff; }, h, b, e, ff, d,
      blk.r_beg, blk.r_end, blk.n0, 1, 1);
  // acc[4 i + 2 hh + j] is row row0 + lane / 4 + 8 hh
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = blk.r_beg + row0 + (lane >> 2) + 8 * hh;
    const float g = r < blk.r_end ? gates[r] : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[4 * i + 2 * hh] *= g;
      acc[4 * i + 2 * hh + 1] *= g;
    }
  }
  store_tile<false>(acc, reinterpret_cast<float*>(base),
                    y + (size_t)blk.r_beg * d + blk.n0, d,
                    blk.r_end - blk.r_beg, min(BN, d - blk.n0), row0, lane,
                    tid);
}

// ---------------------------------------------------------------------------
// weight-streaming path
// ---------------------------------------------------------------------------

constexpr int SNT = 128;    // one warpgroup
constexpr int NR = 32;      // live rows per pass: wgmma N
constexpr int SBN = 64;     // weight columns per block: wgmma M
constexpr int UP_STAGES = 5;
constexpr int W_BYTES = MM_BK * SBN * 2;  // one 64 x 64 bf16 TMA box, 8 KB
constexpr int X_BYTES = NR * 128;         // NR bf16 rows of 64 k, swizzled
constexpr int H_BYTES = NR * MM_BK * 4;   // NR fp32 rows of 64 k, raw
constexpr int UP_STAGE = 2 * W_BYTES + X_BYTES;    // W1, W3, x rows
constexpr int DOWN_STAGE = 2 * W_BYTES + H_BYTES;  // 128 columns of W2, h
constexpr int DOWN_STAGES = 4;
constexpr int UP_SMEM = SWZ + UP_STAGES * UP_STAGE + 8 * UP_STAGES;
constexpr int DOWN_SMEM =
    SWZ + 3 * X_BYTES + DOWN_STAGES * DOWN_STAGE + 8 * DOWN_STAGES;

// A: the weight tile of stage slot `a` (rows k of 64 columns, MN-major), a
// k16 step 16 rows on; B: NR rows of 64 k at `b` (K-major), a k16 step 32
// bytes along the row.
__device__ __forceinline__ uint64_t desc_w(uint32_t a, int j) {
  return desc_b128(a + 2048 * j, W_BYTES, SWZ);
}
__device__ __forceinline__ uint64_t desc_rows(uint32_t b, int j) {
  return desc_b128(b + 32 * j, 16, SWZ);
}

// The stream kernels' pipeline: steps s = pass * nk + kt over the tile's
// 32-row passes and the nk contraction stages, a ring of STAGES slots
// loaded STAGES - 1 ahead.
// load(s) fills slot s % STAGES (TMA arms bar[slot]; cp.async joins the
// commit group); compute(slot) runs after both landed; done(pass) is
// the epilogue after a pass's last stage.
template <int STAGES, typename Load, typename Compute, typename Done>
__device__ __forceinline__ void stream_pipeline(uint64_t* bar, int steps,
                                                int nk, Load load,
                                                Compute compute, Done done) {
  mbar_init_all(bar, STAGES);
  __syncthreads();
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int slot = s % STAGES;
    cp_async_wait<STAGES - 2>();
    fence_async_smem();
    mbar_wait(&bar[slot], (s / STAGES) & 1);
    // stage s is in place, and every thread is done with s - 1
    __syncthreads();
    if (s + STAGES - 1 < steps) load(s + STAGES - 1);
    cp_async_commit();
    compute(slot);
    if (s % nk == nk - 1) done(s / nk);
  }
}

// h[live rows, f0 : f0 + 64] = act(x_rows W1) (* x_rows W3): out^T =
// W1^T x^T with the weights as M.  Grid: n_m * ff / 64, column fastest.
template <bool GATED>
__global__ void __launch_bounds__(SNT) moe_up_stream_kernel(
    const bf16* __restrict__ x, const int* __restrict__ row_idx,
    const float* __restrict__ gates, const int* __restrict__ tile_group,
    float* __restrict__ h, int d, int ff, int G, int bm, int act,
    const __grid_constant__ CUtensorMap w1_map,
    const __grid_constant__ CUtensorMap w3_map) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = align_smem(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + UP_STAGES * UP_STAGE);
  const int n_col = (ff + SBN - 1) / SBN;
  const int tile = blockIdx.x / n_col, f0 = (blockIdx.x % n_col) * SBN;
  const int e = tile_group[tile];
  if (e >= G) return;
  const int n_live = tile_rows(gates + (size_t)tile * bm, bm);
  if (n_live == 0) return;
  const int tid = threadIdx.x, lane = tid & 31;
  const int* ri = row_idx + (size_t)tile * bm;
  const int nk = (d + MM_BK - 1) / MM_BK;

  float a1[16], a3[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a1[i] = a3[i] = 0.f;

  auto load = [&](int s) {
    uint8_t* st = base + (s % UP_STAGES) * UP_STAGE;
    uint64_t* bs = &bar[s % UP_STAGES];
    const int k0 = (s % nk) * MM_BK, r0 = (s / nk) * NR;
    if (tid == 0) {
      mbar_arm(bs, (GATED ? 2 : 1) * W_BYTES);
      tma_load_3d(smem_u32(st), &w1_map, bs, f0, k0, e);
      if (GATED) tma_load_3d(smem_u32(st + W_BYTES), &w3_map, bs, f0, k0, e);
    }
    copy_rows<16, NR, MM_BK>(
        smem_u32(st + 2 * W_BYTES),
        [=](int r) { return x + (size_t)ri[r] * d; }, x, r0, n_live, k0, d,
        [](int r, int c) { return swz(r, c, 0); }, tid, SNT);
  };
  auto compute = [&](int slot) {
    const uint32_t w = smem_u32(base + slot * UP_STAGE);
    const uint32_t xr = w + 2 * W_BYTES;
    float p1[16], p3[16];   // the stage's sums, promoted (hopper_mma.cuh)
    zero(p1);
    zero(p3);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < MM_BK / 16; ++j) {
      wgmma_ss_n32(p1, desc_w(w, j), desc_rows(xr, j));
      if (GATED) wgmma_ss_n32(p3, desc_w(w + W_BYTES, j), desc_rows(xr, j));
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(p1);
    keep(p3);
    promote(a1, p1);
    if (GATED) promote(a3, p3);
  };
  // a[4 i + 2 hh + j]: weight column f0 + m + 8 hh, row r0 + 8 i + 2 (lane
  // % 4) + j, with m = 16 warp + lane / 4
  auto done = [&](int pass) {
    const int m = f0 + ((tid >> 5) << 4) + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int f = m + 8 * ((i >> 1) & 1);
      const int r = pass * NR + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (r < n_live && f < ff) {
        const float v = act_fn(act, a1[i]);
        h[((size_t)tile * bm + r) * ff + f] = GATED ? v * a3[i] : v;
      }
      a1[i] = a3[i] = 0.f;
    }
  };
  stream_pipeline<UP_STAGES>(bar, ((n_live + NR - 1) / NR) * nk, nk, load,
                          compute, done);
}

// y[live rows, c0 : c0 + 128] = gate * (h_rows W2): out^T = W2^T h^T as
// two 64-column halves, h's rows split into three bf16 pieces per stage
// (once for both halves).  Grid: n_m * d / 128.
__global__ void __launch_bounds__(SNT) moe_down_stream_kernel(
    const float* __restrict__ h, const float* __restrict__ gates,
    const int* __restrict__ tile_group, float* __restrict__ y, int d, int ff,
    int G, int bm, const __grid_constant__ CUtensorMap w2_map) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = align_smem(smem_raw);
  uint8_t* pieces = base;                    // hi, mid, lo: X_BYTES each
  uint8_t* ring = base + 3 * X_BYTES;
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(ring + DOWN_STAGES * DOWN_STAGE);
  const int n_col = (d + 2 * SBN - 1) / (2 * SBN);
  const int tile = blockIdx.x / n_col, c0 = (blockIdx.x % n_col) * 2 * SBN;
  const int e = tile_group[tile];
  if (e >= G) return;
  const float* g = gates + (size_t)tile * bm;
  const int n_live = tile_rows(g, bm);
  if (n_live == 0) return;
  const int tid = threadIdx.x, lane = tid & 31;
  const float* ht = h + (size_t)tile * bm * ff;
  const int nk = (ff + MM_BK - 1) / MM_BK;

  float acc[2][16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[0][i] = acc[1][i] = 0.f;

  auto load = [&](int s) {
    uint8_t* st = ring + (s % DOWN_STAGES) * DOWN_STAGE;
    uint64_t* bs = &bar[s % DOWN_STAGES];
    const int k0 = (s % nk) * MM_BK, r0 = (s / nk) * NR;
    if (tid == 0) {
      mbar_arm(bs, 2 * W_BYTES);
      tma_load_3d(smem_u32(st), &w2_map, bs, c0, k0, e);
      tma_load_3d(smem_u32(st + W_BYTES), &w2_map, bs, c0 + SBN, k0, e);
    }
    copy_rows<16, NR, MM_BK>(
        smem_u32(st + 2 * W_BYTES),
        [=](int r) { return ht + (size_t)r * ff; }, ht, r0, n_live, k0, ff,
        [](int r, int c) { return (r * MM_BK + c) * 4; }, tid, SNT);
  };
  auto compute = [&](int slot) {
    uint8_t* st = ring + slot * DOWN_STAGE;
    split_tile<NR, MM_BK>(reinterpret_cast<const float*>(st + 2 * W_BYTES),
                          pieces, X_BYTES, 0, tid, SNT);
    fence_async_smem();
    __syncthreads();
    const uint32_t w = smem_u32(st), p = smem_u32(pieces);
    float part[2][16];      // the stage's sums, promoted (hopper_mma.cuh)
    zero(part[0]);
    zero(part[1]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < MM_BK / 16; ++j)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const uint64_t db = desc_rows(p + q * X_BYTES, j);
        wgmma_ss_n32(part[0], desc_w(w, j), db);
        wgmma_ss_n32(part[1], desc_w(w + W_BYTES, j), db);
      }
    wgmma_commit();
    wgmma_wait<0>();
    keep(part[0]);
    keep(part[1]);
    promote(acc[0], part[0]);
    promote(acc[1], part[1]);
  };
  auto done = [&](int pass) {
    const int m = c0 + ((tid >> 5) << 4) + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = pass * NR + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const float gr = r < n_live ? g[r] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = m + 8 * ((i >> 1) & 1) + half * SBN;
        if (r < n_live && c < d)
          y[((size_t)tile * bm + r) * d + c] = acc[half][i] * gr;
        acc[half][i] = 0.f;
      }
    }
  };
  stream_pipeline<DOWN_STAGES>(bar, ((n_live + NR - 1) / NR) * nk, nk, load,
                               compute, done);
}

// ---------------------------------------------------------------------------
// combine, and the index arrays it reads
// ---------------------------------------------------------------------------

// A live row carries a non-zero gate in a tile that has an expert.
__device__ __forceinline__ int live_token(const int* __restrict__ row_idx,
                                          const float* __restrict__ gates,
                                          const int* __restrict__ tile_group,
                                          int r, int bm, int G, int T) {
  const int t = row_idx[r];
  return gates[r] != 0.0f && tile_group[r / bm] < G && t >= 0 && t < T
             ? t : -1;
}

// counts[t] = live rows of token t (counts zeroed before)
__global__ void moe_combine_count_kernel(const int* __restrict__ row_idx,
                                       const float* __restrict__ gates,
                                       const int* __restrict__ tile_group,
                                       int* __restrict__ counts, int rows,
                                       int bm, int G, int T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int t = live_token(row_idx, gates, tile_group, r, bm, G, T);
  if (t >= 0) atomicAdd(&counts[t], 1);
}

// offsets = cursor = exclusive prefix sum of counts; one block of 1024.
__global__ void __launch_bounds__(1024) moe_combine_scan_kernel(
    const int* __restrict__ counts, int* __restrict__ offsets,
    int* __restrict__ cursor, int T) {
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < T; base += 1024) {
    const int i = base + tid;
    const int v = i < T ? counts[i] : 0;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_sum[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int excl = carry + (warp ? warp_sum[warp - 1] : 0) + inc - v;
    if (i < T) offsets[i] = cursor[i] = excl;
    __syncthreads();
    if (tid == 0) carry += warp_sum[31];
    __syncthreads();
  }
}

// seg[offsets[t] ...]: token t's live rows, in the order atomics give
__global__ void moe_combine_place_kernel(const int* __restrict__ row_idx,
                                       const float* __restrict__ gates,
                                       const int* __restrict__ tile_group,
                                       int* __restrict__ cursor,
                                       int* __restrict__ seg, int rows,
                                       int bm, int G, int T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int t = live_token(row_idx, gates, tile_group, r, bm, G, T);
  if (t >= 0) seg[atomicAdd(&cursor[t], 1)] = r;
}

// out[t] = sum of y over token t's live rows in ascending row order: the
// block first ranks its segment of seg (rows are distinct, so the ranks
// are) into `order`, then adds the rows in that order.
__global__ void moe_combine_kernel(const float* __restrict__ y,
                                   const int* __restrict__ seg,
                                   int* __restrict__ order,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ counts,
                                   float* __restrict__ out, int d) {
  const int t = blockIdx.x;
  const int beg = offsets[t], n = counts[t];
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int v = seg[beg + j];
    int rank = 0;
    for (int i = 0; i < n; ++i) rank += seg[beg + i] < v;
    order[beg + rank] = v;
  }
  __syncthreads();
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kern, typename... Args>
int launch(Kern kern, long long blocks, int threads, int smem,
           cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks > 0)
    kern<<<static_cast<unsigned>(blocks), threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches, on `stream`, the combine's index passes (count, scan, place),
// up and down (the weight-streaming kernels when stream_path, else the
// tensor-core kernels) and the combine.  x (T, d), w1 / w3 (G, d, ff) and
// w2 (G, ff, d) bf16 with d and ff multiples of 8 and 16-byte aligned
// pointers (w3 null when !gated).  Scratch from the caller: h (n_m*bm,
// ff) and y (n_m*bm, d) fp32, idx (3 T + 2 n_m*bm) int32.  Returns the
// first CUDA error (0 = none).
extern "C" int fused_moe_ffn(const void* x, const void* w1, const void* w3,
                             const void* w2, const void* row_idx,
                             const void* gates, const void* tile_group,
                             void* idx, void* h, void* y, void* out, int T,
                             int d, int ff, int G, int n_m, int bm, int act,
                             int gated, int stream_path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* ri = static_cast<const int*>(row_idx);
  const auto* gt = static_cast<const float*>(gates);
  const auto* tg = static_cast<const int*>(tile_group);
  auto* hf = static_cast<float*>(h);
  auto* yf = static_cast<float*>(y);
  const int rows = n_m * bm;
  int* counts = static_cast<int*>(idx);
  int* offsets = counts + T;
  int* cursor = offsets + T;
  int* seg = cursor + T;
  int* order = seg + rows;
  // W1 / W3 (G, d, ff) and W2 (G, ff, d) in boxes of 64 columns x 64 rows
  CUtensorMap m1, m3, m2;
  int err = encode_experts(&m1, static_cast<const bf16*>(w1), ff, d, G, 64);
  if (!err)
    err = gated ? encode_experts(&m3, static_cast<const bf16*>(w3), ff, d, G,
                                 64)
                : (m3 = m1, 0);
  if (!err)
    err = encode_experts(&m2, static_cast<const bf16*>(w2), d, ff, G, 64);
  if (err) return err;
  if (T > 0 && rows > 0) {
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * T, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int rb = (rows + 255) / 256;
    moe_combine_count_kernel<<<rb, 256, 0, s>>>(ri, gt, tg, counts, rows, bm,
                                              G, T);
    moe_combine_scan_kernel<<<1, 1024, 0, s>>>(counts, offsets, cursor, T);
    moe_combine_place_kernel<<<rb, 256, 0, s>>>(ri, gt, tg, cursor, seg, rows,
                                              bm, G, T);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  const long long chunks = (bm + BM - 1) / BM;
  if (stream_path) {
    err = gated ? launch(moe_up_stream_kernel<true>,
                         (long long)n_m * ((ff + SBN - 1) / SBN), SNT,
                         UP_SMEM, s, xb, ri, gt, tg, hf, d, ff, G, bm, act,
                         m1, m3)
                : launch(moe_up_stream_kernel<false>,
                         (long long)n_m * ((ff + SBN - 1) / SBN), SNT,
                         UP_SMEM, s, xb, ri, gt, tg, hf, d, ff, G, bm, act,
                         m1, m3);
    if (!err)
      err = launch(moe_down_stream_kernel,
                   (long long)n_m * ((d + 2 * SBN - 1) / (2 * SBN)), SNT,
                   DOWN_SMEM, s,
                   static_cast<const float*>(hf), gt, tg, yf, d, ff, G, bm,
                   m2);
  } else {
    err = gated ? launch(moe_up_tc_kernel<true>,
                         (long long)n_m * chunks * ((ff + 63) / 64), NT,
                         MmShape<false>::SMEM, s, xb, ri, gt, tg, hf, d, ff,
                         G, bm, act, m1, m3)
                : launch(moe_up_tc_kernel<false>,
                         (long long)n_m * chunks * ((ff + BN - 1) / BN), NT,
                         MmShape<false>::SMEM, s, xb, ri, gt, tg, hf, d, ff,
                         G, bm, act, m1, m3);
    if (!err)
      err = launch(moe_down_tc_kernel,
                   (long long)n_m * chunks * ((d + BN - 1) / BN), NT,
                   MmShape<true>::SMEM, s, static_cast<const float*>(hf), gt,
                   tg, yf, d, ff, G, bm, m2);
  }
  if (err) return err;
  if (T > 0)
    moe_combine_kernel<<<T, 128, 0, s>>>(static_cast<const float*>(yf), seg,
                                         order, offsets, counts,
                                         static_cast<float*>(out), d);
  return static_cast<int>(cudaGetLastError());
}
