// K2: grouped matmul over group-aligned rows, and the grouped weight
// gradient that goes with it, for Hopper (sm_90a), CUDA C++.
//
// grouped_matmul_aligned replaces the TPU kernel `grouped_matmul_aligned`
// in src/repro/kernels/grouped_matmul.py (`_kernel`, pallas_call at :124).
// Same function and tile ownership: the rows of lhs (M_pad, K) are laid out
// by kernels/ops.py::_align_groups so that every bm-row tile belongs to one
// group, tile_group[t] names it, and out[tile rows] = lhs[tile rows] @
// rhs[tile_group[t]] with fp32 accumulation; a tile whose tile_group is G
// (past the last group) is written as zeros.  lhs is fp32 or bf16, rhs
// bf16 (G, K, N), or (G, N, K) read in place as its transpose (`trans_b`)
// so the backward's products with W^T never copy the experts.
//
// grouped_matmul_wgrad computes, per group g, lhs_rows^T @ rhs_rows over
// the rows [off_g, off_g + size_g) of the row-sorted operands (offsets
// cumulated on the device by the caller): the (G, K, N) weight gradient
// of a ragged dot, which the reference leaves to XLA outside any Pallas
// kernel.  Rows past the last group contribute nothing; an empty group
// writes zeros.  The output is fp32, or bf16 rounded once to nearest even.
//
// What bounds them: at the training shapes of a Ling-Lite MoE layer (12288
// routed rows, K and N of 2048 and 1408) each product is ~71 GFLOP against
// 0.3-0.9 GB of operands and output, so both the tensor cores and HBM
// matter.  Design:
//
//  * Tensor cores.  Each block computes a 128 x 128 fp32 output tile with
//    two warpgroups, each issuing wgmma.mma_async m64n128k16 (bf16 inputs,
//    fp32 accumulators, 64 per thread).  The column tile is 128: it divides
//    both 1408 and 2048 (176 would leave 2048 a masked tile).  The tensor
//    cores truncate each wgmma's sum, so every stage adds into 64 fresh
//    registers that the stage then adds to the tile's accumulators in
//    fp32 (hopper_mma.cuh `promote`): the error then grows like sqrt(K),
//    not like K.  With 128 accumulator registers a thread, one block fits
//    an SM.  A comes from registers, B from shared memory
//    through a 128-byte-swizzle descriptor: K-major for trans_b (rhs (N,
//    K)), MN-major (the transpose bit for 16-bit B) otherwise.
//  * Exact split of fp32 operands.  An fp32 value x is cut by truncation
//    into bf16 pieces: hi = x & 0xFFFF0000, r = x - hi, mid = r &
//    0xFFFF0000, lo = (r - mid) & 0xFFFF0000.  fp32 has 24 significant
//    bits and bf16 8, so x = hi + mid + lo exactly (for |x| >= 2^-110;
//    below that, lo falls under bf16's smallest subnormal 2^-133 and the
//    error is < 2^-133 absolute).  Truncation, unlike rounding, cannot
//    turn hi into inf near fp32's maximum.  A non-finite x stays
//    non-finite (+-inf gives inf - inf = NaN in mid and lo), so the spike
//    guard and the clip still see it.  Each bf16 x bf16 product is exact
//    in fp32, so an fp32 lhs takes three wgmma passes (hi, mid, lo)
//    against one B tile and the result equals the fp32 product up to
//    summation order.  In the weight gradient, an fp32 x fp32 product
//    keeps the six piece products with i + j <= 2 (the dropped three are
//    below 2^-24 relative: ~7e-9 of the largest output).
//  * Staging.  A ring of A and B tiles in shared memory (4 stages for fp32
//    rows, 6 for bf16, 4 in the weight gradient), the copies for stage s +
//    STAGES - 1 in flight while stage s computes.  K2 loads the expert
//    tiles with TMA (cp.async.bulk.tensor, 128-byte swizzle, out-of-bounds
//    zero fill, completion on an mbarrier) where rhs's row stride is a
//    multiple of 16 bytes, and with 8-byte cp.async into the same swizzled
//    layout otherwise (N or K = 4 mod 8).  Rows and the A operand always
//    go through cp.async (16-byte, or 8-byte where the stride is not a
//    multiple of 16 bytes) with zero fill past the tile's rows and past
//    K; the weight gradient's row ranges end at group boundaries, which a
//    tensor map cannot express.  fp32 A tiles are split in registers, each
//    k16 step's split overlapping the previous step's wgmmas; an fp32 B
//    tile of the weight gradient is split once per stage into three
//    swizzled bf16 tiles in shared memory.  The output tile goes out
//    through shared memory in rows of 16 bytes (transposed there when the
//    weight gradient swapped its operands).
//  * Raster.  K2's blocks run column tile fastest: the blocks of one row
//    tile run together (its lhs rows are read from HBM once), and the row
//    tiles of one group are neighbours, so each expert's weights are read
//    from HBM about once and then from L2 (row tile fastest instead reads
//    the rows once per column tile, and was slower on the H100).  The
//    weight gradient runs the tiles of one group together, so the group's
//    rows come from L2.
//  * Not yet: a persistent, warp-specialised grid.  The weight gradient's
//    groups average ~192 rows, so each block's pipeline fill and store is
//    exposed beside only 3-6 stages of work.
//
// Both kernels are deterministic: no atomics, one fixed order of wgmma
// issues per output tile.  The PTX helpers, the split, the tile store and
// K2's pipelined tile (`mm_tile`) live in hopper_mma.cuh, which K1's
// tensor-core path shares.
#include "hopper_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// out (M_pad, N) fp32 = per bm-row tile, lhs_tile @ rhs[tile_group[tile]].
// 1-D grid, column tile fastest: block b covers column tile b % n_col and
// rows [tile * bm + chunk * BM, min(+BM, (tile + 1) * bm)) of row block
// b / n_col = tile * chunks + chunk.
template <bool A32, bool TRANS_B>
__global__ void __launch_bounds__(NT, 1) grouped_mm_kernel(
    const void* __restrict__ lhs_, const bf16* __restrict__ rhs,
    const int* __restrict__ tile_group, float* __restrict__ out, int K,
    int N, int G, int bm, int a16, int tma,
    const __grid_constant__ CUtensorMap rhs_map) {
  using TA = typename std::conditional<A32, float, bf16>::type;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((SWZ - (smem_u32(smem_raw) & (SWZ - 1))) &
                              (SWZ - 1));
  const int n_col = (N + BN - 1) / BN, chunks = (bm + BM - 1) / BM;
  const int n0 = (blockIdx.x % n_col) * BN;
  const int rb = blockIdx.x / n_col, tile = rb / chunks;
  const int r_beg = tile * bm + (rb % chunks) * BM;
  const int r_end = min(r_beg + BM, (tile + 1) * bm);
  const int g = tile_group[tile];
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16;  // warp's rows

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (g < G) {
    const TA* lhs = static_cast<const TA*>(lhs_);
    const TileB b{rhs + (size_t)g * K * N, &rhs_map, &rhs_map, n0,
                  n0 + 64};
    mm_tile<A32, TRANS_B>(
        acc, base, [=](int r) { return lhs + (size_t)r * K; }, lhs, b, g, K,
        N, r_beg, r_end, n0, a16, tma);
  }

  store_tile<false>(acc, reinterpret_cast<float*>(base),
                    out + (size_t)r_beg * N + n0, N, r_end - r_beg,
                    min(BN, N - n0), row0, lane, tid);
}

// ---------------------------------------------------------------------------
// the grouped weight gradient
// ---------------------------------------------------------------------------

// The contraction runs over rows, so both operands are MN-major: A = a^T
// (a (M, CA), the operand whose columns make the output rows) from
// registers, B = b (M, CB) from a swizzled bf16 tile (or, for fp32 b, from
// its three split pieces).
template <bool A32, bool B32>
struct WgShape {
  // rows per stage: 64, or 32 for fp32 x fp32, whose split B pieces
  // would otherwise leave room for one block per SM
  static constexpr int BK = (A32 && B32) ? 32 : 64;
  static constexpr int STAGES = 4;  // one block per SM, as K2
  static constexpr int A_LD = BM + (A32 ? 4 : 8);  // conflict-free reads
  static constexpr int A_BYTES = BK * A_LD * (A32 ? 4 : 2);
  static constexpr int PIECE = BK * BN * 2;  // one swizzled bf16 tile
  static constexpr int B_BYTES = B32 ? BK * BN * 4 : PIECE;
  static constexpr int P_BYTES = B32 ? 3 * PIECE : 0;
  static constexpr int RING = P_BYTES + STAGES * (B_BYTES + A_BYTES);
  static constexpr int SMEM = SWZ + (RING > EPI_BYTES ? RING : EPI_BYTES);
};

// One stage (BK rows) of one warpgroup's 64 x 128 tile, its k16 steps
// pipelined as in mm_stage.
template <bool A32, bool B32>
__device__ __forceinline__ void wg_stage(float (&acc)[64],
                                         const uint8_t* a_tile,
                                         uint32_t b_tile, int m0, int lane) {
  using W = WgShape<A32, B32>;
  constexpr int NP = A32 ? 3 : 1, LD = W::A_LD, KS = W::BK / 16;
  constexpr uint32_t HALF = W::BK * 128;
  const int m = m0 + (lane >> 2), k = (lane & 3) * 2;
  uint32_t a[KS][NP][4];
  float part[64];
  zero(part);
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int kc = 16 * j + k;
    // element (m, kc) of A is a_tile[kc][m]
    const int o[8] = {kc * LD + m,           (kc + 1) * LD + m,
                      kc * LD + m + 8,       (kc + 1) * LD + m + 8,
                      (kc + 8) * LD + m,     (kc + 9) * LD + m,
                      (kc + 8) * LD + m + 8, (kc + 9) * LD + m + 8};
    if constexpr (A32) {
      const float* t = reinterpret_cast<const float*>(a_tile);
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = t[o[i]];
      split_frag(v, a[j]);
    } else {
      const uint16_t* t = reinterpret_cast<const uint16_t*>(a_tile);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[j][0][q] = static_cast<uint32_t>(t[o[2 * q]]) |
                     (static_cast<uint32_t>(t[o[2 * q + 1]]) << 16);
    }
    const uint64_t d0 = desc_b128(b_tile + 2048 * j, HALF, SWZ);
    wgmma_fence();
    if constexpr (A32 && B32) {
      // the six piece products with i + j <= 2
      const uint64_t d1 = desc_b128(b_tile + W::PIECE + 2048 * j, HALF, SWZ);
      const uint64_t d2 =
          desc_b128(b_tile + 2 * W::PIECE + 2048 * j, HALF, SWZ);
      wgmma_rs<1>(part, a[j][0], d0);
      wgmma_rs<1>(part, a[j][0], d1);
      wgmma_rs<1>(part, a[j][1], d0);
      wgmma_rs<1>(part, a[j][0], d2);
      wgmma_rs<1>(part, a[j][1], d1);
      wgmma_rs<1>(part, a[j][2], d0);
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) wgmma_rs<1>(part, a[j][p], d0);
    }
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
#pragma unroll
      for (int p = 0; p < NP; ++p) keep(a[j - 1][p]);
    }
  }
  wgmma_wait<0>();
  keep(part);
#pragma unroll
  for (int p = 0; p < NP; ++p) keep(a[KS - 1][p]);
  promote(acc, part);
}

// out[g] = a_g^T b_g over group g's rows: (CA, CB), or stored transposed as
// (CB, CA) when TRANS_OUT; fp32, or bf16 (OUT16) rounded once to nearest
// even.  Grid: (ceil(CB / BN), ceil(CA / BM), G), one group's tiles
// together.
template <bool A32, bool B32, bool TRANS_OUT, bool OUT16>
__global__ void __launch_bounds__(NT, 1) grouped_wgrad_kernel(
    const void* __restrict__ a_, const void* __restrict__ b_,
    const int* __restrict__ offsets, const int* __restrict__ sizes,
    void* __restrict__ out_, int M, int CA, int CB, int a16, int b16) {
  using W = WgShape<A32, B32>;
  using TA = typename std::conditional<A32, float, bf16>::type;
  using TB = typename std::conditional<B32, float, bf16>::type;
  using TO = typename std::conditional<OUT16, bf16, float>::type;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((SWZ - (smem_u32(smem_raw) & (SWZ - 1))) &
                              (SWZ - 1));
  uint8_t* sP = base;
  uint8_t* sB = base + W::P_BYTES;
  uint8_t* sA = sB + W::STAGES * W::B_BYTES;

  const int g = blockIdx.z, n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int r_beg = min(offsets[g], M), r_end = min(r_beg + sizes[g], M);
  const int nk = (r_end - r_beg + W::BK - 1) / W::BK;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int mw = wg * 64 + ((tid >> 5) & 3) * 16;  // the warp's rows
  const TA* a = static_cast<const TA*>(a_);
  const TB* b = static_cast<const TB*>(b_);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto load = [&](int kt) {
    const int slot = kt % W::STAGES, r0 = r_beg + kt * W::BK;
    copy_window_vec<W::BK, BM>(
        a16, smem_u32(sA + slot * W::A_BYTES), a, CA, r0, r_end, m0, CA,
        [](int r, int c) { return (r * W::A_LD + c) * sizeof(TA); }, tid);
    // b: raw fp32 rows (split later), or bf16 straight into the swizzle
    copy_window_vec<W::BK, BN>(
        b16, smem_u32(sB + slot * W::B_BYTES), b, CB, r0, r_end, n0, CB,
        [](int r, int c) -> uint32_t {
          return B32 ? (r * BN + c) * 4 : swz(r, c, W::BK * 128);
        },
        tid);
  };

  for (int s = 0; s < W::STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const bool live = m0 + wg * 64 < CA;
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % W::STAGES;
    cp_async_wait<W::STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    if (kt + W::STAGES - 1 < nk) load(kt + W::STAGES - 1);
    cp_async_commit();
    uint32_t b_tile = smem_u32(sB + slot * W::B_BYTES);
    if constexpr (B32) {
      split_tile<W::BK, BN>(
          reinterpret_cast<const float*>(sB + slot * W::B_BYTES), sP,
          W::PIECE, W::BK * 128, tid);
      fence_async_smem();
      __syncthreads();
      b_tile = smem_u32(sP);
    }
    if (live) wg_stage<A32, B32>(acc, sA + slot * W::A_BYTES, b_tile, mw,
                                 lane);
  }

  TO* out = static_cast<TO*>(out_) + (size_t)g * CA * CB;
  if constexpr (TRANS_OUT)
    store_tile<true>(acc, reinterpret_cast<float*>(base),
                     out + (size_t)n0 * CA + m0, CA, min(BN, CB - n0),
                     min(BM, CA - m0), mw, lane, tid);
  else
    store_tile<false>(acc, reinterpret_cast<float*>(base),
                      out + (size_t)m0 * CB + n0, CB, min(BM, CA - m0),
                      min(BN, CB - n0), mw, lane, tid);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <bool A32, bool TRANS_B>
int launch_mm(const void* lhs, const bf16* rhs, const int* tg, float* out,
              int M_pad, int K, int N, int G, int bm, cudaStream_t s) {
  using S = MmShape<A32>;
  auto kern = grouped_mm_kernel<A32, TRANS_B>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int a16 = aligned16(lhs, (size_t)K * (A32 ? 4 : 2));
  const size_t ld_b = (size_t)(TRANS_B ? K : N) * 2;
  const int tma = aligned16(rhs, ld_b);
  CUtensorMap map;
  memset(&map, 0, sizeof map);
  if (tma) {
    // (G, K, N) in boxes of {64, MM_BK}: one 64-column half;
    // (G, N, K) in boxes of {64, BN}: the whole K-major tile
    const int err = TRANS_B ? encode_experts(&map, rhs, K, N, G, BN)
                            : encode_experts(&map, rhs, N, K, G, MM_BK);
    if (err) return err;
  }
  const long long blocks = (long long)((N + BN - 1) / BN) * (M_pad / bm) *
                           ((bm + BM - 1) / BM);
  if (blocks == 0) return 0;
  kern<<<static_cast<unsigned>(blocks), NT, S::SMEM, s>>>(
      lhs, rhs, tg, out, K, N, G, bm, a16, tma, map);
  return static_cast<int>(cudaGetLastError());
}

template <bool A32, bool B32, bool TRANS_OUT, bool OUT16>
int launch_wg(const void* a, const void* b, const int* off, const int* sz,
              void* out, int M, int CA, int CB, int G, cudaStream_t s) {
  using W = WgShape<A32, B32>;
  auto kern = grouped_wgrad_kernel<A32, B32, TRANS_OUT, OUT16>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int a16 = aligned16(a, (size_t)CA * (A32 ? 4 : 2));
  const int b16 = aligned16(b, (size_t)CB * (B32 ? 4 : 2));
  const dim3 grid((CB + BN - 1) / BN, (CA + BM - 1) / BM, G);
  if (G == 0 || CA == 0 || CB == 0) return 0;
  kern<<<grid, NT, W::SMEM, s>>>(a, b, off, sz, out, M, CA, CB, a16, b16);
  return static_cast<int>(cudaGetLastError());
}

template <bool A32, bool B32, bool TRANS_OUT>
int launch_wg_out(bool out16, const void* a, const void* b, const int* off,
                  const int* sz, void* out, int M, int CA, int CB, int G,
                  cudaStream_t s) {
  return out16 ? launch_wg<A32, B32, TRANS_OUT, true>(a, b, off, sz, out, M,
                                                     CA, CB, G, s)
               : launch_wg<A32, B32, TRANS_OUT, false>(a, b, off, sz, out,
                                                      M, CA, CB, G, s);
}

}  // namespace

// lhs (M_pad, K) fp32 (lhs_bf16 = 0) or bf16 (1); rhs bf16 (G, K, N), or
// (G, N, K) read transposed when trans_b = 1; tile_group (M_pad / bm,)
// int32; out (M_pad, N) fp32.  K and N multiples of 4, pointers 8-byte
// aligned.  Returns the CUDA error of the launch (0 = none).
extern "C" int grouped_matmul_aligned(const void* lhs, const void* rhs,
                                      const void* tile_group, void* out,
                                      int M_pad, int K, int N, int G, int bm,
                                      int lhs_bf16, int trans_b,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const bf16*>(rhs);
  const auto* tg = static_cast<const int*>(tile_group);
  auto* o = static_cast<float*>(out);
  if (lhs_bf16)
    return trans_b ? launch_mm<false, true>(lhs, b, tg, o, M_pad, K, N, G,
                                            bm, s)
                   : launch_mm<false, false>(lhs, b, tg, o, M_pad, K, N, G,
                                             bm, s);
  return trans_b
             ? launch_mm<true, true>(lhs, b, tg, o, M_pad, K, N, G, bm, s)
             : launch_mm<true, false>(lhs, b, tg, o, M_pad, K, N, G, bm, s);
}

// lhs (M, K) fp32 or bf16 (lhs_bf16); rhs (M, N) fp32 or bf16 (rhs_bf16);
// offsets / sizes (G,) int32 row range of each group; out (G, K, N) fp32,
// or bf16 when out_bf16.  K and N multiples of 4, pointers 8-byte aligned.
// An fp32 operand goes to the register (A) side: bf16 lhs x fp32 rhs runs
// as (rhs^T lhs)^T with a transposing store.  Returns the CUDA error.
extern "C" int grouped_matmul_wgrad(const void* lhs, const void* rhs,
                                    const void* offsets, const void* sizes,
                                    void* out, int M, int K, int N, int G,
                                    int lhs_bf16, int rhs_bf16, int out_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int*>(offsets);
  const auto* sz = static_cast<const int*>(sizes);
  const bool o16 = out_bf16 != 0;
  if (lhs_bf16 && rhs_bf16)
    return launch_wg_out<false, false, false>(o16, lhs, rhs, off, sz, out, M,
                                              K, N, G, s);
  if (lhs_bf16)
    return launch_wg_out<true, false, true>(o16, rhs, lhs, off, sz, out, M,
                                            N, K, G, s);
  if (rhs_bf16)
    return launch_wg_out<true, false, false>(o16, lhs, rhs, off, sz, out, M,
                                             K, N, G, s);
  return launch_wg_out<true, true, false>(o16, lhs, rhs, off, sz, out, M, K,
                                          N, G, s);
}
