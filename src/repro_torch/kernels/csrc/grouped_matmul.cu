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
//    both 1408 and 2048 (176 would leave 2048 a masked tile), and n128
//    keeps the accumulators at 64 registers beside two k16 steps of split
//    A fragments (24 registers), so two blocks fit an SM.  A comes from
//    registers, B from shared memory
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
//  * Staging.  A ring of A and B tiles in shared memory (2 stages for fp32
//    rows, 3 for bf16, two blocks per SM), the copies for stage s +
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
// issues per output tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;    // two warpgroups
constexpr int BM = 128;    // output rows per block (2 x wgmma M = 64)
constexpr int BN = 128;    // output columns per block (wgmma N)
constexpr int MM_BK = 64;  // K2 contraction per stage: one 128-byte row
constexpr int SWZ = 1024;  // one 128-byte swizzle atom: 8 rows x 128 B

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, BYTES of 16 or 8; zero fill when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
}

// Copy the R x C window at (r0, c0) of a row-major matrix (row stride ld)
// into shared memory at dst + off(r, c), BYTES per cp.async, zero past
// row r_end and column c_end (c_end is a multiple of the copy's width).
template <int BYTES, int R, int C, typename T, typename Off>
__device__ __forceinline__ void copy_window(uint32_t dst, const T* src,
                                            size_t ld, int r0, int r_end,
                                            int c0, int c_end, Off off,
                                            int tid) {
  constexpr int E = BYTES / sizeof(T), CPR = C / E;
  for (int i = tid; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * E;
    const bool v = r0 + r < r_end && c0 + c < c_end;
    cp_async<BYTES>(dst + off(r, c),
                    v ? src + (size_t)(r0 + r) * ld + c0 + c : src, v);
  }
}

// The same in 16-byte copies where `vec16` (16-byte-aligned rows), else 8.
template <int R, int C, typename T, typename Off>
__device__ __forceinline__ void copy_window_vec(bool vec16, uint32_t dst,
                                            const T* src, size_t ld, int r0,
                                            int r_end, int c0, int c_end,
                                            Off off, int tid) {
  if (vec16)
    copy_window<16, R, C>(dst, src, ld, r0, r_end, c0, c_end, off, tid);
  else
    copy_window<8, R, C>(dst, src, ld, r0, r_end, c0, c_end, off, tid);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the barrier's phase `parity` to complete.  A TMA that never
// lands traps (a launch error) after ~2^34 cycles instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1); lbo and
// sbo in bytes
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep registers live (and ordered) across the asynchronous wgmma: placed
// after a wgmma_wait, the compiler may neither read the accumulators early
// nor reuse the A fragments' registers while a wgmma still reads them.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128 fp32 per warpgroup) += A (64 x 16 bf16, registers) @ B (16 x
// 128 bf16, shared memory); TRANS_B = 1: B is MN-major (N contiguous).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// the exact split and the A fragments
// ---------------------------------------------------------------------------

// x = hi + mid + lo, each the top 16 bits of an fp32 (a bf16), by truncation
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFF0000u;
  const float r = x - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(r - __uint_as_float(mid)) & 0xFFFF0000u;
}

// bf16x2 of two truncated fp32 bit patterns: a in the low half
__device__ __forceinline__ uint32_t pack(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// The wgmma A fragment of one k16 step (per warp 16 rows, as mma.m16n8k16):
// v[0..7] = (r, c), (r, c+1), (r+8, c), (r+8, c+1), (r, c+8), (r, c+9),
// (r+8, c+8), (r+8, c+9) with r = lane / 4, c = 2 (lane % 4); register q
// holds v[2q] (low) and v[2q+1].  fp32 values give three pieces.
__device__ __forceinline__ void split_frag(const float (&v)[8],
                                           uint32_t (&a)[3][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(v[2 * q], h0, m0, l0);
    split3(v[2 * q + 1], h1, m1, l1);
    a[0][q] = pack(h0, h1);
    a[1][q] = pack(m0, m1);
    a[2][q] = pack(l0, l1);
  }
}

// Byte offset of element (row, col) in a 128-byte-swizzled tile made of
// 64-column halves `half` bytes apart (rows of 128 bytes, 8-row atoms).
__device__ __forceinline__ uint32_t swz(int row, int col, uint32_t half) {
  return (col >> 6) * half + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// The epilogue: a block's 128 x 128 fp32 tile (acc: rows mw + lane / 4
// (+ 8), columns 8 i + 2 (lane % 4) (+ 1) of each warp) goes through shared
// memory `t` (every stage of the ring done) and out in rows of 16 bytes
// (fp32) or 8 bytes (bf16, rounded once to nearest even).  `out` points at
// the tile's first element, `ld` is out's row stride; TRANS stores element
// (m, n) at out[n * ld + m].  rows x cols is the part inside out, in out's
// orientation (cols a multiple of 4).
constexpr int EPI_LD = BN + 8;  // conflict-free fragment writes either way
constexpr int EPI_BYTES = 128 * EPI_LD * 4;

template <bool TRANS, typename TO>
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* t,
                                           TO* out, size_t ld, int rows,
                                           int cols, int mw, int lane,
                                           int tid) {
  __syncthreads();
  const int m = mw + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if constexpr (TRANS) {
        t[n * EPI_LD + m + 8 * h] = v0;
        t[(n + 1) * EPI_LD + m + 8 * h] = v1;
      } else {
        *reinterpret_cast<float2*>(t + (m + 8 * h) * EPI_LD + n) =
            make_float2(v0, v1);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < 128 * 32; c += NT) {
    const int r = c >> 5, cc = (c & 31) * 4;
    if (r >= rows || cc >= cols) continue;
    const float4 v = *reinterpret_cast<const float4*>(t + r * EPI_LD + cc);
    TO* dst = out + (size_t)r * ld + cc;
    if constexpr (std::is_same<TO, float>::value) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

template <bool A32>
struct MmShape {
  // fp32 rows: 2 stages (107 KB) so that two blocks share an SM, which
  // was faster on the H100 than 4 stages in one block
  static constexpr int STAGES = A32 ? 2 : 3;
  static constexpr int A_LD = MM_BK + 8;  // conflict-free fragment reads
  static constexpr int A_BYTES = BM * A_LD * (A32 ? 4 : 2);
  static constexpr int B_BYTES = MM_BK * BN * 2;  // 16 KB, 16 atoms
  static constexpr int RING = STAGES * (A_BYTES + B_BYTES) + 8 * STAGES;
  static constexpr int SMEM = SWZ + (RING > EPI_BYTES ? RING : EPI_BYTES);
};

// One stage (MM_BK of K) of one warpgroup's 64 x 128 tile.  The k16
// steps are pipelined: step j's fragments are loaded (and split) while
// step j - 1's wgmmas run; wgmma_wait<1> then frees step j - 1's
// registers, and the stage ends with every wgmma done (its shared-memory
// slot is reloaded after the next barrier).
template <bool A32, bool TRANS_B>
__device__ __forceinline__ void mm_stage(float (&acc)[64],
                                         const uint8_t* a_tile,
                                         uint32_t b_tile, int row0,
                                         int lane) {
  constexpr int NP = A32 ? 3 : 1, LD = MmShape<A32>::A_LD, KS = MM_BK / 16;
  const int r = row0 + (lane >> 2), c = (lane & 3) * 2;
  uint32_t a[KS][NP][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    if constexpr (A32) {
      const float* p = reinterpret_cast<const float*>(a_tile) + r * LD +
                       16 * j + c;
      const float2 x0 = *reinterpret_cast<const float2*>(p);
      const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * LD);
      const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * LD + 8);
      const float v[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
      split_frag(v, a[j]);
    } else {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const bf16*>(a_tile) + r * LD + 16 * j + c);
      a[j][0][0] = p[0];
      a[j][0][1] = p[4 * LD];
      a[j][0][2] = p[4];
      a[j][0][3] = p[4 * LD + 4];
    }
    // K-major: rows of 64 k, a k16 step is 32 bytes along the row.
    // MN-major: two 64-column halves MM_BK * 128 bytes apart (LBO), 8-k
    // atoms 1024 bytes apart (SBO), a k16 step is 16 rows.
    const uint64_t d = TRANS_B ? desc_b128(b_tile + 32 * j, 16, SWZ)
                               : desc_b128(b_tile + 2048 * j, MM_BK * 128,
                                           SWZ);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) wgmma_rs<TRANS_B ? 0 : 1>(acc, a[j][p], d);
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
#pragma unroll
      for (int p = 0; p < NP; ++p) keep(a[j - 1][p]);
    }
  }
  wgmma_wait<0>();
  keep(acc);
#pragma unroll
  for (int p = 0; p < NP; ++p) keep(a[KS - 1][p]);
}

// out (M_pad, N) fp32 = per bm-row tile, lhs_tile @ rhs[tile_group[tile]].
// 1-D grid, column tile fastest: block b covers column tile b % n_col and
// rows [tile * bm + chunk * BM, min(+BM, (tile + 1) * bm)) of row block
// b / n_col = tile * chunks + chunk.
template <bool A32, bool TRANS_B>
__global__ void __launch_bounds__(NT, 2) grouped_mm_kernel(
    const void* __restrict__ lhs_, const bf16* __restrict__ rhs,
    const int* __restrict__ tile_group, float* __restrict__ out, int K,
    int N, int G, int bm, int a16, int tma,
    const __grid_constant__ CUtensorMap rhs_map) {
  using S = MmShape<A32>;
  using TA = typename std::conditional<A32, float, bf16>::type;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((SWZ - (smem_u32(smem_raw) & (SWZ - 1))) &
                              (SWZ - 1));
  uint8_t* sB = base;
  uint8_t* sA = base + S::STAGES * S::B_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sA + S::STAGES * S::A_BYTES);

  const int n_col = (N + BN - 1) / BN, chunks = (bm + BM - 1) / BM;
  const int n0 = (blockIdx.x % n_col) * BN;
  const int rb = blockIdx.x / n_col, tile = rb / chunks;
  const int r_beg = tile * bm + (rb % chunks) * BM;
  const int r_end = min(r_beg + BM, (tile + 1) * bm);
  const int g = tile_group[tile];
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16;  // the warp's rows

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (g < G) {
    const TA* lhs = static_cast<const TA*>(lhs_);
    const bf16* rg = rhs + (size_t)g * K * N;
    const int nk = (K + MM_BK - 1) / MM_BK;
    const CUtensorMap* map = &rhs_map;
    if (tma && tid == 0) {
      for (int s = 0; s < S::STAGES; ++s) mbar_init(&bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    auto load = [&](int kt) {
      const int slot = kt % S::STAGES, k0 = kt * MM_BK;
      // A: BM rows x MM_BK of lhs, zero past r_end and past K
      copy_window_vec<BM, MM_BK>(
          a16, smem_u32(sA + slot * S::A_BYTES), lhs, K, r_beg, r_end, k0,
          K, [](int r, int c) { return (r * S::A_LD + c) * sizeof(TA); },
          tid);
      // B: the expert's MM_BK x BN tile, 128-byte swizzled
      const uint32_t b_s = smem_u32(sB + slot * S::B_BYTES);
      if (tma) {
        if (tid == 0) {
          mbar_arm(&bar[slot], S::B_BYTES);
          if (TRANS_B) {
            tma_load_3d(b_s, map, &bar[slot], k0, n0, g);
          } else {
            tma_load_3d(b_s, map, &bar[slot], n0, k0, g);
            tma_load_3d(b_s + MM_BK * 128, map, &bar[slot], n0 + 64, k0, g);
          }
        }
      } else if (TRANS_B) {  // rows n of 64 k (K-major)
        copy_window<8, BN, MM_BK>(
            b_s, rg, K, n0, N, k0, K,
            [](int r, int c) { return swz(r, c, 0); }, tid);
      } else {               // rows k of two 64-column halves (MN-major)
        copy_window<8, MM_BK, BN>(
            b_s, rg, N, k0, K, n0, N,
            [](int r, int c) { return swz(r, c, MM_BK * 128); }, tid);
      }
    };

    for (int s = 0; s < S::STAGES - 1; ++s) {
      if (s < nk) load(s);
      cp_async_commit();
    }
    const bool live = r_beg + wg * 64 < r_end;
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % S::STAGES;
      cp_async_wait<S::STAGES - 2>();
      fence_async_smem();
      if (tma) mbar_wait(&bar[slot], (kt / S::STAGES) & 1);
      // stage kt is in place, and every warpgroup is done with kt - 1
      __syncthreads();
      if (kt + S::STAGES - 1 < nk) load(kt + S::STAGES - 1);
      cp_async_commit();
      if (live)
        mm_stage<A32, TRANS_B>(acc, sA + slot * S::A_BYTES,
                               smem_u32(sB + slot * S::B_BYTES), row0, lane);
    }
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
  static constexpr int STAGES = 2;
  static constexpr int A_LD = BM + (A32 ? 4 : 8);  // conflict-free reads
  static constexpr int A_BYTES = BK * A_LD * (A32 ? 4 : 2);
  static constexpr int PIECE = BK * BN * 2;  // one swizzled bf16 tile
  static constexpr int B_BYTES = B32 ? BK * BN * 4 : PIECE;
  static constexpr int P_BYTES = B32 ? 3 * PIECE : 0;
  static constexpr int RING = P_BYTES + STAGES * (B_BYTES + A_BYTES);
  static constexpr int SMEM = SWZ + (RING > EPI_BYTES ? RING : EPI_BYTES);
};

// raw fp32 b tile (BK x BN, row-major) -> three swizzled bf16 tiles
__device__ __forceinline__ void split_b(const float* raw, uint8_t* pieces,
                                        int tid) {
  constexpr int BK = WgShape<true, true>::BK, PIECE = BK * BN * 2;
  for (int c = tid; c < BK * BN / 4; c += NT) {
    const int r = c / (BN / 4), cc = (c % (BN / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * BN + cc);
    uint32_t h[4], m[4], l[4];
    split3(x.x, h[0], m[0], l[0]);
    split3(x.y, h[1], m[1], l[1]);
    split3(x.z, h[2], m[2], l[2]);
    split3(x.w, h[3], m[3], l[3]);
    const uint32_t off = swz(r, cc, BK * 128);
    *reinterpret_cast<uint2*>(pieces + off) =
        make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
    *reinterpret_cast<uint2*>(pieces + PIECE + off) =
        make_uint2(pack(m[0], m[1]), pack(m[2], m[3]));
    *reinterpret_cast<uint2*>(pieces + 2 * PIECE + off) =
        make_uint2(pack(l[0], l[1]), pack(l[2], l[3]));
  }
}

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
      wgmma_rs<1>(acc, a[j][0], d0);
      wgmma_rs<1>(acc, a[j][0], d1);
      wgmma_rs<1>(acc, a[j][1], d0);
      wgmma_rs<1>(acc, a[j][0], d2);
      wgmma_rs<1>(acc, a[j][1], d1);
      wgmma_rs<1>(acc, a[j][2], d0);
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) wgmma_rs<1>(acc, a[j][p], d0);
    }
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
#pragma unroll
      for (int p = 0; p < NP; ++p) keep(a[j - 1][p]);
    }
  }
  wgmma_wait<0>();
  keep(acc);
#pragma unroll
  for (int p = 0; p < NP; ++p) keep(a[KS - 1][p]);
}

// out[g] = a_g^T b_g over group g's rows: (CA, CB), or stored transposed as
// (CB, CA) when TRANS_OUT; fp32, or bf16 (OUT16) rounded once to nearest
// even.  Grid: (ceil(CB / BN), ceil(CA / BM), G), one group's tiles
// together.
template <bool A32, bool B32, bool TRANS_OUT, bool OUT16>
__global__ void __launch_bounds__(NT, 2) grouped_wgrad_kernel(
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
      split_b(reinterpret_cast<const float*>(sB + slot * W::B_BYTES), sP,
              tid);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which PyTorch has already loaded
// (no -lcuda at link time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

bool aligned16(const void* p, size_t row_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0;
}

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
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    // (G, K, N) as dims {N, K, G}, box {64, MM_BK}: one 64-column half;
    // (G, N, K) as dims {K, N, G}, box {64, BN}: the whole K-major tile
    const cuuint64_t dims[3] = {(cuuint64_t)(TRANS_B ? K : N),
                                (cuuint64_t)(TRANS_B ? N : K),
                                (cuuint64_t)G};
    const cuuint64_t strides[2] = {ld_b, (cuuint64_t)K * N * 2};
    const cuuint32_t box[3] = {64, TRANS_B ? (cuuint32_t)BN : MM_BK, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<bf16*>(rhs), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
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
