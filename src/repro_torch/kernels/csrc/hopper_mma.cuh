// Device and host helpers shared by the port's Hopper (sm_90a) kernels
// K1 (fused_moe_ffn.cu), K2 (grouped_matmul.cu), K3/K4 (paged_attn.cu),
// K5 (normhead.cu) and K6 (wkv6.cu): cp.async and TMA copies, mbarriers,
// wgmma issue and descriptors, mma.sync m16n8k16, the exact three-piece
// bf16 split of fp32 operands, the 128-byte swizzle, the fp32 tile store,
// K2's pipelined 128 x 128 tile (`mm_tile`), which K1's tensor-core path
// runs with gathered rows, and the per-device shared-memory opt-in.
//
// Included once by each .cu file (each builds its own library), so the
// helpers live in an anonymous namespace.
#pragma once

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
constexpr int MM_BK = 64;  // contraction per stage: one 128-byte row
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

// Copy the R x C window at (r0, c0) of a matrix whose row r starts at
// rows(r) into shared memory at dst + off(r - r0, c - c0), BYTES per
// cp.async, zero past row r_end and column c_end (c_end is a multiple of
// the copy's width; rows() is called for rows before r_end only, and a
// zero fill names `any`, a valid device address); `nthreads` threads
// share the copies.
template <int BYTES, int R, int C, typename Rows, typename Off>
__device__ __forceinline__ void copy_rows(uint32_t dst, Rows rows,
                                          const void* any, int r0, int r_end,
                                          int c0, int c_end, Off off, int tid,
                                          int nthreads = NT) {
  using T = typename std::remove_cv<typename std::remove_pointer<
      decltype(rows(0))>::type>::type;
  constexpr int E = BYTES / sizeof(T), CPR = C / E;
  for (int i = tid; i < R * CPR; i += nthreads) {
    const int r = i / CPR, c = (i % CPR) * E;
    const bool v = r0 + r < r_end && c0 + c < c_end;
    cp_async<BYTES>(dst + off(r, c),
                    v ? static_cast<const void*>(rows(r0 + r) + c0 + c) : any,
                    v);
  }
}

// The same for a row-major matrix with row stride ld.
template <int BYTES, int R, int C, typename T, typename Off>
__device__ __forceinline__ void copy_window(uint32_t dst, const T* src,
                                            size_t ld, int r0, int r_end,
                                            int c0, int c_end, Off off,
                                            int tid) {
  copy_rows<BYTES, R, C>(
      dst, [=](int r) { return src + (size_t)r * ld; }, src, r0, r_end, c0,
      c_end, off, tid);
}

// The same in 16-byte copies where `vec16` (16-byte-aligned rows), else 8.
template <int R, int C, typename Rows, typename Off>
__device__ __forceinline__ void copy_rows_vec(bool vec16, uint32_t dst,
                                              Rows rows, const void* any,
                                              int r0, int r_end, int c0,
                                              int c_end, Off off, int tid) {
  if (vec16)
    copy_rows<16, R, C>(dst, rows, any, r0, r_end, c0, c_end, off, tid);
  else
    copy_rows<8, R, C>(dst, rows, any, r0, r_end, c0, c_end, off, tid);
}

template <int R, int C, typename T, typename Off>
__device__ __forceinline__ void copy_window_vec(bool vec16, uint32_t dst,
                                                const T* src, size_t ld,
                                                int r0, int r_end, int c0,
                                                int c_end, Off off, int tid) {
  copy_rows_vec<R, C>(
      vec16, dst, [=](int r) { return src + (size_t)r * ld; }, src, r0,
      r_end, c0, c_end, off, tid);
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

// Thread 0 initialises `n` barriers of count 1; the caller then syncs.
__device__ __forceinline__ void mbar_init_all(uint64_t* bar, int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
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

// d (64 x 32 fp32 per warpgroup) += A (64 x 16 bf16) @ B (16 x 32 bf16),
// both from shared memory: A MN-major (M contiguous: the transpose bit),
// B K-major.  The narrow form of "swap AB": 64 weight columns as M, up to
// 32 activation rows as N.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d += a (16 x 16 bf16, row) @ b (16 x 8 bf16, col), fp32 (mma.sync: a
// warp's tile; A fragment as `split_frag` below, B fragment b0 = (k, k +
// 1), b1 = (k + 8, k + 9) at k = 2 (lane % 4) of column lane / 4)
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// A raw fp32 R x C tile (row-major) -> three 128-byte-swizzled bf16 tiles
// (hi, mid, lo) `piece` bytes apart, 64-column halves `half` bytes apart.
template <int R, int C>
__device__ __forceinline__ void split_tile(const float* raw, uint8_t* pieces,
                                           uint32_t piece, uint32_t half,
                                           int tid, int nthreads = NT) {
  for (int c = tid; c < R * C / 4; c += nthreads) {
    const int r = c / (C / 4), cc = (c % (C / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * C + cc);
    uint32_t h[4], m[4], l[4];
    split3(x.x, h[0], m[0], l[0]);
    split3(x.y, h[1], m[1], l[1]);
    split3(x.z, h[2], m[2], l[2]);
    split3(x.w, h[3], m[3], l[3]);
    const uint32_t off = swz(r, cc, half);
    *reinterpret_cast<uint2*>(pieces + off) =
        make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
    *reinterpret_cast<uint2*>(pieces + piece + off) =
        make_uint2(pack(m[0], m[1]), pack(m[2], m[3]));
    *reinterpret_cast<uint2*>(pieces + 2 * piece + off) =
        make_uint2(pack(l[0], l[1]), pack(l[2], l[3]));
  }
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
// K2's tile: 128 rows x 128 columns of rows @ one group's rhs
// ---------------------------------------------------------------------------

template <bool A32>
struct MmShape {
  // one block per SM (the promoted accumulators take 128 registers a
  // thread), so the ring fills the SM's shared memory: 213 KB for fp32
  // rows, 209 KB for bf16
  static constexpr int STAGES = A32 ? 4 : 6;
  static constexpr int A_LD = MM_BK + 8;  // conflict-free fragment reads
  static constexpr int A_BYTES = BM * A_LD * (A32 ? 4 : 2);
  static constexpr int B_BYTES = MM_BK * BN * 2;  // 16 KB, 16 atoms
  static constexpr int RING = STAGES * (A_BYTES + B_BYTES) + 8 * STAGES;
  static constexpr int SMEM = SWZ + (RING > EPI_BYTES ? RING : EPI_BYTES);
};

// acc += part, in fp32 registers (round to nearest).  The tensor cores
// truncate each wgmma's sum instead of rounding it, so an accumulator
// that every k16 step adds into shrinks by about half an ulp per step:
// its error grows like K (tests/test_torch_train_kernels.py measures it).
// Each stage's wgmmas therefore add into a fresh `part`, and the stage
// ends by promoting it here: the truncation then touches at most one
// stage's sum (4 k16 steps, 12 with three pieces), and the error grows
// like sqrt(K), as fp32 summation order does.
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N],
                                        const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}
template <int N>
__device__ __forceinline__ void zero(float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) part[i] = 0.f;
}

// One stage (MM_BK of K) of one warpgroup's 64 x 128 tile.  The k16
// steps are pipelined: step j's fragments are loaded (and split) while
// step j - 1's wgmmas run; wgmma_wait<1> then frees step j - 1's
// registers, and the stage ends with every wgmma done (its shared-memory
// slot is reloaded after the next barrier) and its sum promoted to acc.
template <bool A32, bool TRANS_B>
__device__ __forceinline__ void mm_stage(float (&acc)[64],
                                         const uint8_t* a_tile,
                                         uint32_t b_tile, int row0,
                                         int lane) {
  constexpr int NP = A32 ? 3 : 1, LD = MmShape<A32>::A_LD, KS = MM_BK / 16;
  const int r = row0 + (lane >> 2), c = (lane & 3) * 2;
  uint32_t a[KS][NP][4];
  float part[64];
  zero(part);
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
    for (int p = 0; p < NP; ++p) wgmma_rs<TRANS_B ? 0 : 1>(part, a[j][p], d);
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

// The B side of one tile: the group's rhs in device memory (`rg`, for the
// cp.async form) and, with TMA, the maps and column starts of B's two
// 64-column halves (MN-major; one map and n_lo for the K-major form).
// K2 takes both halves from one matrix (n0 and n0 + 64); K1's gated up
// product takes the same 64 columns of W1 and of W3, so one tile computes
// x W1 and x W3 side by side.
struct TileB {
  const bf16* rg;
  const CUtensorMap* map_lo;
  const CUtensorMap* map_hi;
  int n_lo, n_hi;
};

// acc += rows [r_beg, r_end) of A (row r at rows(r), K columns; zero past
// r_end and past K; `any` a valid address for the zero fills) @ group
// g's B tile of columns [n0, n0 + BN): a 128 x 128 fp32 tile on two warpgroups, the ring in `base` (1024-aligned
// dynamic shared memory of MmShape<A32>::RING bytes).  The stages'
// copies run STAGES - 1 ahead of the wgmmas; a warpgroup whose 64 rows
// all lie past r_end issues none.  Called by every thread of the block.
template <bool A32, bool TRANS_B, typename Rows>
__device__ __forceinline__ void mm_tile(float (&acc)[64], uint8_t* base,
                                        Rows rows, const void* any,
                                        const TileB& b, int g,
                                        int K, int N, int r_beg, int r_end,
                                        int n0, int a16, int tma) {
  using S = MmShape<A32>;
  using TA = typename std::conditional<A32, float, bf16>::type;
  uint8_t* sB = base;
  uint8_t* sA = base + S::STAGES * S::B_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sA + S::STAGES * S::A_BYTES);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16;  // the warp's rows
  const int nk = (K + MM_BK - 1) / MM_BK;
  if (tma) mbar_init_all(bar, S::STAGES);
  __syncthreads();

  auto load = [&](int kt) {
    const int slot = kt % S::STAGES, k0 = kt * MM_BK;
    // A: BM rows x MM_BK of lhs, zero past r_end and past K
    copy_rows_vec<BM, MM_BK>(
        a16, smem_u32(sA + slot * S::A_BYTES), rows, any, r_beg, r_end, k0,
        K,
        [](int r, int c) { return (r * S::A_LD + c) * sizeof(TA); }, tid);
    // B: the group's MM_BK x BN tile, 128-byte swizzled
    const uint32_t b_s = smem_u32(sB + slot * S::B_BYTES);
    if (tma) {
      if (tid == 0) {
        mbar_arm(&bar[slot], S::B_BYTES);
        if (TRANS_B) {
          tma_load_3d(b_s, b.map_lo, &bar[slot], k0, b.n_lo, g);
        } else {
          tma_load_3d(b_s, b.map_lo, &bar[slot], b.n_lo, k0, g);
          tma_load_3d(b_s + MM_BK * 128, b.map_hi, &bar[slot], b.n_hi, k0,
                      g);
        }
      }
    } else if (TRANS_B) {  // rows n of 64 k (K-major)
      copy_window<8, BN, MM_BK>(
          b_s, b.rg, K, n0, N, k0, K,
          [](int r, int c) { return swz(r, c, 0); }, tid);
    } else {               // rows k of two 64-column halves (MN-major)
      copy_window<8, MM_BK, BN>(
          b_s, b.rg, N, k0, K, n0, N,
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// Let `kern` launch with `smem` bytes of dynamic shared memory and the
// largest shared-memory carveout on the current device.  The attributes
// hold per device: `granted` (the caller's, one per kernel) remembers the
// devices that have them, so only a device's first launch pays for them.
template <typename Kern>
int opt_in_smem(Kern kern, int smem, bool (&granted)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES && granted[dev]) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES) granted[dev] = true;
  return 0;
}

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

// The tensor map of G bf16 matrices (G, outer, inner), row-major, read in
// boxes of 64 inner x box_outer rows with the 128-byte swizzle and zero
// fill out of bounds.  Returns a CUDA error code (0 = none).
int encode_experts(CUtensorMap* map, const bf16* ptr, int inner, int outer,
                   int G, int box_outer) {
  memset(map, 0, sizeof *map);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * outer * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(ptr),
          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace
