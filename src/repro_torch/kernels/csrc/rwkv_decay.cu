// The RWKV6 time mix's data-dependent decay for Hopper (sm_90a), CUDA C++:
//   w = exp(-exp(w0 + tanh(x A) B))
// for rows x (M, d) in bf16 or fp32, the decay LoRA's A (d, 32) and
// B (32, n) and the bias w0 (n) in fp32; w (M, n) fp32, the decay K6
// takes.  Replaces no TPU kernel: the reference computes it in jnp
// (src/repro/models/rwkv6.py:112), and so does the plain version.
//
// Why a kernel: a row's result must not depend on how many rows share
// the call.  The prefill computes a prompt's decays in one call and each
// decode tick computes one token's alone; cuBLAS picks an fp32 product's
// summation order by its shape, so the same token's decay could differ
// by an ulp between the two, and 32 layers carry one ulp into percents
// of the logits.  Every other op of the rwkv block already gives a row
// the same bits either way.  Here each row is summed in one order that
// depends on d alone:
//  * x A (kernel 1, grid (row blocks, NCHUNK)): d is cut into NCHUNK
//    chunks and each chunk into WARPS spans; a warp sums its span in i
//    order, lane j holding column j (one 128-byte row of A a step), for
//    ROWS rows at once; the block adds its warps' sums in warp order and
//    writes the chunk's partial.
//  * kernel 2 (grid (row blocks, column tiles of NT)): adds the NCHUNK
//    partials in chunk order and takes tanh; each thread then sums t B
//    over the 32 LoRA columns in order for its output column, adds w0
//    and applies exp(-exp(.)).
// Which rows share a block, and the column tiling, change nothing in a
// row's arithmetic.  Cutting d over NCHUNK blocks also spreads A's read
// over the card when there are few rows (a decode tick), where one
// block per row group would read all of A alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int R = 32;          // the LoRA's rank: one lane per column
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int ROWS = NT / R;   // rows a block: one (row, column) a thread
constexpr int NCHUNK = 16;     // chunks of d, one block each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rwkv_decay_xa_kernel(const T* __restrict__ x, const float* __restrict__ A,
                     float* __restrict__ part, int M, int d) {
  __shared__ float red[WARPS][ROWS][R];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS, c = blockIdx.y;
  const int chunk = (d + NCHUNK - 1) / NCHUNK;
  const int span = (chunk + WARPS - 1) / WARPS;
  const int lo = min(d, c * chunk + warp * span);
  const int hi = min(d, c * chunk + min(chunk, (warp + 1) * span));
  const T* xr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)   // rows past M repeat the last one
    xr[r] = x + static_cast<size_t>(min(row0 + r, M - 1)) * d;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const float a = __ldg(A + static_cast<size_t>(i) * R + lane);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(to_f(xr[r][i]), a, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  const int r = threadIdx.x / R, j = threadIdx.x % R;
  float s = red[0][r][j];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s += red[w][r][j];
  if (row0 + r < M)
    part[(static_cast<size_t>(c) * M + row0 + r) * R + j] = s;
}

__global__ void __launch_bounds__(NT)
rwkv_decay_out_kernel(const float* __restrict__ part,
                      const float* __restrict__ Bm,
                      const float* __restrict__ w0, float* __restrict__ out,
                      int M, int n) {
  __shared__ float t[ROWS][R];
  const int row0 = blockIdx.x * ROWS;
  {
    const int r = threadIdx.x / R, j = threadIdx.x % R;
    const size_t row = min(row0 + r, M - 1);
    float s = part[row * R + j];
#pragma unroll
    for (int c = 1; c < NCHUNK; ++c)
      s += part[(static_cast<size_t>(c) * M + row) * R + j];
    t[r][j] = tanhf(s);
  }
  __syncthreads();
  const int col = blockIdx.y * NT + threadIdx.x;
  if (col >= n) return;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 8
  for (int j = 0; j < R; ++j) {
    const float b = __ldg(Bm + static_cast<size_t>(j) * n + col);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(t[r][j], b, acc[r]);
  }
  const float bias = w0[col];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (row0 + r < M)
      out[static_cast<size_t>(row0 + r) * n + col] =
          expf(-expf(acc[r] + bias));
}

}  // namespace

// x (M, d) bf16 (x_bf16) or fp32, A (d, 32), B (32, n), w0 (n) fp32,
// part (NCHUNK, M, 32) fp32 scratch, out (M, n) fp32; all contiguous.
extern "C" int rwkv_decay(const void* x, const void* A, const void* Bm,
                          const void* w0, void* part, void* out, int M,
                          int d, int n, int x_bf16, void* stream) {
  if (M <= 0 || d <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 g1((M + ROWS - 1) / ROWS, NCHUNK);
  auto* p = static_cast<float*>(part);
  if (x_bf16)
    rwkv_decay_xa_kernel<<<g1, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(A),
        p, M, d);
  else
    rwkv_decay_xa_kernel<<<g1, NT, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(A), p, M, d);
  const dim3 g2((M + ROWS - 1) / ROWS, (n + NT - 1) / NT);
  rwkv_decay_out_kernel<<<g2, NT, 0, st>>>(
      p, static_cast<const float*>(Bm), static_cast<const float*>(w0),
      static_cast<float*>(out), M, n);
  return static_cast<int>(cudaGetLastError());
}
