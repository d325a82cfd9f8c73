// The fp32 column sums of a bf16 matrix (`colsum_bf16`): K5's bias
// gradients (block_attention.cu). A block sums CS_ROWS rows of
// CS_THREADS columns, one column a thread (consecutive threads on
// consecutive columns), rows ascending, into a partial row of its own;
// `sum_parts_cols` adds the partial rows in a fixed order. No float
// atomic: two calls on the same inputs give the same bits.
//
// `sum_parts_cols`: the second pass of a sum over many partial rows of
// few columns (K5's and K6's column sums: 160-1,280 rows of 512-3,072
// columns). `sum_parts` gives each column one thread that walks every row,
// which keeps a few SMs busy (0.28-0.32 ms of K6's time at the training
// shapes); here a block of 16 warps takes 32 columns, warp w the rows w,
// w + 16, ... ascending, and the 16 warps' sums meet in shared memory in
// warp order.

#include "common.cuh"

namespace {

constexpr int CS_THREADS = 256, CS_ROWS = 512;
constexpr int SP_WARPS = 16;  // sum_parts_cols: row groups a block

__global__ void __launch_bounds__(CS_THREADS)
    colsum_kernel(const bf16* __restrict__ X, long long ld, int R, int N,
                  float* __restrict__ part) {
  const int n = blockIdx.x * CS_THREADS + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * CS_ROWS, r1 = min(R, r0 + CS_ROWS);
  const bf16* p = X + (long long)r0 * ld + n;
  float s = 0.0f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r, p += ld) s += __bfloat162float(*p);
  part[(long long)blockIdx.y * N + n] = s;
}

// out[i] = sum over s of part[s * stride + i]: block (32, SP_WARPS), the
// columns 32 blockIdx.x ..; warp w sums rows w, w + SP_WARPS, ...
__global__ void __launch_bounds__(32 * SP_WARPS)
    sum_parts_cols_kernel(const float* __restrict__ part, int parts,
                          long long stride, long long len,
                          float* __restrict__ out) {
  __shared__ float red[SP_WARPS][33];
  const long long i = blockIdx.x * 32LL + threadIdx.x;
  const int w = threadIdx.y;
  float v = 0.0f;
  if (i < len)
    for (int s = w; s < parts; s += SP_WARPS) v += part[s * stride + i];
  red[w][threadIdx.x] = v;
  __syncthreads();
  if (w == 0 && i < len) {
    float t = red[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < SP_WARPS; ++k) t += red[k][threadIdx.x];
    out[i] = t;
  }
}

}  // namespace

cudaError_t sum_parts_cols(const float* part, int parts, long long stride,
                           long long len, float* out, cudaStream_t s) {
  if (len <= 0 || parts <= 0) return cudaErrorInvalidValue;
  sum_parts_cols_kernel<<<static_cast<unsigned>((len + 31) / 32),
                          dim3(32, SP_WARPS), 0, s>>>(part, parts, stride,
                                                      len, out);
  return cudaGetLastError();
}

int colsum_bf16_parts(int R) { return R < 1 ? 1 : (R + CS_ROWS - 1) / CS_ROWS; }

cudaError_t colsum_bf16(const bf16* X, long long ld, int R, int N, float* out,
                        float* part, cudaStream_t stream) {
  if (N <= 0 || R < 0 || !part) return cudaErrorInvalidValue;
  const int parts = colsum_bf16_parts(R);
  colsum_kernel<<<dim3((N + CS_THREADS - 1) / CS_THREADS, parts), CS_THREADS,
                  0, stream>>>(X, ld, R, N, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_parts_cols(part, parts, N, N, out, stream);
}
