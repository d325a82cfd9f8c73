// The fp32 column sums of a bf16 matrix (`colsum_bf16`): K5's bias
// gradients (block_attention.cu). A block sums CS_ROWS rows of
// CS_THREADS columns, one column a thread (consecutive threads on
// consecutive columns), and adds its sums into the output with one fp32
// atomic a column.

#include "common.cuh"

namespace {

constexpr int CS_THREADS = 256, CS_ROWS = 512;

__global__ void __launch_bounds__(CS_THREADS)
    colsum_kernel(const bf16* __restrict__ X, long long ld, int R, int N,
                  float* __restrict__ out) {
  const int n = blockIdx.x * CS_THREADS + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * CS_ROWS, r1 = min(R, r0 + CS_ROWS);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += __bfloat162float(X[(long long)r * ld + n]);
  atomicAdd(out + n, s);
}

}  // namespace

cudaError_t colsum_bf16(const bf16* X, long long ld, int R, int N, float* out,
                        cudaStream_t stream) {
  const dim3 grid((N + CS_THREADS - 1) / CS_THREADS,
                  (R + CS_ROWS - 1) / CS_ROWS);
  colsum_kernel<<<grid, CS_THREADS, 0, stream>>>(X, ld, R, N, out);
  return cudaGetLastError();
}
