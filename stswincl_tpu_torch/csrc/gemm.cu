// The wmma GEMM with fp32 accumulation: the products of K3 (reduction)
// and of rows 12-13 (`gemm_bf16`, EPI_BF16), and the fp32 column sums of
// K5's bias gradients (`colsum_bf16`). K1, K2, K5 and K6 run on the Hopper
// GEMM (gemm_sm90.cu).
//
// Bound: at the swin shapes (M = 10^4..10^5 tokens, N and K 512..4096) the
// products are compute-bound on the tensor cores. This version uses
// nvcuda::wmma 16x16x16 bf16 fragments (mma.sync), a 128x128x32 block tile
// in 8 warps (32x64 each) and a two-stage cp.async ring (the main loop,
// `tile::mma` in gemm_tile.cuh, is shared with the whole-block kernel of
// swin_block.cu). It does not reach the wgmma/TMA rate of the card. The row
// maps let a caller gather A rows and scatter C rows through the window
// partition and the cyclic shift, so no partitioned or rolled copy of an
// activation is ever written.

#include <mma.h>

#include "gemm_tile.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = tile::BM, BN = tile::BN, THREADS = tile::THREADS;

__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmParams p) {
  __shared__ __align__(128) tile::Smem sm;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  tile::Acc acc[2][4];
  tile::mma(p.A, p.lda, p.a_map, m0, p.M, p.Wt, n0, p.K, sm, acc, p.N);

  // epilogue: each warp stages one 16x16 fragment at a time in (now idle)
  // shared memory; a lane owns 8 consecutive columns of one row
  float* st = tile::staging(sm, warp);
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c0;
      // N % 8 == 0: a lane's 8 columns lie all below N or all past it
      if (m < p.M && n < p.N) {
        __align__(16) bf16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = __float2bfloat16(activate(
              st[r * 16 + c0 + e] + (p.bias ? p.bias[n + e] : 0.0f), p.act));
        *reinterpret_cast<uint4*>(p.C + map_row(p.c_map, m) * p.ldc + n) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

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

cudaError_t gemm_bf16(const GemmParams& p, int epi, cudaStream_t stream) {
  if (epi != EPI_BF16 || p.N <= 0 || p.N % 8 || p.K % tile::BK ||
      p.lda % 8 || p.ldc % 8)
    return cudaErrorInvalidValue;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  gemm_kernel<<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t colsum_bf16(const bf16* X, long long ld, int R, int N, float* out,
                        cudaStream_t stream) {
  const dim3 grid((N + CS_THREADS - 1) / CS_THREADS,
                  (R + CS_ROWS - 1) / CS_ROWS);
  colsum_kernel<<<grid, CS_THREADS, 0, stream>>>(X, ld, R, N, out);
  return cudaGetLastError();
}
