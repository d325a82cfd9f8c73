// Tiled bf16 GEMM with fp32 accumulation: the matmul building block of
// K1 (qkv, proj), K2 (fc1, fc2), K3 (reduction) and of the backward
// kernels K5 and K6 (input gradients through `gemm_bf16`, weight
// gradients through `gemm_wgrad`, bias gradients through `colsum_bf16`).
//
// Bound: at the swin shapes (M = 10^4..10^5 tokens, N and K 512..4096) the
// products are compute-bound on the tensor cores. This first version uses
// nvcuda::wmma 16x16x16 bf16 fragments (mma.sync), a 128x128x32 block tile
// in 8 warps (32x64 each) and a two-stage cp.async ring (the main loop,
// `tile::mma` in gemm_tile.cuh, is shared with the whole-block kernel of
// swin_block.cu). It does not reach
// the wgmma/TMA rate of the card; that is later work. The row maps let a
// caller gather A rows and scatter C rows through the window partition and
// the cyclic shift, so no partitioned or rolled copy of an activation is
// ever written.
//
// The weight gradients (x^T dqkv, h^T dm, ...) reduce over all token rows
// (163,840 at stage 1), far longer than the output is wide, so
// `gemm_wgrad` splits that reduction over blocks and adds the fp32
// partial sums with atomics; the TPU carried one fp32 accumulator along
// its sequential grid instead.

#include <mma.h>

#include <algorithm>

#include "gemm_tile.cuh"

using namespace nvcuda;
using tile::cp_async_commit;
using tile::cp_async_wait;

namespace {

constexpr int BM = tile::BM, BN = tile::BN, THREADS = tile::THREADS;

template <int EPI>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmParams p) {
  __shared__ __align__(128) tile::Smem sm;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  tile::Acc acc[2][4];
  tile::mma(p.A, p.lda, p.a_map, m0, p.M, p.Wt, n0, p.K, sm, acc, p.N);

  // epilogue: each warp stages one 16x16 fragment at a time in (now idle)
  // shared memory; a lane owns 8 consecutive columns of one row
  __shared__ float col_acc[BN];
  if (EPI == EPI_DGELU && p.colsum) {
    if (tid < BN) col_acc[tid] = 0.0f;
    __syncthreads();
  }
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
      const bool ok = m < p.M && n < p.N;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = st[r * 16 + c0 + e] + (p.bias && ok ? p.bias[n + e] : 0.0f);
      if (ok) {
        const long long orow = map_row(p.c_map, m);
        if (EPI == EPI_BF16 || EPI == EPI_GELU_GRAD || EPI == EPI_DGELU) {
          __align__(16) bf16 o[8];
          __align__(16) float d[8];
          if (EPI == EPI_DGELU) {
            const float4* ax =
                reinterpret_cast<const float4*>(p.aux + orow * p.ldc + n);
            const float4 a0 = ax[0], a1 = ax[1];
            v[0] *= a0.x; v[1] *= a0.y; v[2] *= a0.z; v[3] *= a0.w;
            v[4] *= a1.x; v[5] *= a1.y; v[6] *= a1.z; v[7] *= a1.w;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (EPI == EPI_GELU_GRAD) {
              const float2 gd = gelu_and_grad(v[e], p.act);
              o[e] = __float2bfloat16(gd.x);
              d[e] = gd.y;
            } else if (EPI == EPI_BF16) {
              o[e] = __float2bfloat16(activate(v[e], p.act));
            } else {
              o[e] = __float2bfloat16(v[e]);
            }
          }
          *reinterpret_cast<uint4*>(p.C + orow * p.ldc + n) =
              *reinterpret_cast<const uint4*>(o);
          if (EPI == EPI_GELU_GRAD) {
            float4* dst = reinterpret_cast<float4*>(p.Cf + orow * p.ldc + n);
            dst[0] = make_float4(d[0], d[1], d[2], d[3]);
            dst[1] = make_float4(d[4], d[5], d[6], d[7]);
          }
        } else if (EPI == EPI_F32) {
          float4* dst = reinterpret_cast<float4*>(p.Cf + orow * p.ldc + n);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          float4* dst = reinterpret_cast<float4*>(p.Cf + orow * p.ldc + n);
          float4 s0 = dst[0], s1 = dst[1];
          s0.x += v[0]; s0.y += v[1]; s0.z += v[2]; s0.w += v[3];
          s1.x += v[4]; s1.y += v[5]; s1.z += v[6]; s1.w += v[7];
          dst[0] = s0;
          dst[1] = s1;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.0f;  // past M or N: nothing
      }
      if (EPI == EPI_DGELU && p.colsum) {
        // sum the fragment's 16 rows: lanes 2r and 2r+1 hold row r
#pragma unroll
        for (int e = 0; e < 8; ++e) {
#pragma unroll
          for (int o = 2; o < 32; o <<= 1)
            v[e] += __shfl_xor_sync(0xffffffffu, v[e], o);
        }
        if (lane < 2) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            atomicAdd(&col_acc[n - n0 + e], v[e]);
        }
      }
      __syncwarp();
    }
  }
  if (EPI == EPI_DGELU && p.colsum) {
    __syncthreads();
    if (tid < BN && n0 + tid < p.N)
      atomicAdd(p.colsum + n0 + tid, col_acc[tid]);
  }
}

// ---- weight gradient: Cw += A^T B over a long row reduction -------------

constexpr int WK = 32, WLD = 128 + 8;

__global__ void __launch_bounds__(THREADS) wgrad_kernel(WgradParams p,
                                                        int kt_per_split) {
  __shared__ __align__(128) bf16 As[2][WK * WLD];
  __shared__ __align__(128) bf16 Bs[2][WK * WLD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int KT = (p.R + WK - 1) / WK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(KT, kt0 + kt_per_split);
  if (kt0 >= kt1) return;

  // each thread copies two 16-byte chunks of A and of B per k tile:
  // 32 rows x 16 chunks of 8 columns
  int srow[2], scol[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    srow[i] = c >> 4;
    scol[i] = (c & 15) * 8;
  }
  auto load = [&](int stage, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = kt * WK + srow[i];
      const bool ok = r < p.R;
      const bf16* a = p.A + (ok ? map_row(p.a_map, r) : 0) * p.lda + m0 + scol[i];
      const bf16* b = p.B + (ok ? map_row(p.b_map, r) : 0) * p.ldb + n0 + scol[i];
      cp_async16(&As[stage][srow[i] * WLD + scol[i]], a, ok);
      cp_async16(&Bs[stage][srow[i] * WLD + scol[i]], b, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0, kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load(s ^ 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[s];
    const bf16* bs = Bs[s];
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      // A^T tile: element (m, k) sits at as[k * WLD + m] -> col_major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + kk * WLD + wm * 32 + i * 16, WLD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * WLD + wn * 64 + j * 16, WLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // split-K partial sums meet in fp32 atomics (order varies run to run)
  float* st = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c0;
      float* dst = p.Cw + (long long)m * p.ldc + n;
#pragma unroll
      for (int e = 0; e < 8; ++e) atomicAdd(dst + e, st[r * 16 + c0 + e]);
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
  if (p.N <= 0 || p.N % 8 || p.K % tile::BK || p.lda % 8 || p.ldc % 8)
    return cudaErrorInvalidValue;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  switch (epi) {
    case EPI_BF16:
      gemm_kernel<EPI_BF16><<<grid, THREADS, 0, stream>>>(p);
      break;
    case EPI_RESID_F32:
      gemm_kernel<EPI_RESID_F32><<<grid, THREADS, 0, stream>>>(p);
      break;
    case EPI_GELU_GRAD:
      gemm_kernel<EPI_GELU_GRAD><<<grid, THREADS, 0, stream>>>(p);
      break;
    case EPI_DGELU:
      gemm_kernel<EPI_DGELU><<<grid, THREADS, 0, stream>>>(p);
      break;
    case EPI_F32:
      gemm_kernel<EPI_F32><<<grid, THREADS, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t gemm_wgrad(const WgradParams& p, cudaStream_t stream) {
  if (p.M % 128 || p.N % 128 || p.lda % 8 || p.ldb % 8 || p.R <= 0)
    return cudaErrorInvalidValue;
  // split the row reduction until about two blocks per SM are in flight,
  // keeping at least 16 k tiles per split
  const int KT = (p.R + WK - 1) / WK;
  const int tiles = (p.M / 128) * (p.N / 128);
  int splits = (264 + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, KT / 16));
  const int per = (KT + splits - 1) / splits;
  splits = (KT + per - 1) / per;
  wgrad_kernel<<<dim3(p.N / 128, p.M / 128, splits), THREADS, 0, stream>>>(p,
                                                                          per);
  return cudaGetLastError();
}

cudaError_t colsum_bf16(const bf16* X, long long ld, int R, int N, float* out,
                        cudaStream_t stream) {
  const dim3 grid((N + CS_THREADS - 1) / CS_THREADS,
                  (R + CS_ROWS - 1) / CS_ROWS);
  colsum_kernel<<<grid, CS_THREADS, 0, stream>>>(X, ld, R, N, out);
  return cudaGetLastError();
}
