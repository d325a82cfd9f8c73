// Tiled bf16 GEMM with fp32 accumulation: the matmul building block of
// K1 (qkv, proj), K2 (fc1, fc2) and K3 (reduction).
//
// Bound: at the swin shapes (M = 10^4..10^5 tokens, N and K 512..4096) the
// products are compute-bound on the tensor cores. This first version uses
// nvcuda::wmma 16x16x16 bf16 fragments (mma.sync), a 128x128x32 block tile
// in 8 warps (32x64 each) and a two-stage cp.async ring. It does not reach
// the wgmma/TMA rate of the card; that is later work. The row maps let a
// caller gather A rows and scatter C rows through the window partition and
// the cyclic shift, so no partitioned or rolled copy of an activation is
// ever written.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8, THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill the row past M
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int EPI>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmParams p) {
  __shared__ __align__(128) bf16 As[2][BM * LDS];
  __shared__ __align__(128) bf16 Ws[2][BN * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // each thread copies two 16-byte chunks of A and of Wt per k tile
  const bf16* a_src[2];
  const bf16* w_src[2];
  bool a_ok[2];
  int s_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS, r = c >> 2, col = (c & 3) * 8;
    const int m = m0 + r;
    a_ok[i] = m < p.M;
    a_src[i] = p.A + (a_ok[i] ? map_row(p.a_map, m) : 0) * p.lda + col;
    w_src[i] = p.Wt + (long long)(n0 + r) * p.K + col;
    s_off[i] = r * LDS + col;
  }
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(&As[stage][s_off[i]], a_src[i] + k0, a_ok[i]);
      cp_async16(&Ws[stage][s_off[i]], w_src[i] + k0, true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = p.K / BK;
  load(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[kt & 1];
    const bf16* ws = Ws[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], ws + (wn * 64 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time in (now idle)
  // shared memory; a lane owns 8 consecutive columns of one row
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
      if (m < p.M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = st[r * 16 + c0 + e] + (p.bias ? p.bias[n + e] : 0.0f);
        const long long orow = map_row(p.c_map, m);
        if (EPI == EPI_BF16) {
          __align__(16) bf16 o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(activate(v[e], p.act));
          *reinterpret_cast<uint4*>(p.C + orow * p.ldc + n) =
              *reinterpret_cast<const uint4*>(o);
        } else {
          float4* dst = reinterpret_cast<float4*>(p.Cf + orow * p.ldc + n);
          float4 s0 = dst[0], s1 = dst[1];
          s0.x += v[0]; s0.y += v[1]; s0.z += v[2]; s0.w += v[3];
          s1.x += v[4]; s1.y += v[5]; s1.z += v[6]; s1.w += v[7];
          dst[0] = s0;
          dst[1] = s1;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

cudaError_t gemm_bf16(const GemmParams& p, int epi, cudaStream_t stream) {
  if (p.N % BN || p.K % BK || p.lda % 8 || p.ldc % 8)
    return cudaErrorInvalidValue;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  if (epi == EPI_BF16)
    gemm_kernel<EPI_BF16><<<grid, THREADS, 0, stream>>>(p);
  else
    gemm_kernel<EPI_RESID_F32><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}
