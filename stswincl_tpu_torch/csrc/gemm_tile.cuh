// The 128 x 128 block tile of the bf16 GEMM: the main loop shared by
// `gemm_kernel` (gemm.cu, the launched GEMM of K3 and rows 12-13)
// and by the whole-block kernel (swin_block.cu), which runs it in every
// phase of its one launch.
//
// acc = A[a_map(m0 .. m0 + 127), 0 .. K) @ Wt[n0 .. n0 + 127, 0 .. K)^T:
// nvcuda::wmma 16x16x16 bf16 fragments (mma.sync) with fp32 accumulation,
// 8 warps of 32 x 64 (warp w holds rows (w >> 1) * 32, columns
// (w & 1) * 64), k tiles of 32 in a two-stage cp.async ring. A rows at or
// past M and Wt rows at or past N read as zeros. Wt is the torch Linear
// layout (N, K), row stride K. Requires K % 32 == 0, lda % 8 == 0 and 256
// threads. The implicit-GEMM conv (conv.cu) runs the same main loop
// (`mainloop`) with its own gathered A loads.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace tile {

constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8, THREADS = 256;

typedef nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
    Acc;

// The two stages of A and Wt k tiles. After `mainloop` returns, every thread
// has passed a barrier behind its last read, so the caller may reuse it
// (as per-warp epilogue staging: `staging`).
struct Smem {
  bf16 A[2][BM * LDS];
  bf16 W[2][BN * LDS];
};

// 256 fp32 of staging for warp `warp`: one 16 x 16 fragment at a time.
__device__ __forceinline__ float* staging(Smem& sm, int warp) {
  return reinterpret_cast<float*>(&sm.A[0][0]) + warp * 256;
}

using ::cp_async16;  // common.cuh

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc += one k tile of A (as) times Wt (ws), both BM (BN) rows x BK in
// shared memory with row stride LDS.
__device__ __forceinline__ void mma_tile(const bf16* as, const bf16* ws,
                                         Acc (&acc)[2][4]) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 64
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
}

// Thread `tid` copies chunk i (of 2) of each k tile: row `r`, columns
// `col` .. col + 7 of the BM x BK (and BN x BK) tile.
__device__ __forceinline__ void chunk(int tid, int i, int& r, int& col) {
  const int c = tid + i * THREADS;
  r = c >> 2;
  col = (c & 3) * 8;
}

// The two-stage main loop over KT k tiles: `load(stage, kt)` issues the
// cp.async copies of k tile kt into sm.A[stage] and sm.W[stage] and
// commits them. Callers with their own A addressing (the implicit-GEMM
// conv of conv.cu) pass their own `load`.
template <class Load>
__device__ __forceinline__ void mainloop(int KT, Load&& load, Smem& sm,
                                         Acc (&acc)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  load(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load((kt + 1) & 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_tile(sm.A[kt & 1], sm.W[kt & 1], acc);
    __syncthreads();
  }
}

// Wt rows at or past N read as zeros (N defaults to no bound).
__device__ __forceinline__ void mma(const bf16* A, long long lda,
                                    const RowMap& a_map, int m0, int M,
                                    const bf16* Wt, int n0, int K, Smem& sm,
                                    Acc (&acc)[2][4], int N = 0x7fffffff) {
  const int tid = threadIdx.x;
  // each thread copies two 16-byte chunks of A and of Wt per k tile
  const bf16* a_src[2];
  const bf16* w_src[2];
  bool a_ok[2], w_ok[2];
  int s_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int r, col;
    chunk(tid, i, r, col);
    const int m = m0 + r;
    a_ok[i] = m < M;
    w_ok[i] = n0 + r < N;
    a_src[i] = A + (a_ok[i] ? map_row(a_map, m) : 0) * lda + col;
    w_src[i] = Wt + (long long)(w_ok[i] ? n0 + r : 0) * K + col;
    s_off[i] = r * LDS + col;
  }
  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(&sm.A[stage][s_off[i]], a_src[i] + k0, a_ok[i]);
      cp_async16(&sm.W[stage][s_off[i]], w_src[i] + k0, w_ok[i]);
    }
    cp_async_commit();
  };
  mainloop(K / BK, load, sm, acc);
}

}  // namespace tile
