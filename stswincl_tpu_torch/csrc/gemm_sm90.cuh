// The Hopper GEMMs on wgmma + TMA: C = epilogue(A @ Wt^T + bias), the
// products of K1, K2, K3 (the patch merge's reduction), K5, K6 and rows
// 12-13 (the MLP) and the implicit-GEMM conv of row 17 (EPI_CONV), and the
// weight-gradient GEMM of K5 and K6. gemm_sm90.cu says how they are built.
#pragma once

#include "common.cuh"

// out[c_map(m), n] = epilogue(sum_k A[a_map(m), k] * Wt[n, k] + bias[n]),
// the contract of common.cuh for every epilogue (EPI_GELU_GRAD, EPI_DGELU
// and EPI_GELU_BWD: K6's). A rows are read by TMA under the identity map, by a 4-D
// TMA box a window where a tile holds whole windows, and by cp.async
// through any other row map (EPI_GELU_BWD: identity maps only); EPI_CONV's
// A by one 4-D TMA box a live tap (`ConvGeom`). Requires
// N % 8 == 0, K % 8 == 0, lda % 8 == 0, ldc % 8 == 0, A, A2, Wt and Wt2
// 16-byte aligned; ragged M, N and K tiles are zero-filled on load and
// masked on store.
cudaError_t gemm_sm90(const GemmParams& p, int epi, cudaStream_t stream);

// Weight gradient: Cw[m, n] = sum_r A[a_map(r), m] * B[b_map(r), n] over
// r < R (a long reduction over the token rows), fp32 accumulation, fp32
// output written to Cw (row stride ldc == N), the row splits added in a
// fixed order through `work` (`wgrad_sm90_work(R, M, N)` floats, 16-byte
// aligned; unused, and may be null, when that is 0). A: (R, M) bf16 rows
// of stride lda; B: (R, N) bf16 rows of stride ldb. Requires M % 8 == 0,
// N % 8 == 0, lda % 8 == 0, ldb % 8 == 0, A, B 16-byte aligned; R, and the
// last 128 x 128 output tile of M and N, are ragged (TMA zero-fills the
// columns past M and N, cp.async does so by chunk, the stores are
// masked).
struct WgradParams {
  const bf16* A;
  long long lda;
  RowMap a_map;
  const bf16* B;
  long long ldb;
  RowMap b_map;
  int R, M, N;
  float* Cw;
  long long ldc;
  float* work;
};

cudaError_t gemm_wgrad_sm90(const WgradParams& p, cudaStream_t stream);
size_t wgrad_sm90_work(int R, int M, int N);
