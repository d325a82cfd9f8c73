// The Hopper GEMMs on wgmma + TMA: C = epilogue(A @ Wt^T + bias), the
// products of K1, K2, K5 and K6, and the weight-gradient GEMM of K5 and K6.
// gemm_sm90.cu says how they are built; the older `gemm_bf16` (gemm.cu,
// wmma on mma.sync) keeps K3's and rows 12-13's products.
#pragma once

#include "common.cuh"

// out[c_map(m), n] = epilogue(sum_k A[a_map(m), k] * Wt[n, k] + bias[n]),
// the contract of common.cuh for every epilogue (EPI_GELU_GRAD, EPI_DGELU
// and EPI_GELU_BWD: K6's). A rows are read by TMA under the identity map, by a 4-D
// TMA box a window where a tile holds whole windows, and by cp.async
// through any other row map (EPI_GELU_BWD: identity maps only). Requires
// N % 8 == 0, K % 8 == 0, lda % 8 == 0, ldc % 8 == 0, A, A2, Wt and Wt2
// 16-byte aligned; ragged M, N and K tiles are zero-filled on load and
// masked on store.
cudaError_t gemm_sm90(const GemmParams& p, int epi, cudaStream_t stream);

// Weight gradient: Cw[m, n] += sum_r A[a_map(r), m] * B[b_map(r), n] over
// r < R (a long reduction over the token rows), fp32 accumulation, fp32
// output added into Cw (row stride ldc; the caller zeroes it). A: (R, M)
// bf16 rows of stride lda; B: (R, N) bf16 rows of stride ldb. Requires
// M % 128 == 0, N % 128 == 0, lda % 8 == 0, ldb % 8 == 0, ldc % 4 == 0,
// A, B 16-byte aligned; R is ragged.
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
};

cudaError_t gemm_wgrad_sm90(const WgradParams& p, cudaStream_t stream);
