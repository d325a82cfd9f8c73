// The Hopper GEMM: C = epilogue(A @ Wt^T + bias) on wgmma + TMA, the
// products of K1 (qkv, proj) and K2 (fc1, fc2). gemm_sm90.cu says how it is
// built; the older `gemm_bf16` (gemm.cu, wmma on mma.sync) keeps the other
// kernels' products.
#pragma once

#include "common.cuh"

// out[c_map(m), n] = epilogue(sum_k A[a_map(m), k] * Wt[n, k] + bias[n]),
// the contract of `gemm_bf16` (common.cuh) for the epilogues EPI_BF16 (C =
// bf16(act(v))), EPI_RESID_F32 (Cf += v) and EPI_F32 (Cf = v). A rows are
// read by TMA under the identity map and by cp.async through any other
// (the window partition and the cyclic shift). Requires N % 8 == 0, K % 8 ==
// 0, lda % 8 == 0, ldc % 8 == 0, A and Wt 16-byte aligned; ragged M, N and
// K tiles are zero-filled on load and masked on store.
cudaError_t gemm_sm90(const GemmParams& p, int epi, cudaStream_t stream);
