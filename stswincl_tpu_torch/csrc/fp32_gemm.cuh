// The fp32 GEMM and the LN2 row pass of fp32_forms.cu, shared with the fp32
// backward forms of fp32_train.cu.
#pragma once
#include "common.cuh"

// C[c_map(m), n] = epilogue(sum_k A[a_map(m), k] Wt[n, k] + bias[n]), every
// sum in fp32 FMA with k in order. Epilogues, v = the sum + bias:
//   F32_ACT        C = act(v);
//   F32_RESID      C += v (K2's residual s + MLP);
//   F32_GELU_GRAD  C = gelu(v), C2 = gelu'(v), one erf evaluation (act
//                  names the GELU; K6's fc1);
//   F32_DGELU      C = v * aux (K6's dpre = dh * gelu'); aux may be C.
// C2 and aux share C's row map and ldc.
enum F32Epi { F32_ACT = 0, F32_RESID = 1, F32_GELU_GRAD = 2, F32_DGELU = 3 };

struct F32Gemm {
  const float* A;
  long long lda;
  RowMap a_map;
  const float* Wt;    // (N, K), rows of K
  const float* bias;  // (N,) or null
  int M, N, K;
  float* C;
  long long ldc;
  RowMap c_map;
  int act;
  int epi;
  float* C2;
  const float* aux;
};

// Requires K % 4 == 0 and lda % 4 == 0; M and N ragged.
cudaError_t gemm_f32(const F32Gemm& p, cudaStream_t s);

F32Gemm plain_gemm(const float* A, int lda, const float* Wt,
                   const float* bias, int M, int N, int K, float* C, int ldc,
                   int act);

// K2's first row pass: s32 = x[r] + y[unshift(r)], out = LN2(s32), fp32,
// one warp a row; C % 4 == 0.
cudaError_t ln_rows_add_f32(const float* x, const float* y, const float* g,
                            const float* b, float* s32, float* out, int R,
                            int C, int H, int W, int shift, float eps,
                            cudaStream_t s);

// The fp32 weight-gradient GEMM's launches since the last reset
// (fp32_train.cu); `reset` sets the count to 0 after reading it.
long long wgrad_f32_launches(int reset);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
