// Shared device helpers for the STswin Hopper kernels (sm_90a).
//
// Holds the building blocks the kernels share: the 16-byte cp.async, warp
// reductions, the GELU of the JAX package's kernels (the odd minimax erf polynomial, not
// erff: `stswincl_tpu/ops/pallas_mlp.py:45-101` defines the semantics),
// the window-partition row map, and the declaration of the tiled bf16 GEMM
// in gemm.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

// The shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte cp.async from device to shared memory; with !valid it writes
// zeros and reads nothing (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// erf(x) ~ x * P(x^2) on |x| < 3, saturated to sign(x) beyond; the same
// coefficients and Horner order as `_erf_poly_fast`.
__device__ __forceinline__ float erf_poly_fast(float x) {
  const float xc = fminf(fmaxf(x, -3.0f), 3.0f);
  const float t = xc * xc;
  float p = 4.0745480824e-08f;
  p = p * t + -1.9449437556e-06f;
  p = p * t + 4.1062300646e-05f;
  p = p * t + -5.1105060172e-04f;
  p = p * t + 4.2354873714e-03f;
  p = p * t + -2.5103008059e-02f;
  p = p * t + 1.1107952331e-01f;
  p = p * t + -3.7531498256e-01f;
  p = p * t + 1.1282684439e+00f;
  return fabsf(x) < 3.0f ? xc * p : copysignf(1.0f, x);
}

enum Act { ACT_NONE = 0, ACT_GELU_ERF = 1, ACT_GELU_TANH = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_GELU_ERF)
    return 0.5f * v * (1.0f + erf_poly_fast(v * 0.70710678118654752f));
  if (act == ACT_GELU_TANH)
    return 0.5f * v *
           (1.0f + tanhf(0.79788456080286536f * (v + 0.044715f * v * v * v)));
  return v;
}

// (gelu(x), d gelu / dx) from ONE evaluation of the erf polynomial: the
// derivative OF THE POLYNOMIAL, `_gelu_and_grad`
// (`stswincl_tpu/ops/pallas_mlp.py:104`, `_erf_poly_fast_grad` `:64`),
// so the backward kernels match autograd of the plain twins.
__device__ __forceinline__ float2 gelu_and_grad(float x, int act) {
  if (act == ACT_GELU_TANH) {
    const float c = 0.79788456080286536f;
    const float th = tanhf(c * (x + 0.044715f * x * x * x));
    return make_float2(0.5f * x * (1.0f + th),
                       0.5f * (1.0f + th) + 0.5f * x * (1.0f - th * th) * c *
                                                (1.0f + 3.0f * 0.044715f * x * x));
  }
  const float s = x * 0.70710678118654752f;
  const float sc = fminf(fmaxf(s, -3.0f), 3.0f);
  const float t = sc * sc;
  const float C[9] = {1.1282684439e+00f, -3.7531498256e-01f, 1.1107952331e-01f,
                      -2.5103008059e-02f, 4.2354873714e-03f, -5.1105060172e-04f,
                      4.1062300646e-05f, -1.9449437556e-06f, 4.0745480824e-08f};
  float p = C[8], dp = 0.0f;
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    dp = dp * t + p;
    p = p * t + C[i];
  }
  const bool inside = fabsf(s) < 3.0f;
  const float erf = inside ? sc * p : copysignf(1.0f, s);
  const float derf = inside ? p + 2.0f * t * dp : 0.0f;
  return make_float2(0.5f * x * (1.0f + erf),
                     0.5f * (1.0f + erf) + x * derf * (0.5f * 0.70710678118654752f));
}

// Row r of a window-ordered token matrix -> row of the (B, T, H, W) image.
// Window order is (b, window, t, i, j): windows row-major over the image,
// then the T frames, then the ws x ws tokens, as the JAX partition
// (`pallas_block_attention.py:101-103`). `shift` reads the image through
// the SW-MSA cyclic shift torch.roll(x, (-shift, -shift)), so no rolled
// tensor is ever formed. mode 0 is the identity.
struct RowMap {
  int mode, T, H, W, ws, shift;
};

__device__ __forceinline__ long long map_row(const RowMap& m, int r) {
  if (m.mode == 0) return r;
  const int N = m.ws * m.ws, TN = m.T * N;
  const int nWw = m.W / m.ws, nWin = (m.H / m.ws) * nWw;
  const int bw = r / TN, p = r - bw * TN;
  const int t = p / N, q = p - t * N;
  const int i = q / m.ws, j = q - i * m.ws;
  const int b = bw / nWin, win = bw - b * nWin;
  const int wh = win / nWw, ww = win - wh * nWw;
  int h = wh * m.ws + i + m.shift;
  if (h >= m.H) h -= m.H;
  int w = ww * m.ws + j + m.shift;
  if (w >= m.W) w -= m.W;
  return ((long long)(b * m.T + t) * m.H + h) * m.W + w;
}

// out[c_map(m), n] = epilogue(sum_k A[a_map(m), k] * Wt[n, k] + bias[n])
// A: rows of K bf16 (row stride lda); Wt: (N, K) bf16, the torch Linear
// layout; bias: fp32 or null. Epilogues, v = the fp32 sum + bias:
//   EPI_BF16       C = bf16(act(v));
//   EPI_RESID_F32  Cf += v in place (the epilogue's residual s + MLP);
//   EPI_GELU_GRAD  C = bf16(gelu(v)), Cf = gelu'(v) (one erf evaluation);
//   EPI_DGELU      v *= aux[row, n] (fp32), C = bf16(v), and the fp32
//                  column sums of v are added into colsum (db1 of K6);
//   EPI_F32        Cf = v.
// Aux and Cf share C's row map and ldc. Requires N % 8 == 0 (columns
// past the last 128-wide tile's N are masked), K % 32 == 0, lda % 8 == 0,
// ldc % 8 == 0.
enum Epi {
  EPI_BF16 = 0,
  EPI_RESID_F32 = 1,
  EPI_GELU_GRAD = 2,
  EPI_DGELU = 3,
  EPI_F32 = 4
};

struct GemmParams {
  const bf16* A;
  long long lda;
  RowMap a_map;
  const bf16* Wt;
  const float* bias;
  int M, N, K;
  bf16* C;
  float* Cf;
  long long ldc;
  RowMap c_map;
  int act;
  const float* aux;
  float* colsum;
};

cudaError_t gemm_bf16(const GemmParams& p, int epi, cudaStream_t stream);

inline RowMap identity_map() { return RowMap{0, 1, 1, 1, 1, 0}; }

// Weight-gradient GEMM: Cw[m, n] += sum_r A[a_map(r), m] * B[b_map(r), n]
// over r < R (a long reduction over the token rows), fp32 accumulation,
// fp32 output added into Cw (the caller zeroes it). A: (R, M) bf16 rows of
// stride lda; B: (R, N) bf16 rows of stride ldb. Requires M % 128 == 0,
// N % 128 == 0, lda % 8 == 0, ldb % 8 == 0.
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

cudaError_t gemm_wgrad(const WgradParams& p, cudaStream_t stream);

// out[n] += sum_r X[r, n] for a (R, N) bf16 matrix (bias gradients).
cudaError_t colsum_bf16(const bf16* X, long long ld, int R, int N, float* out,
                        cudaStream_t stream);

// Threads of one attention block (one (window, head)), forward and backward.
constexpr int ATT_THREADS = 256, ATT_WARPS = ATT_THREADS / 32;

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

// The window-attention core of K1 and of the row-10 kernel
// (window_attention.cu): softmax(q k^T * scale + bias (+ mask)) v for every
// (window, head), q, k, v and out read and written through row map `map`
// over token rows of 3C (qkv) and C (out) channels: window order under the
// identity map (K1's qkv buffer), the image layout under the window
// partition map (row 10). bias (heads, TN, TN) fp32; mask (n_mask, TN, TN)
// fp32 indexed by window % n_mask, or null.
cudaError_t window_attention_rows(const bf16* qkv, bf16* out, RowMap map,
                                  int n_windows, int heads, int TN, int hd,
                                  int C, const float* bias, const float* mask,
                                  int n_mask, float scale,
                                  cudaStream_t stream);
