// Shared device helpers for the STswin Hopper kernels (sm_90a).
//
// Holds the building blocks the kernels share: the 16-byte cp.async, warp
// reductions, the quad transpose of an mma accumulator layout, the GELU of
// the JAX package's kernels (the odd minimax erf polynomial, not erff:
// `stswincl_tpu/ops/pallas_mlp.py:45-101` defines the semantics), the
// window-partition row map, and the declarations of the fixed-order sums
// (`sum_parts`, `sum_parts_cols`, the column sums of gemm.cu).
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

// A 4 x 4 transpose of 32-bit words across the quad of lanes 4q .. 4q + 3:
// lane t holds row t (w[0..3]) and ends with column t (word t of lanes
// 0..3, in lane order). Round k swaps with lane t ^ k the word each needs.
// On an mma accumulator (lane t of a quad holding two columns of each
// 8-column block) it leaves each lane 8 consecutive columns of one row, to
// be stored whole.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
  uint32_t out[4] = {w[0], w[1], w[2], w[3]};
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const int i = t ^ k;  // the partner's lane and the word it wants
    const uint32_t send = i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = j == i ? got : out[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = out[j];
}

// ldmatrix (x4, and .trans) and mma.sync m16n8k16 bf16 -> fp32, the
// register-resident attention cores' (window_attention.cu,
// block_attention.cu) building blocks.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
//   EPI_RESID_F32  Cf += v in place (K2's residual s + MLP);
//   EPI_GELU_GRAD  C = bf16(gelu(v)), Cf = gelu'(v) (one erf evaluation);
//   EPI_DGELU      v *= aux[row, n] (fp32), C = bf16(v), and the fp32
//                  column sums of v are added into colsum;
//   EPI_F32        Cf = v;
//   EPI_GELU_BWD   two products of one K over the same rows (K6): pre = v,
//                  dh = A2 @ Wt2^T (no bias); with (g, g') = gelu_and_grad
//                  of pre, C2 = bf16(g) when C2 is not null, C = bf16(dh *
//                  g'), and the fp32 column sums of dh * g' are added into
//                  colsum (db1);
//   EPI_CONV       the implicit-GEMM 3x3 conv (row 17): A is the NHWC image
//                  read through `conv` (a tile is a bh x bw patch of one
//                  image, each k tile one tap's 64 channels), v = sum *
//                  conv.scale[n] + bias[n] (+ conv.res at the same pixel),
//                  ReLU when conv.relu, C = bf16(v) at the pixel's row;
// Cf, C2 and aux share C's row map and ldc. Requires N % 8 == 0 (columns
// past the last 128-wide tile's N are masked), lda % 8 == 0 and
// ldc % 8 == 0.
enum Epi {
  EPI_BF16 = 0,
  EPI_RESID_F32 = 1,
  EPI_GELU_GRAD = 2,
  EPI_DGELU = 3,
  EPI_F32 = 4,
  EPI_GELU_BWD = 5,
  EPI_CONV = 6
};

// EPI_CONV's geometry: the (n, H, W, Cin) image A with Cin = lda, the
// output tiled by bh x bw patches (bh * bw = 128 rows of a tile), ph x pw
// patches an image; K = 9 taps x cb k tiles of 64 channels, tap-major
// (tap = 3 ky + kx at offset ((ky - 1) d, (kx - 1) d)).
struct ConvGeom {
  int H, W, d, bh, bw, ph, pw, cb, relu;
  const float* scale;  // (N,) fp32
  const bf16* res;     // (pixels, N) bf16, C's layout, or null
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
  const bf16* A2;   // EPI_GELU_BWD: the second product's rows (lda, a_map
  const bf16* Wt2;  // identity) and its (N, K) weight
  bf16* C2;
  const float* aux;
  // EPI_DGELU, EPI_GELU_BWD: the column sums of dpre, one row of N a
  // 128-row tile ((M + 127) / 128 rows, written, not added); the caller
  // adds them in order (`sum_parts`)
  float* colsum;
  ConvGeom conv;  // EPI_CONV only
};

inline RowMap identity_map() { return RowMap{0, 1, 1, 1, 1, 0}; }

// out[i] = sum over s of part[s * stride + i], i < len, s ascending
// (fp32_train.cu): the second pass of every sum that spans blocks, so
// that no float atomic orders a sum and two calls give the same bits.
cudaError_t sum_parts(const float* part, int parts, long long stride,
                      long long len, float* out, cudaStream_t s);

// The same sum for many partial rows of few columns (gemm.cu): another
// fixed order, a block of warps a 32-column slice.
cudaError_t sum_parts_cols(const float* part, int parts, long long stride,
                           long long len, float* out, cudaStream_t s);

// out[n] = sum_r X[r, n] for a (R, N) bf16 matrix (K5's bias gradients),
// in a fixed order: part holds colsum_bf16_parts(R) * N floats.
int colsum_bf16_parts(int R);
cudaError_t colsum_bf16(const bf16* X, long long ld, int R, int N, float* out,
                        float* part, cudaStream_t stream);

// The library launches on whichever device the caller's tensors are on
// (`kernels.use_device` sets the runtime's current device), so each query
// and opt-in that is made once is made once a device: arrays indexed by
// `current_device()`, which is -1 if the device cannot be read or lies
// beyond MAX_DEVICES.
constexpr int MAX_DEVICES = 64;

inline int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  return dev;
}

// The SMs of the current device (0 if it cannot be read), asked once a
// device.
inline int sm_count() {
  static int sms[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return 0;
  if (!sms[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
        cudaSuccess)
      sms[dev] = n;
  }
  return sms[dev];
}

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
