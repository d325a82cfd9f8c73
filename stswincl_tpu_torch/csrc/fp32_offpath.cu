// The fp32 forms of the rows on no model path: row 12 (the MLP), row 13
// (the residual add, LayerNorm and MLP) and row 17 (the dilated 3x3 conv
// with its folded BatchNorm, residual and ReLU), on the fp32 GEMM of
// fp32_forms.cu and its tile (fp32_gemm.cuh). Rows 14 and 15 in fp32 are
// the warp-a-row LayerNorm of add_layernorm.cu over fp32 elements.
//
// Replaces the fp32 instances of the dtype-generic TPU kernels, which load
// x.dtype, accumulate in fp32 and store x.dtype:
//   row 12 stswincl_tpu/ops/pallas_mlp.py fused_mlp (:226) -> _mlp_kernel;
//   row 13 stswincl_tpu/ops/pallas_add_ln_mlp.py fused_add_ln_mlp (:97)
//          -> _add_ln_mlp_kernel;
//   row 17 stswincl_tpu/ops/pallas_conv.py conv3x3_bn_act (:132) ->
//          _conv_kernel (:71).
// Their bf16 forms (epilogue.cu, conv.cu) run bf16 operands on the tensor
// cores; nothing of them is shared here.
//
// Bound on the H100: the products, fp32-accurate as 3xTF32 on the tensor
// cores (164.9 TFLOP/s; a single TF32 pass is not fp32, fp32 FMA on the
// CUDA cores peaks at 67): row 12 at (163840, 512) -> 2048, 687 GFLOP, at
// least 4.2 ms; row 17 at layer5 512 -> 512 on (4, 64, 80), 96.6 GFLOP,
// 0.59 ms.
//
// Design:
//   - rows 12 and 13: fc1 with its GELU epilogue (the erf polynomial or
//     tanh, `activate`) and fc2 with its bias, two launches of the fp32
//     GEMM; h stays fp32 in device memory (the TPU kernel stores it in
//     x.dtype, here fp32: nothing is rounded). Row 13 first runs K2's fp32
//     row pass (`ln_rows_add_f32`, shift 0): s = x + y written, LN(s) two
//     pass into the scratch fc1 reads.
//   - row 17: an implicit GEMM on the fp32 GEMM's persistent kernel
//     (`conv_f32`, fp32_forms.cu) and its tile (`f32t::ktile`,
//     fp32_gemm.cuh: 3xTF32 on wgmma). M = N*H*W output pixels in NHWC
//     order, N = Cout, K = 9 Cin tap-major (k = tap * Cin + c, tap = 3 ky
//     + kx): w packed once by the wrapper into (Cout, 9 Cin), no channel
//     padding, read by 2-D TMA. Cin is a multiple of 4, so a 16-byte chunk
//     of a k tile never crosses a tap: the producer warpgroup (a pixel
//     row a thread) maps each to pixel (h + d (ky - 1), w + d (kx - 1)) of
//     the same image by cp.async, and a pixel in the padding is the
//     cp.async zero fill (source size 0). A k tile whose taps lie in the
//     padding for every pixel of the 128-pixel tile (a dilated tap off the
//     image: at dilation 18 on a 32x40 map, a third of the k tiles) reads
//     only zeros and adds nothing: producers and consumers skip it alike,
//     decided once a tile from the tile's pixels (`conv_live`), so the
//     sums keep their bits (`ops.conv.live_k_tiles` lists them; the
//     consumers count the k tiles they sum, `ops.conv.k_tiles_summed`).
//     Epilogue in the twin's order: acc * scale, + shift, + residual,
//     ReLU, each rounded as PyTorch rounds it. Persistent blocks walk the
//     tiles: no limit on the row tiles of a call.

#include <atomic>

#include "fp32_gemm.cuh"

namespace {

std::atomic<long long> conv_f32_count{0};

}  // namespace

long long conv_f32_launches(int reset) {
  return reset ? conv_f32_count.exchange(0) : conv_f32_count.load();
}

// Row 12 fp32. x (rows, C), w1 (hidden, C), w2 (C, hidden), b1 (hidden),
// b2 (C), hid (rows, hidden) scratch, out (rows, C): fp32. C and hidden
// multiples of 4; act 1 the erf-polynomial GELU, 2 tanh.
extern "C" int stswin_mlp_f32(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* hid,
                              void* out, int rows, int C, int hidden, int act,
                              void* stream) {
  if (rows < 0 || C <= 0 || hidden <= 0 || C % 4 || hidden % 4 ||
      (act != ACT_GELU_ERF && act != ACT_GELU_TANH))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(hid);
  cudaError_t err = gemm_f32(
      plain_gemm(static_cast<const float*>(x), C,
                 static_cast<const float*>(w1), static_cast<const float*>(b1),
                 rows, hidden, C, h, hidden, act),
      s);
  if (err != cudaSuccess) return err;
  return gemm_f32(plain_gemm(h, hidden, static_cast<const float*>(w2),
                             static_cast<const float*>(b2), rows, C, hidden,
                             static_cast<float*>(out), C, ACT_NONE),
                  s);
}

// Row 13 fp32. x, y (rows, C); scale, bias (C,) of the LayerNorm; the MLP's
// w1, b1, w2, b2 as row 12's; n (rows, C) and hid (rows, hidden) scratch;
// s = x + y and m = MLP(LN(s)) out, (rows, C): fp32.
extern "C" int stswin_add_ln_mlp_f32(const void* x, const void* y,
                                     const void* scale, const void* bias,
                                     const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* n,
                                     void* hid, void* s_out, void* m_out,
                                     int rows, int C, int hidden, int act,
                                     float eps, void* stream) {
  if (rows < 0 || C <= 0 || hidden <= 0 || C % 4 || hidden % 4 ||
      (act != ACT_GELU_ERF && act != ACT_GELU_TANH))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = ln_rows_add_f32(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(s_out), static_cast<float*>(n), rows, C, 1, rows, 0,
      eps, s);
  if (err != cudaSuccess) return err;
  return stswin_mlp_f32(n, w1, b1, w2, b2, hid, m_out, rows, C, hidden, act,
                        stream);
}

// Row 17 fp32. x (N, H, W, Cin) NHWC, wt (Cout, 9 Cin) tap-major (tap = 3
// ky + kx, no channel padding), residual (N, H, W, Cout) or null, out (N,
// H, W, Cout): fp32; scale, shift (Cout,) fp32. Cin a multiple of 4,
// dilation >= 1; x and wt 16-byte aligned.
extern "C" int stswin_conv3x3_bn_act_f32(const void* x, const void* wt,
                                         const void* scale, const void* shift,
                                         const void* residual, void* out,
                                         int N, int H, int W, int Cin,
                                         int Cout, int dilation, int relu,
                                         void* stream) {
  const F32Conv c{static_cast<const float*>(x),
                  static_cast<const float*>(wt),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(shift),
                  static_cast<const float*>(residual),
                  static_cast<float*>(out),
                  N, H, W, Cin, Cout, dilation, relu};
  const cudaError_t err = conv_f32(c, static_cast<cudaStream_t>(stream));
  if (err != cudaErrorInvalidValue) conv_f32_count.fetch_add(1);
  return err;
}
