// Row 17: y = [ReLU](conv3x3(x, w; dilation d, stride 1, pad d) * scale
// + shift [+ residual]), NHWC bf16 in and out, fp32 accumulation and
// epilogue (inference-folded BatchNorm as scale / shift).
//
// Replaces: stswincl_tpu/ops/pallas_conv.py conv3x3_bn_act (:132) ->
//   _conv_kernel (:71).
//
// Bound on the H100: the tensor cores. 2 * N*H*W * Cout * 9*Cin flops
// against (N*H*W * (Cin + Cout [+ Cout]) + 9*Cin*Cout) * 2 bytes: about
// 1,000 flops a byte at Cin = Cout = 512, far above the card's 295.
//
// Design: an implicit GEMM on the Hopper GEMM of gemm_sm90.cu, its
// EPI_CONV form (wgmma on a 128-byte-swizzled TMA ring, one producer warp,
// persistent blocks, the quad-transposed epilogue), with no padded or
// im2col copy of x and no per-thread gather. M = output pixels, tiled as
// patches of one image, bh x bw = 128 pixels (the wrapper picks them to
// fit W: 8 x 16 on 64x80, 16 x 8 on 32x40, 4 x 32 on 128x160); N = Cout;
// K = 9 taps x ceil(Cin / 64) k tiles of 64 channels, tap-major (tap = 3
// ky + kx). A k tile of A is ONE 4-D TMA box (64 channels, bw, bh, 1) of
// x seen as (Cin, W, H, N), at (c0, w0 + (kx - 1) d, h0 + (ky - 1) d, n):
// TMA zero-fills every element outside the tensor, at negative
// coordinates too, which is the conv's zero padding at any dilation, and
// the channels past Cin when Cin is not a multiple of 64. The box lands in
// (h, w) order, so tile row r is pixel (h0 + r / bw, w0 + r % bw). The
// wrapper packs w once into (Cout, 9 * Cin64), each tap zero-padded to
// Cin64 channels, read by 2-D TMA as any weight. A tap whose box lies
// wholly in the padding (most taps of the ASPP's dilation 12 / 18 on
// 32x40) is skipped by producer and consumers alike. The epilogue works
// from the accumulator registers: * scale + shift per column, the quad
// transpose in fp32, + the bf16 residual read at the same pixel, ReLU, one
// 16-byte bf16 store a lane; rows past H or W are masked. The TPU kernel
// pre-padded x and pre-sliced its three column taps in XLA (Mosaic could
// not slice the sublane axis at kx * d) and double-buffered halo row bands
// into VMEM; none of that is needed here.

#include <climits>

#include "gemm_sm90.cuh"

// x (N, H, W, Cin), wt (Cout, 9 * Cin64) tap-major with Cin64 = 64 *
// ceil(Cin / 64) (each tap zero-padded), residual (N, H, W, Cout) or null,
// out (N, H, W, Cout): bf16; scale, shift (Cout,) fp32. Cin a multiple of
// 32, Cout of 8, dilation >= 1; the output patch bh x bw = 128 pixels.
extern "C" int stswin_conv3x3_bn_act(const void* x, const void* wt,
                                     const void* scale, const void* shift,
                                     const void* residual, void* out, int N,
                                     int H, int W, int Cin, int Cout,
                                     int dilation, int relu, int bh, int bw,
                                     void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 32 || Cout <= 0 ||
      Cout % 8 || dilation < 1 || bh <= 0 || bw <= 0 || bh * bw != 128)
    return cudaErrorInvalidValue;
  const int ph = (H + bh - 1) / bh, pw = (W + bw - 1) / bw;
  const long long rows = (long long)N * ph * pw * 128;  // patches x 128
  if (rows > INT_MAX) return cudaErrorInvalidValue;
  const int cb = (Cin + 63) / 64;
  GemmParams g{};
  g.A = static_cast<const bf16*>(x);
  g.lda = Cin;
  g.a_map = identity_map();
  g.Wt = static_cast<const bf16*>(wt);
  g.bias = static_cast<const float*>(shift);
  g.M = static_cast<int>(rows);
  g.N = Cout;
  g.K = 9 * cb * 64;
  g.C = static_cast<bf16*>(out);
  g.ldc = Cout;
  g.c_map = identity_map();
  g.act = ACT_NONE;
  g.conv = ConvGeom{H,  W,  dilation, bh, bw, ph, pw, cb, relu,
                    static_cast<const float*>(scale),
                    static_cast<const bf16*>(residual)};
  return gemm_sm90(g, EPI_CONV, static_cast<cudaStream_t>(stream));
}
