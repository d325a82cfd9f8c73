// K2: the swin block's post-attention tail in the reference norm order,
// out = LN1(s + fc2(GELU(fc1(LN2(s))))), s = x + unshift(y) kept in fp32.
//
// Replaces: stswincl_tpu/ops/pallas_add_ln_mlp.py
//   fused_swin_block_epilogue (:895) -> _epilogue_kernel (:704), and
//   fused_swin_block_epilogue_shifted (:1012) -> _epi_shifted_kernel (:940)
//   (the `shift` argument: y arrives in the SW-MSA shifted layout).
//
// Bound on the H100: fc1 and fc2 are 2 * rows * C * 4C flops each,
// tensor-core bound; the two LayerNorms and the residual are bound by
// device memory. The TPU kernel kept the hidden (rows x 4C) activation in
// VMEM; this first version writes it to device memory in bf16 (the
// kernel's own rounding point before fc2), which costs 2 * rows * 4C * 2
// bytes of traffic per block. Keeping it on chip is later work.
//
// Design: four launches on one stream.
//   1. one warp per row: s = x + y read through the inverse cyclic shift
//      (no rolled tensor formed), s kept in fp32, LN2(s) rounded to bf16;
//   2. fc1 GEMM + bias + GELU (the erf polynomial) -> bf16 hidden;
//   3. fc2 GEMM + bias, added in fp32 into s (the kernel's rounding: the
//      fp32 MLP sum, not a bf16-rounded m, `pallas_add_ln_mlp.py:743`);
//   4. one warp per row: LN1 -> bf16 output, unshifted.

#include "common.cuh"

namespace {

constexpr int LN_WARPS = 8;

// ADD: s = x[r] + y[unshift(r)] is written to s32 first; else s32 is read.
template <bool ADD>
__global__ void __launch_bounds__(LN_WARPS * 32)
    ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                   const float* __restrict__ g, const float* __restrict__ b,
                   float* __restrict__ s32, bf16* __restrict__ out, int R,
                   int C, int H, int W, int shift, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * LN_WARPS + warp;
  if (r >= R) return;
  float* srow = s32 + (long long)r * C;
  float sum = 0.0f;
  if (ADD) {
    const int w = r % W, h = (r / W) % H, bt = r / (W * H);
    const int hs = h - shift < 0 ? h - shift + H : h - shift;
    const int wsrc = w - shift < 0 ? w - shift + W : w - shift;
    const bf16* xr = x + (long long)r * C;
    const bf16* yr = y + ((long long)(bt * H + hs) * W + wsrc) * C;
    for (int c = lane * 2; c < C; c += 64) {
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
      const float2 yv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(yr + c));
      const float2 s = make_float2(xv.x + yv.x, xv.y + yv.y);
      *reinterpret_cast<float2*>(srow + c) = s;
      sum += s.x + s.y;
    }
  } else {
    for (int c = lane * 2; c < C; c += 64) {
      const float2 s = *reinterpret_cast<const float2*>(srow + c);
      sum += s.x + s.y;
    }
  }
  const float mu = warp_sum(sum) / C;
  float sq = 0.0f;
  for (int c = lane * 2; c < C; c += 64) {
    const float2 s = *reinterpret_cast<const float2*>(srow + c);
    const float d0 = s.x - mu, d1 = s.y - mu;
    sq += d0 * d0 + d1 * d1;
  }
  const float rs = rsqrtf(warp_sum(sq) / C + eps);
  bf16* orow = out + (long long)r * C;
  for (int c = lane * 2; c < C; c += 64) {
    const float2 s = *reinterpret_cast<const float2*>(srow + c);
    *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
        (s.x - mu) * rs * g[c] + b[c], (s.y - mu) * rs * g[c + 1] + b[c + 1]);
  }
}

}  // namespace

// x, y, out: (BT, H, W, C) bf16 (y in the shifted layout when shift > 0);
// s2/b2, s1/b1n, b1, bw2: fp32; w1: (hidden, C), w2: (C, hidden) bf16;
// scratch: s32 (rows, C) fp32, n2 (rows, C) bf16, hid (rows, hidden) bf16.
extern "C" int stswin_block_epilogue(
    const void* x, const void* y, const void* s2, const void* b2,
    const void* w1, const void* b1, const void* w2, const void* bw2,
    const void* s1, const void* b1n, void* s32, void* n2, void* hid,
    void* out, int BT, int H, int W, int C, int hidden, int shift, int act,
    float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = BT * H * W;
  const int blocks = (R + LN_WARPS - 1) / LN_WARPS;
  ln_rows_kernel<true><<<blocks, LN_WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<float*>(s32), static_cast<bf16*>(n2), R, C, H, W, shift,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmParams g{};
  g.A = static_cast<const bf16*>(n2);
  g.lda = C;
  g.a_map = identity_map();
  g.Wt = static_cast<const bf16*>(w1);
  g.bias = static_cast<const float*>(b1);
  g.M = R;
  g.N = hidden;
  g.K = C;
  g.C = static_cast<bf16*>(hid);
  g.ldc = hidden;
  g.c_map = identity_map();
  g.act = act;
  err = gemm_bf16(g, EPI_BF16, s);
  if (err != cudaSuccess) return err;

  g.A = static_cast<const bf16*>(hid);
  g.lda = hidden;
  g.Wt = static_cast<const bf16*>(w2);
  g.bias = static_cast<const float*>(bw2);
  g.N = C;
  g.K = hidden;
  g.C = nullptr;
  g.Cf = static_cast<float*>(s32);
  g.ldc = C;
  g.act = ACT_NONE;
  err = gemm_bf16(g, EPI_RESID_F32, s);
  if (err != cudaSuccess) return err;

  ln_rows_kernel<false><<<blocks, LN_WARPS * 32, 0, s>>>(
      nullptr, nullptr, static_cast<const float*>(s1),
      static_cast<const float*>(b1n), static_cast<float*>(s32),
      static_cast<bf16*>(out), R, C, H, W, 0, eps);
  return cudaGetLastError();
}
