// K3: PatchMerging, 2x2 space-to-depth -> fp32 LayerNorm over 4C ->
// bias-free Linear 4C -> 2C, per frame.
//
// Replaces: stswincl_tpu/ops/pallas_patch_merge.py
//   fused_patch_merge (:122) -> _kernel (:41).
//
// Bound on the H100: the reduction is a 2 * rows * 4C * 2C flop GEMM
// (tensor-core bound); the gather + LayerNorm reads the input once and is
// bound by device memory. The concatenated (rows, 4C) tensor is never
// formed in fp32: the LayerNorm reads the four 2x2 neighbours straight
// from the (BT, H, W, C) input in the reference chunk order [x0|x1|x2|x3]
// (x0 = (2i, 2j), x1 = (2i+1, 2j), x2 = (2i, 2j+1), x3 = (2i+1, 2j+1)),
// with the single-pass variance of `patch_merge_ref` (:72-90), and writes
// the normalised features once in bf16 (their rounding point before the
// matmul). The TPU kernel's [x0|x2|x1|x3] lane permutation (`_chunk_perm`)
// exists only for the TPU's tiling and is not carried over.

#include "common.cuh"

namespace {

constexpr int PM_WARPS = 8;

__global__ void __launch_bounds__(PM_WARPS * 32)
    patch_merge_ln_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ g,
                          const float* __restrict__ b, bf16* __restrict__ n,
                          int BT, int H, int W, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H2 = H / 2, W2 = W / 2, R = BT * H2 * W2;
  const int ro = blockIdx.x * PM_WARPS + warp;
  if (ro >= R) return;
  const int j = ro % W2, i = (ro / W2) % H2, bt = ro / (W2 * H2);
  const bf16* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int di = q & 1, dj = q >> 1;  // x0, x1, x2, x3
    src[q] = x + ((long long)(bt * H + 2 * i + di) * W + 2 * j + dj) * C;
  }
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int c = lane * 2; c < C; c += 64) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src[q] + c));
      sum += v.x + v.y;
      sq += v.x * v.x + v.y * v.y;
    }
  }
  const float inv_n = 1.0f / (4 * C);
  const float mu = warp_sum(sum) * inv_n;
  const float var = warp_sum(sq) * inv_n - mu * mu;
  const float rs = rsqrtf(var + eps);
  bf16* out = n + (long long)ro * 4 * C;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int c = lane * 2; c < C; c += 64) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src[q] + c));
      const int k = q * C + c;
      *reinterpret_cast<__nv_bfloat162*>(out + k) = __floats2bfloat162_rn(
          (v.x - mu) * rs * g[k] + b[k], (v.y - mu) * rs * g[k + 1] + b[k + 1]);
    }
  }
}

}  // namespace

// x: (BT, H, W, C) bf16; scale/bias: (4C) fp32; w: (2C, 4C) bf16;
// n_buf: (rows, 4C) bf16 scratch; out: (BT, H/2, W/2, 2C) bf16.
extern "C" int stswin_patch_merge(const void* x, const void* scale,
                                  const void* bias, const void* w,
                                  void* n_buf, void* out, int BT, int H, int W,
                                  int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = BT * (H / 2) * (W / 2);
  patch_merge_ln_kernel<<<(R + PM_WARPS - 1) / PM_WARPS, PM_WARPS * 32, 0,
                          s>>>(static_cast<const bf16*>(x),
                               static_cast<const float*>(scale),
                               static_cast<const float*>(bias),
                               static_cast<bf16*>(n_buf), BT, H, W, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmParams g{};
  g.A = static_cast<const bf16*>(n_buf);
  g.lda = 4 * C;
  g.a_map = identity_map();
  g.Wt = static_cast<const bf16*>(w);
  g.bias = nullptr;
  g.M = R;
  g.N = 2 * C;
  g.K = 4 * C;
  g.C = static_cast<bf16*>(out);
  g.ldc = 2 * C;
  g.c_map = identity_map();
  g.act = ACT_NONE;
  return gemm_bf16(g, EPI_BF16, s);
}
