// K3: PatchMerging, 2x2 space-to-depth -> fp32 LayerNorm over 4C ->
// bias-free Linear 4C -> 2C, per frame.
//
// Replaces: stswincl_tpu/ops/pallas_patch_merge.py
//   fused_patch_merge (:122) -> _kernel (:41).
//
// Bound on the H100: the reduction is a 2 * rows * 4C * 2C flop GEMM
// (tensor-core bound: 43 GFLOP at the serving shape, 0.043 ms at 989
// TFLOP/s); the gather + LayerNorm pass reads the input once and writes
// the normalised rows once (42 + 42 MB there) and is bound by device
// memory. Design:
//   - the product on the Hopper GEMM (`gemm_sm90`, EPI_BF16, identity row
//     maps: M = rows, N = 2C, K = 4C), counted by the library as one bf16
//     form launch a call. Its fp32 sums run over k in the order of the
//     port's first (wmma) GEMM that took this product before, so on the
//     same n it gives the same bits. The LayerNorm is not folded into the
//     GEMM's epilogue (mean and rstd applied after x @ (g * W)^T): that
//     would skip n's bf16 rounding and cancel badly where the mean is
//     large against the spread;
//   - the LayerNorm pass: a warp an output row reads the four 2x2
//     neighbours straight from the (BT, H, W, C) input in the reference
//     chunk order [x0|x1|x2|x3] (x0 = (2i, 2j), x1 = (2i+1, 2j), x2 = (2i,
//     2j+1), x3 = (2i+1, 2j+1)), with the single-pass variance of
//     `patch_merge_ref` (:72-90), and writes the normalised features once
//     in bf16, their rounding point before the matmul. A lane owns the
//     channel pairs 2 * lane + 64 m of each neighbour and sums them in the
//     order of the kernel's first form, so that n, and with it K3's
//     output, keeps that form's bits: the training checks of
//     `chip_smoke.py` compare gradients through the ASPP's image-pool
//     BatchNorm (8 values a channel), where any re-rounding of n moves the
//     outcome (PERF.md §6). What is new is the memory side: up to C = 512
//     every load of the row (4 bytes a lane, 128 contiguous bytes a warp)
//     is issued before the reduction and the row stays in registers for
//     the output, with gamma and beta as float2; wider rows are read twice
//     (the second time from L1 / L2).

#include "gemm_sm90.cuh"

namespace {

constexpr int PM_WARPS = 8;

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// n[k], n[k + 1] = bf16((v - mu) * rs * g + b)
__device__ __forceinline__ void norm_store2(bf16* out, float2 v,
                                            const float* g, const float* b,
                                            int k, float mu, float rs) {
  const float2 gg = __ldg(reinterpret_cast<const float2*>(g + k));
  const float2 bb = __ldg(reinterpret_cast<const float2*>(b + k));
  *reinterpret_cast<__nv_bfloat162*>(out + k) = __floats2bfloat162_rn(
      (v.x - mu) * rs * gg.x + bb.x, (v.y - mu) * rs * gg.y + bb.y);
}

// CH > 0: C <= 64 CH, the row held in registers (CH pairs a lane and
// neighbour); CH == 0: any even C, the row read twice. The sums run in
// the same order either way.
template <int CH>
__global__ void __launch_bounds__(PM_WARPS * 32)
    patch_merge_ln_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ g,
                          const float* __restrict__ b, bf16* __restrict__ n,
                          int BT, int H, int W, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H2 = H / 2, W2 = W / 2;
  const long long R = (long long)BT * H2 * W2;
  const long long ro = (long long)blockIdx.x * PM_WARPS + warp;
  if (ro >= R) return;
  const int j = ro % W2, i = (ro / W2) % H2;
  const long long bt = ro / ((long long)W2 * H2);
  const bf16* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int di = q & 1, dj = q >> 1;  // x0, x1, x2, x3
    src[q] = x + ((bt * H + 2 * i + di) * W + 2 * j + dj) * C;
  }
  bf16* out = n + ro * 4 * C;
  const float inv_n = 1.0f / (4 * C);
  float sum = 0.0f, sq = 0.0f;
  if constexpr (CH > 0) {
    float2 v[4][CH];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < CH; ++m) {
        const int c = lane * 2 + 64 * m;
        v[q][m] = c < C ? load2(src[q] + c) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < CH; ++m)
        if (lane * 2 + 64 * m < C) {
          sum += v[q][m].x + v[q][m].y;
          sq += v[q][m].x * v[q][m].x + v[q][m].y * v[q][m].y;
        }
    const float mu = warp_sum(sum) * inv_n;
    const float var = warp_sum(sq) * inv_n - mu * mu;
    const float rs = rsqrtf(var + eps);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < CH; ++m) {
        const int c = lane * 2 + 64 * m;
        if (c < C) norm_store2(out, v[q][m], g, b, q * C + c, mu, rs);
      }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      for (int c = lane * 2; c < C; c += 64) {
        const float2 v = load2(src[q] + c);
        sum += v.x + v.y;
        sq += v.x * v.x + v.y * v.y;
      }
    const float mu = warp_sum(sum) * inv_n;
    const float var = warp_sum(sq) * inv_n - mu * mu;
    const float rs = rsqrtf(var + eps);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      for (int c = lane * 2; c < C; c += 64)
        norm_store2(out, load2(src[q] + c), g, b, q * C + c, mu, rs);
  }
}

}  // namespace

// x: (BT, H, W, C) bf16, H and W even, C % 8 == 0; scale/bias: (4C) fp32,
// 8-byte aligned; w: (2C, 4C) bf16; n_buf: (rows, 4C) bf16 scratch; out:
// (BT, H/2, W/2, 2C) bf16.
extern "C" int stswin_patch_merge(const void* x, const void* scale,
                                  const void* bias, const void* w,
                                  void* n_buf, void* out, int BT, int H, int W,
                                  int C, float eps, void* stream) {
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 8 == 0;
  };
  if (BT <= 0 || H < 2 || W < 2 || H % 2 || W % 2 || C <= 0 || C % 8 ||
      !aligned(scale) || !aligned(bias))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = (long long)BT * (H / 2) * (W / 2);
  const unsigned blocks = static_cast<unsigned>((R + PM_WARPS - 1) / PM_WARPS);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  bf16* np = static_cast<bf16*>(n_buf);
  if (C <= 512)
    patch_merge_ln_kernel<8><<<blocks, PM_WARPS * 32, 0, s>>>(
        xp, gp, bp, np, BT, H, W, C, eps);
  else
    patch_merge_ln_kernel<0><<<blocks, PM_WARPS * 32, 0, s>>>(
        xp, gp, bp, np, BT, H, W, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmParams g{};
  g.A = np;
  g.lda = 4 * C;
  g.a_map = identity_map();
  g.Wt = static_cast<const bf16*>(w);
  g.bias = nullptr;
  g.M = static_cast<int>(R);
  g.N = 2 * C;
  g.K = 4 * C;
  g.C = static_cast<bf16*>(out);
  g.ldc = 2 * C;
  g.c_map = identity_map();
  g.act = ACT_NONE;
  return gemm_sm90(g, EPI_BF16, s);
}
