// K6's two LayerNorm-backward row passes past 1024 channels, in both forms
// (epilogue.cu: T = bf16; fp32_train.cu: T = float): a block a row, where
// a warp a row would hold 24-32 float2 a lane (C 1536-2048) and spill.
//
// Each of the block's 256 threads owns the column pairs 2 t + 512 i of
// every row; the row's sums meet through shared memory in warp order (the
// same order every call). The row is read from device memory once a pass
// (four passes; the later ones from L1 / L2), so any C % 2 == 0 runs. The
// block's vector sums over its rows (the LayerNorm scale and bias
// gradients) accumulate in its own partial rows in device memory, each
// column by its owning thread, rows ascending: `sum_parts` then adds the
// blocks in order, as the warp-a-row passes' partials. No float atomic.
#pragma once

#include "common.cuh"

namespace k6wide {

constexpr int THREADS = 256;

// the block's sum of v, every thread the same value: the warps' sums
// through red (THREADS / 32 floats) in warp order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void st2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void add2(float* p, float2 v) {
  float2 a = ld2(p);
  a.x += v.x;
  a.y += v.y;
  st2(p, a);
}

// (mu, rs) of the row s32 (+ m) over C, two passes as the warp-a-row form
template <typename T>
__device__ __forceinline__ float2 row_stats(const float* s32, const T* m,
                                            int C, float eps, float* red) {
  float sum = 0.0f;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * THREADS) {
    float2 o = ld2(s32 + c);
    if (m) {
      const float2 mv = ld2(m + c);
      o.x += mv.x;
      o.y += mv.y;
    }
    sum += o.x + o.y;
  }
  const float mu = block_sum(sum, red) / C;
  float sq = 0.0f;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * THREADS) {
    float2 o = ld2(s32 + c);
    if (m) {
      const float2 mv = ld2(m + c);
      o.x += mv.x;
      o.y += mv.y;
    }
    const float d0 = o.x - mu, d1 = o.y - mu;
    sq += d0 * d0 + d1 * d1;
  }
  return make_float2(mu, rsqrtf(block_sum(sq, red) / C + eps));
}

// LN1 backward: o = s32 + m, g -> do32 (fp32) and, where given, dm =
// T(do32); the block's sums of g * xhat1, g and do32 into part[block][3][C]
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln1_bwd_kernel(const float* __restrict__ s32, const T* __restrict__ m,
                   const T* __restrict__ g, const float* __restrict__ s1,
                   T* __restrict__ dm, float* __restrict__ do32,
                   float* __restrict__ part, int R, int C, float eps) {
  __shared__ float red[THREADS / 32];
  float* acc = part + (long long)blockIdx.x * 3 * C;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * THREADS)
    for (int k = 0; k < 3; ++k) st2(acc + k * C + c, make_float2(0.f, 0.f));
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const long long base = (long long)r * C;
    const float2 st = row_stats(s32 + base, m + base, C, eps, red);
    const auto xhat = [&](int c) {
      const float2 sv = ld2(s32 + base + c), mv = ld2(m + base + c);
      return make_float2((sv.x + mv.x - st.x) * st.y,
                         (sv.y + mv.y - st.x) * st.y);
    };
    float m1 = 0.0f, m2 = 0.0f;
    for (int c = 2 * threadIdx.x; c < C; c += 2 * THREADS) {
      const float2 xh = xhat(c), gv = ld2(g + base + c);
      add2(acc + c, make_float2(gv.x * xh.x, gv.y * xh.y));
      add2(acc + C + c, gv);
      const float gx = gv.x * s1[c], gy = gv.y * s1[c + 1];
      m1 += gx + gy;
      m2 += gx * xh.x + gy * xh.y;
    }
    m1 = block_sum(m1, red) / C;
    m2 = block_sum(m2, red) / C;
    for (int c = 2 * threadIdx.x; c < C; c += 2 * THREADS) {
      const float2 xh = xhat(c), gv = ld2(g + base + c);
      const float2 d = make_float2((gv.x * s1[c] - m1 - xh.x * m2) * st.y,
                                   (gv.y * s1[c + 1] - m1 - xh.y * m2) * st.y);
      st2(do32 + base + c, d);
      if (dm) st2(dm + base + c, d);
      add2(acc + 2 * C + c, d);
    }
  }
}

// LN2 backward of dn2 with xhat2 / rsig2 recomputed from s32; ds = do32 +
// that -> dx (row r) and, where given, dy at the shifted row; the block's
// sums of dn2 * xhat2 and dn2 into part[block][2][C]
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln2_bwd_kernel(const float* __restrict__ s32,
                   const float* __restrict__ dn2,
                   const float* __restrict__ do32,
                   const float* __restrict__ s2, T* __restrict__ dx,
                   T* __restrict__ dy, float* __restrict__ part, int R, int C,
                   int H, int W, int shift, float eps) {
  __shared__ float red[THREADS / 32];
  float* acc = part + (long long)blockIdx.x * 2 * C;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * THREADS)
    for (int k = 0; k < 2; ++k) st2(acc + k * C + c, make_float2(0.f, 0.f));
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const long long base = (long long)r * C;
    const float2 st =
        row_stats(s32 + base, static_cast<const float*>(nullptr), C, eps, red);
    const auto xhat = [&](int c) {
      const float2 sv = ld2(s32 + base + c);
      return make_float2((sv.x - st.x) * st.y, (sv.y - st.x) * st.y);
    };
    float m1 = 0.0f, m2 = 0.0f;
    for (int c = 2 * threadIdx.x; c < C; c += 2 * THREADS) {
      const float2 xh = xhat(c), gv = ld2(dn2 + base + c);
      add2(acc + c, make_float2(gv.x * xh.x, gv.y * xh.y));
      add2(acc + C + c, gv);
      const float gx = gv.x * s2[c], gy = gv.y * s2[c + 1];
      m1 += gx + gy;
      m2 += gx * xh.x + gy * xh.y;
    }
    m1 = block_sum(m1, red) / C;
    m2 = block_sum(m2, red) / C;
    long long ybase = base;
    if (dy) {
      const int w = r % W, h = (r / W) % H, bt = r / (W * H);
      const int hs = h - shift < 0 ? h - shift + H : h - shift;
      const int wsrc = w - shift < 0 ? w - shift + W : w - shift;
      ybase = ((long long)(bt * H + hs) * W + wsrc) * C;
    }
    for (int c = 2 * threadIdx.x; c < C; c += 2 * THREADS) {
      const float2 xh = xhat(c), gv = ld2(dn2 + base + c);
      const float2 o = ld2(do32 + base + c);
      const float2 d =
          make_float2(o.x + (gv.x * s2[c] - m1 - xh.x * m2) * st.y,
                      o.y + (gv.y * s2[c + 1] - m1 - xh.y * m2) * st.y);
      st2(dx + base + c, d);
      if (dy) st2(dy + ybase + c, d);
    }
  }
}

}  // namespace k6wide
