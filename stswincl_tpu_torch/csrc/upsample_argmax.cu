// K4: composed bilinear upsample + class argmax, head-resolution logits
// (B, NC, h, w) -> (B, OH, OW) int32 predictions.
//
// Replaces: stswincl_tpu/ops/pallas_upsample_argmax.py
//   upsample_argmax_pallas (:53) -> _kernel (:36).
//
// Bound on the H100: the full-resolution logits (B * NC * OH * OW fp32,
// 126 MB at bs 2 of the EndoVis protocol) would make this op bound by
// device memory if they were written; here they never leave the SM, and
// the only write is the int32 prediction. What is left is about
// 2 * NC * OH * OW * w flops of small, dense interpolation products.
//
// Design: one block per (batch, 16-row output band, 128-column output
// band). The block keeps its slice of the column matrix (transposed,
// w x 128) and its row-matrix band in shared memory. Per class it forms
// t = mh_band @ x[c] (16 x w) in shared memory, then y = t @ mw^T for its
// 16 x 128 outputs in registers, and folds a running max/argmax with a
// strict `>` so that ties go to the first class. Without `exact` every
// input and t are rounded to bf16 before the products, as the TPU kernel's
// bf16 matmul inputs are; products are exact in fp32 and sums are fp32.
// The products run on the fp32 cores, not the tensor cores.

#include "common.cuh"

namespace {

constexpr int UA_HB = 16, UA_OB = 128, UA_THREADS = 256;
constexpr int UA_RPT = UA_HB * UA_OB / UA_THREADS;  // outputs per thread

template <bool EXACT>
__device__ __forceinline__ float rnd(float v) {
  return EXACT ? v : __bfloat162float(__float2bfloat16_rn(v));
}

template <bool EXACT>
__global__ void __launch_bounds__(UA_THREADS)
    upsample_argmax_kernel(const float* __restrict__ x,
                           const float* __restrict__ mh,
                           const float* __restrict__ mw, int* __restrict__ out,
                           int NC, int h, int w, int OH, int OW) {
  extern __shared__ __align__(16) float sm[];
  float* mwT = sm;                // [w][UA_OB]
  float* mhs = mwT + w * UA_OB;   // [UA_HB][h]
  float* ts = mhs + UA_HB * h;    // [UA_HB][w]
  const int b = blockIdx.z, r0 = blockIdx.y * UA_HB, o0 = blockIdx.x * UA_OB;
  const int tid = threadIdx.x;

  for (int i = tid; i < w * UA_OB; i += UA_THREADS) {
    const int k = i / UA_OB, og = o0 + i - k * UA_OB;
    mwT[i] = og < OW ? rnd<EXACT>(mw[(long long)og * w + k]) : 0.0f;
  }
  for (int i = tid; i < UA_HB * h; i += UA_THREADS) {
    const int r = i / h, rg = r0 + r;
    mhs[i] = rg < OH ? rnd<EXACT>(mh[(long long)rg * h + i - r * h]) : 0.0f;
  }

  const int o = tid % UA_OB, rq = tid / UA_OB;
  float best[UA_RPT];
  int idx[UA_RPT];
#pragma unroll
  for (int e = 0; e < UA_RPT; ++e) {
    best[e] = -INFINITY;
    idx[e] = 0;
  }
  const float* xb = x + (long long)b * NC * h * w;
  for (int c = 0; c < NC; ++c) {
    __syncthreads();  // matrices loaded / previous class done with ts
    const float* xc = xb + (long long)c * h * w;
    for (int i = tid; i < UA_HB * w; i += UA_THREADS) {
      const int r = i / w, k = i - r * w;
      float acc = 0.0f;
      for (int j = 0; j < h; ++j) acc += mhs[r * h + j] * rnd<EXACT>(xc[j * w + k]);
      ts[i] = rnd<EXACT>(acc);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < UA_RPT; ++e) {
      const float* trow = ts + (rq * UA_RPT + e) * w;
      float acc = 0.0f;
      for (int k = 0; k < w; ++k) acc += trow[k] * mwT[k * UA_OB + o];
      if (acc > best[e]) {  // strict: ties keep the earlier class
        best[e] = acc;
        idx[e] = c;
      }
    }
  }
  const int og = o0 + o;
#pragma unroll
  for (int e = 0; e < UA_RPT; ++e) {
    const int r = r0 + rq * UA_RPT + e;
    if (r < OH && og < OW) out[((long long)b * OH + r) * OW + og] = idx[e];
  }
}

template <bool EXACT>
cudaError_t launch(const float* x, const float* mh, const float* mw, int* out,
                   int B, int NC, int h, int w, int OH, int OW,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t(w) * UA_OB + UA_HB * h + UA_HB * w);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_argmax_kernel<EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((OW + UA_OB - 1) / UA_OB, (OH + UA_HB - 1) / UA_HB, B);
  upsample_argmax_kernel<EXACT><<<grid, UA_THREADS, smem, s>>>(
      x, mh, mw, out, NC, h, w, OH, OW);
  return cudaGetLastError();
}

}  // namespace

// x: (B, NC, h, w) fp32; mh: (OH, h) fp32; mw: (OW, w) fp32;
// out: (B, OH, OW) int32.
extern "C" int stswin_upsample_argmax(const void* x, const void* mh,
                                      const void* mw, void* out, int B, int NC,
                                      int h, int w, int OH, int OW, int exact,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mhf = static_cast<const float*>(mh);
  const float* mwf = static_cast<const float*>(mw);
  int* o = static_cast<int*>(out);
  return exact ? launch<true>(xf, mhf, mwf, o, B, NC, h, w, OH, OW, s)
               : launch<false>(xf, mhf, mwf, o, B, NC, h, w, OH, OW, s);
}
