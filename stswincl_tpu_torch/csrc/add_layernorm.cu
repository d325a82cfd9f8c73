// Row 14: the residual add and LayerNorm, (x + y, LN(x + y)), or LN(x + y)
// alone; and row 15: LN(x), the same kernel without y.
//
// Replaces: stswincl_tpu/ops/pallas_add_layernorm.py
//   fused_add_layer_norm (:110) / _run_add_ln (:65) -> _add_ln_kernel (:43)
//   and _add_ln_kernel_noout (:55); and stswincl_tpu/ops/pallas_layernorm.py
//   fused_layer_norm (:82) / _pallas_layer_norm (:50) -> _ln_kernel (:40).
//
// Bound on the H100: device memory. A row of C channels reads 4C bytes
// and writes 2C (4C with the sum; row 15 reads 2C) for about 10 flops a
// channel, far below the card's 295 flops a byte. The TPU kernels picked
// row tiles to fit VMEM; here one warp owns one row: 16-byte loads and
// stores (8 bf16 a lane), the row kept in registers, fp32 statistics in
// two passes (mean, then the mean of squared deviations, as `_ln_math`
// and `_ln_kernel`), and no shared memory. Enough warps are in flight to
// cover the latency of the loads. A row shorter than 256 channels (the
// JAX tests' 32-96) leaves the lanes past C idle.

#include "common.cuh"

namespace {

constexpr int WARPS = 8, MAX_CHUNKS = 8;  // C <= 8 * 256

__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  __align__(16) bf16 o[8];
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(o[e]);
}

__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

// ADD: normalise x + y (and write it to sum_out, when given); else x.
// Lane l holds channels i * 256 + 8 l .. + 7 of chunk i, those below C.
template <bool ADD>
__global__ void __launch_bounds__(WARPS * 32)
    add_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                  const float* __restrict__ g, const float* __restrict__ b,
                  bf16* __restrict__ sum_out, bf16* __restrict__ out, int R,
                  int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const long long base = (long long)r * C;
  float v[MAX_CHUNKS][8];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i)
    if (i * 256 + lane * 8 < C) {
      const int c = i * 256 + lane * 8;
      load8(x + base + c, v[i]);
      if (ADD) {
        float yv[8];
        load8(y + base + c, yv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] += yv[e];
        if (sum_out) store8(sum_out + base + c, v[i]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
  const float mu = warp_sum(sum) / C;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i)
    if (i * 256 + lane * 8 < C)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] -= mu;
        sq += v[i][e] * v[i][e];
      }
  const float rs = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i)
    if (i * 256 + lane * 8 < C) {
      const int c = i * 256 + lane * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = v[i][e] * rs * g[c + e] + b[c + e];
      store8(out + base + c, v[i]);
    }
}

// Row 15 for any C (rows wider than 2048 channels, or not a multiple of 8):
// one block per row, the row read three times (mean, squared deviations,
// the output) in chunks of 8 channels (16-byte loads, when C % 8 == 0 keeps
// every row 16-byte aligned) with a scalar tail; the same two-pass fp32
// statistics. The re-reads hit L1/L2: the row is at most a few tens of KB.
constexpr int WIDE_THREADS = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < WIDE_THREADS / 32; ++i) s += red[i];
  return s;
}

__global__ void __launch_bounds__(WIDE_THREADS)
    ln_wide_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, bf16* __restrict__ out, int C,
                   float eps) {
  __shared__ float red[WIDE_THREADS / 32];
  const long long base = (long long)blockIdx.x * C;
  const bf16* xr = x + base;
  const int nvec = C % 8 == 0 ? C / 8 : 0;  // 8-channel chunks
  const int tid = threadIdx.x;
  float s = 0.0f;
  for (int i = tid; i < nvec; i += WIDE_THREADS) {
    float v[8];
    load8(xr + i * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[e];
  }
  for (int c = nvec * 8 + tid; c < C; c += WIDE_THREADS)
    s += __bfloat162float(xr[c]);
  const float mu = block_sum(s, red) / C;
  float sq = 0.0f;
  for (int i = tid; i < nvec; i += WIDE_THREADS) {
    float v[8];
    load8(xr + i * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq += (v[e] - mu) * (v[e] - mu);
  }
  for (int c = nvec * 8 + tid; c < C; c += WIDE_THREADS) {
    const float d = __bfloat162float(xr[c]) - mu;
    sq += d * d;
  }
  const float rs = rsqrtf(block_sum(sq, red) / C + eps);
  bf16* orow = out + base;
  for (int i = tid; i < nvec; i += WIDE_THREADS) {
    float v[8];
    load8(xr + i * 8, v);
    const int c = i * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * rs * g[c + e] + b[c + e];
    store8(orow + c, v);
  }
  for (int c = nvec * 8 + tid; c < C; c += WIDE_THREADS)
    orow[c] = __float2bfloat16((__bfloat162float(xr[c]) - mu) * rs * g[c] +
                               b[c]);
}

}  // namespace

// x, y, out, sum_out (or null): (rows, C) bf16, C a multiple of 256 up to
// 2048; scale, bias (C,) fp32.
extern "C" int stswin_add_layer_norm(const void* x, const void* y,
                                     const void* scale, const void* bias,
                                     void* sum_out, void* out, int R, int C,
                                     float eps, void* stream) {
  if (C % 256 || C > MAX_CHUNKS * 256 || R <= 0) return cudaErrorInvalidValue;
  add_ln_kernel<true><<<(R + WARPS - 1) / WARPS, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(sum_out), static_cast<bf16*>(out), R, C, eps);
  return cudaGetLastError();
}

// Row 15. x, out: (rows, C) bf16, any C > 0: a warp a row for C a multiple
// of 8 up to 2048, else the wide-row kernel; scale, bias (C,) fp32.
extern "C" int stswin_layer_norm(const void* x, const void* scale,
                                 const void* bias, void* out, int R, int C,
                                 float eps, void* stream) {
  if (C <= 0 || R <= 0) return cudaErrorInvalidValue;
  if (C % 8 || C > MAX_CHUNKS * 256) {
    ln_wide_kernel<<<R, WIDE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<bf16*>(out), C, eps);
    return cudaGetLastError();
  }
  add_ln_kernel<false><<<(R + WARPS - 1) / WARPS, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), nullptr, static_cast<const float*>(scale),
      static_cast<const float*>(bias), nullptr, static_cast<bf16*>(out), R, C,
      eps);
  return cudaGetLastError();
}
