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
// channel, far below the card's 295 flops a byte: at (40960, 2048) row 15
// cannot take less than 0.100 ms. The TPU kernels picked row tiles to fit
// VMEM; here one warp owns a row: 16-byte loads and stores (8 bf16 a lane),
// the row kept in registers, fp32 statistics in two passes (mean, then the
// mean of squared deviations, as `_ln_math` and `_ln_kernel`), no shared
// memory. What the design does for the bytes in flight, which hide the
// latency of device memory:
//   - the kernel is a template on CH, the 256-channel chunks of the row
//     (1..8, from C at launch), so a lane holds CH x 8 values and no more:
//     a row array sized for C = 2048 at every C kept few warps on an SM;
//   - at C <= 512 a warp takes ROWS = 4 / CH rows at once, and every
//     16-byte load of them is issued before the first reduction;
//   - the grid is persistent (as many blocks as fit on the card, rows in a
//     grid-stride loop), so gamma and beta are read once a warp as float4
//     and, at CH <= 2, kept in registers; wider rows read them per row,
//     from L1, as float4.
// Lanes past C in the last chunk idle (C % 256 != 0: the JAX tests' 32-96).

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

// 8 consecutive fp32 (16-byte aligned) as two float4 loads
__device__ __forceinline__ void load8f(const float* src, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The warp-a-row kernel. ADD: normalise x + y (and write it to sum_out,
// when given); else x. Lane l holds channels i * 256 + 8 l .. + 7 of chunk
// i < CH, those below C, of ROWS consecutive rows at a time.
template <bool ADD, int CH, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
    add_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                  const float* __restrict__ g, const float* __restrict__ b,
                  bf16* __restrict__ sum_out, bf16* __restrict__ out, int R,
                  int C, float eps) {
  constexpr bool KEEP = CH <= 2;  // gamma and beta held in registers
  const int lane = threadIdx.x & 31;
  bool live[CH];  // this lane's chunk i lies below C
#pragma unroll
  for (int i = 0; i < CH; ++i) live[i] = i * 256 + lane * 8 < C;
  float gk[KEEP ? CH : 1][8], bk[KEEP ? CH : 1][8];
  if (KEEP) {
#pragma unroll
    for (int i = 0; i < (KEEP ? CH : 1); ++i)
      if (live[i]) {
        load8f(g + i * 256 + lane * 8, gk[i]);
        load8f(b + i * 256 + lane * 8, bk[i]);
      }
  }
  const long long step = (long long)gridDim.x * WARPS * ROWS;
  for (long long r0 = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) *
                      ROWS;
       r0 < R; r0 += step) {
    float v[ROWS][CH][8];
    float sum[ROWS];
    // every load of the ROWS rows first
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const long long base = (r0 + j) * C;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = i * 256 + lane * 8;
        if (r0 + j < R && live[i]) {
          load8(x + base + c, v[j][i]);
          if (ADD) {
            float yv[8];
            load8(y + base + c, yv);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[j][i][e] += yv[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[j][i][e] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      sum[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[j] += v[j][i][e];
    }
    float mu[ROWS], sq[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) mu[j] = warp_sum(sum[j]) / C;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      sq[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (live[i]) {
          if (ADD && sum_out && r0 + j < R)
            store8(sum_out + (r0 + j) * C + i * 256 + lane * 8, v[j][i]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[j][i][e] -= mu[j];
            sq[j] += v[j][i][e] * v[j][i][e];
          }
        }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const float rs = rsqrtf(warp_sum(sq[j]) / C + eps);
      if (r0 + j >= R) continue;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (live[i]) {
          const int c = i * 256 + lane * 8;
          float gv[8], bv[8];
          if (KEEP) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              gv[e] = gk[KEEP ? i : 0][e];
              bv[e] = bk[KEEP ? i : 0][e];
            }
          } else {
            load8f(g + c, gv);
            load8f(b + c, bv);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[j][i][e] = v[j][i][e] * rs * gv[e] + bv[e];
          store8(out + (r0 + j) * C + c, v[j][i]);
        }
    }
  }
}

// Launch the warp-a-row kernel for CH chunks: as many blocks as fit on the
// card at once (asked of the occupancy calculator once an instance), fewer
// when the rows run out first.
template <bool ADD, int CH>
cudaError_t launch_rows(const bf16* x, const bf16* y, const float* g,
                        const float* b, bf16* sum_out, bf16* out, int R, int C,
                        float eps, cudaStream_t s) {
  constexpr int ROWS = CH >= 4 ? 1 : 4 / CH;
  static int per_sm = 0;
  if (!per_sm) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, add_ln_kernel<ADD, CH, ROWS>, WARPS * 32, 0);
    if (err != cudaSuccess) return err;
  }
  const long long groups =
      ((long long)R + WARPS * ROWS - 1) / (WARPS * ROWS);
  const long long most = (long long)per_sm * sm_count();
  if (most <= 0) return cudaErrorInvalidDevice;
  add_ln_kernel<ADD, CH, ROWS>
      <<<static_cast<int>(groups < most ? groups : most), WARPS * 32, 0, s>>>(
          x, y, g, b, sum_out, out, R, C, eps);
  return cudaGetLastError();
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// CH = ceil(C / 256) chosen at run time, 1 <= CH <= MAX_CHUNKS
template <bool ADD>
cudaError_t add_ln(const void* x, const void* y, const void* g, const void* b,
                   void* sum_out, void* out, int R, int C, float eps,
                   void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* yp = static_cast<const bf16*>(y);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  bf16* sp = static_cast<bf16*>(sum_out);
  bf16* op = static_cast<bf16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 255) / 256) {
    case 1: return launch_rows<ADD, 1>(xp, yp, gp, bp, sp, op, R, C, eps, s);
    case 2: return launch_rows<ADD, 2>(xp, yp, gp, bp, sp, op, R, C, eps, s);
    case 3: return launch_rows<ADD, 3>(xp, yp, gp, bp, sp, op, R, C, eps, s);
    case 4: return launch_rows<ADD, 4>(xp, yp, gp, bp, sp, op, R, C, eps, s);
    case 5: return launch_rows<ADD, 5>(xp, yp, gp, bp, sp, op, R, C, eps, s);
    case 6: return launch_rows<ADD, 6>(xp, yp, gp, bp, sp, op, R, C, eps, s);
    case 7: return launch_rows<ADD, 7>(xp, yp, gp, bp, sp, op, R, C, eps, s);
    case 8: return launch_rows<ADD, 8>(xp, yp, gp, bp, sp, op, R, C, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// Row 15 for any C (rows wider than 2048 channels or not a multiple of 8,
// or a scale or bias off 16-byte alignment):
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
// 2048; scale, bias (C,) fp32, 16-byte aligned (float4 loads).
extern "C" int stswin_add_layer_norm(const void* x, const void* y,
                                     const void* scale, const void* bias,
                                     void* sum_out, void* out, int R, int C,
                                     float eps, void* stream) {
  if (C % 256 || C > MAX_CHUNKS * 256 || R <= 0 || !aligned16(scale) ||
      !aligned16(bias))
    return cudaErrorInvalidValue;
  return add_ln<true>(x, y, scale, bias, sum_out, out, R, C, eps, stream);
}

// Row 15. x, out: (rows, C) bf16, any C > 0: a warp a row for C a multiple
// of 8 up to 2048 (and scale, bias 16-byte aligned, as a tensor of its own
// always is), else the wide-row kernel; scale, bias (C,) fp32.
extern "C" int stswin_layer_norm(const void* x, const void* scale,
                                 const void* bias, void* out, int R, int C,
                                 float eps, void* stream) {
  if (C <= 0 || R <= 0) return cudaErrorInvalidValue;
  if (C % 8 || C > MAX_CHUNKS * 256 || !aligned16(scale) ||
      !aligned16(bias)) {
    ln_wide_kernel<<<R, WIDE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<bf16*>(out), C, eps);
    return cudaGetLastError();
  }
  return add_ln<false>(x, nullptr, scale, bias, nullptr, out, R, C, eps,
                       stream);
}
