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
//   2. fc1 on the Hopper GEMM (gemm_sm90.cu: wgmma + TMA) + bias + GELU
//      (the erf polynomial) -> bf16 hidden;
//   3. fc2 on the Hopper GEMM + bias, added in fp32 into s (the kernel's
//      rounding: the
//      fp32 MLP sum, not a bf16-rounded m, `pallas_add_ln_mlp.py:743`);
//   4. one warp per row: LN1 -> bf16 output, unshifted.
// With an `m_out` pointer (the training forward at C = 1024), step 3
// instead writes m = bf16(fc2 + bias) and step 4 normalises s + m, the
// rounding of `_epilogue_kernel_with_m` (`pallas_add_ln_mlp.py:752-799`,
// Pallas row 8), so the backward can take m as saved.
//
// K6 (`stswin_block_epilogue_bwd`, below): the backward of the same tail.
//
// Replaces: stswincl_tpu/ops/pallas_add_ln_mlp.py
//   fused_epilogue_bwd (:310) -> _epi_bwd_kernel (:181), C = 512, and
//   fused_epilogue_bwd_streamed (:557) -> _epi_bwd_slice_kernel (:425) +
//   _epi_bwd_combine_kernel (:502), C = 1024 with the saved m.
// The TPU split the hidden dim into slices plus a combine step to fit
// VMEM; here one launch sequence covers both, m recomputed (rounded as
// `:216` rounds it) when it was not saved.
//
// Bound: the products, 2 * rows * C * hidden flops each (fc1, dh, dn2, dw1,
// dw2; fc2 again without a saved m), on the tensor cores; the row passes
// and the (rows, hidden) bf16 h and dpre through device memory. The TPU
// kernel kept gelu' in VMEM (`:213`, `:233`). Launches, every product on
// the Hopper GEMMs (gemm_sm90.cu):
//   1. one warp per row: s = x + unshift(y) (fp32), n2 = bf16(LN2(s));
//   2. without m: fc1 whose epilogue evaluates the erf polynomial once and
//      writes h = bf16(gelu(pre)) and gelu'(pre) (fp32, EPI_GELU_GRAD),
//      then m = bf16(h @ w2^T + bw2) (m needs h before dm exists);
//   3. one warp per row (a block per row past C 1024): LN1 backward of g
//      -> do (fp32) and dm = bf16(do), with the column sums of g * xhat1,
//      g and do (ds1, db1n, dbw2);
//   4. with m saved: pre = n2 @ w1^T + b1 and dh = dm @ w2 in one tile's
//      registers (EPI_GELU_BWD), whose epilogue writes h, dpre =
//      bf16(dh * gelu'(pre)) and the column sums of dh * gelu'(pre) (db1):
//      gelu' never leaves the registers, fc1 runs once. Without m: dh =
//      dm @ w2 times the gelu' of step 2 (EPI_DGELU), the same dpre and
//      db1. tools/profile_gemm.py times both ways to h, dpre and db1 on
//      an H100 SXM (700 W): with m saved (stage 2, 40960 x 4096 x 1024)
//      the fused pair took 1.955 ms, fc1 writing gelu' then dh times it
//      2.040; without m (stage 1) the fused pair would run fc1 a second
//      time (344 GFLOP) to save the fp32 gelu' (2.7 GB of traffic), and
//      took 3.639 ms with that fc1 against 3.061 through memory;
//   5. dn2 = dpre @ w1 (fp32);
//   6. as step 3: LN2 backward with the fp32 xhat / rsig of the
//      recompute (`_ln_bwd_f32`, `:172`), ds = do + that, written
//      unshifted (dx) and through the shift (dy, the gradient of the
//      attention's shifted output), with the sums of dn2 * xhat2, dn2;
//   7. dw1 = dpre^T n2, dw2 = dm^T h on the weight-gradient GEMM.
// Every sum over rows is formed in a fixed order, with no float atomic
// (two calls give the same bits): the row passes' column sums as partial
// rows a block, db1 as partial rows a 128-row tile, the weight gradients'
// row splits in a workspace, each then added in order by `sum_parts`.
// Any C % 8 runs (K2's forward takes any): the row passes a warp a row
// up to 1024 channels, a block a row past them (ln_bwd_wide.cuh).

// Row 13 (`stswin_add_ln_mlp`, at the end): (s, m) = (bf16(x + y),
// bf16(fc2(GELU(fc1(LN(x + y)))))), the tail of K2 without its LN1.
//
// Replaces: stswincl_tpu/ops/pallas_add_ln_mlp.py
//   fused_add_ln_mlp (:97) -> _kernel (:38).
//
// Bound: fc1 and fc2, 4 * rows * C * hidden flops, on the tensor cores
// (687 GFLOP at the profiler's shapes); the rows move 8 bytes a channel.
// The TPU kernel kept LN(s) and the fp32 accumulator in VMEM across its
// hidden blocks. Here it is K2's device code, three launches: the LN
// prologue (K2's `ln_rows_kernel`, writing bf16(s) beside the fp32 s it
// normalises), then row 12's two products (`mlp_gemms`): fc1 with bias and
// GELU, and fc2 whose fp32 sum plus bias is rounded once, into m. LN(s) and
// the hidden activation go through device memory in bf16, as in K2.
//
// Row 12 (`stswin_mlp`, at the end): fc2(GELU(fc1(x))), the MLP of the
// standalone `Mlp` module, h rounded to bf16 before fc2 and fc2's fp32
// sum plus bias rounded once.
//
// Replaces: stswincl_tpu/ops/pallas_mlp.py fused_mlp (:226) -> _mlp_kernel
//   (:150).
//
// Bound: fc1 and fc2, 4 * rows * C * hidden flops, on the tensor cores.
// The TPU kernel kept the hidden activation in VMEM, blocked over the
// hidden dim; here it is two launches of the Hopper GEMM (`mlp_gemms`: the
// EPI_BF16 form of gemm_sm90.cu, wgmma on a TMA ring, K1's and K2's
// product), fc1 with the bias and GELU in its epilogue, h through device
// memory in bf16 (2 * rows * hidden * 2 bytes), then fc2 with its bias.
// Keeping h in L2 would take rows in chunks (later work). The GEMM masks
// columns past N and TMA zero-fills the k tile past K, so any C and hidden
// that are multiples of 8 (the 16-byte rows TMA and the stores need) run,
// the JAX tests' C 32 and 64 among them.

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "ln_bwd_wide.cuh"

namespace {

constexpr int LN_WARPS = 8;

// ADD: s = x[r] + y[unshift(r)] is written to s32 first (and, with
// sum_out, bf16(s) to sum_out); else s32 is read. Else, with m, the row
// normalised is s32 + m (m bf16, added in fp32).
template <bool ADD>
__global__ void __launch_bounds__(LN_WARPS * 32)
    ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                   const bf16* __restrict__ m, const float* __restrict__ g,
                   const float* __restrict__ b, float* __restrict__ s32,
                   bf16* __restrict__ out, bf16* __restrict__ sum_out, int R,
                   int C, int H, int W, int shift, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * LN_WARPS + warp;
  if (r >= R) return;
  float* srow = s32 + (long long)r * C;
  const bf16* mrow = m ? m + (long long)r * C : nullptr;
  auto row = [&](int c) {
    float2 v = *reinterpret_cast<const float2*>(srow + c);
    if (mrow) {
      const float2 mv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mrow + c));
      v.x += mv.x;
      v.y += mv.y;
    }
    return v;
  };
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
      if (sum_out)
        *reinterpret_cast<__nv_bfloat162*>(sum_out + (long long)r * C + c) =
            __floats2bfloat162_rn(s.x, s.y);
      sum += s.x + s.y;
    }
  } else {
    for (int c = lane * 2; c < C; c += 64) {
      const float2 s = row(c);
      sum += s.x + s.y;
    }
  }
  const float mu = warp_sum(sum) / C;
  float sq = 0.0f;
  for (int c = lane * 2; c < C; c += 64) {
    const float2 s = row(c);
    const float d0 = s.x - mu, d1 = s.y - mu;
    sq += d0 * d0 + d1 * d1;
  }
  const float rs = rsqrtf(warp_sum(sq) / C + eps);
  bf16* orow = out + (long long)r * C;
  for (int c = lane * 2; c < C; c += 64) {
    const float2 s = row(c);
    *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
        (s.x - mu) * rs * g[c] + b[c], (s.y - mu) * rs * g[c + 1] + b[c + 1]);
  }
}

// ---- K6 row kernels: one warp per row, nv = ceil(C / 64) float2 per lane
// (NV the most: C <= 64 NV, any C % 8 up to 1024, the pairs of the last
// float2 at or past C idle; EXACT: C == 64 NV, nv known to the compiler
// and no pair idle: the training widths' code as before any other width
// ran), grid-strided so each warp
// sums its rows' vector gradients in registers; the block's 8 warps then
// meet in shared memory in warp order, into the block's partial rows, and
// `sum_parts` adds the blocks in order (no float atomic). Past 1024
// channels a block a row (ln_bwd_wide.cuh).

// Whether the lane's float2 i lies in the row: i < nv, and (a C off 64)
// its pair below C.
template <bool EXACT>
__device__ __forceinline__ bool live2(int i, int nv, int lane, int C) {
  return i < nv && (EXACT || lane * 2 + 64 * i < C);
}

template <int NV, bool EXACT>
__device__ __forceinline__ void row_stats(float2 (&v)[NV], float& mu,
                                          float& rs, float eps, int nv,
                                          float invC, int lane, int C) {
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (live2<EXACT>(i, nv, lane, C)) sum += v[i].x + v[i].y;
  mu = warp_sum(sum) * invC;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (live2<EXACT>(i, nv, lane, C)) {
      const float d0 = v[i].x - mu, d1 = v[i].y - mu;
      sq += d0 * d0 + d1 * d1;
    }
  }
  rs = rsqrtf(warp_sum(sq) * invC + eps);
}

// dx of y = xhat * scale + bias given dy (`_ln_bwd_f32`): gv holds dy on
// entry and dx on return; xh holds xhat.
template <int NV, bool EXACT>
__device__ __forceinline__ void ln_bwd_row(float2 (&gv)[NV],
                                           const float2 (&xh)[NV],
                                           const float* __restrict__ scale,
                                           float rs, int lane, int nv,
                                           float invC, int C) {
  float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (live2<EXACT>(i, nv, lane, C)) {
      const int c = lane * 2 + 64 * i;
      gv[i].x *= scale[c];
      gv[i].y *= scale[c + 1];
      m1 += gv[i].x + gv[i].y;
      m2 += gv[i].x * xh[i].x + gv[i].y * xh[i].y;
    }
  }
  m1 = warp_sum(m1) * invC;
  m2 = warp_sum(m2) * invC;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    gv[i].x = (gv[i].x - m1 - xh[i].x * m2) * rs;
    gv[i].y = (gv[i].y - m1 - xh[i].y * m2) * rs;
  }
}

// the block's per-lane sums -> part[k * C + c], its warps added in order
// (red: LN_WARPS * 64 NV floats of shared memory)
template <int NV, int NVEC, bool EXACT>
__device__ __forceinline__ void flush_vec_sums(const float2 (&acc)[NVEC][NV],
                                               float* red, float* part,
                                               int C, int nv, int warp,
                                               int lane) {
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (live2<EXACT>(i, nv, lane, C))
        *reinterpret_cast<float2*>(red + warp * C + lane * 2 + 64 * i) =
            acc[k][i];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += LN_WARPS * 32) {
      float v = red[c];
      for (int w = 1; w < LN_WARPS; ++w) v += red[w * C + c];
      part[k * C + c] = v;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// LN1 backward: o = s32 + m, g -> do32 (fp32), dm = bf16(do32); the
// block's sums of g * xhat1, g and do32 (ds1, db1n, dbw2) -> part[block][3][C]
template <int NV, bool EXACT>
__global__ void __launch_bounds__(LN_WARPS * 32)
    epi_bwd_ln1_kernel(const float* __restrict__ s32,
                       const bf16* __restrict__ m, const bf16* __restrict__ g,
                       const float* __restrict__ s1, bf16* __restrict__ dm,
                       float* __restrict__ do32, float* __restrict__ part,
                       int R, int C, float eps) {
  __shared__ __align__(16) float red[LN_WARPS * 64 * NV];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = EXACT ? NV : (C + 63) >> 6;
  const float invC = 1.0f / C;
  float2 acc[3][NV];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[k][i] = make_float2(0.0f, 0.0f);
  for (int r = blockIdx.x * LN_WARPS + warp; r < R;
       r += gridDim.x * LN_WARPS) {
    const long long base = (long long)r * C;
    float2 o[NV], gv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      o[i] = gv[i] = make_float2(0.0f, 0.0f);
      if (live2<EXACT>(i, nv, lane, C)) {
        const int c = lane * 2 + 64 * i;
        const float2 sv = *reinterpret_cast<const float2*>(s32 + base + c);
        const float2 mv = ld_bf2(m + base + c);
        o[i] = make_float2(sv.x + mv.x, sv.y + mv.y);
        gv[i] = ld_bf2(g + base + c);
      }
    }
    float mu, rs;
    row_stats<NV, EXACT>(o, mu, rs, eps, nv, invC, lane, C);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      o[i].x = (o[i].x - mu) * rs;  // xhat1
      o[i].y = (o[i].y - mu) * rs;
      acc[0][i].x += gv[i].x * o[i].x;
      acc[0][i].y += gv[i].y * o[i].y;
      acc[1][i].x += gv[i].x;
      acc[1][i].y += gv[i].y;
    }
    ln_bwd_row<NV, EXACT>(gv, o, s1, rs, lane, nv, invC, C);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live2<EXACT>(i, nv, lane, C)) {
        const int c = lane * 2 + 64 * i;
        *reinterpret_cast<float2*>(do32 + base + c) = gv[i];
        *reinterpret_cast<__nv_bfloat162*>(dm + base + c) =
            __floats2bfloat162_rn(gv[i].x, gv[i].y);
        acc[2][i].x += gv[i].x;
        acc[2][i].y += gv[i].y;
      }
    }
  }
  flush_vec_sums<NV, 3, EXACT>(acc, red, part + (long long)blockIdx.x * 3 * C,
                               C, nv, warp, lane);
}

// LN2 backward of dn2 with the recomputed xhat2 / rsig2 of s32;
// ds = do32 + that -> ds (row r, unshifted) and, with dy, dy at the
// shifted row (the gradient of y as K1 left it); the block's sums of dn2 *
// xhat2 and dn2 (ds2, db2) -> part[block][2][C]
template <int NV, bool EXACT>
__global__ void __launch_bounds__(LN_WARPS * 32)
    epi_bwd_ln2_kernel(const float* __restrict__ s32,
                       const float* __restrict__ dn2,
                       const float* __restrict__ do32,
                       const float* __restrict__ s2, bf16* __restrict__ ds,
                       bf16* __restrict__ dy, float* __restrict__ part, int R,
                       int C, int H, int W, int shift, float eps) {
  __shared__ __align__(16) float red[LN_WARPS * 64 * NV];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = EXACT ? NV : (C + 63) >> 6;
  const float invC = 1.0f / C;
  float2 acc[2][NV];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[k][i] = make_float2(0.0f, 0.0f);
  for (int r = blockIdx.x * LN_WARPS + warp; r < R;
       r += gridDim.x * LN_WARPS) {
    const long long base = (long long)r * C;
    float2 xh[NV], gv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xh[i] = gv[i] = make_float2(0.0f, 0.0f);
      if (live2<EXACT>(i, nv, lane, C)) {
        const int c = lane * 2 + 64 * i;
        xh[i] = *reinterpret_cast<const float2*>(s32 + base + c);
        gv[i] = *reinterpret_cast<const float2*>(dn2 + base + c);
      }
    }
    float mu, rs;
    row_stats<NV, EXACT>(xh, mu, rs, eps, nv, invC, lane, C);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xh[i].x = (xh[i].x - mu) * rs;
      xh[i].y = (xh[i].y - mu) * rs;
      acc[0][i].x += gv[i].x * xh[i].x;
      acc[0][i].y += gv[i].y * xh[i].y;
      acc[1][i].x += gv[i].x;
      acc[1][i].y += gv[i].y;
    }
    ln_bwd_row<NV, EXACT>(gv, xh, s2, rs, lane, nv, invC, C);
    long long ybase = base;
    if (dy && shift) {
      const int w = r % W, h = (r / W) % H, bt = r / (W * H);
      const int hs = h - shift < 0 ? h - shift + H : h - shift;
      const int wsrc = w - shift < 0 ? w - shift + W : w - shift;
      ybase = ((long long)(bt * H + hs) * W + wsrc) * C;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live2<EXACT>(i, nv, lane, C)) {
        const int c = lane * 2 + 64 * i;
        const float2 d = *reinterpret_cast<const float2*>(do32 + base + c);
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(d.x + gv[i].x, d.y + gv[i].y);
        *reinterpret_cast<__nv_bfloat162*>(ds + base + c) = v;
        if (dy) *reinterpret_cast<__nv_bfloat162*>(dy + ybase + c) = v;
      }
    }
  }
  flush_vec_sums<NV, 2, EXACT>(acc, red, part + (long long)blockIdx.x * 2 * C,
                               C, nv, warp, lane);
}

template <int NV>
cudaError_t launch_bwd_rows(int blocks, cudaStream_t s, bool first,
                            const float* s32, const bf16* m, const bf16* g,
                            const float* scale, bf16* dm, float* do32,
                            const float* dn2, bf16* ds, bf16* dy, float* part,
                            int R, int C, int H, int W, int shift,
                            float eps) {
  const bool exact = C == 64 * NV;
  if (first && exact)
    epi_bwd_ln1_kernel<NV, true><<<blocks, LN_WARPS * 32, 0, s>>>(
        s32, m, g, scale, dm, do32, part, R, C, eps);
  else if (first)
    epi_bwd_ln1_kernel<NV, false><<<blocks, LN_WARPS * 32, 0, s>>>(
        s32, m, g, scale, dm, do32, part, R, C, eps);
  else if (exact)
    epi_bwd_ln2_kernel<NV, true><<<blocks, LN_WARPS * 32, 0, s>>>(
        s32, dn2, do32, scale, ds, dy, part, R, C, H, W, shift, eps);
  else
    epi_bwd_ln2_kernel<NV, false><<<blocks, LN_WARPS * 32, 0, s>>>(
        s32, dn2, do32, scale, ds, dy, part, R, C, H, W, shift, eps);
  return cudaGetLastError();
}

// K6's row pass (LN1's with `first`, else LN2's) at any C % 8: a warp a
// row templated on the next of 128, 256, 512, 1024 channels, else a block
// a row. Its vector sums (3 with `first`, else 2) -> vec[k], each over the
// blocks' partial rows (part: `blocks` x 3 x C floats) in order.
cudaError_t bwd_rows(int C, int blocks, cudaStream_t s, bool first,
                     const float* s32, const bf16* m, const bf16* g,
                     const float* scale, bf16* dm, float* do32,
                     const float* dn2, bf16* ds, bf16* dy, float* part,
                     float* const* vec, int R, int H, int W, int shift,
                     float eps) {
  if (C <= 0 || C % 8) return cudaErrorInvalidValue;
  cudaError_t err;
  if (C <= 128)
    err = launch_bwd_rows<2>(blocks, s, first, s32, m, g, scale, dm, do32,
                             dn2, ds, dy, part, R, C, H, W, shift, eps);
  else if (C <= 256)
    err = launch_bwd_rows<4>(blocks, s, first, s32, m, g, scale, dm, do32,
                             dn2, ds, dy, part, R, C, H, W, shift, eps);
  else if (C <= 512)
    err = launch_bwd_rows<8>(blocks, s, first, s32, m, g, scale, dm, do32,
                             dn2, ds, dy, part, R, C, H, W, shift, eps);
  else if (C <= 1024)
    err = launch_bwd_rows<16>(blocks, s, first, s32, m, g, scale, dm, do32,
                              dn2, ds, dy, part, R, C, H, W, shift, eps);
  else {
    if (first)
      k6wide::ln1_bwd_kernel<bf16><<<blocks, k6wide::THREADS, 0, s>>>(
          s32, m, g, scale, dm, do32, part, R, C, eps);
    else
      k6wide::ln2_bwd_kernel<bf16><<<blocks, k6wide::THREADS, 0, s>>>(
          s32, dn2, do32, scale, ds, dy, part, R, C, H, W, shift, eps);
    err = cudaGetLastError();
  }
  const int nvec = first ? 3 : 2;
  for (int k = 0; k < nvec && err == cudaSuccess; ++k)
    err = sum_parts_cols(part + k * C, blocks, (long long)nvec * C, C,
                         vec[k], s);
  return err;
}

// K6's workspace (`stswin_block_epilogue_bwd_work` floats), one region
// reused by its steps in stream order: the row passes' partials, db1's
// per-row-tile partials, the weight gradients' row splits.
constexpr int ROW_BLOCKS = 1056;
inline int k6_row_blocks(int R) {
  const int b = (R + LN_WARPS - 1) / LN_WARPS;
  return b < 1 ? 1 : (b > ROW_BLOCKS ? ROW_BLOCKS : b);
}
size_t k6_work(int R, int C, int hidden) {
  size_t w = size_t(k6_row_blocks(R)) * 3 * C;
  const size_t cols = size_t((R + 127) / 128) * hidden;
  const size_t w1 = wgrad_sm90_work(R, hidden, C),
               w2 = wgrad_sm90_work(R, C, hidden);
  w = w > cols ? w : cols;
  w = w > w1 ? w : w1;
  return w > w2 ? w : w2;
}

}  // namespace

// x, y, out: (BT, H, W, C) bf16 (y in the shifted layout when shift > 0);
// s2/b2, s1/b1n, b1, bw2: fp32; w1: (hidden, C), w2: (C, hidden) bf16;
// scratch: s32 (rows, C) fp32, n2 (rows, C) bf16, hid (rows, hidden) bf16.
extern "C" int stswin_block_epilogue(
    const void* x, const void* y, const void* s2, const void* b2,
    const void* w1, const void* b1, const void* w2, const void* bw2,
    const void* s1, const void* b1n, void* s32, void* n2, void* hid,
    void* out, void* m_out, int BT, int H, int W, int C, int hidden,
    int shift, int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = BT * H * W;
  const int blocks = (R + LN_WARPS - 1) / LN_WARPS;
  ln_rows_kernel<true><<<blocks, LN_WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), nullptr,
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<float*>(s32), static_cast<bf16*>(n2), nullptr, R, C, H, W,
      shift, eps);
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
  err = gemm_sm90(g, EPI_BF16, s);
  if (err != cudaSuccess) return err;

  g.A = static_cast<const bf16*>(hid);
  g.lda = hidden;
  g.Wt = static_cast<const bf16*>(w2);
  g.bias = static_cast<const float*>(bw2);
  g.N = C;
  g.K = hidden;
  g.ldc = C;
  g.act = ACT_NONE;
  if (m_out) {  // m = bf16(fc2 + bias), then LN1(s + m)
    g.C = static_cast<bf16*>(m_out);
    err = gemm_sm90(g, EPI_BF16, s);
  } else {      // s += fc2 + bias in fp32
    g.Cf = static_cast<float*>(s32);
    err = gemm_sm90(g, EPI_RESID_F32, s);
  }
  if (err != cudaSuccess) return err;

  ln_rows_kernel<false><<<blocks, LN_WARPS * 32, 0, s>>>(
      nullptr, nullptr, static_cast<const bf16*>(m_out),
      static_cast<const float*>(s1),
      static_cast<const float*>(b1n), static_cast<float*>(s32),
      static_cast<bf16*>(out), nullptr, R, C, H, W, 0, eps);
  return cudaGetLastError();
}

// K6. x, g: (rows, C) bf16 unshifted (g: the gradient of `out`); y: as the
// forward took it (shifted layout when shift > 0); m_in: the forward's
// bf16 m, or null to recompute it. w1 (hidden, C), w2 (C, hidden) and
// their transposes w1_t (C, hidden), w2_t (hidden, C), bf16. Scratch:
// s32, do32, dn2 (rows, C) fp32; n2, m, dm (rows, C) bf16; h, dpre
// (rows, hidden) bf16; dgelu (rows, hidden) fp32 when m_in is null (else
// unused); work: `stswin_block_epilogue_bwd_work` floats. Outputs
// (overwritten): ds (rows, C) bf16 = dx; dy (rows, C) bf16 in y's layout
// (only when shift > 0); dw1 (hidden, C), db1, dw2 (C, hidden), dbw2, ds1,
// db1n, ds2, db2 fp32, every sum over rows in a fixed order. C % 8 == 0.
extern "C" int stswin_block_epilogue_bwd(
    const void* x, const void* y, const void* g, const void* m_in,
    const void* s2, const void* b2, const void* w1, const void* b1,
    const void* w1_t, const void* w2, const void* bw2, const void* w2_t,
    const void* s1, void* s32, void* n2, void* h, void* dgelu, void* m,
    void* dm, void* do32, void* dpre, void* dn2, void* ds, void* dy,
    void* work, void* dw1, void* db1, void* dw2, void* dbw2, void* ds1,
    void* db1n, void* ds2, void* db2, int BT, int H, int W, int C,
    int hidden, int shift, int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = BT * H * W;
  cudaError_t err;
  float* wk = static_cast<float*>(work);
  if (C <= 0 || C % 8 || !wk) return cudaErrorInvalidValue;

  // 1. s = x + unshift(y), n2 = bf16(LN2(s))
  const int blocks = (R + LN_WARPS - 1) / LN_WARPS;
  ln_rows_kernel<true><<<blocks, LN_WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), nullptr,
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<float*>(s32), static_cast<bf16*>(n2), nullptr, R, C, H, W,
      shift, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 2. without m: h = bf16(gelu(n2 @ w1^T + b1)) and gelu' (fp32), then
  // m = bf16(h @ w2^T + bw2)
  GemmParams p{};
  p.A = static_cast<const bf16*>(n2);
  p.lda = C;
  p.a_map = identity_map();
  p.Wt = static_cast<const bf16*>(w1);
  p.bias = static_cast<const float*>(b1);
  p.M = R;
  p.N = hidden;
  p.K = C;
  p.C = static_cast<bf16*>(h);
  p.ldc = hidden;
  p.c_map = identity_map();
  p.act = act;
  const bf16* m_use = static_cast<const bf16*>(m_in);
  if (!m_use) {
    if (!dgelu) return cudaErrorInvalidValue;
    p.Cf = static_cast<float*>(dgelu);
    if ((err = gemm_sm90(p, EPI_GELU_GRAD, s)) != cudaSuccess) return err;
    GemmParams q = p;
    q.A = static_cast<const bf16*>(h);
    q.lda = hidden;
    q.Wt = static_cast<const bf16*>(w2);
    q.bias = static_cast<const float*>(bw2);
    q.N = C;
    q.K = hidden;
    q.C = static_cast<bf16*>(m);
    q.Cf = nullptr;
    q.ldc = C;
    q.act = ACT_NONE;
    if ((err = gemm_sm90(q, EPI_BF16, s)) != cudaSuccess) return err;
    m_use = static_cast<const bf16*>(m);
  }

  // 3. LN1 backward -> do32, dm; ds1, db1n, dbw2
  const int row_blocks = k6_row_blocks(R);
  float* ln1_vec[] = {static_cast<float*>(ds1), static_cast<float*>(db1n),
                      static_cast<float*>(dbw2)};
  if ((err = bwd_rows(C, row_blocks, s, true, static_cast<const float*>(s32),
                      m_use, static_cast<const bf16*>(g),
                      static_cast<const float*>(s1), static_cast<bf16*>(dm),
                      static_cast<float*>(do32), nullptr, nullptr, nullptr,
                      wk, ln1_vec, R, H, W, shift, eps)) != cudaSuccess)
    return err;

  // 4. dpre = bf16(dh * gelu'(pre)), db1: gelu' from step 2 without m;
  // with m, pre and dh = dm @ w2 in one tile's registers (and h). Each is
  // the faster way for its stage (step 4 above). db1: a partial row a
  // 128-row tile, then the tiles in order
  p.C = static_cast<bf16*>(dpre);
  p.colsum = wk;
  if (!m_in) {
    p.A = static_cast<const bf16*>(dm);
    p.Wt = static_cast<const bf16*>(w2_t);
    p.bias = nullptr;
    p.Cf = nullptr;
    p.aux = static_cast<const float*>(dgelu);
    err = gemm_sm90(p, EPI_DGELU, s);
  } else {
    p.Cf = nullptr;
    p.A2 = static_cast<const bf16*>(dm);
    p.Wt2 = static_cast<const bf16*>(w2_t);
    p.C2 = static_cast<bf16*>(h);
    err = gemm_sm90(p, EPI_GELU_BWD, s);
  }
  if (err != cudaSuccess ||
      (err = sum_parts_cols(wk, (R + 127) / 128, hidden, hidden,
                            static_cast<float*>(db1), s)) != cudaSuccess)
    return err;

  // 5. dn2 = dpre @ w1 (fp32)
  GemmParams d{};
  d.A = static_cast<const bf16*>(dpre);
  d.lda = hidden;
  d.a_map = identity_map();
  d.Wt = static_cast<const bf16*>(w1_t);
  d.M = R;
  d.N = C;
  d.K = hidden;
  d.Cf = static_cast<float*>(dn2);
  d.ldc = C;
  d.c_map = identity_map();
  d.act = ACT_NONE;
  if ((err = gemm_sm90(d, EPI_F32, s)) != cudaSuccess) return err;

  // 6. LN2 backward, ds = do32 + it -> ds (and dy through the shift)
  float* ln2_vec[] = {static_cast<float*>(ds2), static_cast<float*>(db2)};
  if ((err = bwd_rows(C, row_blocks, s, false, static_cast<const float*>(s32),
                      nullptr, nullptr, static_cast<const float*>(s2), nullptr,
                      static_cast<float*>(do32),
                      static_cast<const float*>(dn2), static_cast<bf16*>(ds),
                      shift ? static_cast<bf16*>(dy) : nullptr, wk, ln2_vec,
                      R, H, W, shift, eps)) != cudaSuccess)
    return err;

  // 7. dw1 = dpre^T n2 (hidden, C), dw2 = dm^T h (C, hidden)
  WgradParams w{};
  w.A = static_cast<const bf16*>(dpre);
  w.lda = hidden;
  w.a_map = identity_map();
  w.B = static_cast<const bf16*>(n2);
  w.ldb = C;
  w.b_map = identity_map();
  w.R = R;
  w.M = hidden;
  w.N = C;
  w.Cw = static_cast<float*>(dw1);
  w.ldc = C;
  w.work = wk;
  if ((err = gemm_wgrad_sm90(w, s)) != cudaSuccess) return err;
  w.A = static_cast<const bf16*>(dm);
  w.lda = C;
  w.B = static_cast<const bf16*>(h);
  w.ldb = hidden;
  w.M = C;
  w.N = hidden;
  w.Cw = static_cast<float*>(dw2);
  w.ldc = hidden;
  return gemm_wgrad_sm90(w, s);
}

// The floats of K6's workspace (a query, not a launch).
extern "C" int stswin_block_epilogue_bwd_work(int R, int C, int hidden,
                                              long long* out) {
  *out = static_cast<long long>(k6_work(R, C, hidden));
  return 0;
}

// fc1 + bias + act -> bf16 hid, then fc2 + bias -> bf16 out: the MLP of
// rows 12 and 13, two EPI_BF16 launches of the Hopper GEMM. a, out: (R, C)
// bf16; w1 (hidden, C), w2 (C, hidden) bf16; b1, b2 fp32; hid (R, hidden)
// bf16 scratch; every matrix 16-byte aligned, C and hidden multiples of 8.
static cudaError_t mlp_gemms(const bf16* a, const bf16* w1,
                             const float* b1, const bf16* w2,
                             const float* b2, bf16* hid, bf16* out, int R,
                             int C, int hidden, int act, cudaStream_t s) {
  GemmParams g{};
  g.A = a;
  g.lda = C;
  g.a_map = identity_map();
  g.Wt = w1;
  g.bias = b1;
  g.M = R;
  g.N = hidden;
  g.K = C;
  g.C = hid;
  g.ldc = hidden;
  g.c_map = identity_map();
  g.act = act;
  cudaError_t err = gemm_sm90(g, EPI_BF16, s);
  if (err != cudaSuccess) return err;

  g.A = hid;
  g.lda = hidden;
  g.Wt = w2;
  g.bias = b2;
  g.N = C;
  g.K = hidden;
  g.C = out;
  g.ldc = C;
  g.act = ACT_NONE;
  return gemm_sm90(g, EPI_BF16, s);
}

// Row 13. x, y, sum_out, m_out: (rows, C) bf16; scale, bias, b1, b2 fp32;
// w1 (hidden, C), w2 (C, hidden) bf16. Scratch: s32 (rows, C) fp32, n
// (rows, C) bf16, hid (rows, hidden) bf16. C and hidden multiples of 8.
extern "C" int stswin_add_ln_mlp(const void* x, const void* y,
                                 const void* scale, const void* bias,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* s32,
                                 void* n, void* hid, void* sum_out,
                                 void* m_out, int R, int C, int hidden,
                                 int act, float eps, void* stream) {
  if (R <= 0 || C % 8 || hidden % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (R + LN_WARPS - 1) / LN_WARPS;
  ln_rows_kernel<true><<<blocks, LN_WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), nullptr,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(s32), static_cast<bf16*>(n),
      static_cast<bf16*>(sum_out), R, C, 1, R, 0, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return mlp_gemms(static_cast<const bf16*>(n), static_cast<const bf16*>(w1),
                   static_cast<const float*>(b1),
                   static_cast<const bf16*>(w2),
                   static_cast<const float*>(b2), static_cast<bf16*>(hid),
                   static_cast<bf16*>(m_out), R, C, hidden, act, s);
}

// Row 12. x, out: (rows, C) bf16; w1 (hidden, C), w2 (C, hidden) bf16;
// b1, b2 fp32; scratch hid (rows, hidden) bf16. C and hidden multiples of
// 8 (the Hopper GEMM's lda, ldc and N).
extern "C" int stswin_mlp(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* hid,
                          void* out, int R, int C, int hidden, int act,
                          void* stream) {
  if (R <= 0 || C % 8 || hidden % 8) return cudaErrorInvalidValue;
  return mlp_gemms(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                   static_cast<const float*>(b1),
                   static_cast<const bf16*>(w2),
                   static_cast<const float*>(b2), static_cast<bf16*>(hid),
                   static_cast<bf16*>(out), R, C, hidden, act,
                   static_cast<cudaStream_t>(stream));
}
