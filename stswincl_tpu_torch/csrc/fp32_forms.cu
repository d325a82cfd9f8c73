// The fp32 forms of K1, K2 and K3, on one fp32 GEMM: what an fp32 model
// serves and evaluates through on the card, and the forward it trains
// through (the backward forms are in fp32_train.cu).
//
// Replaces the fp32 instances of the dtype-generic TPU kernels, which load
// x.dtype, accumulate in fp32 and store x.dtype
// (`pallas_block_attention.py:229-231`, `:274-275`):
//   K1 stswincl_tpu/ops/pallas_block_attention.py
//        fused_swin_block_attention (:320) -> _full_kernel (:179);
//   K2 stswincl_tpu/ops/pallas_add_ln_mlp.py
//        fused_swin_block_epilogue (:895) -> _epilogue_kernel (:704) and
//        fused_swin_block_epilogue_shifted (:1012) -> _epi_shifted_kernel
//        (:940), the serving form, and with its m output
//        _fused_epilogue_fwd_with_m (:802) -> _epilogue_kernel_with_m
//        (:752), Pallas row 8;
//   K3 stswincl_tpu/ops/pallas_patch_merge.py
//        fused_patch_merge (:122) -> _kernel (:41).
// Their bf16 forms (block_attention.cu, epilogue.cu, patch_merge.cu) run
// bf16 operands on the tensor cores; nothing of them is shared here but the
// row map and the GELU of common.cuh.
//
// Bound on the H100: the products. The tensor cores have no fp32 form, and
// one TF32 pass rounds each operand to 10 mantissa bits (relative error
// about 2^-11), which an fp32 model does not ask for; so every product runs
// as fp32 FMA on the CUDA cores, whose peak is 67 TFLOP/s: K1 at the
// serving stage 1 (97 GFLOP) at least 1.44 ms, K2 (172 GFLOP) 2.57 ms, K3
// (43 GFLOP) 0.64 ms. A 3xTF32 split on wgmma (three TF32 products of the
// operands' high and low halves, fp32-accurate at a third of the TF32 rate,
// 165 TFLOP/s) is later work.
//
// Design:
//   - `gemm_f32`: C[c_map(m), n] = epilogue(sum_k A[a_map(m), k] Wt[n, k] +
//     bias[n]), the products of all three. A 128 x 128 output tile a block
//     of 256 threads, 8 x 8 sums a thread (rows ty + 16 i, columns tx +
//     16 j), k tiles of 8 through a three-stage cp.async ring in shared
//     memory (rows padded to 12 floats: a quarter warp's eight 16-byte
//     reads of B fall on distinct banks, its reads of A on one address).
//     A row is read through its RowMap (the window partition with the
//     SW-MSA cyclic shift: K1's qkv gathers the unshifted clip, no rolled
//     copy is formed), its index computed once for the whole k loop; C rows
//     scatter through another (K1's proj back to the image layout). Each
//     sum runs over k in order, in fp32. Epilogues (`F32Epi`,
//     fp32_gemm.cuh): act(v) stored, v added into C (K2's residual s +
//     MLP), K6's gelu(v) and gelu'(v) from one erf evaluation, and v times
//     an aux matrix (K6's dh * gelu'). Ragged M and N are zero-filled on
//     load and masked on store; K is a multiple of 4.
//   - K1's attention (`attn_f32_kernel`): one block a (window, head), TN /
//     16 warps, q, k and v of the window in fp32 in shared memory (rows of
//     hd + 4: 198 KiB at stage 1, TN 128 x hd 128, one block an SM; 98 KiB
//     at stage 2, TN 32 x hd 256). A warp owns 16 query rows; lane l holds
//     row l % 16 against the keys of parity l / 16, its scores in
//     registers: fp32 q k^T, the scale after the product, + the tiled
//     relative bias, + the window's mask for SW-MSA, the row max and sum
//     across the two lanes of a row, exp, a multiply by the reciprocal of
//     the sum; then P V 32 columns at a time, the two lanes' halves summed
//     by one shuffle each (hd % 32 == 0). P stays fp32: nothing is rounded.
//   - K2's and K3's row passes: a warp a row, fp32 in and out: K2's
//     s = x + y read through the inverse cyclic shift and LN2(s), and
//     LN1(s + m) after fc2 has added m into s (row 8: fc2 writes m, and
//     the LN1 pass adds it); K3's 2x2 regroup in the reference chunk order
//     with the twin's single-pass variance.

#include <atomic>

#include "fp32_gemm.cuh"

namespace {

// ---- the fp32 GEMM ------------------------------------------------------

constexpr int GBM = 128, GBN = 128, GBK = 8;
constexpr int GLD = GBK + 4;  // a shared row: 8 floats + 4 of padding
constexpr int GSTAGES = 3;
constexpr int GTHREADS = 256;

std::atomic<long long> f32_gemm_launches{0};

__global__ void __launch_bounds__(GTHREADS)
    gemm_f32_kernel(const F32Gemm p) {
  __shared__ __align__(16) float As[GSTAGES][GBM][GLD];
  __shared__ __align__(16) float Bs[GSTAGES][GBN][GLD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  // the loader: row lr of each tile, the 16-byte chunk at column lc
  const int lr = tid >> 1, lc = (tid & 1) * 4;
  const bool a_row = m0 + lr < p.M, b_row = n0 + lr < p.N;
  const float* a_src =
      p.A + (a_row ? map_row(p.a_map, m0 + lr) : 0) * p.lda + lc;
  const float* b_src = p.Wt + (long long)(b_row ? n0 + lr : 0) * p.K + lc;
  const int nk = (p.K + GBK - 1) / GBK;
  auto load = [&](int stage, int kt) {
    const int k = kt * GBK;
    const bool kin = k + lc < p.K;  // K % 4 == 0: a chunk is whole or out
    cp_async16(&As[stage][lr][lc], kin ? a_src + k : a_src, a_row && kin);
    cp_async16(&Bs[stage][lr][lc], kin ? b_src + k : b_src, b_row && kin);
  };
#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < nk) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed (this thread's copies); after the barrier every
    // thread's have, and every thread is done with the stage refilled next
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // GSTAGES - 2
    __syncthreads();
    const int next = kt + GSTAGES - 1;
    if (next < nk) load(next % GSTAGES, next);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int s = kt % GSTAGES;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&As[s][ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(&Bs[s][tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = acc[i][j];
          v = fmaf(a[i].x, b[j].x, v);
          v = fmaf(a[i].y, b[j].y, v);
          v = fmaf(a[i].z, b[j].z, v);
          acc[i][j] = fmaf(a[i].w, b[j].w, v);
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
    const long long crow = map_row(p.c_map, m) * p.ldc;
    float* c = p.C + crow;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < p.N) {
        float v = acc[i][j] + (p.bias ? p.bias[n] : 0.0f);
        if (p.epi == F32_RESID) {
          c[n] += v;
        } else if (p.epi == F32_GELU_GRAD) {
          const float2 gg = gelu_and_grad(v, p.act);
          c[n] = gg.x;
          p.C2[crow + n] = gg.y;
        } else if (p.epi == F32_DGELU) {
          c[n] = v * p.aux[crow + n];
        } else {
          c[n] = activate(v, p.act);
        }
      }
    }
  }
}

}  // namespace

cudaError_t gemm_f32(const F32Gemm& p, cudaStream_t s) {
  if (p.M < 0 || p.N <= 0 || p.K <= 0 || p.K % 4 || p.lda % 4 ||
      p.epi < F32_ACT || p.epi > F32_DGELU ||
      (p.epi == F32_GELU_GRAD && (!p.C2 || p.act == ACT_NONE)) ||
      (p.epi == F32_DGELU && !p.aux))
    return cudaErrorInvalidValue;
  if (p.M == 0) return cudaSuccess;
  const dim3 grid((p.N + GBN - 1) / GBN, (p.M + GBM - 1) / GBM);
  gemm_f32_kernel<<<grid, GTHREADS, 0, s>>>(p);
  f32_gemm_launches.fetch_add(1);
  return cudaGetLastError();
}

namespace {

// ---- K1's attention -----------------------------------------------------

// keys a lane can hold: TN <= 2 KPL; the widest window, TN 176
// (`ops/attention.py` MAX_WINDOW_TOKENS), takes 88
template <int KPL>
__global__ void __launch_bounds__(352, 1)
    attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask, int heads,
                    int TN, int hd, int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bw = blockIdx.x / heads, h = blockIdx.x - bw * heads;
  const int ld = hd + 4;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + TN * ld;
  float* vs = ks + TN * ld;
  const int nthr = blockDim.x, tid = threadIdx.x;
  // q and k in one cp.async group, v in a second that lands while the
  // scores are computed
  const int chunks = hd / 4;
  const float* win = qkv + (long long)bw * TN * 3 * C + h * hd;
  for (int which = 0; which < 3; ++which) {
    for (int i = tid; i < TN * chunks; i += nthr) {
      const int r = i / chunks, c = (i - r * chunks) * 4;
      cp_async16(qs + (which * TN + r) * ld + c,
                 win + (long long)r * 3 * C + which * C + c);
    }
    if (which) asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int lane = tid & 31, half = lane >> 4;
  const int row = (tid >> 5) * 16 + (lane & 15);
  const int kpl = TN / 2;
  // s[jj]: the score of key 2 jj + half
  float s[KPL];
#pragma unroll
  for (int jj = 0; jj < KPL; ++jj) s[jj] = 0.0f;
  const float* qr = qs + row * ld;
  const float* kr = ks + half * ld;
  for (int d = 0; d < hd; d += 4) {
    const float4 q = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
    for (int jj = 0; jj < KPL; ++jj) {
      if (jj < kpl) {
        const float4 k =
            *reinterpret_cast<const float4*>(kr + 2 * jj * ld + d);
        float v = fmaf(q.x, k.x, s[jj]);
        v = fmaf(q.y, k.y, v);
        v = fmaf(q.z, k.z, v);
        s[jj] = fmaf(q.w, k.w, v);
      }
    }
  }

  const float* brow = bias + ((long long)h * TN + row) * TN + half;
  const float* mrow =
      mask ? mask + ((long long)(bw % n_mask) * TN + row) * TN + half
           : nullptr;
  float mx = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < KPL; ++jj) {
    if (jj < kpl) {
      float v = s[jj] * scale + brow[2 * jj];
      if (mrow) v += mrow[2 * jj];  // after the bias, as the twin adds them
      s[jj] = v;
      mx = fmaxf(mx, v);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
  float sum = 0.0f;
#pragma unroll
  for (int jj = 0; jj < KPL; ++jj) {
    if (jj < kpl) {
      s[jj] = expf(s[jj] - mx);
      sum += s[jj];
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 16);
  const float inv = 1.0f / sum;
#pragma unroll
  for (int jj = 0; jj < KPL; ++jj) s[jj] *= inv;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // v has landed

  // o = P V, 32 columns at a time: each lane sums over its parity's keys,
  // then lane half 0 keeps columns 0-15 and half 1 columns 16-31, each the
  // sum of its own and its partner's (lane ^ 16) partial sums
  float* dst = out + ((long long)bw * TN + row) * C + h * hd + 16 * half;
  const float* vr = vs + half * ld;
  for (int c0 = 0; c0 < hd; c0 += 32) {
    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KPL; ++jj) {
      if (jj < kpl) {
        const float pj = s[jj];
        const float* v = vr + 2 * jj * ld + c0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(v + 4 * i);
          o[4 * i] = fmaf(pj, vv.x, o[4 * i]);
          o[4 * i + 1] = fmaf(pj, vv.y, o[4 * i + 1]);
          o[4 * i + 2] = fmaf(pj, vv.z, o[4 * i + 2]);
          o[4 * i + 3] = fmaf(pj, vv.w, o[4 * i + 3]);
        }
      }
    }
    float mine[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float keep = half ? o[16 + e] : o[e];
      const float send = half ? o[e] : o[16 + e];
      mine[e] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + c0 + 4 * i) = make_float4(
          mine[4 * i], mine[4 * i + 1], mine[4 * i + 2], mine[4 * i + 3]);
  }
}

// The shared memory of a (window, head) block: q, k and v in rows of
// hd + 4 floats (`ops/attention.py` `_attn_f32_smem_bytes`).
size_t attn_f32_smem(int TN, int hd) {
  return align128(size_t(3) * TN * (hd + 4) * sizeof(float));
}

template <int KPL>
cudaError_t launch_attn(const float* qkv, float* out, int n_windows,
                        int heads, int TN, int hd, int C, const float* bias,
                        const float* mask, int n_mask, float scale,
                        cudaStream_t s) {
  const size_t bytes = attn_f32_smem(TN, hd);
  static int optins[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!optins[dev]) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_f32_kernel<KPL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return err;
    optins[dev] = most;
  }
  if (bytes > static_cast<size_t>(optins[dev])) return cudaErrorInvalidValue;
  attn_f32_kernel<KPL><<<n_windows * heads, TN * 2, bytes, s>>>(
      qkv, out, bias, mask, n_mask, heads, TN, hd, C, scale);
  return cudaGetLastError();
}

// softmax(q k^T * scale + bias (+ mask)) v for every (window, head) of the
// window-order qkv rows (rows of 3C) into window-order rows of C.
cudaError_t attention_f32(const float* qkv, float* out, int n_windows,
                          int heads, int TN, int hd, int C,
                          const float* bias, const float* mask, int n_mask,
                          float scale, cudaStream_t s) {
  if (TN <= 0 || TN % 16 || TN > 176 || hd <= 0 || hd % 32)
    return cudaErrorInvalidValue;
  const float* m = n_mask > 1 ? mask : nullptr;
  if (TN <= 32)
    return launch_attn<16>(qkv, out, n_windows, heads, TN, hd, C, bias, m,
                           n_mask, scale, s);
  if (TN <= 64)
    return launch_attn<32>(qkv, out, n_windows, heads, TN, hd, C, bias, m,
                           n_mask, scale, s);
  if (TN <= 128)
    return launch_attn<64>(qkv, out, n_windows, heads, TN, hd, C, bias, m,
                           n_mask, scale, s);
  return launch_attn<88>(qkv, out, n_windows, heads, TN, hd, C, bias, m,
                         n_mask, scale, s);
}

// ---- the row passes -----------------------------------------------------

constexpr int ROW_WARPS = 8;

__device__ __forceinline__ float sum4(float4 v) {
  return v.x + v.y + v.z + v.w;
}

// K2's LayerNorms, two-pass (`layer_norm_f32`). ADD: s = x[r] + y[unshift
// (r)] is written to s32 and normalised; else the row of s32 is, after
// s32 += m where m is given (row 8: LN1 of s + the saved m). C % 4 == 0.
template <bool ADD>
__global__ void __launch_bounds__(ROW_WARPS * 32)
    ln_rows_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ m,
                       const float* __restrict__ g,
                       const float* __restrict__ b, float* __restrict__ s32,
                       float* __restrict__ out, int R, int C, int H, int W,
                       int shift, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + warp;
  if (r >= R) return;
  float* srow = s32 + (long long)r * C;
  float sum = 0.0f;
  if (ADD) {
    const int w = r % W, h = (r / W) % H, bt = r / (W * H);
    const int hs = h - shift < 0 ? h - shift + H : h - shift;
    const int wsrc = w - shift < 0 ? w - shift + W : w - shift;
    const float* xr = x + (long long)r * C;
    const float* yr = y + ((long long)(bt * H + hs) * W + wsrc) * C;
    for (int c = lane * 4; c < C; c += 128) {
      const float4 xv = ld4(xr + c), yv = ld4(yr + c);
      const float4 sv =
          make_float4(xv.x + yv.x, xv.y + yv.y, xv.z + yv.z, xv.w + yv.w);
      *reinterpret_cast<float4*>(srow + c) = sv;
      sum += sum4(sv);
    }
  } else if (m) {
    const float* mrow = m + (long long)r * C;
    for (int c = lane * 4; c < C; c += 128) {
      const float4 sv = ld4(srow + c), mv = ld4(mrow + c);
      const float4 ov =
          make_float4(sv.x + mv.x, sv.y + mv.y, sv.z + mv.z, sv.w + mv.w);
      *reinterpret_cast<float4*>(srow + c) = ov;
      sum += sum4(ov);
    }
  } else {
    for (int c = lane * 4; c < C; c += 128) sum += sum4(ld4(srow + c));
  }
  const float mu = warp_sum(sum) / C;
  float sq = 0.0f;
  for (int c = lane * 4; c < C; c += 128) {
    const float4 v = ld4(srow + c);
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
  }
  const float rs = rsqrtf(warp_sum(sq) / C + eps);
  float* orow = out + (long long)r * C;
  for (int c = lane * 4; c < C; c += 128) {
    const float4 v = ld4(srow + c);
    *reinterpret_cast<float4*>(orow + c) = make_float4(
        (v.x - mu) * rs * g[c] + b[c], (v.y - mu) * rs * g[c + 1] + b[c + 1],
        (v.z - mu) * rs * g[c + 2] + b[c + 2],
        (v.w - mu) * rs * g[c + 3] + b[c + 3]);
  }
}

// K3's LayerNorm over the 2x2 regroup [x0 | x1 | x2 | x3] (x0 = (2i, 2j),
// x1 = (2i+1, 2j), x2 = (2i, 2j+1), x3 = (2i+1, 2j+1)), the single-pass
// variance of `patch_merge_ref`; the row is read twice (the second time
// from L1 / L2). C % 4 == 0.
__global__ void __launch_bounds__(ROW_WARPS * 32)
    patch_merge_ln_f32_kernel(const float* __restrict__ x,
                              const float* __restrict__ g,
                              const float* __restrict__ b,
                              float* __restrict__ n, int BT, int H, int W,
                              int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H2 = H / 2, W2 = W / 2;
  const long long R = (long long)BT * H2 * W2;
  const long long ro = (long long)blockIdx.x * ROW_WARPS + warp;
  if (ro >= R) return;
  const int j = ro % W2, i = (ro / W2) % H2;
  const long long bt = ro / ((long long)W2 * H2);
  const float* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int di = q & 1, dj = q >> 1;
    src[q] = x + ((bt * H + 2 * i + di) * W + 2 * j + dj) * C;
  }
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = ld4(src[q] + c);
      sum += sum4(v);
      sq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  const float inv_n = 1.0f / (4 * C);
  const float mu = warp_sum(sum) * inv_n;
  const float var = warp_sum(sq) * inv_n - mu * mu;
  const float rs = rsqrtf(var + eps);
  float* out = n + ro * 4 * C;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = ld4(src[q] + c);
      const int k = q * C + c;
      *reinterpret_cast<float4*>(out + k) = make_float4(
          (v.x - mu) * rs * g[k] + b[k], (v.y - mu) * rs * g[k + 1] + b[k + 1],
          (v.z - mu) * rs * g[k + 2] + b[k + 2],
          (v.w - mu) * rs * g[k + 3] + b[k + 3]);
    }
}

}  // namespace

F32Gemm plain_gemm(const float* A, int lda, const float* Wt,
                   const float* bias, int M, int N, int K, float* C, int ldc,
                   int act) {
  F32Gemm g{};
  g.A = A;
  g.lda = lda;
  g.a_map = identity_map();
  g.Wt = Wt;
  g.bias = bias;
  g.M = M;
  g.N = N;
  g.K = K;
  g.C = C;
  g.ldc = ldc;
  g.c_map = identity_map();
  g.act = act;
  g.epi = F32_ACT;
  return g;
}

cudaError_t ln_rows_add_f32(const float* x, const float* y, const float* g,
                            const float* b, float* s32, float* out, int R,
                            int C, int H, int W, int shift, float eps,
                            cudaStream_t s) {
  if (C % 4) return cudaErrorInvalidValue;
  const int blocks = (R + ROW_WARPS - 1) / ROW_WARPS;
  ln_rows_f32_kernel<true><<<blocks, ROW_WARPS * 32, 0, s>>>(
      x, y, nullptr, g, b, s32, out, R, C, H, W, shift, eps);
  return cudaGetLastError();
}

// K1 fp32. x: (B, T, H, W, C) fp32, unshifted; wqkv (3C, C), wproj (C, C)
// fp32; bqkv, bproj, bias (heads, TN, TN) and mask (n_mask, TN, TN) fp32.
// Scratch: qkv_buf (rows, 3C), attn_buf (rows, C) fp32, window order. out:
// (B, T, H, W, C) fp32, in the shifted layout when shift > 0.
extern "C" int stswin_block_attention_f32(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* bias, const void* mask, void* qkv_buf,
    void* attn_buf, void* out, int B, int T, int H, int W, int C, int heads,
    int ws, float scale, int shift, int n_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T * H * W, hd = C / heads, TN = T * ws * ws;
  const int nWin = (H / ws) * (W / ws);
  float* qkv = static_cast<float*>(qkv_buf);
  float* attn = static_cast<float*>(attn_buf);

  F32Gemm g = plain_gemm(static_cast<const float*>(x), C,
                         static_cast<const float*>(wqkv),
                         static_cast<const float*>(bqkv), M, 3 * C, C, qkv,
                         3 * C, ACT_NONE);
  g.a_map = RowMap{1, T, H, W, ws, shift};  // the shifted window partition
  cudaError_t err = gemm_f32(g, s);
  if (err != cudaSuccess) return err;

  err = attention_f32(qkv, attn, B * nWin, heads, TN, hd, C,
                      static_cast<const float*>(bias),
                      static_cast<const float*>(mask), n_mask, scale, s);
  if (err != cudaSuccess) return err;

  g = plain_gemm(attn, C, static_cast<const float*>(wproj),
                 static_cast<const float*>(bproj), M, C, C,
                 static_cast<float*>(out), C, ACT_NONE);
  g.c_map = RowMap{1, T, H, W, ws, 0};  // window order -> (shifted) image
  return gemm_f32(g, s);
}

// K2 fp32: the serving form, and with `m_out` Pallas row 8 (the training
// forward that saves m, `_fused_epilogue_fwd_with_m`). x, y: (BT, H, W, C)
// rows fp32 (y in the shifted layout when shift > 0); w1 (hidden, C), w2
// (C, hidden) fp32; the vectors fp32. Scratch: s32, n2 (rows, C), hid
// (rows, hidden) fp32. out: (rows, C) fp32, unshifted; m_out (rows, C)
// fp32 or null: fc2 + bias written to it (in fp32 the "rounding" of m is
// the identity), then LN1 of s + m, `_epilogue_kernel_with_m`'s order
// (`pallas_add_ln_mlp.py:752-799`).
extern "C" int stswin_block_epilogue_f32(
    const void* x, const void* y, const void* s2, const void* b2,
    const void* w1, const void* b1, const void* w2, const void* bw2,
    const void* s1, const void* b1n, void* s32, void* n2, void* hid,
    void* out, void* m_out, int BT, int H, int W, int C, int hidden,
    int shift, int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 || hidden % 4) return cudaErrorInvalidValue;
  const int R = BT * H * W;
  const int blocks = (R + ROW_WARPS - 1) / ROW_WARPS;
  float* s32p = static_cast<float*>(s32);
  float* n2p = static_cast<float*>(n2);
  float* hidp = static_cast<float*>(hid);
  float* mp = static_cast<float*>(m_out);
  cudaError_t err = ln_rows_add_f32(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(s2), static_cast<const float*>(b2), s32p,
      n2p, R, C, H, W, shift, eps, s);
  if (err != cudaSuccess) return err;

  F32Gemm g = plain_gemm(n2p, C, static_cast<const float*>(w1),
                         static_cast<const float*>(b1), R, hidden, C, hidp,
                         hidden, act);
  err = gemm_f32(g, s);
  if (err != cudaSuccess) return err;
  g = plain_gemm(hidp, hidden, static_cast<const float*>(w2),
                 static_cast<const float*>(bw2), R, C, hidden,
                 mp ? mp : s32p, C, ACT_NONE);
  // serving: s += fc2 + bias, the fp32 MLP sum unrounded; row 8: m = it
  if (!mp) g.epi = F32_RESID;
  err = gemm_f32(g, s);
  if (err != cudaSuccess) return err;

  ln_rows_f32_kernel<false><<<blocks, ROW_WARPS * 32, 0, s>>>(
      nullptr, nullptr, mp, static_cast<const float*>(s1),
      static_cast<const float*>(b1n), s32p, static_cast<float*>(out), R, C,
      H, W, 0, eps);
  return cudaGetLastError();
}

// K3 fp32. x: (BT, H, W, C) fp32, H and W even, C % 4 == 0; scale, bias
// (4C) fp32; w (2C, 4C) fp32; n_buf (rows, 4C) fp32 scratch; out (BT, H/2,
// W/2, 2C) fp32.
extern "C" int stswin_patch_merge_f32(const void* x, const void* scale,
                                      const void* bias, const void* w,
                                      void* n_buf, void* out, int BT, int H,
                                      int W, int C, float eps, void* stream) {
  if (BT <= 0 || H < 2 || W < 2 || H % 2 || W % 2 || C <= 0 || C % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = (long long)BT * (H / 2) * (W / 2);
  const unsigned blocks =
      static_cast<unsigned>((R + ROW_WARPS - 1) / ROW_WARPS);
  float* np = static_cast<float*>(n_buf);
  patch_merge_ln_f32_kernel<<<blocks, ROW_WARPS * 32, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), np, BT, H, W, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemm_f32(plain_gemm(np, 4 * C, static_cast<const float*>(w),
                             nullptr, static_cast<int>(R), 2 * C, 4 * C,
                             static_cast<float*>(out), 2 * C, ACT_NONE),
                  s);
}

// The fp32 GEMM alone (`ops/gemm.linear_f32`): C[c_map(m)] = the epilogue
// `epi` (F32Epi) of A[a_map(m)] @ Wt^T + bias, with C2 and aux the second
// output and input of F32_GELU_GRAD and F32_DGELU (else null). The row
// maps (mode 1: the window partition over (T, H, W, ws) with its shift)
// share the grid.
extern "C" int stswin_gemm_f32(const void* A, const void* Wt,
                               const void* bias, void* C, void* C2,
                               const void* aux, int M, int N, int K,
                               int lda, int ldc, int act, int epi,
                               int a_mode, int c_mode, int T, int H, int W,
                               int ws, int a_shift, int c_shift,
                               void* stream) {
  F32Gemm g = plain_gemm(static_cast<const float*>(A), lda,
                         static_cast<const float*>(Wt),
                         static_cast<const float*>(bias), M, N, K,
                         static_cast<float*>(C), ldc, act);
  g.epi = epi;
  g.C2 = static_cast<float*>(C2);
  g.aux = static_cast<const float*>(aux);
  if (a_mode) g.a_map = RowMap{1, T, H, W, ws, a_shift};
  if (c_mode) g.c_map = RowMap{1, T, H, W, ws, c_shift};
  return gemm_f32(g, static_cast<cudaStream_t>(stream));
}

// The fp32 GEMMs' launches (a query, not a launch), those inside the fp32
// entries of K1-K3, K5 and K6 included, since the last call with `reset`
// set: out[0] the fp32 GEMM's, out[1] the fp32 weight-gradient GEMM's
// (fp32_train.cu); `reset` then sets the counts to 0.
extern "C" int stswin_gemm_f32_launches(long long* out, int reset) {
  out[0] = reset ? f32_gemm_launches.exchange(0) : f32_gemm_launches.load();
  out[1] = wgrad_f32_launches(reset);
  return 0;
}
