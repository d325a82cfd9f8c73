// The fp32 forms of K1, K2 and K3, on one fp32 GEMM, and of rows 10 and 11
// on K1's fp32 attention core: what an fp32 model serves and evaluates
// through on the card, and the forward it trains through (the backward
// forms are in fp32_train.cu, row 16's fp32 form in fp32_whole_block.cu).
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
//        fused_patch_merge (:122) -> _kernel (:41);
//   row 10 stswincl_tpu/ops/pallas_block_attention.py
//        windowed_attention_image (:128) -> _row_kernel (:44): attention on
//        the image-layout qkv (the 'pallas' route);
//   row 11 stswincl_tpu/ops/pallas_attention.py
//        fused_window_attention (:118) -> _attn_kernel (:38): attention on
//        partitioned (Bw, heads, TN, hd) q, k, v (the 'pallas_windows'
//        route).
// Their bf16 forms (block_attention.cu, epilogue.cu, patch_merge.cu) run
// bf16 operands on the tensor cores; nothing of them is shared here but the
// row map and the GELU of common.cuh.
//
// Bound on the H100. The GEMM products run as fp32 FMA on the CUDA cores,
// whose peak is 67 TFLOP/s: K1's two products at the serving stage 1 (86
// GFLOP) at least 1.28 ms, K2 (172 GFLOP) 2.57 ms, K3 (43 GFLOP) 0.64 ms.
// The attention (rows 10 and 11 at stage 1, and K1's: 10.7 GFLOP, 336 MB
// of q, k, v and output) runs on the tensor cores: the tensor cores have
// no fp32 product and one TF32 pass rounds each operand to 10 mantissa
// bits (relative error about 2^-11), which an fp32 model does not ask
// for, so every product of the attention is a 3xTF32 split (tf32x3.cuh:
// three TF32 products of the operands' high and low halves, fp32-accurate
// at a third of the TF32 rate, 164.9 TFLOP/s): 0.065 ms of products
// against 0.100 ms of bytes, so the attention is bounded by its bytes.
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
//   - the attention (`attn_f32_kernel`, the core `attn32::pairs` of
//     fp32_attention.cuh): persistent blocks of TN / 16 warps, as many as
//     the SMs hold (one at stage 1, whose pair of q, k and v in fp32 rows
//     of hd + 4 takes 198 KiB at TN 128 x hd 128; two at stage 2, 98 KiB
//     at TN 32 x hd 256), each walking its share of the (window, head)
//     pairs. A warp owns 16 query rows: mma.sync m16n8k8 tf32, three
//     passes a product, forms its 16 x TN scores in registers, where the
//     scale, + the tiled relative bias, + the window's mask for SW-MSA,
//     the row max and sum (quad shuffles), exp and the multiply by the
//     reciprocal of the sum run; P stays fp32 in those registers and is P
//     V's A fragment (the keys of a k step taken in the accumulator's
//     order), so it is never stored; the output leaves from the P V
//     accumulators. A pair's loads hide behind the pair before it: the
//     next pair's q and k are copied in while this pair's softmax and P V
//     run, its v while the next scores are formed. The three callers
//     differ only in where a (window, head, token) row lives, so the
//     kernel is one template over an address functor: K1 reads its
//     window-order qkv buffer (the identity map); row 10 gathers straight
//     from the image-layout qkv through the window partition and scatters
//     its output back to the image (no partitioned copy is formed); row 11
//     reads the head-major tensors, window b taking mask b % n_mask.
//   - K2's and K3's row passes: a warp a row, fp32 in and out: K2's
//     s = x + y read through the inverse cyclic shift and LN2(s), and
//     LN1(s + m) after fc2 has added m into s (row 8: fc2 writes m, and
//     the LN1 pass adds it); K3's 2x2 regroup in the reference chunk order
//     with the twin's single-pass variance.

#include <atomic>

#include "fp32_attention.cuh"
#include "fp32_gemm.cuh"

namespace {

// ---- the fp32 GEMM ------------------------------------------------------

std::atomic<long long> f32_gemm_launches{0};

__global__ void __launch_bounds__(F32_THREADS)
    gemm_f32_kernel(const F32Gemm p) {
  __shared__ __align__(16) F32Tile sm;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * F32_BM, n0 = blockIdx.x * F32_BN;
  const int lr = tid >> 1;  // the row of each tile this thread loads
  const bool a_row = m0 + lr < p.M, b_row = n0 + lr < p.N;
  float acc[8][8];
  f32_tile_sums(sm, p.A + (a_row ? map_row(p.a_map, m0 + lr) : 0) * p.lda,
                a_row, p.Wt + (long long)(b_row ? n0 + lr : 0) * p.K, b_row,
                p.K, acc);

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
  const dim3 grid((p.N + F32_BN - 1) / F32_BN, (p.M + F32_BM - 1) / F32_BM);
  gemm_f32_kernel<<<grid, F32_THREADS, 0, s>>>(p);
  f32_gemm_launches.fetch_add(1);
  return cudaGetLastError();
}

namespace {

// ---- the attention: K1's, row 10's and row 11's ------------------------

// Persistent blocks of one pair's TN / 16 warps (at most NT * 16
// threads: the registers a thread may use follow the block's size), each
// running pairs blockIdx.x, + gridDim.x, ... through the core's pipeline.
template <int NT, class Addr>
__global__ void __launch_bounds__(NT * 16, 1)
    attn_f32_kernel(const Addr a, const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask, int heads,
                    int total, int TN, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn32::pairs<NT>(a, blockIdx.x, total, gridDim.x, heads,
                    reinterpret_cast<float*>(smem), threadIdx.x, blockDim.x,
                    1, bias, mask, n_mask, TN, hd, scale);
}

template <int NT, class Addr>
cudaError_t launch_attn(const Addr& a, int n_windows, int heads, int TN,
                        int hd, const float* bias, const float* mask,
                        int n_mask, float scale, cudaStream_t s) {
  const size_t bytes = attn32::smem_bytes(TN, hd);
  static int optins[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!optins[dev]) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_f32_kernel<NT, Addr>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return err;
    optins[dev] = most;
  }
  if (bytes > static_cast<size_t>(optins[dev])) return cudaErrorInvalidValue;
  const int threads = TN * 2, total = n_windows * heads;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, attn_f32_kernel<NT, Addr>, threads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0 || !sm_count()) return cudaErrorInvalidConfiguration;
  const int grid = total < per_sm * sm_count() ? total : per_sm * sm_count();
  attn_f32_kernel<NT, Addr><<<grid, threads, bytes, s>>>(
      a, bias, mask, n_mask, heads, total, TN, hd, scale);
  return cudaGetLastError();
}

// softmax(q k^T * scale + bias (+ mask)) v for every (window, head) of
// n_windows windows of TN tokens, read and written through `a`; mask
// (n_mask, TN, TN) indexed by window % n_mask when n_mask > 1.
template <class Addr>
cudaError_t attention_f32(const Addr& a, int n_windows, int heads, int TN,
                          int hd, const float* bias, const float* mask,
                          int n_mask, float scale, cudaStream_t s) {
  if (TN <= 0 || TN % 16 || TN > 176 || hd <= 0 || hd % 32 || heads <= 0 ||
      n_windows < 0)
    return cudaErrorInvalidValue;
  if (n_windows == 0) return cudaSuccess;
  const float* m = n_mask > 1 ? mask : nullptr;
  switch (attn32::score_tiles(TN)) {
    case 4:
      return launch_attn<4>(a, n_windows, heads, TN, hd, bias, m, n_mask,
                            scale, s);
    case 8:
      return launch_attn<8>(a, n_windows, heads, TN, hd, bias, m, n_mask,
                            scale, s);
    case 16:
      return launch_attn<16>(a, n_windows, heads, TN, hd, bias, m, n_mask,
                             scale, s);
    default:
      return launch_attn<22>(a, n_windows, heads, TN, hd, bias, m, n_mask,
                             scale, s);
  }
}

// ---- the row passes -----------------------------------------------------

constexpr int ROW_WARPS = 8;

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
  ln_row_f32(srow, sum, g, b, out + (long long)r * C, C, eps, lane);
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

  err = attention_f32(attn32::MappedRows{qkv, attn, identity_map(), TN, hd, C},
                      B * nWin, heads, TN, hd,
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

// Row 10 fp32. qkv (B, T, H, W, 3C) fp32, out (B, T, H, W, C) fp32, both
// in the image layout (qkv already rolled for SW-MSA); bias (heads, TN, TN)
// fp32; mask (nH * nW, TN, TN) fp32, one entry per window of an image
// (index i * nW + j), when n_mask > 1. The arguments of the bf16 entry
// `stswin_window_attention_image`.
extern "C" int stswin_window_attention_image_f32(
    const void* qkv, const void* bias, const void* mask, void* out, int B,
    int T, int H, int W, int C, int heads, int ws, float scale, int n_mask,
    void* stream) {
  if (heads <= 0 || C % heads || ws <= 0 || H % ws || W % ws)
    return cudaErrorInvalidValue;
  const int TN = T * ws * ws, hd = C / heads;
  return attention_f32(
      attn32::MappedRows{static_cast<const float*>(qkv),
                         static_cast<float*>(out), RowMap{1, T, H, W, ws, 0},
                         TN, hd, C},
      B * (H / ws) * (W / ws), heads, TN, hd,
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      n_mask, scale, static_cast<cudaStream_t>(stream));
}

// Row 11 fp32. q, k, v, out: (Bw, heads, TN, hd) fp32, windows minor;
// mask (n_mask, TN, TN) fp32 indexed by window % n_mask, when n_mask > 1.
// The arguments of the bf16 entry `stswin_window_attention_heads`.
extern "C" int stswin_window_attention_heads_f32(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, void* out, int Bw, int heads, int TN, int hd,
    float scale, int n_mask, void* stream) {
  const attn32::HeadMajor a{{static_cast<const float*>(q),
                             static_cast<const float*>(k),
                             static_cast<const float*>(v)},
                            static_cast<float*>(out), heads, TN, hd};
  return attention_f32(a, Bw, heads, TN, hd, static_cast<const float*>(bias),
                       static_cast<const float*>(mask), n_mask, scale,
                       static_cast<cudaStream_t>(stream));
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
// entries of K1-K3, K5, K6 and rows 12-13 included, since the last call
// with `reset` set: out[0] the fp32 GEMM's, out[1] the fp32 weight-gradient
// GEMM's (fp32_train.cu), out[2] row 17's fp32 implicit GEMM's
// (fp32_offpath.cu); `reset` then sets the counts to 0.
extern "C" int stswin_gemm_f32_launches(long long* out, int reset) {
  out[0] = reset ? f32_gemm_launches.exchange(0) : f32_gemm_launches.load();
  out[1] = wgrad_f32_launches(reset);
  out[2] = conv_f32_launches(reset);
  return 0;
}
