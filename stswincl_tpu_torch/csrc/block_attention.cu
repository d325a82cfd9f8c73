// K1: the swin block's attention sub-block, qkv -> joint space-time window
// attention -> proj, on the image-layout clip (B, T, H, W, C).
//
// Replaces: stswincl_tpu/ops/pallas_block_attention.py
//   fused_swin_block_attention (:320) -> _full_kernel (:179).
//
// Bound on the H100: the two projections are tensor-core GEMMs
// (2 * rows * C * 4C flops); the attention core is small per window
// (TN = 128, hd = 128 at stage 1; TN = 32, hd = 256 at stage 2) and is
// bound by shared-memory traffic and the fp32 softmax, not by device
// memory, as long as the score matrix never leaves the SM.
//
// Design: three launches on one stream.
//   1. qkv on the Hopper GEMM (gemm_sm90.cu: wgmma, Wt by TMA) whose A
//      rows come through the window partition and the SW-MSA cyclic
//      shift: the producer warp loads each whole window as one 4-D TMA
//      box, and only the tiles holding a window the shift wraps round the
//      image edge by cp.async. The rolled, partitioned tensor is never
//      formed; qkv lands in window order.
//   2. the register-resident attention core shared with the standalone
//      attention kernels (window_attention.cu, `window_attention_rows` on
//      the window-order qkv): q, k and v of a (window, head) in shared
//      memory, each warp's 16 query rows of scores, softmax and P in
//      registers. Scores use the JAX package's softmax contract: fp32
//      scale after the matmul, + tiled relative bias, + the window's mask
//      only for SW-MSA, row max, exp, and a multiply by the reciprocal of
//      the row sum.
//   3. proj on the Hopper GEMM (A by TMA) whose C rows scatter back to
//      the image layout; with
//      shift > 0 the output stays in the shifted layout, as in the TPU
//      kernel, and K2 reads it back through the inverse shift.
//
// K5 (`stswin_block_attention_bwd`, below): the backward of the same
// sub-block.
//
// Replaces: stswincl_tpu/ops/pallas_block_attention.py
//   fused_swin_block_attention_bwd (:547) -> _full_bwd_kernel (:405), and
//   the two rolls `_fsba_bwd` (:640-646) puts around it for SW blocks.
//
// Bound: the same GEMM flops as the forward twice over (input and weight
// gradients) plus, per (window, head), five TN x TN x hd products; the
// weight gradients reduce over every token row. The design keeps the
// forward's window-ordered qkv and pre-proj attention (saved by the
// autograd Function, 4C bf16 per token) instead of recomputing the qkv
// GEMM as the TPU kernel does, and launches:
//   1. dattn = g @ wproj, g gathered from the (shifted) image layout by
//      the same row map the forward's proj scattered with;
//   2. one block per (window, head): recompute P (fp32) from q, k, then
//      dV = P^T dO, dP = dO V^T (twice: once for the row sums of dP * P,
//      once to form dS = P * (dP - rowsum) in place of P), dbias += dS by
//      fp32 atomics, dQ = dS K * scale, dK = dS^T Q * scale. Shared
//      memory is reused so the fp32 P / dS buffer, q, k, dO and one bf16
//      buffer (P, then V, then dS) fit: 211 KB at stage 1;
//   3. dx = dqkv @ wqkv scattered back through the row map with the
//      shift, so dx lands unshifted and no roll is formed;
//   4. dwqkv = dqkv^T x, dwproj = g^T attn (split-K weight-gradient GEMM,
//      fp32), and the bias gradients as fp32 column sums.

#include <mma.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

using namespace nvcuda;

namespace {

struct AttnBwdSmem {
  int ldq, ldf, ldb;
  size_t q, k, d, f, b, st, dr, total;
};

// q, k, dO (TN x hd bf16); f: fp32 TN x TN (P, then dS); b: bf16 buffer
// of P, then V, then dS; st: per-warp 16x16 fp32 staging; dr: row sums.
__host__ __device__ inline AttnBwdSmem attn_bwd_smem(int TN, int hd) {
  AttnBwdSmem m;
  m.ldq = hd + 8;
  m.ldf = TN + 4;
  m.ldb = (hd > TN ? hd : TN) + 8;
  const size_t qkv = align128(size_t(TN) * m.ldq * sizeof(bf16));
  m.q = 0;
  m.k = qkv;
  m.d = 2 * qkv;
  m.f = 3 * qkv;
  m.b = m.f + align128(size_t(TN) * m.ldf * sizeof(float));
  m.st = m.b + align128(size_t(TN) * m.ldb * sizeof(bf16));
  m.dr = m.st + align128(ATT_WARPS * 256 * sizeof(float));
  m.total = m.dr + align128(size_t(TN) * sizeof(float));
  return m;
}

// Store a warp's 16x16 fp32 fragment (times `mul`) as bf16 into rows
// [row0, row0 + 16) and columns [col0, col0 + 16) of a row-major matrix.
__device__ __forceinline__ void store_tile_bf16(
    float* st, const wmma::fragment<wmma::accumulator, 16, 16, 16, float>& acc,
    bf16* out, long long ld, int row0, int col0, float mul, int lane) {
  wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(st[r * 16 + c0 + e] * mul);
  *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * ld + col0 + c0) =
      *reinterpret_cast<const uint4*>(o);
  __syncwarp();
}

// qkv: (B * nWin * TN, 3C) bf16 window order (the forward's); dattn:
// (B * nWin * TN, C) bf16 window order; dqkv: (B * nWin * TN, 3C) out;
// dbias: (heads, TN, TN) fp32, accumulated.
__global__ void __launch_bounds__(ATT_THREADS)
    window_attention_bwd_kernel(const bf16* __restrict__ qkv,
                                const bf16* __restrict__ dattn,
                                const float* __restrict__ bias,
                                const float* __restrict__ mask, int n_mask,
                                bf16* __restrict__ dqkv,
                                float* __restrict__ dbias, int TN, int hd,
                                int C, int nWin, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdSmem L = attn_bwd_smem(TN, hd);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* ds = reinterpret_cast<bf16*>(smem + L.d);  // dO
  float* fs = reinterpret_cast<float*>(smem + L.f);
  bf16* bs = reinterpret_cast<bf16*>(smem + L.b);
  float* rsum = reinterpret_cast<float*>(smem + L.dr);

  const int bw = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* st = reinterpret_cast<float*>(smem + L.st) + warp * 256;
  const long long row0 = (long long)bw * TN;
  const int C3 = 3 * C;

  const bf16* qbase = qkv + row0 * C3 + h * hd;
  const bf16* dbase = dattn + row0 * C + h * hd;
  const int chunks = hd / 8;
  for (int i = tid; i < TN * chunks; i += ATT_THREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    *reinterpret_cast<uint4*>(qs + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(qbase + (long long)r * C3 + c);
    *reinterpret_cast<uint4*>(ks + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(qbase + (long long)r * C3 + C + c);
    *reinterpret_cast<uint4*>(ds + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(dbase + (long long)r * C + c);
  }
  for (int r = tid; r < TN; r += ATT_THREADS) rsum[r] = 0.0f;
  __syncthreads();

  // S = q @ k^T (fp32)
  const int tq = TN / 16, td = hd / 16;
  for (int t = warp; t < tq * tq; t += ATT_WARPS) {
    const int tm = t / tq, tn = t - tm * tq;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < hd; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, qs + tm * 16 * L.ldq + kk, L.ldq);
      wmma::load_matrix_sync(b, ks + tn * 16 * L.ldq + kk, L.ldq);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(fs + tm * 16 * L.ldf + tn * 16, acc, L.ldf,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // P = softmax(S * scale + bias (+ mask)), the forward's contract; fp32
  // in fs, bf16 in bs
  const float* bias_h = bias + (long long)h * TN * TN;
  const float* mask_w =
      n_mask > 1 ? mask + (long long)(bw % nWin) * TN * TN : nullptr;
  for (int r = warp; r < TN; r += ATT_WARPS) {
    float* row = fs + r * L.ldf;
    float mx = -INFINITY;
    for (int c = lane; c < TN; c += 32) {
      float v = row[c] * scale + bias_h[r * TN + c];
      if (mask_w) v += mask_w[r * TN + c];
      row[c] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < TN; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int c = lane; c < TN; c += 32) {
      const float pv = row[c] * inv;
      row[c] = pv;
      bs[r * L.ldb + c] = __float2bfloat16(pv);
    }
  }
  __syncthreads();

  // dV = P^T @ dO -> dqkv[:, 2C + h*hd]
  bf16* dq_out = dqkv + row0 * C3 + h * hd;
  for (int t = warp; t < tq * td; t += ATT_WARPS) {
    const int tm = t / td, tn = t - tm * td;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < TN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, bs + kk * L.ldb + tm * 16, L.ldb);
      wmma::load_matrix_sync(b, ds + kk * L.ldq + tn * 16, L.ldq);
      wmma::mma_sync(acc, a, b, acc);
    }
    store_tile_bf16(st, acc, dq_out + 2 * C, C3, tm * 16, tn * 16, 1.0f, lane);
  }
  __syncthreads();

  // V replaces P in the bf16 buffer
  for (int i = tid; i < TN * chunks; i += ATT_THREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    *reinterpret_cast<uint4*>(bs + r * L.ldb + c) =
        *reinterpret_cast<const uint4*>(qbase + (long long)r * C3 + 2 * C + c);
  }
  __syncthreads();

  // dP = dO @ V^T, two passes: rowsum(dP * P), then dS = P * (dP - rowsum)
  // written over P (each element is read and written by one lane)
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = warp; t < tq * tq; t += ATT_WARPS) {
      const int tm = t / tq, tn = t - tm * tq;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < hd; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, ds + tm * 16 * L.ldq + kk, L.ldq);
        wmma::load_matrix_sync(b, bs + tn * 16 * L.ldb + kk, L.ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
      __syncwarp();
      float* prow = fs + (tm * 16 + r) * L.ldf + tn * 16 + c0;
      if (pass == 0) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part += st[r * 16 + c0 + e] * prow[e];
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if ((lane & 1) == 0) atomicAdd(&rsum[tm * 16 + r], part);
      } else {
        const float d = rsum[tm * 16 + r];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          prow[e] = prow[e] * (st[r * 16 + c0 + e] - d);
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // dbias += dS (fp32 atomics: every window of the batch adds into the
  // same (heads, TN, TN) table); dS in bf16 replaces V
  float* dbias_h = dbias + (long long)h * TN * TN;
  for (int i = tid; i < TN * TN; i += ATT_THREADS) {
    const int rr = i / TN, cc = i - rr * TN;
    const float v = fs[rr * L.ldf + cc];
    atomicAdd(dbias_h + i, v);
    bs[rr * L.ldb + cc] = __float2bfloat16(v);
  }
  __syncthreads();

  // dQ = dS @ K * scale, dK = dS^T @ Q * scale
  for (int t = warp; t < 2 * tq * td; t += ATT_WARPS) {
    const bool is_k = t >= tq * td;
    const int tt = is_k ? t - tq * td : t;
    const int tm = tt / td, tn = tt - tm * td;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < TN; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      if (is_k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, bs + kk * L.ldb + tm * 16, L.ldb);
        wmma::load_matrix_sync(b, qs + kk * L.ldq + tn * 16, L.ldq);
        wmma::mma_sync(acc, a, b, acc);
      } else {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, bs + tm * 16 * L.ldb + kk, L.ldb);
        wmma::load_matrix_sync(b, ks + kk * L.ldq + tn * 16, L.ldq);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    store_tile_bf16(st, acc, dq_out + (is_k ? C : 0), C3, tm * 16, tn * 16,
                    scale, lane);
  }
}

}  // namespace

extern "C" int stswin_block_attention(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* bias, const void* mask, void* qkv_buf,
    void* attn_buf, void* out, int B, int T, int H, int W, int C, int heads,
    int ws, float scale, int shift, int n_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T * H * W, hd = C / heads, TN = T * ws * ws;
  const int nWin = (H / ws) * (W / ws);

  GemmParams g{};
  g.A = static_cast<const bf16*>(x);
  g.lda = C;
  g.a_map = RowMap{1, T, H, W, ws, shift};
  g.Wt = static_cast<const bf16*>(wqkv);
  g.bias = static_cast<const float*>(bqkv);
  g.M = M;
  g.N = 3 * C;
  g.K = C;
  g.C = static_cast<bf16*>(qkv_buf);
  g.ldc = 3 * C;
  g.c_map = identity_map();
  g.act = ACT_NONE;
  cudaError_t err = gemm_sm90(g, EPI_BF16, s);
  if (err != cudaSuccess) return err;

  err = window_attention_rows(static_cast<const bf16*>(qkv_buf),
                              static_cast<bf16*>(attn_buf), identity_map(),
                              B * nWin, heads, TN, hd, C,
                              static_cast<const float*>(bias),
                              static_cast<const float*>(mask), n_mask, scale,
                              s);
  if (err != cudaSuccess) return err;

  g.A = static_cast<const bf16*>(attn_buf);
  g.a_map = identity_map();
  g.Wt = static_cast<const bf16*>(wproj);
  g.bias = static_cast<const float*>(bproj);
  g.N = C;
  g.C = static_cast<bf16*>(out);
  g.ldc = C;
  g.c_map = RowMap{1, T, H, W, ws, 0};  // window order -> (shifted) image
  return gemm_sm90(g, EPI_BF16, s);
}

// x: (B, T, H, W, C) bf16 unshifted; g: the output's gradient in the
// forward's (shifted) output layout; qkv, attn: the forward's window-order
// scratch; wqkv_t (C, 3C) and wproj_t (C, C): transposed bf16 weights.
// Scratch: dattn (rows, C), dqkv (rows, 3C) bf16. Outputs: dx unshifted
// bf16; dwqkv (3C, C), dbqkv (3C), dwproj (C, C), dbproj (C), dbias
// (heads, TN, TN), all fp32 and overwritten.
extern "C" int stswin_block_attention_bwd(
    const void* x, const void* g, const void* qkv, const void* attn,
    const void* wqkv_t, const void* wproj_t, const void* bias,
    const void* mask, void* dattn, void* dqkv, void* dx, void* dwqkv,
    void* dbqkv, void* dwproj, void* dbproj, void* dbias, int B, int T,
    int H, int W, int C, int heads, int ws, float scale, int shift,
    int n_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T * H * W, hd = C / heads, TN = T * ws * ws;
  const int nWin = (H / ws) * (W / ws);
  const RowMap win = RowMap{1, T, H, W, ws, 0};
  const RowMap win_shift = RowMap{1, T, H, W, ws, shift};
  cudaError_t err;
  const size_t c4 = sizeof(float) * C;
  if ((err = cudaMemsetAsync(dwqkv, 0, c4 * 3 * C, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(dbqkv, 0, c4 * 3, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(dwproj, 0, c4 * C, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(dbproj, 0, c4, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(dbias, 0, sizeof(float) * heads * TN * TN, s)) !=
          cudaSuccess)
    return err;

  // 1. dattn (window order) = g (gathered) @ wproj
  GemmParams p{};
  p.A = static_cast<const bf16*>(g);
  p.lda = C;
  p.a_map = win;
  p.Wt = static_cast<const bf16*>(wproj_t);
  p.M = M;
  p.N = C;
  p.K = C;
  p.C = static_cast<bf16*>(dattn);
  p.ldc = C;
  p.c_map = identity_map();
  p.act = ACT_NONE;
  if ((err = gemm_bf16(p, EPI_BF16, s)) != cudaSuccess) return err;

  // 2. attention backward per (window, head)
  const AttnBwdSmem L = attn_bwd_smem(TN, hd);
  err = cudaFuncSetAttribute(window_attention_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  window_attention_bwd_kernel<<<dim3(B * nWin, heads), ATT_THREADS, L.total,
                                s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dattn),
      static_cast<const float*>(bias), static_cast<const float*>(mask), n_mask,
      static_cast<bf16*>(dqkv), static_cast<float*>(dbias), TN, hd, C, nWin,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 3. dx (unshifted image) = dqkv @ wqkv, scattered through the shift map
  p.A = static_cast<const bf16*>(dqkv);
  p.lda = 3 * C;
  p.a_map = identity_map();
  p.Wt = static_cast<const bf16*>(wqkv_t);
  p.K = 3 * C;
  p.C = static_cast<bf16*>(dx);
  p.c_map = win_shift;
  if ((err = gemm_bf16(p, EPI_BF16, s)) != cudaSuccess) return err;

  // 4. weight and bias gradients
  WgradParams w{};
  w.A = static_cast<const bf16*>(dqkv);
  w.lda = 3 * C;
  w.a_map = identity_map();
  w.B = static_cast<const bf16*>(x);
  w.ldb = C;
  w.b_map = win_shift;
  w.R = M;
  w.M = 3 * C;
  w.N = C;
  w.Cw = static_cast<float*>(dwqkv);
  w.ldc = C;
  if ((err = gemm_wgrad(w, s)) != cudaSuccess) return err;
  w.A = static_cast<const bf16*>(g);
  w.lda = C;
  w.a_map = win;
  w.B = static_cast<const bf16*>(attn);
  w.b_map = identity_map();
  w.M = C;
  w.Cw = static_cast<float*>(dwproj);
  if ((err = gemm_wgrad(w, s)) != cudaSuccess) return err;
  if ((err = colsum_bf16(static_cast<const bf16*>(dqkv), 3 * C, M, 3 * C,
                         static_cast<float*>(dbqkv), s)) != cudaSuccess)
    return err;
  return colsum_bf16(static_cast<const bf16*>(g), C, M, C,
                     static_cast<float*>(dbproj), s);
}
