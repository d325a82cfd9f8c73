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
//   1. qkv GEMM (gemm.cu) whose A rows are gathered through the window
//      partition and the SW-MSA cyclic shift: the rolled, partitioned
//      tensor is never formed; qkv lands in window order.
//   2. one block per (window, head): q, k and v (TN x hd bf16) and the
//      fp32 scores stay in shared memory (about 200 KB at stage 1, so the
//      kernel opts in to dynamic shared memory above 48 KB). Scores use
//      the JAX package's softmax contract: fp32 scale after the matmul,
//      + tiled relative bias, + the window's mask only for SW-MSA, row
//      max, exp, and a multiply by the reciprocal of the row sum.
//   3. proj GEMM whose C rows scatter back to the image layout; with
//      shift > 0 the output stays in the shifted layout, as in the TPU
//      kernel, and K2 reads it back through the inverse shift.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int ATT_THREADS = 256, ATT_WARPS = ATT_THREADS / 32;

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

struct AttnSmem {
  int ldq, lds, ldo, ldp;
  size_t q, k, v, s, p, total;
};

__host__ __device__ inline AttnSmem attn_smem(int TN, int hd) {
  AttnSmem m;
  m.ldq = hd + 8;  // bf16 q/k/v rows, padded against bank conflicts
  m.lds = TN + 4;  // fp32 scores
  m.ldo = hd + 4;  // fp32 output staging (reuses the score buffer)
  m.ldp = TN + 8;  // bf16 probabilities
  const size_t qkv = align128(size_t(TN) * m.ldq * sizeof(bf16));
  m.q = 0;
  m.k = qkv;
  m.v = 2 * qkv;
  m.s = 3 * qkv;
  const int lds_max = m.lds > m.ldo ? m.lds : m.ldo;
  m.p = m.s + align128(size_t(TN) * lds_max * sizeof(float));
  m.total = m.p + align128(size_t(TN) * m.ldp * sizeof(bf16));
  return m;
}

// qkv: (B * nWin * TN, 3C) bf16 in window order; out: (B * nWin * TN, C)
__global__ void __launch_bounds__(ATT_THREADS)
    window_attention_kernel(const bf16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask, int n_mask,
                            bf16* __restrict__ out, int TN, int hd, int C,
                            int nWin, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem L = attn_smem(TN, hd);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);

  const int bw = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // q, k, v of this (window, head): 16-byte loads
  const bf16* base = qkv + (long long)bw * TN * 3 * C + h * hd;
  const int chunks = hd / 8;
  for (int i = tid; i < TN * chunks; i += ATT_THREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const bf16* src = base + (long long)r * 3 * C + c;
    *reinterpret_cast<uint4*>(qs + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(ks + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(src + C);
    *reinterpret_cast<uint4*>(vs + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(src + 2 * C);
  }
  __syncthreads();

  // scores = q @ k^T, fp32
  const int tq = TN / 16;
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
    wmma::store_matrix_sync(ss + tm * 16 * L.lds + tn * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // softmax, one warp per row
  const float* bias_h = bias + (long long)h * TN * TN;
  const float* mask_w =
      n_mask > 1 ? mask + (long long)(bw % nWin) * TN * TN : nullptr;
  for (int r = warp; r < TN; r += ATT_WARPS) {
    float* row = ss + r * L.lds;
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
    for (int c = lane; c < TN; c += 32)
      ps[r * L.ldp + c] = __float2bfloat16(row[c] * inv);
  }
  __syncthreads();

  // o = p @ v, fp32, staged over the score buffer
  float* os = ss;
  const int td = hd / 16;
  for (int t = warp; t < tq * td; t += ATT_WARPS) {
    const int tm = t / td, tn = t - tm * td;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < TN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, ps + tm * 16 * L.ldp + kk, L.ldp);
      wmma::load_matrix_sync(b, vs + kk * L.ldq + tn * 16, L.ldq);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(os + tm * 16 * L.ldo + tn * 16, acc, L.ldo,
                            wmma::mem_row_major);
  }
  __syncthreads();

  bf16* ob = out + (long long)bw * TN * C + h * hd;
  const int pairs = hd / 2;
  for (int i = tid; i < TN * pairs; i += ATT_THREADS) {
    const int r = i / pairs, c = (i - r * pairs) * 2;
    *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * C + c) =
        __floats2bfloat162_rn(os[r * L.ldo + c], os[r * L.ldo + c + 1]);
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
  cudaError_t err = gemm_bf16(g, EPI_BF16, s);
  if (err != cudaSuccess) return err;

  const AttnSmem L = attn_smem(TN, hd);
  err = cudaFuncSetAttribute(window_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  window_attention_kernel<<<dim3(B * nWin, heads), ATT_THREADS, L.total, s>>>(
      static_cast<const bf16*>(qkv_buf), static_cast<const float*>(bias),
      static_cast<const float*>(mask), n_mask, static_cast<bf16*>(attn_buf),
      TN, hd, C, nWin, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  g.A = static_cast<const bf16*>(attn_buf);
  g.a_map = identity_map();
  g.Wt = static_cast<const bf16*>(wproj);
  g.bias = static_cast<const float*>(bproj);
  g.N = C;
  g.C = static_cast<bf16*>(out);
  g.ldc = C;
  g.c_map = RowMap{1, T, H, W, ws, 0};  // window order -> (shifted) image
  return gemm_bf16(g, EPI_BF16, s);
}
