// Window attention: the per-(window, head) core shared by K1 and by the two
// standalone attention kernels of the `attn_impl` routes 'pallas' and
// 'pallas_windows'.
//
// Replaces:
//   row 10, stswincl_tpu/ops/pallas_block_attention.py
//     windowed_attention_image (:128) -> _row_kernel (:44): attention on the
//     image-layout qkv (B, T, H, W, 3C), output (B, T, H, W, C);
//   row 11, stswincl_tpu/ops/pallas_attention.py
//     fused_window_attention (:118) / _pallas_attention (:77) ->
//     _attn_kernel (:38): attention on partitioned q, k, v
//     (Bw, heads, TN, hd), windows minor (Bw = batch * nW + window);
//   and the attention step of K1 (block_attention.cu).
//
// Contract (`attend_tiled`): bf16 q k^T with fp32 accumulation, the scale
// applied to the fp32 scores, + the fp32 tiled relative bias (heads, TN,
// TN), + the window's mask (window % n_mask) when there is one per window,
// a max-subtracted exp, the row sum applied as a reciprocal multiply, P
// rounded to bf16 before P V, the output in bf16.
//
// Bound on the H100: per (window, head) two TN x TN x hd products (TN 128,
// hd 128 at stage 1; TN 32, hd 256 at stage 2) and a TN x TN fp32 softmax.
// Device memory sees q, k, v and the output once each; the bias and mask
// tables (256 KB and 5 MB at stage 1) stay in L2. The block is bound by
// shared-memory traffic and the fp32 softmax, as long as the scores never
// leave the SM.
//
// Design: one block per (window, head), the grid K1's core always used.
// q, k, v of the block go to shared memory with 16-byte loads (each row is
// hd contiguous bf16 in every layout), the fp32 scores and the bf16 P stay
// there (203 KB at stage 1, opted in above 48 KB), wmma 16x16x16 bf16
// fragments compute both products, and the output leaves in 16-byte
// stores. The three callers differ only in where a (window, head, token)
// row lives, so the body is one template over an address functor; the
// block maps each of its TN rows once, into shared memory, before any
// load, so a gather (integer divisions per row) costs TN address
// computations a block, not one per 16-byte chunk:
//   MappedRows: token rows of a (rows, 3C) qkv matrix and a (rows, C)
//     output read through a RowMap: the identity for K1's window-order
//     buffers, the window partition for row 10, which so gathers straight
//     from the image layout and scatters its output back to it: no
//     partitioned copy is formed (that copy is the plain twin's work);
//   HeadMajor: three (Bw, heads, TN, hd) tensors and a (Bw, heads, TN, hd)
//     output (row 11).

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

struct AttnSmem {
  int ldq, lds, ldo, ldp;
  size_t q, k, v, s, p, r, total;
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
  m.r = m.p + align128(size_t(TN) * m.ldp * sizeof(bf16));
  m.total = m.r + align128(size_t(TN) * sizeof(long long));  // row offsets
  return m;
}

// row(bw, h, r): the row index of token r of (window bw, head h); then
// in(row, h, which) its q / k / v row (which = 0 / 1 / 2) and dst(row, h)
// its output row, each hd contiguous bf16.
struct MappedRows {
  const bf16* qkv;
  bf16* out;
  RowMap map;
  int TN, hd, C;
  __device__ long long row(int bw, int, int r) const {
    return map_row(map, bw * TN + r);
  }
  __device__ const bf16* in(long long row, int h, int which) const {
    return qkv + row * 3 * C + which * C + h * hd;
  }
  __device__ bf16* dst(long long row, int h) const {
    return out + row * C + h * hd;
  }
};

struct HeadMajor {
  const bf16* qkv[3];
  bf16* out;
  int heads, TN, hd;
  __device__ long long row(int bw, int h, int r) const {
    return (long long)(bw * heads + h) * TN + r;
  }
  __device__ const bf16* in(long long row, int, int which) const {
    return qkv[which] + row * hd;
  }
  __device__ bf16* dst(long long row, int) const { return out + row * hd; }
};

template <class Addr>
__global__ void __launch_bounds__(ATT_THREADS)
    window_attention_kernel(Addr a, const float* __restrict__ bias,
                            const float* __restrict__ mask, int n_mask,
                            int TN, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem L = attn_smem(TN, hd);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  long long* rows = reinterpret_cast<long long*>(smem + L.r);

  const int bw = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int r = tid; r < TN; r += ATT_THREADS) rows[r] = a.row(bw, h, r);
  __syncthreads();

  // q, k, v of this (window, head): 16-byte loads
  const int chunks = hd / 8;
  for (int i = tid; i < TN * chunks; i += ATT_THREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const long long row = rows[r];
    *reinterpret_cast<uint4*>(qs + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(a.in(row, h, 0) + c);
    *reinterpret_cast<uint4*>(ks + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(a.in(row, h, 1) + c);
    *reinterpret_cast<uint4*>(vs + r * L.ldq + c) =
        *reinterpret_cast<const uint4*>(a.in(row, h, 2) + c);
  }
  __syncthreads();

  // scores = q @ k^T, fp32
  const int tq = TN / 16;
  for (int t = warp; t < tq * tq; t += ATT_WARPS) {
    const int tm = t / tq, tn = t - tm * tq;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < hd; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, qs + tm * 16 * L.ldq + kk, L.ldq);
      wmma::load_matrix_sync(fb, ks + tn * 16 * L.ldq + kk, L.ldq);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(ss + tm * 16 * L.lds + tn * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // softmax, one warp per row
  const float* bias_h = bias + (long long)h * TN * TN;
  const float* mask_w =
      n_mask > 1 ? mask + (long long)(bw % n_mask) * TN * TN : nullptr;
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, ps + tm * 16 * L.ldp + kk, L.ldp);
      wmma::load_matrix_sync(fb, vs + kk * L.ldq + tn * 16, L.ldq);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(os + tm * 16 * L.ldo + tn * 16, acc, L.ldo,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // the output: 8 bf16 (16 bytes) a store
  for (int i = tid; i < TN * chunks; i += ATT_THREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const float* o = os + r * L.ldo + c;
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p2[j] = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
    *reinterpret_cast<uint4*>(a.dst(rows[r], h) + c) = packed;
  }
}

template <class Addr>
cudaError_t launch(const Addr& a, int n_windows, int heads, int TN, int hd,
                   const float* bias, const float* mask, int n_mask,
                   float scale, cudaStream_t s) {
  const AttnSmem L = attn_smem(TN, hd);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<Addr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  window_attention_kernel<Addr>
      <<<dim3(n_windows, heads), ATT_THREADS, L.total, s>>>(
          a, bias, n_mask > 1 ? mask : nullptr, n_mask, TN, hd, scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t window_attention_rows(const bf16* qkv, bf16* out, RowMap map,
                                  int n_windows, int heads, int TN, int hd,
                                  int C, const float* bias, const float* mask,
                                  int n_mask, float scale,
                                  cudaStream_t stream) {
  return launch(MappedRows{qkv, out, map, TN, hd, C}, n_windows, heads, TN,
                hd, bias, mask, n_mask, scale, stream);
}

// Row 10. qkv (B, T, H, W, 3C) bf16, out (B, T, H, W, C) bf16, both in the
// image layout; mask (nH * nW, TN, TN), one entry per window of an image
// (index i * nW + j, the same for every batch element), when n_mask > 1.
extern "C" int stswin_window_attention_image(
    const void* qkv, const void* bias, const void* mask, void* out, int B,
    int T, int H, int W, int C, int heads, int ws, float scale, int n_mask,
    void* stream) {
  const int TN = T * ws * ws, n_windows = B * (H / ws) * (W / ws);
  return window_attention_rows(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      RowMap{1, T, H, W, ws, 0}, n_windows, heads, TN, C / heads, C,
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      n_mask, scale, static_cast<cudaStream_t>(stream));
}

// Row 11. q, k, v, out: (Bw, heads, TN, hd) bf16; mask (n_mask, TN, TN)
// indexed by window % n_mask (windows minor), when n_mask > 1.
extern "C" int stswin_window_attention_heads(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, void* out, int Bw, int heads, int TN, int hd,
    float scale, int n_mask, void* stream) {
  HeadMajor a{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v)},
              static_cast<bf16*>(out), heads, TN, hd};
  return launch(a, Bw, heads, TN, hd, static_cast<const float*>(bias),
                static_cast<const float*>(mask), n_mask, scale,
                static_cast<cudaStream_t>(stream));
}
