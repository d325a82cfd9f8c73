// The first window-attention core: softmax(q k^T * scale + bias (+ mask))
// v for one (window, head) by one block of 256 threads, q, k, v, the fp32
// scores and the bf16 P in shared memory. The whole-block kernel
// (swin_block.cu) runs it in its attention phase. K1 and the two
// standalone attention kernels of the `attn_impl` routes 'pallas' and
// 'pallas_windows' run the register-resident core of window_attention.cu,
// which says what both replace and what bounds them; it shares the
// address functors below.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace attn {

using namespace nvcuda;

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

// The attention of (window bw, head h) by the 256 threads of one block, in
// `smem` (attn_smem(TN, hd).total bytes). Returns once every output row is
// stored; a caller that calls again in the same block synchronises first.
template <class Addr>
__device__ __forceinline__ void attend(const Addr& a, int bw, int h,
                                       unsigned char* smem,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mask,
                                       int n_mask, int TN, int hd,
                                       float scale) {
  const AttnSmem L = attn_smem(TN, hd);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  long long* rows = reinterpret_cast<long long*>(smem + L.r);

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

}  // namespace attn
