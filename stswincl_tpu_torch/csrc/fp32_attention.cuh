// The fp32 window-attention core: softmax(q k^T * scale + bias (+ mask)) v
// for one (window, head) pair, every value fp32 and nothing rounded. K1's
// fp32 form and the fp32 forms of rows 10 and 11 launch it alone
// (fp32_forms.cu, which says what it replaces and what bounds it); row
// 16's fp32 form (fp32_whole_block.cu) runs it in its attention phase. The
// address functors say where a (window, head, token) row lives, as
// attention_core.cuh's do for the bf16 core.
#pragma once

#include "common.cuh"

namespace attn32 {

// row(bw, h, r): the row index of token r of (window bw, head h); then
// in(row, h, which) its q / k / v row (which = 0 / 1 / 2) and dst(row, h)
// its output row, each hd contiguous floats.
//   MappedRows: token rows of a (rows, 3C) qkv matrix and a (rows, C)
//     output through a RowMap: the identity for window-order buffers (K1,
//     row 16), the window partition for row 10's image layout;
//   HeadMajor: three (Bw, heads, TN, hd) tensors and a (Bw, heads, TN, hd)
//     output (row 11).
struct MappedRows {
  const float* qkv;
  float* out;
  RowMap map;
  int TN, hd, C;
  __device__ long long row(int bw, int, int r) const {
    return map_row(map, bw * TN + r);
  }
  __device__ const float* in(long long row, int h, int which) const {
    return qkv + row * 3 * C + which * C + h * hd;
  }
  __device__ float* dst(long long row, int h) const {
    return out + row * C + h * hd;
  }
};

struct HeadMajor {
  const float* qkv[3];
  float* out;
  int heads, TN, hd;
  __device__ long long row(int bw, int h, int r) const {
    return (long long)(bw * heads + h) * TN + r;
  }
  __device__ const float* in(long long row, int, int which) const {
    return qkv[which] + row * hd;
  }
  __device__ float* dst(long long row, int) const { return out + row * hd; }
};

// Shared memory of one pair: q, k and v in fp32 rows of hd + 4
// (`ops/attention.py` `_attn_f32_smem_bytes`).
__host__ __device__ inline size_t smem_bytes(int TN, int hd) {
  return align128(size_t(3) * TN * (hd + 4) * sizeof(float));
}

// The attention of (window bw, head h) by a block of nthr threads (tid its
// thread; nthr >= 2 TN, a multiple of 32) in `smem` (smem_bytes(TN, hd)),
// on the block's barrier. Every thread loads: warp w copies rows w, w +
// nthr / 32, ... of q and k in one cp.async group and of v in a second,
// which lands while the scores are computed. The first 2 TN threads
// compute: warp w owns query rows 16 w .. 16 w + 15; lane l holds row
// l % 16 against the keys of parity l / 16 (KPL >= TN / 2 of them), its
// scores in registers: fp32 q k^T, the scale after the product, + the
// tiled relative bias (heads, TN, TN), + the window's mask (bw % n_mask;
// null for none), the row max and sum across the two lanes of a row, exp,
// a multiply by the reciprocal of the sum; then P V 32 columns at a time
// (hd % 32 == 0), the two lanes' halves summed by one shuffle each. P
// stays fp32. Starts by meeting the block, so a caller may reuse `smem`.
template <int KPL, class Addr>
__device__ __forceinline__ void pair(const Addr& a, int bw, int h,
                                     float* smem, int tid, int nthr,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mask,
                                     int n_mask, int TN, int hd,
                                     float scale) {
  const int ld = hd + 4;
  float* qs = smem;
  float* ks = qs + TN * ld;
  float* vs = ks + TN * ld;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  __syncthreads();  // the block's earlier reads of `smem` are done
  for (int r = warp; r < TN; r += nwarps) {
    const long long row = a.row(bw, h, r);
    for (int which = 0; which < 2; ++which) {
      const float* src = a.in(row, h, which);
      float* d = qs + (which * TN + r) * ld;
      for (int c = lane * 4; c < hd; c += 128) cp_async16(d + c, src + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int r = warp; r < TN; r += nwarps) {
    const float* src = a.in(a.row(bw, h, r), h, 2);
    float* d = vs + r * ld;
    for (int c = lane * 4; c < hd; c += 128) cp_async16(d + c, src + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int half = lane >> 4;
  const int row = warp * 16 + (lane & 15);
  const int kpl = TN / 2;
  const bool active = tid < 2 * TN;  // whole warps: 2 TN % 32 == 0
  // s[jj]: the score, then P, of key 2 jj + half
  float s[KPL];
#pragma unroll
  for (int jj = 0; jj < KPL; ++jj) s[jj] = 0.0f;
  if (active) {
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
        if (mrow) v += mrow[2 * jj];  // after the bias, as the twin adds
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
  }

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // v has landed
  if (!active) return;

  // o = P V, 32 columns at a time: each lane sums over its parity's keys,
  // then lane half 0 keeps columns 0-15 and half 1 columns 16-31, each the
  // sum of its own and its partner's (lane ^ 16) partial sums
  float* dst = a.dst(a.row(bw, h, row), h) + 16 * half;
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

}  // namespace attn32
