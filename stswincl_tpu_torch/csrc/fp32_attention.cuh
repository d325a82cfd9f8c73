// The fp32 window-attention core: softmax(q k^T * scale + bias (+ mask)) v
// for (window, head) pairs, every value fp32 and both products in fp32
// accuracy on the tensor cores (3xTF32, tf32x3.cuh). K1's fp32 form and
// the fp32 forms of rows 10 and 11 launch it alone (fp32_forms.cu, which
// says what it replaces and what bounds it); row 16's fp32 form
// (fp32_whole_block.cu) runs it in its attention phase. The address
// functors say where a (window, head, token) row lives, as
// attention_core.cuh's do for the bf16 core.
#pragma once

#include "common.cuh"
#include "tf32x3.cuh"

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

// Shared memory of one pair (`ops/attention.py` `_attn_f32_smem_bytes`):
// the q-and-k region, q and k in fp32 rows of hd + 4, then v in the same
// rows. A pitch of 4 mod 32 words puts every fragment read of the products
// on distinct banks (see `pairs`).
__host__ __device__ inline size_t smem_bytes(int TN, int hd) {
  return align128(size_t(3) * TN * (hd + 4) * sizeof(float));
}

// 8-key tiles of the score registers for windows of TN tokens (TN <= 176,
// `ops/attention.py` MAX_WINDOW_TOKENS)
__host__ __device__ constexpr int score_tiles(int TN) {
  return TN <= 32 ? 4 : (TN <= 64 ? 8 : (TN <= 128 ? 16 : 22));
}

// cp.async the rows `which0` .. `which1` (q, k, v = 0, 1, 2) of pair (bw,
// h) into consecutive TN-row blocks of `dst` (rows of ld floats), then
// commit them as one group. hd / 4 16-byte chunks a row: a row a warp
// from hd 128 up, else 32 / lpr rows a warp with lpr lanes a row.
template <class Addr>
__device__ __forceinline__ void load_rows(const Addr& a, int bw, int h,
                                          int which0, int which1, float* dst,
                                          int TN, int hd, int ld, int t,
                                          int pt) {
  const int chunks = hd / 4;
  const int lpr = chunks >= 32 ? 32 : (chunks >= 16 ? 16 : 8);
  const int rpw = 32 / lpr, lane = t & 31;
  const int sub = lane / lpr, sl = lane - sub * lpr;
  for (int r = (t >> 5) * rpw + sub; r < TN; r += (pt >> 5) * rpw) {
    const long long row = a.row(bw, h, r);
    for (int which = which0; which <= which1; ++which) {
      const float* src = a.in(row, h, which);
      float* d = dst + ((which - which0) * TN + r) * ld;
      for (int c = sl * 4; c < hd; c += lpr * 4) cp_async16(d + c, src + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The attention of pairs first, first + step, ... < total (pair p is
// window p / heads, head p % heads) by pt = TN / 16 * 32 threads (t = 0 ..
// pt - 1 their index) in `smem` (smem_bytes(TN, hd)), meeting on named
// barrier `bar` of pt threads. NT >= score_tiles(TN); TN % 16 == 0, hd %
// 8 == 0 (a last chunk of P V off 32 columns a tile at a time). The caller
// makes sure every earlier reader of `smem` is done.
//
// Warp w owns query rows 16 w .. 16 w + 15 and computes on the tensor
// cores, mma.sync m16n8k8 tf32, each k step's product as three TF32
// passes over the operands' split halves from 0, added to the fp32 sums
// rounded to nearest (tf32x3::mma3_add: four key tiles or eight column
// tiles at a time, their chains interleaved; the mma's own accumulation
// truncates, which over the 16-32 steps of a sum put the core at 4x the
// FMA form's rounding error):
//   - scores: the 16 x TN tile q k^T into registers (s[j]: keys 8j ..
//     8j + 7; lane g = lane / 4, t = lane % 4 holds rows g and g + 8,
//     keys 8j + 2t and 8j + 2t + 1), q and k read from shared memory as
//     the A and B fragments (row g / key g, column d + t and d + t + 4);
//   - softmax in those registers, the twin's contract: the scale after the
//     product, + the tiled relative bias (heads, TN, TN), + the window's
//     mask (bw % n_mask; null for none), the row max and sum across the
//     quad, exp, a multiply by the reciprocal of the sum; P stays fp32;
//   - o = P V, 64 columns at a time: the score accumulator of key tile j
//     is P V's A fragment of that k step when the step's k index t stands
//     for key 8j + 2t and t + 4 for key 8j + 2t + 1 (the sum over keys does
//     not mind the order), so P never leaves the registers and V's B
//     fragment is V[8j + 2t (+ 1)][column g]; the output stored from the
//     accumulators, two floats a lane and row.
// Row pitch hd + 4 (4 mod 32 words): the q / k fragment reads fall on banks
// 4g + t and the v reads on 8t + g (+ 4), all distinct.
// The loads run a pair ahead: q and k of the next pair are copied while
// this pair's softmax and P V run, v of the next while its scores are
// formed, so the pair's smem holds one pair and the copies hide behind the
// products.
template <int NT, class Addr>
__device__ __forceinline__ void pairs(const Addr& a, int first, int total,
                                      int step, int heads, float* smem,
                                      int t, int pt, int bar,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ mask,
                                      int n_mask, int TN, int hd,
                                      float scale) {
  const int ld = hd + 4, nt = TN / 8;
  float* qs = smem;
  float* ks = qs + TN * ld;
  float* vs = ks + TN * ld;
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int q0 = (t >> 5) * 16;
  const auto sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(pt) : "memory");
  };
  if (first < total) {
    load_rows(a, first / heads, first % heads, 0, 1, qs, TN, hd, ld, t, pt);
    load_rows(a, first / heads, first % heads, 2, 2, vs, TN, hd, ld, t, pt);
  }
  for (int p = first; p < total; p += step) {
    const int bw = p / heads, h = p - bw * heads, nx = p + step;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    sync();  // q and k have landed

    // ---- scores: s[j] = q k^T over keys 8j .. 8j + 7 ----
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    const float* qa = qs + (q0 + g) * ld + tq;
    const float* kb = ks + g * ld + tq;
    for (int kk = 0; kk < hd; kk += 8) {
      tf32x3::FragA fa;
      fa.set(qa[kk], qa[8 * ld + kk], qa[kk + 4], qa[8 * ld + kk + 4]);
      // key tiles in fours, their chains interleaved (nt is even: a last
      // pair alone)
#pragma unroll
      for (int j = 0; j < NT; j += 4) {
        const float* kr = kb + j * 8 * ld + kk;
        if (j + 4 <= nt) {
          tf32x3::FragB fb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            fb[u].set(kr[8 * u * ld], kr[8 * u * ld + 4]);
          tf32x3::mma3_add(s, j, fa, fb);
        } else if (j < nt) {
          tf32x3::FragB fb[2];
          fb[0].set(kr[0], kr[4]);
          fb[1].set(kr[8 * ld], kr[8 * ld + 4]);
          tf32x3::mma3_add(s, j, fa, fb);
        }
      }
    }
    sync();  // every warp has read q and k: the next pair's may land
    if (nx < total)
      load_rows(a, nx / heads, nx % heads, 0, 1, qs, TN, hd, ld, t, pt);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");

    // ---- softmax of rows q0 + g (s[j][0..1]) and q0 + g + 8 (s[j][2..3]) --
    const float* bias_r = bias + ((long long)h * TN + q0 + g) * TN + 2 * tq;
    const float* mask_r =
        mask ? mask + ((long long)(bw % n_mask) * TN + q0 + g) * TN + 2 * tq
             : nullptr;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 b = *reinterpret_cast<const float2*>(
              bias_r + hh * 8 * TN + 8 * j);
          s[j][2 * hh] = s[j][2 * hh] * scale + b.x;
          s[j][2 * hh + 1] = s[j][2 * hh + 1] * scale + b.y;
          if (mask_r) {  // after the bias, as the twin adds them
            const float2 m = *reinterpret_cast<const float2*>(
                mask_r + hh * 8 * TN + 8 * j);
            s[j][2 * hh] += m.x;
            s[j][2 * hh + 1] += m.y;
          }
          mx[hh] = fmaxf(mx[hh], fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        }
      }
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
      }
    }
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      inv[hh] = 1.0f / sum[hh];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] *= inv[0];
      s[j][1] *= inv[0];
      s[j][2] *= inv[1];
      s[j][3] *= inv[1];
    }

    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    sync();  // v has landed

    // ---- o = P V, 64 columns at a time, stored from the accumulators ----
    float* d0 = a.dst(a.row(bw, h, q0 + g), h) + 2 * tq;
    float* d1 = a.dst(a.row(bw, h, q0 + g + 8), h) + 2 * tq;
    const float* vb = vs + 2 * tq * ld + g;
    for (int c0 = 0; c0 < hd; c0 += 64) {
      float o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          tf32x3::FragA fa;
          fa.set(s[j][0], s[j][2], s[j][1], s[j][3]);
          const float* vr = vb + j * 8 * ld + c0;
          // the chunk's column tiles at once, their chains interleaved:
          // eight, the four of a last 32 columns, or a last chunk of
          // another width a tile at a time
          if (c0 + 64 <= hd) {
            tf32x3::FragB fb[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              fb[u].set(vr[8 * u], vr[ld + 8 * u]);
            tf32x3::mma3_add(o, 0, fa, fb);
          } else if (c0 + 32 == hd) {
            tf32x3::FragB fb[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              fb[u].set(vr[8 * u], vr[ld + 8 * u]);
            tf32x3::mma3_add(o, 0, fa, fb);
          } else {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (c0 + 8 * u < hd) {
                tf32x3::FragB fb[1];
                fb[0].set(vr[8 * u], vr[ld + 8 * u]);
                tf32x3::mma3_add(o, u, fa, fb);
              }
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (c0 + 8 * n < hd) {
          *reinterpret_cast<float2*>(d0 + c0 + 8 * n) =
              make_float2(o[n][0], o[n][1]);
          *reinterpret_cast<float2*>(d1 + c0 + 8 * n) =
              make_float2(o[n][2], o[n][3]);
        }
      }
    }
    sync();  // every warp has read v: the next pair's may land
    if (nx < total)
      load_rows(a, nx / heads, nx % heads, 2, 2, vs, TN, hd, ld, t, pt);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace attn32
