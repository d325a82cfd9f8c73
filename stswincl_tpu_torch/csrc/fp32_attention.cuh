// The fp32 window-attention core: softmax(q k^T * scale + bias (+ mask)) v
// for (window, head) pairs, every value fp32 and both products in fp32
// accuracy on the tensor cores (3xTF32, tf32x3.cuh). K1's fp32 form and
// the fp32 forms of rows 10 and 11 launch it alone (fp32_forms.cu, which
// says what it replaces and what bounds it); row 16's fp32 form
// (fp32_whole_block.cuh) runs it in its attention phase. Two instances: the
// resident pair (`pairs`) where q, k and v fit a block, and the streamed
// pair (`pairs_streamed`) for every other window (`takes`). The
// address functors say where a (window, head, token) row lives, as
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

// Shared memory one block may use on sm_90 (`kernels.SMEM_LIMIT`): the
// plans below are decided from the shapes against it, not from the card.
constexpr size_t SMEM_LIMIT = 232448;

// The windows the fp32 core takes: exactly those of K1's bf16 core and of
// the JAX kernels short of their VMEM tiling, 16-token tiles up to 176
// (`ops/attention.py` MAX_WINDOW_TOKENS) and any head dim of 8: the
// streamed pair's ring does not depend on the head dim.
__host__ __device__ inline bool takes(int TN, int hd) {
  return TN > 0 && TN % 16 == 0 && TN <= 176 && hd > 0 && hd % 8 == 0;
}

// Whether a window runs the resident pair (`pairs`): its fp32 q, k and v
// fit one block. Every other window the core takes streams (`pairs_streamed`).
__host__ __device__ inline bool resident(int TN, int hd) {
  return smem_bytes(TN, hd) <= SMEM_LIMIT;
}

// The streamed pair's ring: RING slots of TN rows of SLOT floats, each
// holding a chunk of SC columns of q and of k (rows of SC + 4 each) or of
// VC columns of v (rows of VC + 4), 4 mod 32 words as the resident rows.
constexpr int SC = 32, VC = 64, RING = 3;
constexpr int SLD = SC + 4, VLD = VC + 4, SLOT = 2 * SLD;
__host__ __device__ inline size_t streamed_bytes(int TN) {
  return size_t(RING) * TN * SLOT * sizeof(float);
}

// The shared memory of the instance a window gets (`ops/attention.py`
// `_attn_f32_smem_bytes`), 0 for a window the core refuses.
__host__ __device__ inline size_t plan_bytes(int TN, int hd) {
  if (!takes(TN, hd)) return 0;
  return resident(TN, hd) ? smem_bytes(TN, hd) : streamed_bytes(TN);
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

// acc[j] (j < nt: columns 8j .. 8j + 7) += a b^T over w columns (w % 8
// == 0): a the 16 rows at `a`, b the rows at `b`, both rows of ld floats;
// 8-column k steps in order, four column tiles at a time, their chains
// interleaved (nt is even: a last pair alone). The scores of `pairs`;
// the streamed instances' S and dP, a chunk's k steps added to the same
// registers.
template <int NT>
__device__ __forceinline__ void scores_add(float (&acc)[NT][4], const float* a,
                                           const float* b, int ld, int w,
                                           int nt, int g, int tq) {
  const float* aa = a + g * ld + tq;
  const float* bb = b + g * ld + tq;
  for (int kk = 0; kk < w; kk += 8) {
    tf32x3::FragA fa;
    fa.set(aa[kk], aa[8 * ld + kk], aa[kk + 4], aa[8 * ld + kk + 4]);
#pragma unroll
    for (int j = 0; j < NT; j += 4) {
      const float* br = bb + j * 8 * ld + kk;
      if (j + 4 <= nt) {
        tf32x3::FragB fb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          fb[u].set(br[8 * u * ld], br[8 * u * ld + 4]);
        tf32x3::mma3_add<4, NT>(acc, j, fa, fb);
      } else if (j < nt) {
        tf32x3::FragB fb[2];
        fb[0].set(br[0], br[4]);
        fb[1].set(br[8 * ld], br[8 * ld + 4]);
        tf32x3::mma3_add<2, NT>(acc, j, fa, fb);
      }
    }
  }
}

// The softmax of the core on the score registers of rows g and g + 8 (s[j]
// for j < nt): the scale after the product, + the bias row (`bias_r`), +
// the mask row (`mask_r`, or null), the row max and sum across the quad,
// exp, a multiply by the reciprocal of the sum: s becomes P, fp32.
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4],
                                             const float* bias_r,
                                             const float* mask_r, int nt,
                                             int TN, float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 b =
            *reinterpret_cast<const float2*>(bias_r + hh * 8 * TN + 8 * j);
        s[j][2 * hh] = s[j][2 * hh] * scale + b.x;
        s[j][2 * hh + 1] = s[j][2 * hh + 1] * scale + b.y;
        if (mask_r) {  // after the bias, as the twin adds them
          const float2 m =
              *reinterpret_cast<const float2*>(mask_r + hh * 8 * TN + 8 * j);
          s[j][2 * hh] += m.x;
          s[j][2 * hh + 1] += m.y;
        }
        mx[hh] = fmaxf(mx[hh], fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      }
    }
  }
  float sum[2] = {0.0f, 0.0f}, inv[2];
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
}

// o = P V over the 64 output columns c0 .. c0 + 63 (fewer where hd ends
// first) for rows g and g + 8 of a warp, stored from the accumulators: P
// the softmax's registers (s[j], j < nt), `vb` v's element [2t][c0 + g] in
// rows of ld floats, d0 / d1 the two rows' output at column c0 + 2t. The
// score accumulator of key tile j is P V's A fragment of that k step when
// the step's k index t stands for key 8j + 2t and t + 4 for key 8j + 2t +
// 1 (the sum over keys does not mind the order), so P never leaves the
// registers and V's B fragment is V[8j + 2t (+ 1)][column g].
template <int NT>
__device__ __forceinline__ void pv_store(const float (&s)[NT][4],
                                         const float* vb, int ld, int c0,
                                         int hd, int nt, float* d0,
                                         float* d1) {
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      tf32x3::FragA fa;
      fa.set(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* vr = vb + j * 8 * ld;
      // the chunk's column tiles at once, their chains interleaved: eight,
      // the four of a last 32 columns, or a last chunk of another width a
      // tile at a time
      if (c0 + 64 <= hd) {
        tf32x3::FragB fb[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) fb[u].set(vr[8 * u], vr[ld + 8 * u]);
        tf32x3::mma3_add(o, 0, fa, fb);
      } else if (c0 + 32 == hd) {
        tf32x3::FragB fb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) fb[u].set(vr[8 * u], vr[ld + 8 * u]);
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
      *reinterpret_cast<float2*>(d0 + 8 * n) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(d1 + 8 * n) = make_float2(o[n][2], o[n][3]);
    }
  }
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
//   - o = P V, 64 columns at a time (`pv_store`), P in the registers, the
//     output stored from the accumulators, two floats a lane and row.
// (`scores_add`, `softmax_rows` and `pv_store` are the steps; the streamed
// pair and K5 fp32's streamed query pass run the same ones.)
// Row pitch hd + 4 (4 mod 32 words): the q / k fragment reads fall on banks
// 4g + t and the v reads on 8t + g (+ 4), all distinct.
// The loads run a pair ahead: q and k of the next pair are copied while
// this pair's softmax and P V run, v of the next while its scores are
// formed, so the pair's smem holds one pair and the copies hide behind the
// products.
// SLABS: the pair has fewer warps (pt / 32) than 16-row slabs (row 16 past
// 128 tokens): q, k and v of a pair land together, then warp w takes
// slabs w, w + pt / 32, ... one after another, each row computed as above
// (the same bits); the next pair's loads wait for the last slab.
template <int NT, class Addr, bool SLABS = false>
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
  if constexpr (SLABS) {
    for (int p = first; p < total; p += step) {
      const int bw = p / heads, h = p - bw * heads;
      load_rows(a, bw, h, 0, 2, qs, TN, hd, ld, t, pt);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      sync();  // q, k and v have landed
      for (int r0 = q0; r0 < TN; r0 += pt / 2) {
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        scores_add<NT>(s, qs + r0 * ld, ks, ld, hd, nt, g, tq);
        softmax_rows<NT>(
            s, bias + ((long long)h * TN + r0 + g) * TN + 2 * tq,
            mask ? mask + ((long long)(bw % n_mask) * TN + r0 + g) * TN +
                       2 * tq
                 : nullptr,
            nt, TN, scale);
        float* d0 = a.dst(a.row(bw, h, r0 + g), h) + 2 * tq;
        float* d1 = a.dst(a.row(bw, h, r0 + g + 8), h) + 2 * tq;
        const float* vb = vs + 2 * tq * ld + g;
        for (int c0 = 0; c0 < hd; c0 += 64)
          pv_store<NT>(s, vb + c0, ld, c0, hd, nt, d0 + c0, d1 + c0);
      }
      sync();  // every warp has read q, k and v: the next pair's may land
    }
    return;
  }
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
    scores_add<NT>(s, qs + q0 * ld, ks, ld, hd, nt, g, tq);
    sync();  // every warp has read q and k: the next pair's may land
    if (nx < total)
      load_rows(a, nx / heads, nx % heads, 0, 1, qs, TN, hd, ld, t, pt);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");

    // ---- softmax of rows q0 + g (s[j][0..1]) and q0 + g + 8 (s[j][2..3]) --
    softmax_rows<NT>(
        s, bias + ((long long)h * TN + q0 + g) * TN + 2 * tq,
        mask ? mask + ((long long)(bw % n_mask) * TN + q0 + g) * TN + 2 * tq
             : nullptr,
        nt, TN, scale);

    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    sync();  // v has landed

    // ---- o = P V, 64 columns at a time, stored from the accumulators ----
    float* d0 = a.dst(a.row(bw, h, q0 + g), h) + 2 * tq;
    float* d1 = a.dst(a.row(bw, h, q0 + g + 8), h) + 2 * tq;
    const float* vb = vs + 2 * tq * ld + g;
    for (int c0 = 0; c0 < hd; c0 += 64)
      pv_store<NT>(s, vb + c0, ld, c0, hd, nt, d0 + c0, d1 + c0);
    sync();  // every warp has read v: the next pair's may land
    if (nx < total)
      load_rows(a, nx / heads, nx % heads, 2, 2, vs, TN, hd, ld, t, pt);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cp.async columns c0 .. c0 + w - 1 (w % 8 == 0) of rows `which` (q, k, v
// = 0, 1, 2) of pair (bw, h) into the TN rows of ld floats at `dst`; no
// commit.
template <class Addr>
__device__ __forceinline__ void load_cols(const Addr& a, int bw, int h,
                                          int which, int c0, int w,
                                          float* dst, int ld, int TN, int t,
                                          int pt) {
  const int nc = w >> 2;
  for (int i = t; i < TN * nc; i += pt) {
    const int r = i / nc, c = (i - r * nc) << 2;
    cp_async16(dst + r * ld + c, a.in(a.row(bw, h, r), h, which) + c0 + c);
  }
}

// `pairs` for the windows whose q, k and v do not fit one block (the same
// arguments; `smem` streamed_bytes(TN)). The pair streams through a ring
// of RING slots, one chunk a slot, in the order the products read them:
// q and k in chunks of SC columns, then v in chunks of VC, then the next
// pair's q and k; a chunk lands RING - 1 chunks ahead of its use, so a
// pair's loads hide behind the products as the resident pair's do. The
// arithmetic is the resident core's: the scores are summed over the same
// 8-column k steps in the same order d = 0 .. hd (a chunk's steps, then
// the next chunk's, each through `mma3_add` into the same registers), the
// softmax runs in those registers once the last chunk is summed, and P V
// forms 64 output columns a v chunk.
// SLABS: the pair has fewer warps than 16-row slabs (`pairs`): each pair
// streams `rounds` times, round rnd's warp w on slab w + rnd * pt / 32 (a
// warp past the last slab only copies).
template <int NT, class Addr, bool SLABS = false>
__device__ __forceinline__ void pairs_streamed(
    const Addr& a, int first, int total, int step, int heads, float* smem,
    int t, int pt, int bar, const float* __restrict__ bias,
    const float* __restrict__ mask, int n_mask, int TN, int hd, float scale) {
  const int nt = TN / 8, nqk = (hd + SC - 1) / SC, per = nqk + (hd + VC - 1) / VC;
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int rounds = SLABS ? (2 * TN + pt - 1) / pt : 1;
  const int n_mine = first < total ? (total - first + step - 1) / step : 0;
  const int n_chunks = n_mine * rounds * per;
  const auto sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(pt) : "memory");
  };
  // chunk c of this block's stream into its slot, then a commit (empty
  // past the last)
  const auto load = [&](int c) {
    if (c < n_chunks) {
      const int p = first + (c / per / rounds) * step, r = c % per;
      const int bw = p / heads, h = p - bw * heads;
      float* slot = smem + (c % RING) * TN * SLOT;
      if (r < nqk) {
        const int c0 = r * SC, w = hd - c0 < SC ? hd - c0 : SC;
        load_cols(a, bw, h, 0, c0, w, slot, SLD, TN, t, pt);
        load_cols(a, bw, h, 1, c0, w, slot + TN * SLD, SLD, TN, t, pt);
      } else {
        const int c0 = (r - nqk) * VC, w = hd - c0 < VC ? hd - c0 : VC;
        load_cols(a, bw, h, 2, c0, w, slot, VLD, TN, t, pt);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int c = 0; c < RING - 1; ++c) load(c);

  float s[NT][4];
  for (int c = 0; c < n_chunks; ++c) {
    const int p = first + (c / per / rounds) * step, r = c % per;
    const int bw = p / heads, h = p - bw * heads;
    const int q0 = (t >> 5) * 16 + (c / per % rounds) * (pt / 2);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
    sync();  // chunk c has landed; every warp is done with chunk c - 1
    load(c + RING - 1);  // into chunk c - 1's slot
    const float* slot = smem + (c % RING) * TN * SLOT;

    if (SLABS && q0 >= TN) {  // past the last slab: this warp only copies
    } else if (r < nqk) {
      // ---- scores: this chunk's k steps added to s[j] ----
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      }
      const int w = hd - r * SC < SC ? hd - r * SC : SC;
      scores_add<NT>(s, slot + q0 * SLD, slot + TN * SLD, SLD, w, nt, g, tq);
      if (r == nqk - 1) {
        // ---- softmax of rows q0 + g and q0 + g + 8, as `pairs` ----
        softmax_rows<NT>(
            s, bias + ((long long)h * TN + q0 + g) * TN + 2 * tq,
            mask ? mask + ((long long)(bw % n_mask) * TN + q0 + g) * TN +
                       2 * tq
                 : nullptr,
            nt, TN, scale);
      }
    } else {
      // ---- o = P V over this chunk's VC columns, as `pairs` ----
      const int c0 = (r - nqk) * VC;
      float* d0 = a.dst(a.row(bw, h, q0 + g), h) + c0 + 2 * tq;
      float* d1 = a.dst(a.row(bw, h, q0 + g + 8), h) + c0 + 2 * tq;
      pv_store<NT>(s, slot + 2 * tq * VLD + g, VLD, c0, hd, nt, d0, d1);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace attn32
