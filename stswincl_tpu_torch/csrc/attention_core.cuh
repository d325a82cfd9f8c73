// The register-resident window-attention core: softmax(q k^T * scale +
// bias (+ mask)) v for one (window, head) pair, run by the pair's TN / 16
// warps. K1's attention step and the standalone attention kernels of the
// `attn_impl` routes 'pallas' and 'pallas_windows' launch it
// (window_attention.cu, which says what it replaces and what bounds it);
// the whole-block kernel (swin_block.cu) runs it on its consumer warps in
// its attention phase. The address functors say where a (window, head,
// token) row lives.
#pragma once

#include "common.cuh"

namespace attn {

constexpr int MAX_NT = 11;  // 16-key tiles: TN <= 176

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

// Shared memory of one pair: q, k and v in bf16 rows of hd + 8 (16 bytes
// of padding: ldmatrix rows on distinct banks), then the TN row offsets.
struct PairSmem {
  int ld;                  // bf16 row stride of q, k, v: hd + 8
  size_t kv, rows, total;  // offsets of k (v follows), the row offsets; size
};

__host__ __device__ inline PairSmem pair_smem(int TN, int hd) {
  PairSmem m;
  m.ld = hd + 8;
  const size_t one = size_t(TN) * m.ld * sizeof(bf16);
  m.kv = one;
  m.rows = align128(3 * one);
  m.total = m.rows + align128(size_t(TN) * sizeof(long long));
  return m;
}

// The attention of (window bw, head h) by the pair's pt = TN / 16 * 32
// threads (t = 0 .. pt - 1 their index in the pair) in `base`
// (pair_smem(TN, hd).total bytes), meeting on named barrier `bar` of pt
// threads. Each warp owns 16 query rows: mma.sync m16n8k16 (bf16 -> fp32)
// fed by ldmatrix from shared memory (.trans for V) computes its 16 x TN
// scores into registers, where the scale, bias, mask, the row max and sum
// (quad shuffles) and the bf16 P stay: the score accumulators become P V's
// A fragments without leaving the registers. q, k and v are copied with
// cp.async, v in a second group that lands while the scores are computed;
// a warp's q rows, read only by that warp, then stage its output for
// 16-byte stores. NT (the score registers, 16-key tiles) >= TN / 16.
// Returns once the pair's output rows are stored; a caller that reuses
// `base` meets the pair's threads first.
template <int NT, class Addr>
__device__ __forceinline__ void pair_core(
    const Addr& a, int bw, int h, unsigned char* base, int t, int pt,
    int bar, const float* __restrict__ bias, const float* __restrict__ mask,
    int n_mask, int TN, int hd, float scale) {
  const PairSmem L = pair_smem(TN, hd);
  const int nt = TN / 16;
  const int wi = t >> 5, lane = t & 31;
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = reinterpret_cast<bf16*>(base + L.kv);
  bf16* vs = ks + size_t(TN) * L.ld;
  long long* rows = reinterpret_cast<long long*>(base + L.rows);

  const auto sync_pair = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(pt) : "memory");
  };
  for (int r = t; r < TN; r += pt) rows[r] = a.row(bw, h, r);
  sync_pair();
  // q and k in one cp.async group, v in a second that lands while the
  // scores are computed
  const int chunks = hd / 8;
  for (int which = 0; which < 3; ++which) {
    for (int i = t; i < TN * chunks; i += pt) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      cp_async16(qs + (size_t(which) * TN + r) * L.ld + c,
                 a.in(rows[r], h, which) + c);
    }
    if (which) asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  sync_pair();

  const int q0 = wi * 16, g = lane >> 2, tq = lane & 3;
  // ---- scores: s[j] is the 16 x 8 tile of keys 8j .. 8j + 7 ----
  float s[2 * NT][4];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  const bf16* qa = qs + (q0 + (lane & 15)) * L.ld + (lane >> 4) * 8;
  const bf16* kb = ks + ((lane & 7) + ((lane >> 4) << 3)) * L.ld +
                   ((lane >> 3) & 1) * 8;
  for (int kk = 0; kk < hd; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, qa + kk);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t bf[4];
        ldsm_x4(bf, kb + j * 16 * L.ld + kk);
        mma16816(s[2 * j], af, bf[0], bf[1]);
        mma16816(s[2 * j + 1], af, bf[2], bf[3]);
      }
    }
  }

  // ---- softmax of rows q0 + g (s[j][0..1]) and q0 + g + 8 (s[j][2..3]) --
  const float* bias_r = bias + ((long long)h * TN + q0 + g) * TN + 2 * tq;
  const float* mask_r =
      mask ? mask + ((long long)(bw % n_mask) * TN + q0 + g) * TN + 2 * tq
           : nullptr;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    if (j < 2 * nt) {
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
  for (int j = 0; j < 2 * NT; ++j) {
    if (j < 2 * nt) {
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
  // P in bf16 as the A fragments of P V: k tile kt is key tiles 2kt, 2kt+1
  uint32_t pa[NT][4];
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < nt) {
      pa[kt][0] = pack_bf16(s[2 * kt][0] * inv[0], s[2 * kt][1] * inv[0]);
      pa[kt][1] = pack_bf16(s[2 * kt][2] * inv[1], s[2 * kt][3] * inv[1]);
      pa[kt][2] =
          pack_bf16(s[2 * kt + 1][0] * inv[0], s[2 * kt + 1][1] * inv[0]);
      pa[kt][3] =
          pack_bf16(s[2 * kt + 1][2] * inv[1], s[2 * kt + 1][3] * inv[1]);
    }
  }

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  sync_pair();  // v has landed

  // ---- o = P V, 64 columns at a time, staged as bf16 over this warp's q
  // rows (read by no other warp) ----
  bf16* os = qs + q0 * L.ld;
  const bf16* vb = vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * L.ld +
                   (lane >> 4) * 8;
  for (int c0 = 0; c0 < hd; c0 += 64) {
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      if (kt < nt) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (c0 + 16 * jj < hd) {
            uint32_t bf[4];
            ldsm_x4_t(bf, vb + kt * 16 * L.ld + c0 + 16 * jj);
            mma16816(o[2 * jj], pa[kt], bf[0], bf[1]);
            mma16816(o[2 * jj + 1], pa[kt], bf[2], bf[3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * j + 2 * tq;
      if (c0 + 8 * j < hd) {
        *reinterpret_cast<uint32_t*>(os + g * L.ld + c) =
            pack_bf16(o[j][0], o[j][1]);
        *reinterpret_cast<uint32_t*>(os + (g + 8) * L.ld + c) =
            pack_bf16(o[j][2], o[j][3]);
      }
    }
  }
  __syncwarp();
  // the warp's 16 output rows: 8 bf16 (16 bytes) a store
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    *reinterpret_cast<uint4*>(a.dst(rows[q0 + r], h) + c) =
        *reinterpret_cast<const uint4*>(os + r * L.ld + c);
  }
}

}  // namespace attn
