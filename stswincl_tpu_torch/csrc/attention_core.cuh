// The register-resident window-attention core: softmax(q k^T * scale +
// bias (+ mask)) v for one (window, head) pair, run by the pair's TN / 16
// warps. K1's attention step and the standalone attention kernels of the
// `attn_impl` routes 'pallas' and 'pallas_windows' launch it
// (window_attention.cu, which says what it replaces and what bounds it);
// the whole-block kernel (swin_block.cuh) runs it on its consumer warps in
// its attention phase. Past a block's shared memory (hd past 288 at TN 128)
// K1, the standalone kernels and the whole-block kernel run the streamed
// form of the same steps, `pairs_streamed`. The address functors say where
// a (window, head, token) row lives.
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

// The steps of the core, each on one warp's 16 query rows (lane g =
// lane / 4, tq = lane % 4 holds rows g and g + 8): `pair_core` runs them on
// a pair resident in shared memory, `pairs_streamed` on chunks of it.

// s[j] (the 16 x 8 tile of keys 8j .. 8j + 7, j < 2 nt) += q k^T over the
// w columns at `qa` / `kb` (the lane's ldmatrix row addresses of q's 16
// rows and of k's first key tile, rows of ld bf16): k16 steps in order; at
// w % 16 == 8 the last step reads the 8 pad columns of the q and k rows,
// which hold zeros.
template <int NT>
__device__ __forceinline__ void scores_add(float (&s)[2 * NT][4],
                                           const bf16* qa, const bf16* kb,
                                           int ld, int w, int nt) {
  for (int kk = 0; kk < w; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, qa + kk);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t bf[4];
        ldsm_x4(bf, kb + j * 16 * ld + kk);
        mma16816(s[2 * j], af, bf[0], bf[1]);
        mma16816(s[2 * j + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// The softmax of rows g (s[j][0..1]) and g + 8 (s[j][2..3]) in the score
// registers: the scale after the product, + the bias row (`bias_r`), + the
// mask row (`mask_r`, or null), the row max and sum across the quad, exp,
// a multiply by the reciprocal of the sum; P in bf16 as the A fragments of
// P V (pa[kt]: k tile kt is key tiles 2kt, 2kt + 1).
template <int NT>
__device__ __forceinline__ void softmax_p(float (&s)[2 * NT][4],
                                          uint32_t (&pa)[NT][4],
                                          const float* bias_r,
                                          const float* mask_r, int nt,
                                          int TN, float scale) {
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
}

// o (o[j]: columns 8j .. 8j + 7 of rows g and g + 8) = P V over the w
// columns (at most 64) at `vb` (the lane's ldmatrix.trans row address of
// v's first key tile, rows of ld bf16); at w % 16 == 8 the last n8 tile
// reads v's 8 pad columns into columns that are never stored.
template <int NT>
__device__ __forceinline__ void pv_tile(float (&o)[8][4],
                                        const uint32_t (&pa)[NT][4],
                                        const bf16* vb, int ld, int w,
                                        int nt) {
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < nt) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (16 * jj < w) {
          uint32_t bf[4];
          ldsm_x4_t(bf, vb + kt * 16 * ld + 16 * jj);
          mma16816(o[2 * jj], pa[kt], bf[0], bf[1]);
          mma16816(o[2 * jj + 1], pa[kt], bf[2], bf[3]);
        }
      }
    }
  }
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
// At a head dim of 8 mod 16 the scores' last k16 step reads the 8 pad
// columns of the q and k rows, which are zeroed first; P V's n8 tiles past
// hd read v's pad into columns that are never stored.
// Returns once the pair's output rows are stored; a caller that reuses
// `base` meets the pair's threads first.
// SLABS: the pair has fewer warps (pt / 32) than 16-row slabs (row 16 past
// 128 tokens, 8 warps for up to 11 slabs): warp wi takes slabs wi, wi +
// pt / 32, ... one after another, each row computed as above, so the
// bits do not change.
template <int NT, class Addr, bool SLABS = false>
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
  if (hd % 16) {  // QK^T's last k16 step reads the 8-column pad: zero it
    for (int r = t; r < 2 * TN; r += pt)
      *reinterpret_cast<uint4*>(qs + size_t(r) * L.ld + hd) =
          make_uint4(0u, 0u, 0u, 0u);
  }
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

  const int g = lane >> 2, tq = lane & 3;
  for (int q0 = wi * 16;; q0 += pt / 2) {
    // ---- scores: s[j] is the 16 x 8 tile of keys 8j .. 8j + 7 ----
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    scores_add<NT>(s, qs + (q0 + (lane & 15)) * L.ld + (lane >> 4) * 8,
                   ks + ((lane & 7) + ((lane >> 4) << 3)) * L.ld +
                       ((lane >> 3) & 1) * 8,
                   L.ld, hd, nt);

    // ---- softmax of rows q0 + g and q0 + g + 8; P in bf16 ----
    uint32_t pa[NT][4];
    softmax_p<NT>(
        s, pa, bias + ((long long)h * TN + q0 + g) * TN + 2 * tq,
        mask ? mask + ((long long)(bw % n_mask) * TN + q0 + g) * TN + 2 * tq
             : nullptr,
        nt, TN, scale);

    if (!SLABS || q0 == wi * 16) {  // every warp has a first slab
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      sync_pair();  // v has landed
    }

    // ---- o = P V, 64 columns at a time, staged as bf16 over this warp's
    // q rows of the slab (read by no other warp) ----
    bf16* os = qs + q0 * L.ld;
    const bf16* vb = vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * L.ld +
                     (lane >> 4) * 8;
    for (int c0 = 0; c0 < hd; c0 += 64) {
      float o[8][4];
      pv_tile<NT>(o, pa, vb + c0, L.ld, hd - c0, nt);
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
    if (!SLABS || q0 + pt / 2 >= TN) break;
  }
}

// ---- the streamed pair: the windows whose q, k and v do not fit a block

// Shared memory one block may use on sm_90 (`kernels.SMEM_LIMIT`): the
// library decides from the shapes against it which instance a window gets.
constexpr size_t SMEM_LIMIT = 232448;

// Whether a window runs the resident pair (`pair_core`): its q, k, v and
// row offsets fit one block. Every other window streams (`pairs_streamed`).
__host__ __device__ inline bool resident(int TN, int hd) {
  return pair_smem(TN, hd).total <= SMEM_LIMIT;
}

// The streamed pair's ring: RING slots of TN rows of SLOT bf16, each
// holding a chunk of SC columns of q and of k (rows of SLD) or of VC
// columns of v (rows of VLD): 16 bytes of padding a row, as the resident
// rows (ldmatrix rows on distinct banks). 864 TN bytes whatever the head
// dim.
constexpr int SC = 64, VC = 128, RING = 3;
constexpr int SLD = SC + 8, VLD = VC + 8, SLOT = 2 * SLD;
static_assert(VLD <= SLOT, "a v chunk fits a slot");
__host__ __device__ inline size_t streamed_bytes(int TN) {
  return size_t(RING) * TN * SLOT * sizeof(bf16);
}

// The shared memory of the instance a window gets (`ops/attention.py`
// `_attn_plan_bytes`): the resident pair's where it fits, else the ring's.
__host__ __device__ inline size_t plan_bytes(int TN, int hd) {
  return resident(TN, hd) ? pair_smem(TN, hd).total : streamed_bytes(TN);
}

// The attention of pairs first, first + step, ... < total (pair p is
// window p / heads, head p % heads) by pt = TN / 16 * 32 threads (t = 0 ..
// pt - 1 their index) in `smem` (streamed_bytes(TN)), meeting on named
// barrier `bar` of pt threads; the other arguments as `pair_core`'s. The
// pair streams through a ring of RING slots, one chunk a slot, in the
// order the products read them: q and k in chunks of SC columns, then v in
// chunks of VC, then the next pair's q and k; a chunk lands RING - 1
// chunks ahead of its use. Thread t copies row t / 2 of each chunk (its
// half of the 16-byte pieces), so it maps one row a pair. The arithmetic
// is the resident core's, so the two give the same bits: the scores are
// summed over the same k16 steps in the same order d = 0 .. hd (a chunk's
// steps, then the next chunk's, into the same registers; the last chunk's
// 8-column pad zeroed where hd % 16 == 8), the softmax and the bf16 P
// (`softmax_p`) run in those registers once the last chunk is summed, and
// P V (`pv_tile`) forms 64 output columns at a time, each lane's 8
// consecutive columns of one row after a quad transpose, stored 16 bytes
// at a time straight from the registers.
// SLABS: the pair has fewer warps than 16-row slabs (`pair_core`'s): each
// pair streams `rounds` times, round rnd's warp wi on slab wi + rnd * pt /
// 32 (a warp past the last slab only copies), and thread t copies rows t /
// 2, t / 2 + pt / 2, ... of each chunk.
template <int NT, class Addr, bool SLABS = false>
__device__ __forceinline__ void pairs_streamed(
    const Addr& a, int first, int total, int step, int heads, bf16* smem,
    int t, int pt, int bar, const float* __restrict__ bias,
    const float* __restrict__ mask, int n_mask, int TN, int hd,
    float scale) {
  const int nt = TN / 16, nqk = (hd + SC - 1) / SC;
  const int per = nqk + (hd + VC - 1) / VC;
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int rounds = SLABS ? (2 * TN + pt - 1) / pt : 1;
  const int n_mine = first < total ? (total - first + step - 1) / step : 0;
  const int n_chunks = n_mine * rounds * per;
  const int lr = t >> 1, half = t & 1;  // the row this thread copies
  long long lrow = 0;
  int lpair = -1;
  const auto sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(pt) : "memory");
  };
  // row rr (at `row`) of chunk r of pair head h into `slot`
  const auto copy = [&](bf16* slot, int rr, long long row, int h, int r) {
    if (r < nqk) {
      const int c0 = r * SC, w = hd - c0 < SC ? hd - c0 : SC;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const bf16* src = a.in(row, h, which) + c0;
        bf16* dst = slot + (which * TN + rr) * SLD;
        for (int i = 8 * half; i < w; i += 16) cp_async16(dst + i, src + i);
      }
      if (w % 16)  // the last k16 step reads the pad: q's, k's zeroed
        *reinterpret_cast<uint4*>(slot + (half * TN + rr) * SLD + w) =
            make_uint4(0u, 0u, 0u, 0u);
    } else {
      const int c0 = (r - nqk) * VC, w = hd - c0 < VC ? hd - c0 : VC;
      const bf16* src = a.in(row, h, 2) + c0;
      bf16* dst = slot + rr * VLD;
      for (int i = 8 * half; i < w; i += 16) cp_async16(dst + i, src + i);
    }
  };
  // chunk c of this block's stream into its slot, then a commit (empty
  // past the last)
  const auto load = [&](int c) {
    if (c < n_chunks) {
      const int p = first + (c / per / rounds) * step, r = c % per;
      const int bw = p / heads, h = p - bw * heads;
      if (p != lpair) {
        lrow = a.row(bw, h, lr);
        lpair = p;
      }
      bf16* slot = smem + (c % RING) * TN * SLOT;
      if constexpr (SLABS) {
        for (int rr = lr; rr < TN; rr += pt / 2)
          copy(slot, rr, rr == lr ? lrow : a.row(bw, h, rr), h, r);
      } else {
        copy(slot, lr, lrow, h, r);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int c = 0; c < RING - 1; ++c) load(c);

  // chunk c's slot once it has landed and every warp is done with chunk c
  // - 1, whose slot then takes chunk c + RING - 1
  int c = 0;
  const auto next = [&]() -> const bf16* {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
    sync();
    load(c + RING - 1);
    return smem + (c++ % RING) * TN * SLOT;
  };
  // ldmatrix row addresses within a chunk: k's and v's keys
  const int kb = (TN + (lane & 7) + ((lane >> 4) << 3)) * SLD +
                 ((lane >> 3) & 1) * 8;
  const int vb = ((lane & 7) + (((lane >> 3) & 1) << 3)) * VLD +
                 (lane >> 4) * 8;
  for (int p = first; p < total; p += step) {
    const int bw = p / heads, h = p - bw * heads;
    for (int rnd = 0; rnd < rounds; ++rnd) {
      const int q0 = (t >> 5) * 16 + rnd * (pt / 2);
      const bool live = !SLABS || q0 < TN;  // else this warp only copies
      const int qa = (q0 + (lane & 15)) * SLD + (lane >> 4) * 8;
      // ---- scores: each q and k chunk's k16 steps added to s[j] ----
      float s[2 * NT][4];
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      for (int c0 = 0; c0 < hd; c0 += SC) {
        const bf16* slot = next();
        if (live)
          scores_add<NT>(s, slot + qa, slot + kb, SLD,
                         hd - c0 < SC ? hd - c0 : SC, nt);
      }
      // ---- softmax of rows q0 + g and q0 + g + 8, as `pair_core` ----
      uint32_t pa[NT][4];
      if (live)
        softmax_p<NT>(
            s, pa, bias + ((long long)h * TN + q0 + g) * TN + 2 * tq,
            mask ? mask + ((long long)(bw % n_mask) * TN + q0 + g) * TN +
                       2 * tq
                 : nullptr,
            nt, TN, scale);
      // ---- o = P V over each v chunk's VC columns, 64 at a time; lane tq
      // stores row g (tq < 2) or g + 8, columns 8 (2 jj + tq % 2) .. + 7
      // of each 16 ----
      bf16* orow =
          live ? a.dst(a.row(bw, h, q0 + g + 8 * (tq >> 1)), h) : nullptr;
      for (int c0 = 0; c0 < hd; c0 += VC) {
        const bf16* slot = next();
        const int w = hd - c0 < VC ? hd - c0 : VC;
        for (int c1 = 0; live && c1 < w; c1 += 64) {
          float o[8][4];
          pv_tile<NT>(o, pa, slot + vb + c1, VLD, w - c1, nt);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (c1 + 16 * jj < w) {
              uint32_t wd[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int j = 2 * jj + (i & 1), hh = i >> 1;
                wd[i] = pack_bf16(o[j][2 * hh], o[j][2 * hh + 1]);
              }
              quad_transpose(wd, tq);
              const int col = c1 + 8 * (2 * jj + (tq & 1));
              if (col < w)
                *reinterpret_cast<uint4*>(orow + c0 + col) =
                    make_uint4(wd[0], wd[1], wd[2], wd[3]);
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace attn
