// K5 fp32's attention backward on the tensor cores: every product as a
// 3xTF32 split on mma.sync m16n8k8 (tf32x3.cuh). fp32_train.cu launches
// it between K5's dattn and dx products (`attn_bwd_f32`), and alone for
// timing (`stswin_attn_bwd_f32`).
//
// Replaces, with the products of K5's fp32 form, the attention part of
// stswincl_tpu/ops/pallas_block_attention.py
// fused_swin_block_attention_bwd (:547) -> _full_bwd_kernel (:405) in
// fp32 (Pallas row 6). For a (window bw, head h) it computes what the twin
// `swin_block_attention_bwd_ref` does (autograd of `attend_tiled`):
//   S = q k^T * scale + bias[h] (+ mask[bw % n_mask]), the scale after
//   the product; P = softmax over keys, fp32 (exp(S - max) * 1 / sum);
//   dP = dO v^T; D = sum_j dP P; dS = P (dP - D);
//   dq = dS k * scale, dk = dS^T q * scale, dv = P^T dO,
//   dbias[h] = the sum of dS over the windows (the mask gets none).
// Five products of 2 TN^2 hd flops a pair; the two passes form seven (S
// and dP in both).
//
// Bound on the H100. Stage 1 (1280 windows x 4 heads, TN 128, hd 128):
// the bytes of q, k, v, dO, dq, dk and dv (7 x 335 MB) take 0.70 ms at
// 3.35 TB/s, the five products (107 GFLOP) 0.65 ms at the 3xTF32 rate
// (164.9 TFLOP/s), the seven of the passes 0.91 ms; each pass reads its
// inputs once, so the bytes the passes move are about 1.3 GB. mma.sync
// reaches about 300 TFLOP/s of TF32 (`tools/profile_mma_rate.py`), about
// 100 of 3xTF32.
//
// The split: hi rounded to nearest, lo left to the mma's truncation (the
// attention core's `tf32x3::split`); each k step's three passes summed
// from 0 and added to fp32 sums rounded to nearest (`tf32x3::mma3_add`).
// `tests/test_torch_tf32x3.py` emulates this arithmetic on the attention
// backward and holds it within the fp32 bound, one TF32 pass tenfold out.
//
// Two launches and a fixed-order sum (no float atomics; every output the
// same bits from call to call):
//   a. the query pass (`q_kernel`): a block of TN / 16 warps holds k and v
//      of a (window, head) in shared memory, each warp its 16 query rows
//      of q, then of dO, in a region of its own. A warp forms its 16 x TN
//      score tile in registers (S = q k^T, the forward core's fragments),
//      the softmax there, then dP = dO v^T beside it, D and dS = P (dP -
//      D) in place, and dq = dS k with dS as the A fragment from the
//      registers: the accumulator of key tile j is the A fragment of k
//      step j when k index t stands for key 8j + 2t and t + 4 for 8j + 2t
//      + 1, so k's B fragment is k[8j + 2t (+1)][column g]. It writes each
//      row's max, 1 / sum and D. The blocks are persistent over a run of
//      windows of one head (`q_split`), so each adds its dS, the bias's
//      gradient, into a partial table of its own, window by window (each
//      lane its own entries: the same order every call); `sum_parts` adds
//      the tables in order.
//   b. the key pass (`kv_kernel`): a block a (window, head), each warp 16
//      keys (and, past hd 128, 128 of the columns: two warps a key group
//      at hd 256). k and v stay in shared memory; q and dO stream through
//      a ring of 16-query chunks (cp.async, up to two chunks ahead). A warp
//      forms the transposed tiles k q^T and v dO^T of its keys against the
//      chunk directly (the same terms in the same order as pass a's q k^T
//      and dO v^T: `mma3_add`'s MIRROR), P^T and dS^T from the saved max,
//      1 / sum and D of each query column, and with them as A fragments
//      from the registers dv += P^T dO and dk += dS^T q, 16 x hd
//      accumulators each (at most 128 columns a warp: 128 registers).
// Every row of shared memory is hd + 4 floats (4 mod 32 words): the A and
// B fragment reads fall on banks 4g + t, the B reads of the products from
// registers on 8t + g (+ 4), all distinct. The query pass's k, v and q
// (dO) of TN 128 x hd 128 take 198 KB (one block, 8 warps an SM); the
// next window's v and q load behind this one's dbias and dq, its k behind
// the barrier after dq.
//
// Past that window (a head dim past 128, or 256 to 32 tokens; windows past
// 128 tokens) the window's q, k, v and dO no longer fit a block, and the
// backward streams them instead (`qs_kernel`, `kvs_kernel`): the same
// windows as K1's fp32 core (`attn32::takes`), through the forward's
// streamed ring. Bound there: the five products and the seven tensors'
// bytes as above, plus P and dS of every pair written once by the query
// pass and read once by the key pass (4 TN^2 floats a pair).
//   a'. the query pass (`qs_kernel`): blocks as in pass a, persistent over
//      the windows of one head, each warp its 16 query rows. Every tensor
//      streams through `attn32`'s ring of RING slots, one chunk a slot:
//      q and k in chunks of SC columns (S = q k^T summed over the chunks'
//      k steps in order d = 0 .. hd into the score registers), the
//      softmax, P written to the workspace, then dO and v in the same
//      chunks (dP = dO v^T into the same registers; P read back for D and
//      dS = P (dP - D)), dS written beside P and added to the block's
//      dbias partial, then k again in chunks of VC columns for dq = dS k
//      (dS the A fragment from the registers). One score tile of
//      registers lives at a time, so TN 176 (22 key tiles, 11 warps)
//      fits a thread's share of the register file.
//   b'. the key pass (`kvs_kernel`): a block a (window, head) and KC
//      columns of hd, each warp 16 keys; P, dS, q and dO stream through a
//      ring of QC-query chunks (P and dS whole rows of the window, q and
//      dO the block's columns), and dv += P^T dO, dk += dS^T q with P^T
//      and dS^T read as A fragments straight from the chunk. No sum over
//      hd: any head dim fits.
#pragma once

#include "common.cuh"
#include "fp32_attention.cuh"
#include "tf32x3.cuh"

namespace attn32b {

constexpr int QC = 16;      // query rows of a key-pass chunk
constexpr int QT = QC / 8;  // its 8-query tiles
constexpr int HC = 128;     // columns of dk and dv a key-pass warp holds
constexpr int SMS = 132;    // the H100's SMs: the query pass's grid
constexpr int SM_SMEM = 233472;  // shared memory of an SM
constexpr int KC = 64;      // columns of hd a streamed key-pass block holds
constexpr int KLD = KC + 8;  // rows of its q and dO chunks
constexpr int KRING = 3;    // its ring of QC-query chunks

// the key pass's ring: three chunks past 32 queries, else two
__host__ __device__ inline int ring_stages(int TN) {
  return TN / QC >= 3 ? 3 : 2;
}
// warps a key group of the key pass: one a 128 columns of hd
__host__ __device__ inline int col_splits(int hd) { return (hd + HC - 1) / HC; }

// Whether a window runs the resident passes (a and b): 16-token tiles up
// to 128 (the query pass's score tile is 16 key tiles of 8 at most) and
// head dims of 8 up to 256 at TN <= 32 and 128 beyond (the key pass's dk
// and dv accumulators: 128 columns a warp, two warps a key group past 128).
// The rest of `attn32::takes` streams (a' and b').
__host__ __device__ inline bool resident(int TN, int hd) {
  return TN > 0 && TN % 16 == 0 && TN <= 128 && hd > 0 && hd % 8 == 0 &&
         hd <= (TN <= 32 ? 256 : 128);
}

// Shared memory (`_attn_f32_bwd_smem_bytes` in ops/block_attention.py):
// the query pass k, v and a q / dO region of TN rows; the key pass k, v
// and the ring of q and dO chunks; rows of hd + 4 floats.
inline size_t q_smem(int TN, int hd) {
  return size_t(3) * TN * (hd + 4) * sizeof(float);
}
inline size_t kv_smem(int TN, int hd) {
  return (size_t(2) * TN + size_t(2) * QC * ring_stages(TN)) * (hd + 4) *
         sizeof(float);
}
// The streamed passes: the query pass the forward's ring; the key pass
// KRING chunks of P and dS (QC rows of TN + 8 floats: 8 or 24 mod 32
// words, so the transposed A fragment reads fall on distinct banks) and of
// q and dO (QC rows of KLD).
inline size_t qs_smem(int TN) { return attn32::streamed_bytes(TN); }
__host__ __device__ inline int kvs_stage(int TN) {
  return 2 * QC * (TN + 8) + 2 * QC * KLD;
}
inline size_t kvs_smem(int TN) {
  return size_t(KRING) * kvs_stage(TN) * sizeof(float);
}
// The window's plan: the larger of its two passes' shared memory.
inline size_t smem_bytes(int TN, int hd) {
  const size_t a = resident(TN, hd) ? q_smem(TN, hd) : qs_smem(TN);
  const size_t b = resident(TN, hd) ? kv_smem(TN, hd) : kvs_smem(TN);
  return a > b ? a : b;
}

// The query pass's blocks an SM: as many as shared memory holds, up to 8
// warps an SM at TN > 64 (a thread's score and dP tiles take 128 of its
// registers), 16 below. From the shapes alone, so every card sums dbias in
// the same order.
inline int q_blocks_per_sm(int TN, int hd) {
  const int warps = TN / 16;
  const int by_warps = (TN > 64 ? 8 : 16) / warps;
  const size_t bytes = resident(TN, hd) ? q_smem(TN, hd) : qs_smem(TN);
  const int by_smem = SM_SMEM / int(bytes + 1024);
  const int b = by_warps < by_smem ? by_warps : by_smem;
  return b < 1 ? 1 : b;
}

// The query pass's grid: per_head blocks a head (the dbias partial tables
// of each head), each over per_block consecutive windows (the last fewer).
inline void q_split(int n_windows, int heads, int TN, int hd, int* per_head,
                    int* per_block) {
  int ph = SMS * q_blocks_per_sm(TN, hd) / heads;
  if (ph < 1) ph = 1;
  if (ph > n_windows) ph = n_windows;
  const int pb = (n_windows + ph - 1) / ph;
  *per_block = pb;
  *per_head = (n_windows + pb - 1) / pb;
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async `rows` rows of hd floats from `src` (rows lds floats apart)
// into shared rows of ld, by the caller's threads t = 0 .. nt - 1
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, long long lds,
                                          int rows, int hd, int t, int nt) {
  const int chunks = hd >> 2;
  for (int i = t; i < rows * chunks; i += nt) {
    const int r = i / chunks, c = (i - r * chunks) << 2;
    cp_async16(dst + r * ld + c, src + r * lds + c);
  }
}

// acc[j] (j < nt: columns 8j .. 8j + 7) = a b^T over hd: a the 16 rows
// at `a`, b the rows at `b`, both in shared memory (rows of ld); lane g =
// lane / 4, t = lane % 4 holds rows g and g + 8, columns 8j + 2t (+1). The
// fragments as the forward core reads them (`attn32::pairs`), the column
// tiles in fours, their chains interleaved (nt is even: a last pair
// alone).
template <int NT, bool MIRROR>
__device__ __forceinline__ void rows_nt(float (&acc)[NT][4], const float* a,
                                        const float* b, int ld, int hd,
                                        int nt, int g, int tq) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const float* aa = a + g * ld + tq;
  const float* bb = b + g * ld + tq;
  for (int kk = 0; kk < hd; kk += 8) {
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
        tf32x3::mma3_add<4, NT, MIRROR>(acc, j, fa, fb);
      } else if (j < nt) {
        tf32x3::FragB fb[2];
        fb[0].set(br[0], br[4]);
        fb[1].set(br[8 * ld], br[8 * ld + 4]);
        tf32x3::mma3_add<2, NT, MIRROR>(acc, j, fa, fb);
      }
    }
  }
}

// out[n] (n < CT: columns 8n .. 8n + 7 of `b`) += s b over the k steps j <
// nk: s[j] a score accumulator as the A fragment (k index t: row 8j + 2t
// of b, t + 4: row 8j + 2t + 1), b in shared memory (rows of ld, column g
// of the tile); the tiles below ncols (a multiple of 32), in fours; with
// TAIL (ncols a multiple of 8) those of a last group of fewer than four
// one at a time. Head dims a multiple of 32 run instances without TAIL:
// one instance for both took about 4 % longer at C 512, hd 128 (H100).
template <int NK, int CT, bool TAIL>
__device__ __forceinline__ void regs_rows(float (&out)[CT][4],
                                          float (&s)[NK][4], int nk,
                                          const float* b, int ld, int ncols,
                                          int g, int tq) {
  const float* bb = b + 2 * tq * ld + g;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (j < nk) {
      tf32x3::FragA fa;
      fa.set(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* br = bb + j * 8 * ld;
#pragma unroll
      for (int n = 0; n < CT; n += 4) {
        if (TAIL ? 8 * (n + 4) <= ncols : 8 * n < ncols) {
          tf32x3::FragB fb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            fb[u].set(br[8 * (n + u)], br[ld + 8 * (n + u)]);
          tf32x3::mma3_add<4, CT>(out, n, fa, fb);
        } else if (TAIL) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (8 * (n + u) < ncols) {
              tf32x3::FragB fb[1];
              fb[0].set(br[8 * (n + u)], br[ld + 8 * (n + u)]);
              tf32x3::mma3_add<1, CT>(out, n + u, fa, fb);
            }
          }
        }
      }
    }
  }
}

// Pass a. Grid (per_head, heads), TN / 16 warps; NT >= TN / 8. qkv, dqkv:
// window-order rows of 3C; dO: rows of C; stats: (windows, heads, TN, 4)
// [max, 1 / sum, D, 0]; dbias_part: (per_head, heads, TN, TN). TAIL: a
// head dim off 32 (`regs_rows`).
template <int NT, bool TAIL>
__global__ void __launch_bounds__(256) q_kernel(
    const float* __restrict__ qkv, const float* __restrict__ dO,
    const float* __restrict__ bias, const float* __restrict__ mask,
    int n_mask, float* __restrict__ dqkv, float* __restrict__ stats,
    float* __restrict__ dbias_part, int n_windows, int per_block, int heads,
    int TN, int hd, int C, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int ld = hd + 4, nt = TN / 8;
  const int t = threadIdx.x, pt = blockDim.x, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3, q0 = (t >> 5) * 16;
  float* Ks = sm;
  float* Vs = Ks + TN * ld;
  float* Xw = Vs + TN * ld + q0 * ld;  // this warp's q rows, then its dO
  const int h = blockIdx.y;
  const long long C3 = 3LL * C;
  const int w0 = blockIdx.x * per_block;
  const int w1 = w0 + per_block < n_windows ? w0 + per_block : n_windows;
  float* part = dbias_part + ((long long)blockIdx.x * heads + h) * TN * TN +
                (q0 + g) * TN + 2 * tq;
  const float* bias_r = bias + ((long long)h * TN + q0 + g) * TN + 2 * tq;
  // (`q_split` gives every block at least one window)
  const float* win = qkv + (long long)w0 * TN * C3 + h * hd;
  copy_rows(Ks, ld, win + C, C3, TN, hd, t, pt);
  copy_rows(Vs, ld, win + 2 * C, C3, TN, hd, t, pt);
  copy_rows(Xw, ld, win + q0 * C3, C3, 16, hd, lane, 32);
  commit();

  for (int bw = w0; bw < w1; ++bw) {
    win = qkv + (long long)bw * TN * C3 + h * hd;
    wait<0>();
    __syncthreads();  // k, v and the warps' q have landed

    // ---- S = q k^T, then the softmax in the registers ----
    float s[NT][4];
    rows_nt<NT, false>(s, Xw, Ks, ld, hd, nt, g, tq);
    __syncwarp();  // the warp has read its q: its dO goes over it
    copy_rows(Xw, ld, dO + ((long long)bw * TN + q0) * C + h * hd, C, 16, hd,
              lane, 32);
    commit();
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
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];

    // ---- dP = dO v^T; D = sum dP P; dS = P (dP - D) over dP ----
    wait<0>();
    __syncwarp();  // the warp's dO has landed
    float dp[NT][4];
    rows_nt<NT, false>(dp, Xw, Vs, ld, hd, nt, g, tq);
    float D[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) D[e >> 1] += dp[j][e] * s[j][e];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      D[hh] += __shfl_xor_sync(0xffffffffu, D[hh], 1);
      D[hh] += __shfl_xor_sync(0xffffffffu, D[hh], 2);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - D[e >> 1]);
    if (tq == 0) {
      float4* st = reinterpret_cast<float4*>(
          stats + (((long long)bw * heads + h) * TN + q0 + g) * 4);
      st[0] = make_float4(mx[0], inv[0], D[0], 0.0f);
      st[8] = make_float4(mx[1], inv[1], D[1], 0.0f);
    }
    __syncthreads();  // every warp has read v: the next window's v may land
    if (bw + 1 < w1) {
      const float* nx = win + TN * C3;
      copy_rows(Vs, ld, nx + 2 * C, C3, TN, hd, t, pt);
      copy_rows(Xw, ld, nx + q0 * C3, C3, 16, hd, lane, 32);
    }
    commit();

    // ---- the block's dbias partial, window by window ----
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* p = reinterpret_cast<float2*>(part + hh * 8 * TN + 8 * j);
          float2 v = make_float2(dp[j][2 * hh], dp[j][2 * hh + 1]);
          if (bw > w0) {
            const float2 o = *p;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *p = v;
        }
      }
    }

    // ---- dq = dS k * scale, 64 columns at a time ----
    float* d0 = dqkv + ((long long)bw * TN + q0 + g) * C3 + h * hd + 2 * tq;
    for (int c0 = 0; c0 < hd; c0 += 64) {
      float o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
      regs_rows<NT, 8, TAIL>(o, dp, nt, Ks + c0, ld,
                             hd - c0 < 64 ? hd - c0 : 64, g, tq);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (c0 + 8 * n < hd) {
          *reinterpret_cast<float2*>(d0 + c0 + 8 * n) =
              make_float2(o[n][0] * scale, o[n][1] * scale);
          *reinterpret_cast<float2*>(d0 + 8 * C3 + c0 + 8 * n) =
              make_float2(o[n][2] * scale, o[n][3] * scale);
        }
      }
    }
    __syncthreads();  // every warp has read k: the next window's may land
    if (bw + 1 < w1) copy_rows(Ks, ld, win + TN * C3 + C, C3, TN, hd, t, pt);
    commit();
  }
  wait<0>();
}

// Pass b. One block a (window, head): TN / 16 key groups x col_splits(hd)
// warps; CT >= min(hd, HC) / 8. stats from pass a; writes dk (scaled) and
// dv into dqkv. TAIL: a head dim off 32 (`regs_rows`).
template <int CT, bool TAIL>
__global__ void __launch_bounds__(256) kv_kernel(
    const float* __restrict__ qkv, const float* __restrict__ dO,
    const float* __restrict__ bias, const float* __restrict__ mask,
    int n_mask, const float* __restrict__ stats, float* __restrict__ dqkv,
    int heads, int TN, int hd, int C, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int ld = hd + 4, nkw = TN / 16, stages = ring_stages(TN);
  const int nch = TN / QC;
  const int t = threadIdx.x, pt = blockDim.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = (warp % nkw) * 16, cb = (warp / nkw) * HC;
  const int ncols = hd - cb < HC ? hd - cb : HC;
  float* Ks = sm;
  float* Vs = Ks + TN * ld;
  float* ring = Vs + TN * ld;  // [stages][q, dO][QC][ld]
  const int h = blockIdx.x % heads, bw = blockIdx.x / heads;
  const long long C3 = 3LL * C;
  const float* win = qkv + (long long)bw * TN * C3 + h * hd;
  const float* dwin = dO + (long long)bw * TN * C + h * hd;
  copy_rows(Ks, ld, win + C, C3, TN, hd, t, pt);
  copy_rows(Vs, ld, win + 2 * C, C3, TN, hd, t, pt);
  commit();
  const auto load_chunk = [&](int c) {
    float* q = ring + (c % stages) * 2 * QC * ld;
    copy_rows(q, ld, win + (long long)c * QC * C3, C3, QC, hd, t, pt);
    copy_rows(q + QC * ld, ld, dwin + (long long)c * QC * C, C, QC, hd, t,
              pt);
  };
  for (int c = 0; c < stages - 1; ++c) {  // stages - 1 <= nch
    load_chunk(c);
    commit();
  }
  const float* st = stats + ((long long)bw * heads + h) * TN * 4;
  const float* bh = bias + (long long)h * TN * TN;
  const float* mw = mask ? mask + (long long)(bw % n_mask) * TN * TN : nullptr;
  float dv[CT][4], dk[CT][4];
#pragma unroll
  for (int n = 0; n < CT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.0f;

  for (int c = 0; c < nch; ++c) {
    if (stages == 3)
      wait<1>();
    else
      wait<0>();
    __syncthreads();  // chunk c landed; every warp is done with c - 1's
    if (c + stages - 1 < nch) load_chunk(c + stages - 1);
    commit();
    const float* Qc = ring + (c % stages) * 2 * QC * ld;
    const float* dOc = Qc + QC * ld;
    const int i0 = c * QC;
    float4 sq[QT][2];  // [max, 1 / sum, D] of query i0 + 8j + 2t + e
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sq[j][e] = *reinterpret_cast<const float4*>(
            st + (i0 + 8 * j + 2 * tq + e) * 4);

    // ---- k q^T and v dO^T of the warp's keys against the chunk ----
    float s[QT][4], ds[QT][4];
    rows_nt<QT, true>(s, Ks + k0 * ld, Qc, ld, hd, QT, g, tq);
    rows_nt<QT, true>(ds, Vs + k0 * ld, dOc, ld, hd, QT, g, tq);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + g + 8 * (e >> 1);
        const int i = i0 + 8 * j + 2 * tq + (e & 1);
        float v = s[j][e] * scale + bh[(long long)i * TN + key];  // as pass a
        if (mw) v += mw[(long long)i * TN + key];
        const float4 q = sq[j][e & 1];
        const float p = expf(v - q.x) * q.y;
        s[j][e] = p;
        ds[j][e] = p * (ds[j][e] - q.z);
      }
    }

    // ---- dv += P^T dO, dk += dS^T q (the warp's columns) ----
    regs_rows<QT, CT, TAIL>(dv, s, QT, dOc + cb, ld, ncols, g, tq);
    regs_rows<QT, CT, TAIL>(dk, ds, QT, Qc + cb, ld, ncols, g, tq);
  }
  wait<0>();

  float* d0 = dqkv + ((long long)bw * TN + k0 + g) * C3 + h * hd + cb + 2 * tq;
#pragma unroll
  for (int n = 0; n < CT; ++n) {
    if (8 * n < ncols) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* d = d0 + hh * 8 * C3 + 8 * n;
        *reinterpret_cast<float2*>(d + C) =
            make_float2(dk[n][2 * hh] * scale, dk[n][2 * hh + 1] * scale);
        *reinterpret_cast<float2*>(d + 2 * C) =
            make_float2(dv[n][2 * hh], dv[n][2 * hh + 1]);
      }
    }
  }
}

// Pass a'. Grid (per_head, heads), TN / 16 warps; NT >= TN / 8. qkv, dqkv:
// window-order rows of 3C; dO: rows of C; pw, dsw: (windows, heads, TN,
// TN) P and dS; dbias_part: (per_head, heads, TN, TN). Writes dq (scaled).
template <int NT>
__global__ void __launch_bounds__(NT * 16) qs_kernel(
    const float* __restrict__ qkv, const float* __restrict__ dO,
    const float* __restrict__ bias, const float* __restrict__ mask,
    int n_mask, float* __restrict__ dqkv, float* pw, float* dsw,
    float* __restrict__ dbias_part, int n_windows, int per_block, int heads,
    int TN, int hd, int C, float scale) {
  using attn32::RING;
  using attn32::SC;
  using attn32::SLD;
  using attn32::SLOT;
  using attn32::VC;
  using attn32::VLD;
  extern __shared__ __align__(16) float sm[];
  const int nt = TN / 8, n32 = (hd + SC - 1) / SC;
  const int per = 2 * n32 + (hd + VC - 1) / VC;
  const int t = threadIdx.x, pt = blockDim.x, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3, q0 = (t >> 5) * 16;
  const int h = blockIdx.y;
  const long long C3 = 3LL * C;
  const int w0 = blockIdx.x * per_block;
  const int w1 = w0 + per_block < n_windows ? w0 + per_block : n_windows;
  const int n_chunks = (w1 - w0) * per;
  float* part = dbias_part + ((long long)blockIdx.x * heads + h) * TN * TN +
                (q0 + g) * TN + 2 * tq;
  const float* bias_r = bias + ((long long)h * TN + q0 + g) * TN + 2 * tq;
  // chunk c of the block's stream into its slot, then a commit (empty
  // past the last): per window q | k in SC columns, then dO | v, then k
  // in VC columns
  const auto load = [&](int c) {
    if (c < n_chunks) {
      const int bw = w0 + c / per, r = c % per;
      float* slot = sm + (c % RING) * TN * SLOT;
      const float* win = qkv + (long long)bw * TN * C3 + h * hd;
      if (r < 2 * n32) {
        const int c0 = (r % n32) * SC, w = hd - c0 < SC ? hd - c0 : SC;
        if (r < n32)
          copy_rows(slot, SLD, win + c0, C3, TN, w, t, pt);
        else
          copy_rows(slot, SLD, dO + (long long)bw * TN * C + h * hd + c0, C,
                    TN, w, t, pt);
        copy_rows(slot + TN * SLD, SLD, win + (r < n32 ? C : 2 * C) + c0, C3,
                  TN, w, t, pt);
      } else {
        const int c0 = (r - 2 * n32) * VC, w = hd - c0 < VC ? hd - c0 : VC;
        copy_rows(slot, VLD, win + C + c0, C3, TN, w, t, pt);
      }
    }
    commit();
  };
  for (int c = 0; c < RING - 1; ++c) load(c);

  float acc[NT][4];  // S, then P; then dP, then dS
  for (int c = 0; c < n_chunks; ++c) {
    const int bw = w0 + c / per, r = c % per;
    wait<RING - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with c - 1
    load(c + RING - 1);  // into chunk c - 1's slot
    const float* slot = sm + (c % RING) * TN * SLOT;
    const long long pair = (long long)bw * heads + h;
    float* pr = pw + (pair * TN + q0 + g) * TN + 2 * tq;
    float* dr = dsw + (pair * TN + q0 + g) * TN + 2 * tq;

    if (r < 2 * n32) {
      // ---- S = q k^T, or dP = dO v^T: this chunk's k steps ----
      const int rr = r % n32, w = hd - rr * SC < SC ? hd - rr * SC : SC;
      if (rr == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      }
      attn32::scores_add<NT>(acc, slot + q0 * SLD, slot + TN * SLD, SLD, w,
                             nt, g, tq);
      if (r == n32 - 1) {
        // ---- the softmax in the registers; P to the workspace ----
        attn32::softmax_rows<NT>(
            acc, bias_r,
            mask ? mask + ((long long)(bw % n_mask) * TN + q0 + g) * TN +
                       2 * tq
                 : nullptr,
            nt, TN, scale);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(pr + hh * 8 * TN + 8 * j) =
                  make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
          }
        }
      } else if (r == 2 * n32 - 1) {
        // ---- D = sum dP P; dS = P (dP - D) over dP, P read back (this
        // lane's own entries); dS to the workspace and the dbias partial
        float D[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 p =
                  *reinterpret_cast<const float2*>(pr + hh * 8 * TN + 8 * j);
              D[hh] += acc[j][2 * hh] * p.x;
              D[hh] += acc[j][2 * hh + 1] * p.y;
            }
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          D[hh] += __shfl_xor_sync(0xffffffffu, D[hh], 1);
          D[hh] += __shfl_xor_sync(0xffffffffu, D[hh], 2);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 p =
                  *reinterpret_cast<const float2*>(pr + hh * 8 * TN + 8 * j);
              float2 v = make_float2(p.x * (acc[j][2 * hh] - D[hh]),
                                     p.y * (acc[j][2 * hh + 1] - D[hh]));
              acc[j][2 * hh] = v.x;
              acc[j][2 * hh + 1] = v.y;
              *reinterpret_cast<float2*>(dr + hh * 8 * TN + 8 * j) = v;
              float2* q = reinterpret_cast<float2*>(part + hh * 8 * TN + 8 * j);
              if (bw > w0) {
                const float2 o = *q;
                v = make_float2(o.x + v.x, o.y + v.y);
              }
              *q = v;
            }
          }
        }
      }
    } else {
      // ---- dq = dS k * scale over this chunk's VC columns ----
      const int c0 = (r - 2 * n32) * VC;
      float o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
      regs_rows<NT, 8, true>(o, acc, nt, slot, VLD,
                             hd - c0 < VC ? hd - c0 : VC, g, tq);
      float* d0 = dqkv + ((long long)bw * TN + q0 + g) * C3 + h * hd + c0 +
                  2 * tq;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (c0 + 8 * n < hd) {
          *reinterpret_cast<float2*>(d0 + 8 * n) =
              make_float2(o[n][0] * scale, o[n][1] * scale);
          *reinterpret_cast<float2*>(d0 + 8 * C3 + 8 * n) =
              make_float2(o[n][2] * scale, o[n][3] * scale);
        }
      }
    }
  }
  wait<0>();
}

// Pass b'. One block a (window, head) and KC columns of hd (blockIdx.x =
// pair * ceil(hd / KC) + column block), TN / 16 warps of 16 keys. pw, dsw
// from pass a'; writes dk (scaled) and dv into dqkv.
__global__ void __launch_bounds__(352) kvs_kernel(
    const float* __restrict__ qkv, const float* __restrict__ dO,
    const float* __restrict__ pw, const float* __restrict__ dsw,
    float* __restrict__ dqkv, int heads, int TN, int hd, int C,
    float scale) {
  extern __shared__ __align__(16) float sm[];
  const int ncb = (hd + KC - 1) / KC, pld = TN + 8, nch = TN / QC;
  const int pair = blockIdx.x / ncb, cb = blockIdx.x - pair * ncb;
  const int c0 = cb * KC, ncols = hd - c0 < KC ? hd - c0 : KC;
  const int bw = pair / heads, h = pair - bw * heads;
  const int t = threadIdx.x, pt = blockDim.x, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3, k0 = (t >> 5) * 16;
  const long long C3 = 3LL * C, tt = (long long)TN * TN;
  const int stage = kvs_stage(TN);
  // chunk c (queries c QC ..) into its stage: P and dS rows, the block's
  // columns of q and dO
  const auto load = [&](int c) {
    if (c < nch) {
      const int i0 = c * QC;
      float* st = sm + (c % KRING) * stage;
      copy_rows(st, pld, pw + pair * tt + (long long)i0 * TN, TN, QC, TN, t,
                pt);
      copy_rows(st + QC * pld, pld, dsw + pair * tt + (long long)i0 * TN, TN,
                QC, TN, t, pt);
      const long long row = (long long)bw * TN + i0;
      copy_rows(st + 2 * QC * pld, KLD, qkv + row * C3 + h * hd + c0, C3, QC,
                ncols, t, pt);
      copy_rows(st + 2 * QC * pld + QC * KLD, KLD, dO + row * C + h * hd + c0,
                C, QC, ncols, t, pt);
    }
    commit();
  };
  for (int c = 0; c < KRING - 1; ++c) load(c);
  float dv[8][4], dk[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.0f;

  for (int c = 0; c < nch; ++c) {
    wait<KRING - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with c - 1
    load(c + KRING - 1);
    const float* Pc = sm + (c % KRING) * stage;
    const float* Sc = Pc + QC * pld;
    const float* Qc = Sc + QC * pld;
    const float* Oc = Qc + QC * KLD;
#pragma unroll
    for (int ks = 0; ks < QT; ++ks) {
      // A: P^T and dS^T of the warp's keys (rows) by the k step's 8
      // queries (columns); B: dO and q of those queries
      const float* pa = Pc + (8 * ks + tq) * pld + k0 + g;
      const float* sa = Sc + (8 * ks + tq) * pld + k0 + g;
      tf32x3::FragA fp, fs;
      fp.set(pa[0], pa[8], pa[4 * pld], pa[4 * pld + 8]);
      fs.set(sa[0], sa[8], sa[4 * pld], sa[4 * pld + 8]);
      const float* ob = Oc + (8 * ks + tq) * KLD + g;
      const float* qb = Qc + (8 * ks + tq) * KLD + g;
#pragma unroll
      for (int n = 0; n < 8; n += 4) {
        if (8 * (n + 4) <= ncols) {
          tf32x3::FragB fb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            fb[u].set(ob[8 * (n + u)], ob[4 * KLD + 8 * (n + u)]);
          tf32x3::mma3_add<4, 8>(dv, n, fp, fb);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            fb[u].set(qb[8 * (n + u)], qb[4 * KLD + 8 * (n + u)]);
          tf32x3::mma3_add<4, 8>(dk, n, fs, fb);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (8 * (n + u) < ncols) {
              tf32x3::FragB fb[1];
              fb[0].set(ob[8 * (n + u)], ob[4 * KLD + 8 * (n + u)]);
              tf32x3::mma3_add<1, 8>(dv, n + u, fp, fb);
              fb[0].set(qb[8 * (n + u)], qb[4 * KLD + 8 * (n + u)]);
              tf32x3::mma3_add<1, 8>(dk, n + u, fs, fb);
            }
          }
        }
      }
    }
  }
  wait<0>();

  float* d0 = dqkv + ((long long)bw * TN + k0 + g) * C3 + h * hd + c0 + 2 * tq;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (8 * n < ncols) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* d = d0 + hh * 8 * C3 + 8 * n;
        *reinterpret_cast<float2*>(d + C) =
            make_float2(dk[n][2 * hh] * scale, dk[n][2 * hh + 1] * scale);
        *reinterpret_cast<float2*>(d + 2 * C) =
            make_float2(dv[n][2 * hh], dv[n][2 * hh + 1]);
      }
    }
  }
}

}  // namespace attn32b
