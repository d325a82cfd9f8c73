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
// gradients), on the tensor cores, plus, per (window, head), five TN x TN
// x hd products (0.11 ms at stage 1 at the bf16 peak); the weight
// gradients reduce over every token row. The design keeps the forward's
// window-ordered qkv and pre-proj attention (saved by the autograd
// Function, 4C bf16 per token) instead of recomputing the qkv GEMM as the
// TPU kernel does, and launches, every product on the Hopper GEMMs
// (gemm_sm90.cu):
//   1. dattn = g @ wproj, g gathered from the (shifted) image layout by
//      the window partition the forward's proj scattered with: a 4-D TMA
//      box a window;
//   2. the attention backward (`attn_bwd_kernel`), on the register-resident
//      design of the forward core (window_attention.cu: mma.sync fed by
//      ldmatrix, q, k, v in shared memory by cp.async, each warp owning 16
//      query rows), in two phases per (window, head):
//        a. each warp recomputes its rows' scores and fp32 P in registers
//           under the forward's contract (fp32 scale after the product,
//           + bias, + the window's mask for SW-MSA, max, exp, times the
//           reciprocal of the sum), forms dP = dO V^T once, in registers,
//           the row sums of dP * P within its quads, dS = P * (dP -
//           rowsum) (fp32 P, `pallas_block_attention.py:470-494`), adds dS
//           into the block's fp32 dbias table in shared memory, and dQ =
//           dS K * scale; then writes bf16 P and bf16 dS to shared memory,
//           over k and v;
//        b. each warp, on 16 key rows, forms dV = P^T dO and dK = dS^T Q *
//           scale, the transposed operands by ldmatrix.trans.
//      No fp32 TN x TN matrix sits in shared memory but the dbias table:
//      200 KB at stage 1 (q, dO, k / P, v / dS and the table), one block
//      an SM. The blocks are persistent over a run of windows of one head
//      (about 39 at stage 1 on 132 SMs) and write their table once into a
//      partial of their own; `sum_parts` adds the partials in order. This
//      slot kernel takes TN <= 128 with its slot within shared memory (hd
//      <= 144 at TN 128); any other window K1 takes (TN to 176, any head
//      dim) goes to two passes of the same products (below, "the
//      two-pass attention backward"), chosen by shape;
//   3. dx = dqkv @ wqkv, scattered back through the row map with the
//      shift, so dx lands unshifted and no roll is formed;
//   4. dwqkv = dqkv^T x (x gathered through the shifted window partition),
//      dwproj = g^T attn (g through the window partition) on the
//      weight-gradient GEMM, and the bias gradients as fp32 column sums.
// Every sum over windows or rows is formed in a fixed order (partials,
// then `sum_parts`), with no float atomic: two calls give the same bits.

#include <atomic>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int BWD_MAX_NT = 8;  // the slot kernel: TN <= 128, its registers
constexpr int WIDE_MAX_NT = 11;  // the two-pass kernels: K1's widest, 176
constexpr int SMS = 132;  // the H100's SMs: the query passes' grids, from
                          // the shapes alone (every card sums alike)

struct BwdSmem {
  int ld, ldp;  // bf16 row strides: hd + 8 (q, dO, k, v), TN + 8 (P, dS)
  size_t dO, kv, dbias, total;  // q at 0; k then P, v then dS in kv
};

// One (window, head) slot of the backward block: q, dO, the k / v region
// (later P / dS) and the slot's fp32 (TN, TN) dbias table.
__host__ __device__ inline BwdSmem bwd_smem(int TN, int hd) {
  BwdSmem m;
  m.ld = hd + 8;  // 16 bytes of padding: ldmatrix rows on distinct banks
  m.ldp = TN + 8;
  const size_t one = align128(size_t(TN) * m.ld * sizeof(bf16));
  const int wide = m.ld > m.ldp ? m.ld : m.ldp;
  m.dO = one;
  m.kv = 2 * one;
  m.dbias = m.kv + align128(2 * size_t(TN) * wide * sizeof(bf16));
  m.total = m.dbias + align128(size_t(TN) * TN * sizeof(float));
  return m;
}

// At a head dim of 8 mod 16 the k16 steps of a product over hd (the
// scores, dP) read the 8 pad columns past hd of its shared rows:
// zero_pad zeroes them in `rows` rows of stride ld at `base`, by threads
// t = 0 .. nt - 1; the A fragments read from device memory are zeroed
// there.
__device__ __forceinline__ void zero_pad(bf16* base, int rows, int ld,
                                         int hd, int t, int nt) {
  for (int r = t; r < rows; r += nt)
    *reinterpret_cast<uint4*>(base + size_t(r) * ld + hd) =
        make_uint4(0u, 0u, 0u, 0u);
}

// A warp's 16 x 64 fp32 tile o (o[j]: columns 8j .. 8j + 7 of rows g and
// g + 8, the mma layout) times mul as bf16 into rows of stride ld at dst,
// 16 bytes a store after the quad transpose; columns at or past `cols`
// are skipped (cols a multiple of 8), by 8-column block.
__device__ __forceinline__ void store_tile16(const float (&o)[8][4], float mul,
                                             bf16* dst, long long ld,
                                             int cols, int lane) {
  const int t = lane & 3;
  bf16* row = dst + (long long)((lane >> 2) + 8 * (t >> 1)) * ld;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if (16 * jj < cols) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * jj + (i & 1), hh = i >> 1;
        w[i] = pack_bf16(o[j][2 * hh] * mul, o[j][2 * hh + 1] * mul);
      }
      quad_transpose(w, t);
      if (8 * (2 * jj + (t & 1)) < cols)
        *reinterpret_cast<uint4*>(row + 8 * (2 * jj + (t & 1))) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// o (16 x 64 at columns c0) += A (16 x TN, fragments a[kt] or loaded by
// `afrag(kt)`) @ B (TN x hd rows in shared memory, read with
// ldmatrix.trans from bt = the lane's ldmatrix row address), over nt key
// tiles
template <int NT, class AFrag>
__device__ __forceinline__ void mma_rows_t(float (&o)[8][4], AFrag afrag,
                                           const bf16* bt, int ld, int nt,
                                           int c0, int hd) {
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < nt) {
      uint32_t a[4];
      afrag(kt, a);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (c0 + 16 * jj < hd) {
          uint32_t b[4];
          ldsm_x4_t(b, bt + kt * 16 * ld + c0 + 16 * jj);
          mma16816(o[2 * jj], a, b[0], b[1]);
          mma16816(o[2 * jj + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// s (16 x TN, s[j]: keys 8j .. 8j + 7) = A (16 rows at `arow`, the lane's
// ldmatrix row address) @ B^T (TN rows at `brow`) over hd
template <int NT>
__device__ __forceinline__ void mma_scores(float (&s)[2 * NT][4],
                                           const bf16* arow, const bf16* brow,
                                           int ld, int nt, int hd) {
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  for (int kk = 0; kk < hd; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, arow + kk);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t bf[4];
        ldsm_x4(bf, brow + j * 16 * ld + kk);
        mma16816(s[2 * j], af, bf[0], bf[1]);
        mma16816(s[2 * j + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// qkv: (n_windows * TN, 3C) bf16 window order (the forward's); dattn:
// (n_windows * TN, C) bf16 window order; dqkv: (n_windows * TN, 3C) out;
// dbias_part: (per_head, heads, TN, TN) fp32, the block's partial written.
// Block (x, head): windows x * per_block .. + per_block - 1, `slots` at a
// time (TN / 16 warps a slot, each slot its own shared memory).
template <int NT>
__global__ void __launch_bounds__(256, 1)
    attn_bwd_kernel(const bf16* __restrict__ qkv,
                    const bf16* __restrict__ dattn,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask,
                    bf16* __restrict__ dqkv, float* __restrict__ dbias_part,
                    int n_windows, int per_block, int slots, int TN, int hd,
                    int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem L = bwd_smem(TN, hd);
  const int nt = TN / 16, pt = nt * 32;  // key tiles, threads a slot
  const int slot = threadIdx.x / pt, t = threadIdx.x - slot * pt;
  const int wi = t >> 5, lane = t & 31;
  const int h = blockIdx.y;
  unsigned char* base = smem + slot * L.total;
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* dos = reinterpret_cast<bf16*>(base + L.dO);
  bf16* ks = reinterpret_cast<bf16*>(base + L.kv);
  bf16* vs = ks + size_t(TN) * L.ld;
  bf16* ps = ks;                        // phase b: P over k,
  bf16* dss = ps + size_t(TN) * L.ldp;  // dS over v
  float* db = reinterpret_cast<float*>(base + L.dbias);
  const auto sync_slot = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(pt) : "memory");
  };
  for (int i = t; i < TN * TN; i += pt) db[i] = 0.0f;

  const int C3 = 3 * C, chunks = hd / 8;
  const int q0 = wi * 16, g = lane >> 2, tq = lane & 3;
  // the lane's ldmatrix row addresses: A rows (non-trans), B rows of a
  // B^T operand (non-trans), B rows (trans), A^T rows (trans)
  const int a_r = lane & 15, a_c = (lane >> 4) * 8;
  const int bn_r = (lane & 7) + ((lane >> 4) << 3), bn_c = ((lane >> 3) & 1) * 8;
  const int bt_r = (lane & 7) + (((lane >> 3) & 1) << 3), bt_c = (lane >> 4) * 8;
  const int at_r = (lane & 7) + ((lane >> 4) << 3), at_c = ((lane >> 3) & 1) * 8;
  const float* bias_h = bias + (long long)h * TN * TN;
  const int w_end = min(n_windows, (blockIdx.x + 1) * per_block);

  for (int bw = blockIdx.x * per_block + slot; bw < w_end; bw += slots) {
    const long long row0 = (long long)bw * TN;
    const bf16* src = qkv + row0 * C3 + h * hd;
    const bf16* dsrc = dattn + row0 * C + h * hd;
    if (hd % 16) {  // the pads (phase b's P and dS overwrote k's and v's)
      zero_pad(qs, TN, L.ld, hd, t, pt);
      zero_pad(ks, TN, L.ld, hd, t, pt);
      zero_pad(vs, TN, L.ld, hd, t, pt);
      zero_pad(dos, TN, L.ld, hd, t, pt);
    }
    // q and k in one cp.async group; v and dO in a second, landing while
    // the scores are computed
    for (int i = t; i < TN * chunks; i += pt) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      cp_async16(qs + r * L.ld + c, src + (long long)r * C3 + c);
      cp_async16(ks + r * L.ld + c, src + (long long)r * C3 + C + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = t; i < TN * chunks; i += pt) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      cp_async16(vs + r * L.ld + c, src + (long long)r * C3 + 2 * C + c);
      cp_async16(dos + r * L.ld + c, dsrc + (long long)r * C + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    sync_slot();

    // ---- a. scores and P (fp32) of rows q0 + g (s[j][0..1]) and
    // q0 + g + 8 (s[j][2..3]) ----
    float s[2 * NT][4];
    mma_scores<NT>(s, qs + (q0 + a_r) * L.ld + a_c, ks + bn_r * L.ld + bn_c,
                   L.ld, nt, hd);
    const float* bias_r = bias_h + (q0 + g) * TN + 2 * tq;
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
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      sum[hh] = 1.0f / sum[hh];
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sum[e >> 1];

    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    sync_slot();  // v and dO have landed

    // dP = dO V^T, once; the row sums of dP * P within the quads
    float dp[2 * NT][4];
    mma_scores<NT>(dp, dos + (q0 + a_r) * L.ld + a_c, vs + bn_r * L.ld + bn_c,
                   L.ld, nt, hd);
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
      if (j < 2 * nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[j][e] * s[j][e];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
    }
    // dS = P (dP - rowsum) in fp32, added into the slot's dbias table
    // (each element owned by one lane); P and dS packed to bf16 as A
    // fragments (k tile kt: key tiles 2kt, 2kt + 1)
    float* dbr = db + (q0 + g) * TN + 2 * tq;
    uint32_t pa[NT][4], sa[NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j < 2 * nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          dp[j][2 * hh] = s[j][2 * hh] * (dp[j][2 * hh] - rs[hh]);
          dp[j][2 * hh + 1] = s[j][2 * hh + 1] * (dp[j][2 * hh + 1] - rs[hh]);
          float2* d = reinterpret_cast<float2*>(dbr + hh * 8 * TN + 8 * j);
          float2 o = *d;
          o.x += dp[j][2 * hh];
          o.y += dp[j][2 * hh + 1];
          *d = o;
        }
      }
    }
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kt + (i >> 1), hh = i & 1;
        pa[kt][i] = pack_bf16(s[j][2 * hh], s[j][2 * hh + 1]);
        sa[kt][i] = pack_bf16(dp[j][2 * hh], dp[j][2 * hh + 1]);
      }
    }

    // dQ = dS K * scale -> dqkv[:, h hd ..)
    bf16* out = dqkv + (row0 + q0) * C3 + h * hd;
    for (int c0 = 0; c0 < hd; c0 += 64) {
      float o[8][4];
      mma_rows_t<NT>(
          o, [&](int kt, uint32_t(&a)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sa[kt][i];
          },
          ks + bt_r * L.ld + bt_c, L.ld, nt, c0, hd);
      store_tile16(o, scale, out + c0, C3, hd - c0, lane);
    }

    sync_slot();  // every warp is done with k and v
    // P and dS in bf16 over k and v: word i of a fragment is row g + 8
    // (i & 1), columns 16 kt + 8 (i >> 1) + 2 tq
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      if (kt < nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int off = (q0 + g + 8 * (i & 1)) * L.ldp + 16 * kt +
                          8 * (i >> 1) + 2 * tq;
          *reinterpret_cast<uint32_t*>(ps + off) = pa[kt][i];
          *reinterpret_cast<uint32_t*>(dss + off) = sa[kt][i];
        }
      }
    }
    sync_slot();

    // ---- b. this warp's 16 key rows j0 = q0: dV = P^T dO, dK = dS^T Q *
    // scale; the A^T fragments by ldmatrix.trans of P / dS rows ----
    for (int c0 = 0; c0 < hd; c0 += 64) {
      float o[8][4];
      mma_rows_t<NT>(
          o, [&](int kt, uint32_t(&a)[4]) {
            ldsm_x4_t(a, ps + (16 * kt + at_r) * L.ldp + q0 + at_c);
          },
          dos + bt_r * L.ld + bt_c, L.ld, nt, c0, hd);
      store_tile16(o, 1.0f, out + 2 * C + c0, C3, hd - c0, lane);
      mma_rows_t<NT>(
          o, [&](int kt, uint32_t(&a)[4]) {
            ldsm_x4_t(a, dss + (16 * kt + at_r) * L.ldp + q0 + at_c);
          },
          qs + bt_r * L.ld + bt_c, L.ld, nt, c0, hd);
      store_tile16(o, scale, out + C + c0, C3, hd - c0, lane);
    }
    sync_slot();  // the slot's shared memory is free for the next window
  }

  // the slots' dbias tables, summed in slot order, into the block's
  // partial (sum_parts adds the blocks' partials in order)
  __syncthreads();
  float* dst =
      dbias_part + ((long long)blockIdx.x * gridDim.y + h) * TN * TN;
  for (int i = 4 * threadIdx.x; i < TN * TN; i += 4 * blockDim.x) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int sl = 0; sl < slots; ++sl) {
      const float4 a = *reinterpret_cast<const float4*>(
          smem + sl * L.total + L.dbias + i * sizeof(float));
      v.x += a.x;
      v.y += a.y;
      v.z += a.z;
      v.w += a.w;
    }
    *reinterpret_cast<float4*>(dst + i) = v;
  }
}

// ---- the two-pass attention backward: any window and head dim K1 takes --
//
// Where the slot kernel's q, dO, k / P, v / dS and dbias table do not fit
// one block (hd past 144 at TN 128) or its score registers do not (TN
// past 128), two launches and a fixed-order sum, FlashAttention-2's
// split of the backward without its atomics:
//   a. the query pass (`attn_bwd_q_kernel`): a block of TN / 16 warps, each
//      warp its 16 query rows of a (window, head); k and v stream through a
//      ring of 64-column chunks in shared memory (432 TN bytes, whatever
//      the head dim), so every head dim fits. A warp reads its q and dO
//      fragments straight from device memory (this warp alone uses them)
//      and, chunk by chunk over the k chunks, sums its 16 x TN scores in
//      registers over the k16 steps d = 0 .. hd in order; then the
//      forward's softmax there, fp32 P to a tile of the block's shared
//      memory (each lane its own entries) and bf16 P to a scratch (the key
//      pass's operand); D = rowsum(dO o O) from the forward's saved output
//      O (`attn`: no dP row is needed before dS); then, over the v chunks,
//      dP = dO v^T into the same registers, dS = P (dP - D) with P read
//      back, dS in bf16 to the scratch, added into its block's fp32 dbias
//      partial in device memory (each lane its own entries, windows
//      ascending) and kept as bf16 A fragments; then, over the k chunks
//      again, dq = dS k * scale, a chunk's 64 columns at a time. The
//      registers hold the score row (TN / 2 a lane) or dS's fragments
//      (TN / 4): none scale with hd. The blocks are persistent over a run
//      of windows of one head; `sum_parts` adds the partials in order.
//      Every sum runs over the same k steps in the same order as when k
//      and v were held whole, so the pass keeps those bits.
//   b. the key pass (`attn_bwd_kv_kernel`): a block a (window, head), P and
//      dS of the window in shared memory, q and dO through it 64 columns at
//      a time; each warp, on 16 key rows, dV = P^T dO and dK = dS^T q *
//      scale, the transposed operands by ldmatrix.trans (the slot kernel's
//      phase b).

// s (16 x TN) += A (16 rows read from device memory: a = the lane's word
// at row g, column 2 t of the first k step; rows lda apart) @ B^T (TN rows
// at `brow`, the lane's ldmatrix row address) over the w columns from a
// and brow; where w % 16 == 8 the last k step's upper half of A is zero
// (B's pad is zeroed in shared memory)
template <int NT>
__device__ __forceinline__ void scores_g_add(float (&s)[2 * NT][4],
                                             const bf16* a, long long lda,
                                             const bf16* brow, int ld, int nt,
                                             int w) {
  for (int kk = 0; kk < w; kk += 16) {
    uint32_t af[4];
    const bool up = kk + 8 < w;
    af[0] = *reinterpret_cast<const uint32_t*>(a + kk);
    af[1] = *reinterpret_cast<const uint32_t*>(a + 8 * lda + kk);
    af[2] = up ? *reinterpret_cast<const uint32_t*>(a + kk + 8) : 0u;
    af[3] = up ? *reinterpret_cast<const uint32_t*>(a + 8 * lda + kk + 8) : 0u;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t bf[4];
        ldsm_x4(bf, brow + j * 16 * ld + kk);
        mma16816(s[2 * j], af, bf[0], bf[1]);
        mma16816(s[2 * j + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// The query pass's ring: QRING slots of TN rows of a QC-column chunk of k
// or of v (rows of QLD bf16: 16 bytes of padding, ldmatrix rows on
// distinct banks); then the fp32 P tile, rows of TN + 8 floats.
constexpr int QC = 64, QLD = QC + 8, QRING = 3;
__host__ __device__ inline size_t wide_q_ring(int TN) {
  return align128(size_t(QRING) * TN * QLD * sizeof(bf16));
}
__host__ __device__ inline size_t wide_q_smem(int TN) {
  return wide_q_ring(TN) + size_t(TN) * (TN + 8) * sizeof(float);
}
// The key pass's: P and dS (rows of TN + 8), then q's and dO's 64-column
// chunk (rows of 72).
__host__ __device__ inline size_t wide_kv_smem(int TN) {
  return 2 * align128(size_t(TN) * (TN + 8) * sizeof(bf16)) +
         2 * align128(size_t(TN) * 72 * sizeof(bf16));
}

// Pass a. Grid (per_head, heads), TN / 16 warps; NT >= TN / 16. attn: the
// forward's window-order output O (rows of C). ps, dss: (windows, heads,
// TN, TN) bf16 P and dS; dbias_part: (per_head, heads, TN, TN).
template <int NT>
__global__ void __launch_bounds__(32 * NT, 1)
    attn_bwd_q_kernel(const bf16* __restrict__ qkv,
                      const bf16* __restrict__ dattn,
                      const bf16* __restrict__ attn,
                      const float* __restrict__ bias,
                      const float* __restrict__ mask, int n_mask,
                      bf16* __restrict__ dqkv, bf16* __restrict__ ps,
                      bf16* __restrict__ dss, float* __restrict__ dbias_part,
                      int n_windows, int per_block, int heads, int TN, int hd,
                      int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = TN / 16, nc = (hd + QC - 1) / QC, per = 3 * nc;
  const int t = threadIdx.x, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3, q0 = (t >> 5) * 16;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* ptile = reinterpret_cast<float*>(smem + wide_q_ring(TN)) +
                 (q0 + g) * (TN + 8) + 2 * tq;  // the lane's P entries
  const int h = blockIdx.y, C3 = 3 * C;
  const int w0 = blockIdx.x * per_block;
  const int w1 = min(n_windows, w0 + per_block);
  const int n_chunks = (w1 - w0) * per;
  // ldmatrix row addresses in a chunk: B rows of a B^T operand (non-trans),
  // B rows (trans)
  const int bn = ((lane & 7) + ((lane >> 4) << 3)) * QLD + ((lane >> 3) & 1) * 8;
  const int bt = ((lane & 7) + (((lane >> 3) & 1) << 3)) * QLD + (lane >> 4) * 8;
  float* part = dbias_part + ((long long)blockIdx.x * heads + h) * TN * TN +
                (q0 + g) * TN + 2 * tq;
  const float* bias_r = bias + ((long long)h * TN + q0 + g) * TN + 2 * tq;
  // chunk c of the block's stream into its slot, then a commit (empty past
  // the last): per window k in chunks of QC columns (the scores), v (dP),
  // k again (dq). Thread t copies row t / 2, its half of the 16-byte
  // pieces, and zeroes the row's pad where the chunk ends 8 mod 16.
  const int lr = t >> 1, half = t & 1;
  const auto load = [&](int c) {
    if (c < n_chunks) {
      const int bw = w0 + c / per, r = c % per, c0 = (r % nc) * QC;
      const int w = hd - c0 < QC ? hd - c0 : QC;
      const bf16* src = qkv + ((long long)bw * TN + lr) * C3 +
                        (r / nc == 1 ? 2 : 1) * C + h * hd + c0;
      bf16* dst = ring + ((c % QRING) * TN + lr) * QLD;
      for (int i = 8 * half; i < w; i += 16) cp_async16(dst + i, src + i);
      if (w % 16 && !half)
        *reinterpret_cast<uint4*>(dst + w) = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int c = 0; c < QRING - 1; ++c) load(c);
  // chunk c's slot once it has landed and every warp is done with chunk
  // c - 1, whose slot then takes chunk c + QRING - 1
  int c = 0;
  const auto next = [&]() -> const bf16* {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(QRING - 2) : "memory");
    __syncthreads();
    load(c + QRING - 1);
    return ring + (c++ % QRING) * TN * QLD;
  };

  for (int bw = w0; bw < w1; ++bw) {
    const long long rw = (long long)bw * TN + q0;
    const bf16* qrow = qkv + (rw + g) * C3 + h * hd + 2 * tq;
    const bf16* dorow = dattn + (rw + g) * C + h * hd + 2 * tq;
    // D = rowsum(dO o O) of the warp's rows (lane: rows g, g + 8), while
    // the first chunks land
    float D[2] = {0.0f, 0.0f};
    for (int r = 0; r < 16; ++r) {
      const bf16* o = attn + (rw + r) * C + h * hd;
      const bf16* d = dattn + (rw + r) * C + h * hd;
      float v = 0.0f;
      for (int cc = 2 * lane; cc < hd; cc += 64) {
        const float2 a =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + cc));
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + cc));
        v += a.x * b.x + a.y * b.y;
      }
      v = warp_sum(v);
      if (r == g) D[0] = v;
      if (r == g + 8) D[1] = v;
    }

    // ---- scores and P (fp32) of rows q0 + g (s[j][0..1]) and q0 + g + 8
    // (s[j][2..3]), over the k chunks ----
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    for (int c0 = 0; c0 < hd; c0 += QC) {
      const bf16* slot = next();
      scores_g_add<NT>(s, qrow + c0, C3, slot + bn, QLD, nt,
                       hd - c0 < QC ? hd - c0 : QC);
    }
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
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      sum[hh] = 1.0f / sum[hh];
    }
    // P: fp32 to the lane's entries of the tile, bf16 to the scratch
    const long long pw = ((long long)bw * heads + h) * TN * TN;
    bf16* prow = ps + pw + (q0 + g) * TN + 2 * tq;
    bf16* drow = dss + pw + (q0 + g) * TN + 2 * tq;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j < 2 * nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 p = make_float2(s[j][2 * hh] * sum[hh],
                                       s[j][2 * hh + 1] * sum[hh]);
          *reinterpret_cast<float2*>(ptile + hh * 8 * (TN + 8) + 8 * j) = p;
          *reinterpret_cast<uint32_t*>(prow + hh * 8 * TN + 8 * j) =
              pack_bf16(p.x, p.y);
        }
      }
    }

    // ---- dP = dO v^T over the v chunks, into the score registers ----
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    for (int c0 = 0; c0 < hd; c0 += QC) {
      const bf16* slot = next();
      scores_g_add<NT>(s, dorow + c0, C, slot + bn, QLD, nt,
                       hd - c0 < QC ? hd - c0 : QC);
    }
    // ---- dS = P (dP - D), P read back; dS to the scratch, the partial and
    // sa (k tile kt: key tiles 2 kt, 2 kt + 1) ----
    uint32_t sa[NT][4];
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      if (kt < nt) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 2 * kt + u;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 p = *reinterpret_cast<const float2*>(
                ptile + hh * 8 * (TN + 8) + 8 * j);
            const float d0 = p.x * (s[j][2 * hh] - D[hh]);
            const float d1 = p.y * (s[j][2 * hh + 1] - D[hh]);
            const int off = hh * 8 * TN + 8 * j;
            sa[kt][2 * u + hh] = pack_bf16(d0, d1);
            *reinterpret_cast<uint32_t*>(drow + off) = sa[kt][2 * u + hh];
            float2* pp = reinterpret_cast<float2*>(part + off);
            float2 v = make_float2(d0, d1);
            if (bw > w0) {
              const float2 o = *pp;
              v = make_float2(o.x + v.x, o.y + v.y);
            }
            *pp = v;
          }
        }
      }
    }

    // ---- dQ = dS K * scale -> dqkv[:, h hd ..), over the k chunks ----
    bf16* out = dqkv + rw * C3 + h * hd;
    for (int c0 = 0; c0 < hd; c0 += QC) {
      const bf16* slot = next();
      const int w = hd - c0 < QC ? hd - c0 : QC;
      float o[8][4];
      mma_rows_t<NT>(
          o, [&](int kt, uint32_t(&a)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sa[kt][i];
          },
          slot + bt, QLD, nt, 0, w);
      store_tile16(o, scale, out + c0, C3, w, lane);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pass b. One block a (window, head), TN / 16 warps; NT >= TN / 16. ps,
// dss from pass a; writes dk (scaled) and dv into dqkv.
template <int NT>
__global__ void __launch_bounds__(32 * NT)
    attn_bwd_kv_kernel(const bf16* __restrict__ qkv,
                       const bf16* __restrict__ dattn,
                       const bf16* __restrict__ ps,
                       const bf16* __restrict__ dss, bf16* __restrict__ dqkv,
                       int heads, int TN, int hd, int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldp = TN + 8, ldc = 72, nt = TN / 16;
  const int t = threadIdx.x, pt = blockDim.x, lane = t & 31;
  const int k0 = (t >> 5) * 16;
  const size_t pbytes = align128(size_t(TN) * ldp * sizeof(bf16));
  const size_t cbytes = align128(size_t(TN) * ldc * sizeof(bf16));
  bf16* p_s = reinterpret_cast<bf16*>(smem);
  bf16* ds_s = reinterpret_cast<bf16*>(smem + pbytes);
  bf16* q_c = reinterpret_cast<bf16*>(smem + 2 * pbytes);
  bf16* do_c = reinterpret_cast<bf16*>(smem + 2 * pbytes + cbytes);
  const int h = blockIdx.x % heads, bw = blockIdx.x / heads, C3 = 3 * C;
  const int bt_r = (lane & 7) + (((lane >> 3) & 1) << 3), bt_c = (lane >> 4) * 8;
  const int at_r = (lane & 7) + ((lane >> 4) << 3), at_c = ((lane >> 3) & 1) * 8;
  const long long row0 = (long long)bw * TN;
  const long long pw = ((long long)bw * heads + h) * TN * TN;
  const int pch = TN / 8;
  for (int i = t; i < TN * pch; i += pt) {
    const int r = i / pch, c = (i - r * pch) * 8;
    cp_async16(p_s + r * ldp + c, ps + pw + (long long)r * TN + c);
    cp_async16(ds_s + r * ldp + c, dss + pw + (long long)r * TN + c);
  }
  const bf16* src = qkv + row0 * C3 + h * hd;
  const bf16* dsrc = dattn + row0 * C + h * hd;
  bf16* out = dqkv + (row0 + k0) * C3 + h * hd;
  for (int c0 = 0; c0 < hd; c0 += 64) {
    const int cols = hd - c0 < 64 ? hd - c0 : 64, cch = cols / 8;
    for (int i = t; i < TN * cch; i += pt) {
      const int r = i / cch, c = (i - r * cch) * 8;
      cp_async16(q_c + r * ldc + c, src + (long long)r * C3 + c0 + c);
      cp_async16(do_c + r * ldc + c, dsrc + (long long)r * C + c0 + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // P, dS (first chunk) and the chunk have landed

    float o[8][4];
    // dV = P^T dO
    mma_rows_t<NT>(
        o, [&](int kt, uint32_t(&a)[4]) {
          ldsm_x4_t(a, p_s + (16 * kt + at_r) * ldp + k0 + at_c);
        },
        do_c + bt_r * ldc + bt_c, ldc, nt, 0, cols);
    store_tile16(o, 1.0f, out + 2 * C + c0, C3, cols, lane);
    // dK = dS^T q * scale
    mma_rows_t<NT>(
        o, [&](int kt, uint32_t(&a)[4]) {
          ldsm_x4_t(a, ds_s + (16 * kt + at_r) * ldp + k0 + at_c);
        },
        q_c + bt_r * ldc + bt_c, ldc, nt, 0, cols);
    store_tile16(o, scale, out + C + c0, C3, cols, lane);
    __syncthreads();  // every warp is done with the chunk
  }
}

// The grid of the slot kernel (`per_head` blocks a head, of `per_block`
// windows each) or of the query pass: about one block an SM of the
// H100's 132, from the shapes alone.
inline void q_split(int n_windows, int heads, int* per_head, int* per_block) {
  int ph = SMS / heads > 1 ? SMS / heads : 1;
  if (ph > n_windows) ph = n_windows;
  *per_block = (n_windows + ph - 1) / ph;
  *per_head = (n_windows + *per_block - 1) / *per_block;
}

// Whether the slot kernel takes (TN, hd): its score registers (TN <= 128)
// and one slot within an SM's opt-in shared memory (227 KiB).
inline bool slot_takes(int TN, int hd) {
  return TN <= 16 * BWD_MAX_NT && bwd_smem(TN, hd).total <= 232448;
}

// The attention backward's workspace in floats: the dbias partials, then
// (two-pass kernels) P and dS in bf16.
struct BwdWork {
  size_t part, pds, total;
};
inline BwdWork bwd_work(int n_windows, int heads, int TN, int hd) {
  int per_head = 0, per_block = 0;
  q_split(n_windows, heads, &per_head, &per_block);
  BwdWork w;
  w.part = 0;
  w.pds = (size_t(per_head) * heads * TN * TN + 3) / 4 * 4;  // 16-byte aligned
  w.total = w.pds + (slot_takes(TN, hd)
                         ? 0
                         : size_t(n_windows) * heads * TN * TN);  // 2 x bf16
  return w;
}

// The opt-in to the device's most dynamic shared memory, once a kernel and
// device (done[dev]: the bytes, 0 until made)
template <class K>
cudaError_t opt_in(K kernel, int* done) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  int most = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
  if (err == cudaSuccess) done[dev] = most;
  return err;
}

template <int NT>
cudaError_t launch_slot(const bf16* qkv, const bf16* dattn, const float* bias,
                        const float* mask, int n_mask, bf16* dqkv,
                        float* dbias_part, int n_windows, int heads, int TN,
                        int hd, int C, float scale, cudaStream_t s) {
  static int optins[MAX_DEVICES] = {};
  cudaError_t err = opt_in(attn_bwd_kernel<NT>, optins);
  if (err != cudaSuccess) return err;
  const BwdSmem L = bwd_smem(TN, hd);
  const int pt = TN / 16 * 32;
  int slots = 256 / pt;
  const int fit = static_cast<int>(optins[current_device()] / L.total);
  if (slots > fit) slots = fit;
  if (slots < 1) return cudaErrorInvalidValue;
  int per_head = 0, per_block = 0;
  q_split(n_windows, heads, &per_head, &per_block);
  attn_bwd_kernel<NT><<<dim3(per_head, heads), slots * pt, slots * L.total,
                        s>>>(qkv, dattn, bias, n_mask > 1 ? mask : nullptr,
                             n_mask, dqkv, dbias_part, n_windows, per_block,
                             slots, TN, hd, C, scale);
  return cudaGetLastError();
}

// runs of the two passes since the last reset (a streamed query pass and
// a key pass each; `stswin_attn_bwd_passes_launches`)
std::atomic<long long> passes_launches{0};

template <int NT>
cudaError_t launch_wide(const bf16* qkv, const bf16* dattn, const bf16* attn,
                        const float* bias, const float* mask, int n_mask,
                        bf16* dqkv, float* work, int n_windows, int heads,
                        int TN, int hd, int C, float scale, cudaStream_t s) {
  static int q_optins[MAX_DEVICES] = {}, kv_optins[MAX_DEVICES] = {};
  cudaError_t err;
  if ((err = opt_in(attn_bwd_q_kernel<NT>, q_optins)) != cudaSuccess ||
      (err = opt_in(attn_bwd_kv_kernel<NT>, kv_optins)) != cudaSuccess)
    return err;
  const int dev = current_device();
  const size_t qs = wide_q_smem(TN), kvs = wide_kv_smem(TN);
  if (qs > size_t(q_optins[dev]) || kvs > size_t(kv_optins[dev]))
    return cudaErrorInvalidValue;
  const BwdWork L = bwd_work(n_windows, heads, TN, hd);
  bf16* ps = reinterpret_cast<bf16*>(work + L.pds);
  bf16* dss = ps + size_t(n_windows) * heads * TN * TN;
  int per_head = 0, per_block = 0;
  q_split(n_windows, heads, &per_head, &per_block);
  const int pt = TN / 16 * 32;
  attn_bwd_q_kernel<NT><<<dim3(per_head, heads), pt, qs, s>>>(
      qkv, dattn, attn, bias, n_mask > 1 ? mask : nullptr, n_mask, dqkv, ps,
      dss, work + L.part, n_windows, per_block, heads, TN, hd, C, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_kv_kernel<NT><<<n_windows * heads, pt, kvs, s>>>(
      qkv, dattn, ps, dss, dqkv, heads, TN, hd, C, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++passes_launches;
  return err;
}

// The attention backward: dq, dk, dv into dqkv and dbias (heads, TN, TN),
// the slot kernel where it takes the window, else the two passes (a
// choice by shape: each is held against the twin on the card at its own
// shapes); dbias from the blocks' partials (work: `bwd_work(...).total`
// floats) by `sum_parts`.
cudaError_t attn_bwd(const bf16* qkv, const bf16* dattn, const bf16* attn,
                     const float* bias, const float* mask, int n_mask,
                     bf16* dqkv, float* dbias, float* work, int n_windows,
                     int heads, int TN, int hd, int C, float scale,
                     cudaStream_t s) {
  if (TN <= 0 || TN % 16 || TN > 16 * WIDE_MAX_NT || hd <= 0 || hd % 8 ||
      !work)
    return cudaErrorInvalidValue;
  const int nt = TN / 16;
  cudaError_t err;
  if (slot_takes(TN, hd)) {
    if (nt <= 2)
      err = launch_slot<2>(qkv, dattn, bias, mask, n_mask, dqkv, work,
                           n_windows, heads, TN, hd, C, scale, s);
    else if (nt <= 4)
      err = launch_slot<4>(qkv, dattn, bias, mask, n_mask, dqkv, work,
                           n_windows, heads, TN, hd, C, scale, s);
    else
      err = launch_slot<BWD_MAX_NT>(qkv, dattn, bias, mask, n_mask, dqkv,
                                    work, n_windows, heads, TN, hd, C, scale,
                                    s);
  } else if (nt <= 2) {
    err = launch_wide<2>(qkv, dattn, attn, bias, mask, n_mask, dqkv, work,
                         n_windows, heads, TN, hd, C, scale, s);
  } else if (nt <= 4) {
    err = launch_wide<4>(qkv, dattn, attn, bias, mask, n_mask, dqkv, work,
                         n_windows, heads, TN, hd, C, scale, s);
  } else if (nt <= 8) {
    err = launch_wide<8>(qkv, dattn, attn, bias, mask, n_mask, dqkv, work,
                         n_windows, heads, TN, hd, C, scale, s);
  } else {
    err = launch_wide<WIDE_MAX_NT>(qkv, dattn, attn, bias, mask, n_mask, dqkv,
                                   work, n_windows, heads, TN, hd, C, scale,
                                   s);
  }
  if (err != cudaSuccess) return err;
  int per_head = 0, per_block = 0;
  q_split(n_windows, heads, &per_head, &per_block);
  const long long table = (long long)heads * TN * TN;
  return sum_parts(work, per_head, table, table, dbias, s);
}

// K5's workspace in floats, one region reused in stream order: the
// attention backward's (dbias partials, P and dS), then the bias
// gradients' column partials, then the weight gradients' row splits.
size_t k5_work(int R, int C, int heads, int TN) {
  const int hd = C / heads;
  size_t w = bwd_work(R / TN, heads, TN, hd).total;
  const size_t cs = size_t(colsum_bf16_parts(R)) * 3 * C;
  const size_t w1 = wgrad_sm90_work(R, 3 * C, C), w2 = wgrad_sm90_work(R, C, C);
  w = w > cs ? w : cs;
  w = w > w1 ? w : w1;
  return w > w2 ? w : w2;
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
// Scratch: dattn (rows, C), dqkv (rows, 3C) bf16; work:
// `stswin_block_attention_bwd_work` floats. Outputs: dx unshifted bf16;
// dwqkv (3C, C), dbqkv (3C), dwproj (C, C), dbproj (C), dbias (heads, TN,
// TN), all fp32 and overwritten, each sum in a fixed order.
extern "C" int stswin_block_attention_bwd(
    const void* x, const void* g, const void* qkv, const void* attn,
    const void* wqkv_t, const void* wproj_t, const void* bias,
    const void* mask, void* dattn, void* dqkv, void* work, void* dx,
    void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dbias, int B,
    int T, int H, int W, int C, int heads, int ws, float scale, int shift,
    int n_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T * H * W, hd = C / heads, TN = T * ws * ws;
  const int nWin = (H / ws) * (W / ws);
  const RowMap win = RowMap{1, T, H, W, ws, 0};
  const RowMap win_shift = RowMap{1, T, H, W, ws, shift};
  float* wk = static_cast<float*>(work);
  cudaError_t err;

  // 1. dattn (window order) = g (gathered, a TMA box a window) @ wproj
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
  if ((err = gemm_sm90(p, EPI_BF16, s)) != cudaSuccess) return err;

  // 2. attention backward, persistent blocks over the windows of a head
  if ((err = attn_bwd(static_cast<const bf16*>(qkv),
                      static_cast<const bf16*>(dattn),
                      static_cast<const bf16*>(attn),
                      static_cast<const float*>(bias),
                      static_cast<const float*>(mask), n_mask,
                      static_cast<bf16*>(dqkv), static_cast<float*>(dbias),
                      wk, B * nWin, heads, TN, hd, C, scale, s)) !=
      cudaSuccess)
    return err;

  // 3. dx (unshifted image) = dqkv @ wqkv, scattered through the shift map
  p.A = static_cast<const bf16*>(dqkv);
  p.lda = 3 * C;
  p.a_map = identity_map();
  p.Wt = static_cast<const bf16*>(wqkv_t);
  p.K = 3 * C;
  p.C = static_cast<bf16*>(dx);
  p.c_map = win_shift;
  if ((err = gemm_sm90(p, EPI_BF16, s)) != cudaSuccess) return err;

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
  w.work = wk;
  if ((err = gemm_wgrad_sm90(w, s)) != cudaSuccess) return err;
  w.A = static_cast<const bf16*>(g);
  w.lda = C;
  w.a_map = win;
  w.B = static_cast<const bf16*>(attn);
  w.b_map = identity_map();
  w.M = C;
  w.Cw = static_cast<float*>(dwproj);
  if ((err = gemm_wgrad_sm90(w, s)) != cudaSuccess) return err;
  if ((err = colsum_bf16(static_cast<const bf16*>(dqkv), 3 * C, M, 3 * C,
                         static_cast<float*>(dbqkv), wk, s)) != cudaSuccess)
    return err;
  return colsum_bf16(static_cast<const bf16*>(g), C, M, C,
                     static_cast<float*>(dbproj), wk, s);
}

// The floats of K5's workspace (a query, not a launch): R token rows.
extern "C" int stswin_block_attention_bwd_work(int R, int C, int heads,
                                               int TN, long long* out) {
  *out = static_cast<long long>(k5_work(R, C, heads, TN));
  return 0;
}

// K5's attention backward alone (step 2 of `stswin_block_attention_bwd`),
// for timing and checking it by itself: qkv (rows, 3C), dattn and attn
// (rows, C) bf16 in window order (rows = windows x TN); work:
// `stswin_attn_bwd_work` floats; dqkv (rows, 3C) bf16 and dbias (heads,
// TN, TN) fp32 out.
extern "C" int stswin_attn_bwd(const void* qkv, const void* dattn,
                               const void* attn, const void* bias,
                               const void* mask, void* work, void* dqkv,
                               void* dbias, int rows, int C, int heads,
                               int TN, float scale, int n_mask,
                               void* stream) {
  if (TN <= 0 || heads <= 0 || C % heads || rows % TN || rows <= 0)
    return cudaErrorInvalidValue;
  return attn_bwd(static_cast<const bf16*>(qkv),
                  static_cast<const bf16*>(dattn),
                  static_cast<const bf16*>(attn),
                  static_cast<const float*>(bias),
                  static_cast<const float*>(mask), n_mask,
                  static_cast<bf16*>(dqkv), static_cast<float*>(dbias),
                  static_cast<float*>(work), rows / TN, heads, TN, C / heads,
                  C, scale, static_cast<cudaStream_t>(stream));
}

// Queries, not launches: the floats of `stswin_attn_bwd`'s workspace, and
// the runs of the two passes (the windows past the slot kernel) since the
// last reset.
extern "C" int stswin_attn_bwd_work(int rows, int C, int heads, int TN,
                                    long long* out) {
  *out = TN > 0 && heads > 0 && C % heads == 0
             ? static_cast<long long>(
                   bwd_work(rows / TN, heads, TN, C / heads).total)
             : -1;
  return 0;
}

extern "C" int stswin_attn_bwd_passes_launches(int reset, long long* out) {
  *out = reset ? passes_launches.exchange(0) : passes_launches.load();
  return 0;
}
