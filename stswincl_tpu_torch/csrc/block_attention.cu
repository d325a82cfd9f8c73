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
//      (about 39 at stage 1 on 132 SMs) and flush their table once, as
//      16-byte reductions: the old kernel added dS with one fp32 atomic an
//      element and window (84 M at stage 1 into 65,536 addresses);
//   3. dx = dqkv @ wqkv, scattered back through the row map with the
//      shift, so dx lands unshifted and no roll is formed;
//   4. dwqkv = dqkv^T x (x gathered through the shifted window partition),
//      dwproj = g^T attn (g through the window partition) on the
//      weight-gradient GEMM, and the bias gradients as fp32 column sums.

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int BWD_MAX_NT = 8;  // TN <= 128: the score registers of a warp

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

// A warp's 16 x 64 fp32 tile o (o[j]: columns 8j .. 8j + 7 of rows g and
// g + 8, the mma layout) times mul as bf16 into rows of stride ld at dst,
// 16 bytes a store after the quad transpose; columns at or past `cols`
// are skipped (cols a multiple of 16).
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
// dbias: (heads, TN, TN) fp32, added into. Block (x, head): windows
// x * per_block .. + per_block - 1, `slots` at a time (TN / 16 warps a
// slot, each slot its own shared memory).
template <int NT>
__global__ void __launch_bounds__(256, 1)
    attn_bwd_kernel(const bf16* __restrict__ qkv,
                    const bf16* __restrict__ dattn,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask,
                    bf16* __restrict__ dqkv, float* __restrict__ dbias,
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

  // the slots' dbias tables, summed, into dbias[h] once
  __syncthreads();
  float* dst = dbias + (long long)h * TN * TN;
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
    red_add_f32x4(dst + i, v);
  }
}

template <int NT>
cudaError_t launch_attn_bwd(const bf16* qkv, const bf16* dattn,
                            const float* bias, const float* mask, int n_mask,
                            bf16* dqkv, float* dbias, int n_windows,
                            int heads, int TN, int hd, int C, float scale,
                            cudaStream_t s) {
  // once an instance and device: the most shared memory a block may use
  static int optins[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!optins[dev]) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_kernel<NT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return err;
    optins[dev] = most;
  }
  const int optin = optins[dev], sms = sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  const BwdSmem L = bwd_smem(TN, hd);
  const int pt = TN / 16 * 32;
  int slots = 256 / pt;
  const int fit = static_cast<int>(optin / L.total);
  if (slots > fit) slots = fit;
  if (slots < 1) return cudaErrorInvalidValue;
  // one block an SM: sms / heads blocks a head, each a run of windows
  int per_head = sms / heads > 1 ? sms / heads : 1;
  if (per_head > n_windows) per_head = n_windows;
  const int per_block = (n_windows + per_head - 1) / per_head;
  per_head = (n_windows + per_block - 1) / per_block;
  attn_bwd_kernel<NT><<<dim3(per_head, heads), slots * pt, slots * L.total,
                         s>>>(qkv, dattn, bias, n_mask > 1 ? mask : nullptr,
                              n_mask, dqkv, dbias, n_windows, per_block,
                              slots, TN, hd, C, scale);
  return cudaGetLastError();
}

cudaError_t attn_bwd(const bf16* qkv, const bf16* dattn, const float* bias,
                     const float* mask, int n_mask, bf16* dqkv, float* dbias,
                     int n_windows, int heads, int TN, int hd, int C,
                     float scale, cudaStream_t s) {
  if (TN <= 0 || TN % 16 || TN > 16 * BWD_MAX_NT || hd <= 0 || hd % 16)
    return cudaErrorInvalidValue;
  const int nt = TN / 16;
  if (nt <= 2)
    return launch_attn_bwd<2>(qkv, dattn, bias, mask, n_mask, dqkv, dbias,
                              n_windows, heads, TN, hd, C, scale, s);
  if (nt <= 4)
    return launch_attn_bwd<4>(qkv, dattn, bias, mask, n_mask, dqkv, dbias,
                              n_windows, heads, TN, hd, C, scale, s);
  return launch_attn_bwd<BWD_MAX_NT>(qkv, dattn, bias, mask, n_mask, dqkv,
                                     dbias, n_windows, heads, TN, hd, C,
                                     scale, s);
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
// Scratch: dattn (rows, C), dqkv (rows, 3C) bf16. Outputs: dx unshifted
// bf16; dwqkv (3C, C), dbqkv (3C), dwproj (C, C), dbproj (C), dbias
// (heads, TN, TN), all fp32 and overwritten.
extern "C" int stswin_block_attention_bwd(
    const void* x, const void* g, const void* qkv, const void* attn,
    const void* wqkv_t, const void* wproj_t, const void* bias,
    const void* mask, void* dattn, void* dqkv, void* dx, void* dwqkv,
    void* dbqkv, void* dwproj, void* dbproj, void* dbias, int B, int T,
    int H, int W, int C, int heads, int ws, float scale, int shift,
    int n_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T * H * W, hd = C / heads, TN = T * ws * ws;
  const int nWin = (H / ws) * (W / ws);
  const RowMap win = RowMap{1, T, H, W, ws, 0};
  const RowMap win_shift = RowMap{1, T, H, W, ws, shift};
  cudaError_t err;
  const size_t c4 = sizeof(float) * C;
  if ((err = cudaMemsetAsync(dwqkv, 0, c4 * 3 * C, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(dbqkv, 0, c4 * 3, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(dwproj, 0, c4 * C, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(dbproj, 0, c4, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(dbias, 0, sizeof(float) * heads * TN * TN, s)) !=
          cudaSuccess)
    return err;

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
                      static_cast<const float*>(bias),
                      static_cast<const float*>(mask), n_mask,
                      static_cast<bf16*>(dqkv), static_cast<float*>(dbias),
                      B * nWin, heads, TN, hd, C, scale, s)) != cudaSuccess)
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
                         static_cast<float*>(dbqkv), s)) != cudaSuccess)
    return err;
  return colsum_bf16(static_cast<const bf16*>(g), C, M, C,
                     static_cast<float*>(dbproj), s);
}
