// Window attention: the per-(window, head) core of K1 and of the two
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
// Bound on the H100: device memory. Per (window, head) two TN x TN x hd
// products (TN 128, hd 128 at stage 1; TN 32, hd 256 at stage 2), 64 flops
// a byte of q, k, v and the output at stage 1, far below the card's 295;
// the bias and mask tables (256 KB and 5 MB at stage 1) stay in L2. So the
// design keeps the scores off shared memory and keeps enough loads in
// flight (the first core, `attn::attend` in attention_core.cuh, still the
// whole-block kernel's, kept q, k, v, the fp32 scores and the bf16 P in
// 203 KB of shared memory, one block an SM, loads not overlapped):
//   - each warp owns 16 query rows; mma.sync m16n8k16 (bf16 -> fp32) fed
//     by ldmatrix from shared memory (.trans for V) computes its 16 x TN
//     scores into registers, where the scale, bias, mask, the row max and
//     sum (quad shuffles) and the bf16 P stay: the score accumulators
//     become P V's A fragments without leaving the registers;
//   - shared memory holds q, k and v of the block's (window, head) pairs,
//     copied with cp.async (105 KB at stage 1, so two blocks an SM, one's
//     loads overlapping the other's products), v in a second group that
//     lands while the scores are computed; a pair's warps meet on their
//     own named barrier; a warp's q rows, read only by that warp, then
//     stage its output for 16-byte stores;
//   - at stage 2 (TN 32: two warps a pair) a block takes two (window,
//     head) pairs, so it still has four warps and two blocks fit an SM.
// The three callers differ only in where a (window, head, token) row
// lives, so the body is one template over an address functor
// (attention_core.cuh); each pair maps its TN rows once, into shared
// memory, before any load:
//   MappedRows: token rows of a (rows, 3C) qkv matrix and a (rows, C)
//     output read through a RowMap: the identity for K1's window-order
//     buffers, the window partition for row 10, which so gathers straight
//     from the image layout and scatters its output back to it: no
//     partitioned copy is formed (that copy is the plain twin's work);
//   HeadMajor: three (Bw, heads, TN, hd) tensors and a (Bw, heads, TN, hd)
//     output (row 11).
// The score registers are sized at compile time: NT, the most 16-key
// tiles a variant takes (2, 4, 8 or 11; TN <= 176, the widest window the
// first core's shared memory took).

#include "attention_core.cuh"

namespace {

using attn::HeadMajor;
using attn::MappedRows;

constexpr int MAX_NT = 11;                // TN <= 176
constexpr size_t PAIR_TARGET = 113 * 1024;  // half an SM's shared memory

struct PairSmem {
  int ld;                // bf16 row stride of q, k, v: hd + 8
  size_t kv, rows, total;  // offsets of k (v follows), the row offsets; size
};

__host__ __device__ inline PairSmem pair_smem(int TN, int hd) {
  PairSmem m;
  m.ld = hd + 8;  // 16 bytes of padding: ldmatrix rows on distinct banks
  const size_t one = size_t(TN) * m.ld * sizeof(bf16);
  m.kv = one;
  m.rows = align128(3 * one);
  m.total = m.rows + align128(size_t(TN) * sizeof(long long));
  return m;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One block: `group` (window, head) pairs, TN / 16 warps each; the pair of
// block b and slot g is b * group + g (pair = window * heads + head). Up
// to 256 threads, two blocks an SM (128 registers a thread), but 352 (11
// warps, one pair) for the widest windows.
template <int NT, class Addr>
__global__ void __launch_bounds__(NT > 8 ? 352 : 256, NT > 8 ? 1 : 2)
    window_attention_mma_kernel(
    Addr a, const float* __restrict__ bias, const float* __restrict__ mask,
    int n_mask, int n_pairs, int heads, int TN, int hd, int group,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PairSmem L = pair_smem(TN, hd);
  const int nt = TN / 16, pt = nt * 32;  // 16-key tiles, threads a pair
  const int slot = threadIdx.x / pt, t = threadIdx.x - slot * pt;
  const int wi = t >> 5, lane = t & 31;
  const int pair = blockIdx.x * group + slot;
  const bool live = pair < n_pairs;
  const int bw = pair / heads, h = pair - bw * heads;
  unsigned char* base = smem + slot * L.total;
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = reinterpret_cast<bf16*>(base + L.kv);
  bf16* vs = ks + size_t(TN) * L.ld;
  long long* rows = reinterpret_cast<long long*>(base + L.rows);

  if (!live) return;
  // the pair's warps meet on their own barrier (1 + slot; 0 is the block's)
  const auto sync_pair = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(pt) : "memory");
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

template <int NT, class Addr>
cudaError_t launch_nt(const Addr& a, int n_pairs, int heads, int TN, int hd,
                      const float* bias, const float* mask, int n_mask,
                      float scale, cudaStream_t s) {
  const PairSmem L = pair_smem(TN, hd);
  const int pt = TN / 16 * 32;
  int group = 256 / pt;
  const int fit = static_cast<int>(PAIR_TARGET / L.total);
  if (group > fit) group = fit;
  if (group < 1) group = 1;
  const size_t bytes = group * L.total;
  // once per instance: let it ask for the most shared memory a block may
  static int optin = 0;
  if (!optin) {
    int dev = 0, most = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_attention_mma_kernel<NT, Addr>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return err;
    optin = most;
  }
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  window_attention_mma_kernel<NT, Addr>
      <<<(n_pairs + group - 1) / group, group * pt, bytes, s>>>(
          a, bias, mask, n_mask, n_pairs, heads, TN, hd, group, scale);
  return cudaGetLastError();
}

template <class Addr>
cudaError_t launch(const Addr& a, int n_windows, int heads, int TN, int hd,
                   const float* bias, const float* mask, int n_mask,
                   float scale, cudaStream_t s) {
  if (TN <= 0 || TN % 16 || TN > 16 * MAX_NT || hd <= 0 || hd % 16)
    return cudaErrorInvalidValue;
  const float* m = n_mask > 1 ? mask : nullptr;
  const int n_pairs = n_windows * heads, nt = TN / 16;
  if (nt <= 2)
    return launch_nt<2>(a, n_pairs, heads, TN, hd, bias, m, n_mask, scale, s);
  if (nt <= 4)
    return launch_nt<4>(a, n_pairs, heads, TN, hd, bias, m, n_mask, scale, s);
  if (nt <= 8)
    return launch_nt<8>(a, n_pairs, heads, TN, hd, bias, m, n_mask, scale, s);
  return launch_nt<MAX_NT>(a, n_pairs, heads, TN, hd, bias, m, n_mask, scale,
                           s);
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
