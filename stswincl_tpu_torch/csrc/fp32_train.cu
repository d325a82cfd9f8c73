// The fp32 training forms: K5 and K6 in fp32, on an fp32 weight-gradient
// GEMM; what an fp32 model trains through on the card.
//
// Replaces the fp32 instances of the dtype-generic TPU kernels:
//   K5 stswincl_tpu/ops/pallas_block_attention.py
//        fused_swin_block_attention_bwd (:547) -> _full_bwd_kernel (:405)
//        (Pallas row 6);
//   K6 stswincl_tpu/ops/pallas_add_ln_mlp.py
//        fused_epilogue_bwd (:310) -> _epi_bwd_kernel (:181), m recomputed
//        (row 7, C 512), and fused_epilogue_bwd_streamed (:557) ->
//        _epi_bwd_slice_kernel (:425) + _epi_bwd_combine_kernel (:502), the
//        saved m (row 9, C 1024).
// Row 8, K2's training forward that saves m, is `stswin_block_epilogue_f32`
// with its m output (fp32_forms.cu). The bf16 forms (block_attention.cu,
// epilogue.cu) run bf16 operands on the tensor cores; nothing of them is
// shared here but the row map and the GELU of common.cuh.
//
// Bound on the H100: the products. The fp32 GEMM's (`gemm_f32`, the tile
// of fp32_gemm.cuh) and the weight gradients (`wgrad_f32`) run on the
// tensor cores as a 3xTF32 split (tf32x3.cuh: fp32-accurate at a third of
// the TF32 rate, 164.9 TFLOP/s; one TF32 pass is not fp32), the GEMM on
// wgmma, `wgrad_f32` and K5's attention backward (fp32_attention_bwd.cuh)
// on mma.sync. K5 at stage 1 (794 GFLOP: 344 weight
// gradients, 344 GEMM, 106 attention) at least 5.8 ms, K6 with m
// recomputed (2,062 GFLOP, all products) 12.5 ms, K6 with m saved at stage
// 2 (1,718 GFLOP) 10.4 ms. A weight gradient alone: K5's dwqkv at stage
// 1, (163840, 1536)^T (163840, 512), 257.7 GFLOP, at least 1.56 ms.
//
// Every reduction is deterministic: no float atomics anywhere. A sum that
// spans blocks is written as one partial a block (or a split of the rows)
// into scratch and summed by a second launch in a fixed order
// (`sum_parts`), so two calls on the same inputs give the same bits.
//
// Design:
//   - `wgrad_f32`: out = sum_r A[a_map(r)]^T B[b_map(r)], the weight
//     gradients, on mma.sync m16n8k8 tf32, three passes a product. A 128 x
//     128 output tile a block of 8 warps (64 x 32 a warp: 16 sub-tiles of
//     16 x 8, every pass over all 16 so the dependent mmas of a sub-tile
//     are 15 apart), the rows r in k tiles of 32 through a four-stage
//     cp.async ring; each operand row read through its RowMap. Both
//     operands arrive R-major (M- and N-major), the layout tf32 wgmma
//     cannot read (it takes tf32 from shared memory K-major only); mma.sync
//     reads its fragments with scalar loads from the raw tiles at a row
//     pitch of 8 mod 32 words (conflict-free), splitting each value as it
//     is read, so no transposed or split copy is written: the simpler of
//     the two designs, at the cost of mma.sync's rate (about 300 TFLOP/s
//     of TF32 on the H100, `tools/profile_mma_rate.py`, against the 494.7
//     that wgmma reaches). Each k tile sums in the
//     mma from 0 and is added to the thread's fp32 sums, rounded to
//     nearest: the mma's accumulation truncates, and over a split of
//     thousands of rows that drifts past the fp32 bound. R is split in
//     `wgrad_splits(R, M, N)` ranges, the count that fills the card's
//     waves best (11 for stage 1's dwqkv), a split a z-block, each
//     writing its partial; `sum_parts` adds them in order.
//   - `colsum_f32`: the bias gradients, the column sums of a row matrix:
//     a thread a column over 1,024 rows, then the partials in order.
//   - K5's attention backward (fp32_attention_bwd.cuh, which says how):
//     a query pass (dq, each query row's max, 1 / sum and D, per-block
//     dbias partials), `sum_parts` of the partials, a key pass (dk, dv),
//     every product 3xTF32 on mma.sync, P and dS fp32 in registers, the
//     forward's softmax contract (the scale after the product, + bias, +
//     the window's mask for SW-MSA, max, exp, x 1 / sum,
//     `pallas_block_attention.py:470-494`). The fp32 q, k, v and dO of a
//     whole (window, head) at stage 1 take 270 KB, past the 227 KB a block
//     may use: the query pass holds k and v and each warp's own q, then
//     dO; the key pass k and v and a ring of q and dO chunks.
//   - K5 (`stswin_block_attention_bwd_f32`), bf16 K5's plan in fp32:
//     dattn = g @ wproj (g gathered by the window partition), the two
//     passes, dx = dqkv @ wqkv scattered back through the shift map,
//     dwqkv and dwproj on `wgrad_f32`, dbqkv and dbproj on `colsum_f32`.
//   - K6 (`stswin_block_epilogue_bwd_f32`), bf16 K6's seven steps in fp32:
//     s = x + unshift(y) and LN2(s); fc1 writing h and gelu' (F32_GELU_GRAD)
//     and, without a saved m, m = h @ w2^T + bw2; the LN1 backward row pass
//     (do, with the column sums ds1, db1n, dbw2); dpre = (do @ w2) * gelu'
//     (F32_DGELU, in place over gelu') and db1 = its column sums; dn2 =
//     dpre @ w1; the LN2 backward row pass (dx unshifted, dy through the
//     shift, the sums ds2 and db2); dw1 and dw2 on `wgrad_f32`. gelu'
//     goes through device memory for both rows (1.34 GB at stage 1); in
//     fp32 dm is do itself. The row passes run a fixed grid of at most
//     1,024 blocks, a warp a row; each block sums its rows' terms in
//     registers, then its 8 warps in order, into its partial.

#include <atomic>

#include "fp32_attention_bwd.cuh"
#include "fp32_gemm.cuh"
#include "tf32x3.cuh"

namespace {

std::atomic<long long> wgrad_count{0};

// ---- fixed-order reductions ----------------------------------------------

constexpr int WSPLIT_ROWS = 2048, WSPLIT_MAX = 32;
constexpr int WAVE = 132;  // weight-gradient blocks the H100 holds at once
constexpr int CS_ROWS = 1024;
constexpr int RW = 8;             // warps a row-pass block
constexpr int ROW_BLOCKS = 1024;  // the row passes' grid, at most

// The ranges R is split in for an (M, N) output: of 1 .. min(32, R /
// 2048), the count whose blocks (128 x 128 tiles times splits, one an SM)
// fill their waves of WAVE best, the fewest on a tie. It depends on the
// shapes alone, so every card sums in the same order.
inline int wgrad_splits(int R, int M, int N) {
  const long long tiles = (long long)((M + 127) / 128) * ((N + 127) / 128);
  int most = R / WSPLIT_ROWS;
  most = most < 1 ? 1 : (most > WSPLIT_MAX ? WSPLIT_MAX : most);
  int best = 1;
  double fill = 0.0;
  for (int s = 1; s <= most; ++s) {
    const long long blocks = tiles * s;
    const double f =
        double(blocks) / double((blocks + WAVE - 1) / WAVE * WAVE);
    if (f > fill + 1e-9) {
      fill = f;
      best = s;
    }
  }
  return best;
}
inline int cs_splits(int R) { return R < 1 ? 1 : (R + CS_ROWS - 1) / CS_ROWS; }
inline int row_blocks(int R) {
  const int b = (R + RW - 1) / RW;
  return b < 1 ? 1 : (b > ROW_BLOCKS ? ROW_BLOCKS : b);
}

// out[i] = sum_s part[s * stride + i], s ascending
__global__ void sum_parts_kernel(const float* __restrict__ part, int parts,
                                 long long stride, long long len,
                                 float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= len) return;
  float v = part[i];
  for (int s = 1; s < parts; ++s) v += part[s * stride + i];
  out[i] = v;
}

cudaError_t sum_parts(const float* part, int parts, long long stride,
                      long long len, float* out, cudaStream_t s) {
  sum_parts_kernel<<<static_cast<unsigned>((len + 255) / 256), 256, 0, s>>>(
      part, parts, stride, len, out);
  return cudaGetLastError();
}

// part[s][n] = sum of X[r][n] over the rows r of split s, r ascending
__global__ void colsum_f32_kernel(const float* __restrict__ X, long long ld,
                                  int R, int N, float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * CS_ROWS;
  const int r1 = r0 + CS_ROWS < R ? r0 + CS_ROWS : R;
  const float* p = X + (long long)r0 * ld + n;
  float v = 0.0f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r, p += ld) v += *p;
  part[(long long)blockIdx.y * N + n] = v;
}

// out[n] = sum_r X[r][n] in a fixed order; part: cs_splits(R) * N floats
cudaError_t colsum_f32(const float* X, long long ld, int R, int N, float* out,
                       float* part, cudaStream_t s) {
  if (N <= 0 || R < 0) return cudaErrorInvalidValue;
  const int parts = cs_splits(R);
  colsum_f32_kernel<<<dim3((N + 255) / 256, parts), 256, 0, s>>>(X, ld, R, N,
                                                                   part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_parts(part, parts, N, N, out, s);
}

// ---- the weight-gradient GEMM ------------------------------------------

// A 128 x 128 output tile a block of 8 warps, each warp 64 (m) x 32 (n);
// the rows r in k tiles of 32 through a four-stage cp.async ring of raw
// fp32 [r][m] and [r][n] tiles, rows padded to 136 floats (139 KiB: one
// block an SM, up to 255 registers a thread).
constexpr int WBM = 128, WBN = 128, WBK = 32, WSTAGES = 4;
constexpr int WPITCH = WBM + 8;  // 8 mod 32 words: fragment reads t * 8 + g
constexpr int WTHREADS = 256;
constexpr size_t WSMEM = size_t(2) * WSTAGES * WBK * WPITCH * sizeof(float);

struct F32Wgrad {
  const float* A;
  long long lda;
  RowMap a_map;
  const float* B;
  long long ldb;
  RowMap b_map;
  int R, M, N;
};

// x / d for 0 <= x < 2^31 by a multiply-high and a shift (d >= 1).
struct FastDiv {
  int d;
  unsigned mul, shr;
  explicit FastDiv(int div = 1) : d(div), mul(0), shr(0) {
    if (div > 1) {
      int l = 31 - __builtin_clz(unsigned(div));
      l += (div & (div - 1)) != 0;  // ceil(log2 d)
      const unsigned p = 31 + l;
      mul = unsigned(((1ull << p) + unsigned(div) - 1) / unsigned(div));
      shr = p - 32;
    }
  }
  __device__ __forceinline__ int operator()(int x) const {
    return d == 1 ? x : int(__umulhi(unsigned(x), mul) >> shr);
  }
};

// `map_row` with its five divisions by multiply-high: the weight-gradient
// loader maps 8 rows a warp and k tile, and the divisions of the plain
// form cost as many issue slots as a tenth of the tile's products.
struct FastMap {
  int mode, T, H, W, ws, shift, TN, N, nWin, nWw;
  FastDiv by_TN, by_N, by_ws, by_nWin, by_nWw;
  explicit FastMap(const RowMap& m)
      : mode(m.mode), T(m.T), H(m.H), W(m.W), ws(m.ws), shift(m.shift),
        TN(m.T * m.ws * m.ws), N(m.ws * m.ws),
        nWin((m.H / m.ws) * (m.W / m.ws)), nWw(m.W / m.ws),
        by_TN(TN), by_N(N), by_ws(m.ws), by_nWin(nWin), by_nWw(nWw) {}
  __device__ __forceinline__ long long operator()(int r) const {
    if (mode == 0) return r;
    const int bw = by_TN(r), p = r - bw * TN;
    const int t = by_N(p), q = p - t * N;
    const int i = by_ws(q), j = q - i * ws;
    const int b = by_nWin(bw), win = bw - b * nWin;
    const int wh = by_nWw(win), ww = win - wh * nWw;
    int h = wh * ws + i + shift;
    if (h >= H) h -= H;
    int w = ww * ws + j + shift;
    if (w >= W) w -= W;
    return ((long long)(b * T + t) * H + h) * W + w;
  }
};

// dst[split][m][n] (rows of N) = the sum over the split's rows, k tile by
// k tile in ascending r. A warp's 4 x 4 sub-tiles of 16 x 8 take each k
// step of 8 rows as three mma.sync m16n8k8 tf32 passes (tf32x3.cuh: the
// small terms, then the big), every pass over all 16 sub-tiles before the
// next, so each mma has 15 others between it and the one it waits for.
// The k tile's four steps sum in the mma from 0 and are then added to the
// thread's fp32 sums, rounded to nearest: the mma's own accumulation
// drops the bits past its sum's last (a bias toward zero), which over a
// split's thousands of rows drifts past the fp32 bound, over 32 rows not.
// The tiles stay as they arrive, r-major (M- and N-major): the A fragment
// (row m, column r) reads As[r][m] and the B fragment (row r, column n)
// Bs[r][n] with scalar loads, each value split into its TF32 halves in
// registers as it is read, so no transposed copy is made.
__global__ void __launch_bounds__(WTHREADS, 1)
    wgrad_f32_kernel(const F32Wgrad p, const FastMap a_map,
                     const FastMap b_map, int chunk,
                     float* __restrict__ dst) {
  extern __shared__ __align__(16) float wsm[];
  float* As = wsm;                           // [WSTAGES][WBK][WPITCH]
  float* Bs = wsm + WSTAGES * WBK * WPITCH;  // the same
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;
  const int r0 = blockIdx.z * chunk;
  const int r1 = r0 + chunk < p.R ? r0 + chunk : p.R;
  // the loader: rows lr + 8 i of the k tile, the 16-byte chunk at lc. The
  // warp's 2 x 4 row indices (A's and B's, each through its row map) are
  // computed by lanes 0-7, one each, and shuffled to the rest.
  const int lr = tid >> 5, lc = (tid & 31) * 4;
  const bool a_col = m0 + lc < p.M, b_col = n0 + lc < p.N;
  const int nk = r1 > r0 ? (r1 - r0 + WBK - 1) / WBK : 0;
  static_assert(WBK == 32, "the loader maps 4 rows an operand a warp");
  auto load = [&](int stage, int kt) {
    const int rr = r0 + kt * WBK + lr + 8 * (lane & 3);
    const long long mine =
        rr < r1 ? ((lane & 4) ? b_map(rr) : a_map(rr)) : -1;
#pragma unroll
    for (int i = 0; i < WBK / 8; ++i) {
      const long long ra = __shfl_sync(0xffffffffu, mine, i);
      const long long rb = __shfl_sync(0xffffffffu, mine, 4 + i);
      const bool rin = ra >= 0;
      const float* a =
          p.A + (rin ? ra : 0) * p.lda + (a_col ? m0 + lc : 0);
      const float* b =
          p.B + (rin ? rb : 0) * p.ldb + (b_col ? n0 + lc : 0);
      const int o = (stage * WBK + lr + 8 * i) * WPITCH + lc;
      cp_async16(As + o, a, rin && a_col);
      cp_async16(Bs + o, b, rin && b_col);
    }
  };
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < nk) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float acc[16][4];  // sub-tile 4 i + j: rows wm + 16 i, columns wn + 8 j
#pragma unroll
  for (int u = 0; u < 16; ++u)
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WSTAGES - 2) : "memory");
    __syncthreads();  // stage kt landed; stage kt - 1's readers done
    const int next = kt + WSTAGES - 1;
    if (next < nk) load(next % WSTAGES, next);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int st = kt % WSTAGES;
    float d[16][4];
#pragma unroll
    for (int k0 = 0; k0 < WBK; k0 += 8) {
      const float* a = As + (st * WBK + k0 + tq) * WPITCH + wm + g;
      const float* b = Bs + (st * WBK + k0 + tq) * WPITCH + wn + g;
      tf32x3::FragA fa[4];
      tf32x3::FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) fb[j].set(b[8 * j], b[4 * WPITCH + 8 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        fa[i].set(a[16 * i], a[16 * i + 8], a[4 * WPITCH + 16 * i],
                  a[4 * WPITCH + 16 * i + 8]);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (k0 == 0)
          tf32x3::mma1688_from0(d[u], fa[u / 4].lo, fb[u % 4].hi[0],
                                fb[u % 4].hi[1]);
        else
          tf32x3::mma1688(d[u], fa[u / 4].lo, fb[u % 4].hi[0],
                          fb[u % 4].hi[1]);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        tf32x3::mma1688(d[u], fa[u / 4].hi, fb[u % 4].lo[0], fb[u % 4].lo[1]);
#pragma unroll
      for (int u = 0; u < 16; ++u)
        tf32x3::mma1688(d[u], fa[u / 4].hi, fb[u % 4].hi[0], fb[u % 4].hi[1]);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] += d[u][e];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  float* out = dst + (long long)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm + 16 * i + g + 8 * hh;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * tq;
        if (n < p.N)
          *reinterpret_cast<float2*>(out + (long long)m * p.N + n) =
              make_float2(acc[4 * i + j][2 * hh], acc[4 * i + j][2 * hh + 1]);
      }
    }
  }
}

// out (M, N) = sum_r A[a_map(r)]^T B[b_map(r)]; part: wgrad_work floats
cudaError_t wgrad_f32(const F32Wgrad& p, float* out, float* part,
                      cudaStream_t s) {
  if (p.R < 0 || p.M <= 0 || p.N <= 0 || p.M % 4 || p.N % 4 || p.lda % 4 ||
      p.ldb % 4)
    return cudaErrorInvalidValue;
  const int splits = wgrad_splits(p.R, p.M, p.N);
  if (splits > 1 && !part) return cudaErrorInvalidValue;
  static bool allowed[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(WSMEM));
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const int chunk = ((p.R + splits - 1) / splits + WBK - 1) / WBK * WBK;
  const dim3 grid((p.N + WBN - 1) / WBN, (p.M + WBM - 1) / WBM, splits);
  wgrad_f32_kernel<<<grid, WTHREADS, WSMEM, s>>>(p, FastMap(p.a_map),
                                                FastMap(p.b_map), chunk,
                                                splits > 1 ? part : out);
  wgrad_count.fetch_add(1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)p.M * p.N;
  return sum_parts(part, splits, mn, mn, out, s);
}

size_t wgrad_work(int R, int M, int N) {
  const int splits = wgrad_splits(R, M, N);
  return splits > 1 ? size_t(splits) * M * N : 0;
}

// ---- K5's attention backward (fp32_attention_bwd.cuh) --------------------

// once a kernel and device: the most shared memory a block may use
template <typename K>
cudaError_t opt_in(K kernel, int* optins, size_t bytes) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!optins[dev]) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    optins[dev] = most;
  }
  return bytes > static_cast<size_t>(optins[dev]) ? cudaErrorInvalidValue
                                                  : cudaSuccess;
}

template <int NT>
cudaError_t launch_q_pass(const float* qkv, const float* dO,
                          const float* bias, const float* mask, int n_mask,
                          float* dqkv, float* stats, float* dbias_part,
                          int n_windows, int heads, int TN, int hd, int C,
                          float scale, cudaStream_t s, int* per_head) {
  static int optin[MAX_DEVICES] = {};
  const size_t bytes = attn32b::q_smem(TN, hd);
  cudaError_t err = opt_in(attn32b::q_kernel<NT>, optin, bytes);
  if (err != cudaSuccess) return err;
  int per_block;
  attn32b::q_split(n_windows, heads, TN, hd, per_head, &per_block);
  attn32b::q_kernel<NT><<<dim3(*per_head, heads), TN / 16 * 32, bytes, s>>>(
      qkv, dO, bias, mask, n_mask, dqkv, stats, dbias_part, n_windows,
      per_block, heads, TN, hd, C, scale);
  return cudaGetLastError();
}

template <int CT>
cudaError_t launch_kv_pass(const float* qkv, const float* dO,
                           const float* bias, const float* mask, int n_mask,
                           const float* stats, float* dqkv, int n_windows,
                           int heads, int TN, int hd, int C, float scale,
                           cudaStream_t s) {
  static int optin[MAX_DEVICES] = {};
  const size_t bytes = attn32b::kv_smem(TN, hd);
  cudaError_t err = opt_in(attn32b::kv_kernel<CT>, optin, bytes);
  if (err != cudaSuccess) return err;
  attn32b::kv_kernel<CT>
      <<<n_windows * heads, TN / 16 * attn32b::col_splits(hd) * 32, bytes,
         s>>>(qkv, dO, bias, mask, n_mask, stats, dqkv, heads, TN, hd, C,
              scale);
  return cudaGetLastError();
}

// The window and head dims the attention backward takes (`ops/
// block_attention.check_backward_window` refuses the rest before K1 runs):
// windows of 16-token tiles up to 128 tokens (the query pass's score tile
// is 16 key tiles of 8 at most), head dims a multiple of 32 (the forward
// core's) up to 256 at TN <= 32 and 128 beyond (the key pass's dk and dv
// accumulators hold 128 columns a warp, two warps a key group past 128).
bool attn_bwd_f32_takes(int TN, int hd) {
  return TN > 0 && TN % 16 == 0 && TN <= 128 && hd > 0 && hd % 32 == 0 &&
         hd <= (TN <= 32 ? 256 : 128);
}

// dq, dk, dv into dqkv and dbias: the query pass, the dbias partials
// summed in order, the key pass. stats: (windows, heads, TN, 4) floats;
// dbias_part: per_head (`attn32b::q_split`) x heads x TN x TN floats.
cudaError_t attn_bwd_f32(const float* qkv, const float* dO, const float* bias,
                         const float* mask, int n_mask, float* dqkv,
                         float* stats, float* dbias_part, float* dbias,
                         int n_windows, int heads, int TN, int hd, int C,
                         float scale, cudaStream_t s) {
  if (!attn_bwd_f32_takes(TN, hd) || n_windows <= 0)
    return cudaErrorInvalidValue;
  const float* m = n_mask > 1 ? mask : nullptr;
  int per_head = 0;
  cudaError_t err;
  if (TN <= 32)
    err = launch_q_pass<4>(qkv, dO, bias, m, n_mask, dqkv, stats, dbias_part,
                           n_windows, heads, TN, hd, C, scale, s, &per_head);
  else if (TN <= 64)
    err = launch_q_pass<8>(qkv, dO, bias, m, n_mask, dqkv, stats, dbias_part,
                           n_windows, heads, TN, hd, C, scale, s, &per_head);
  else
    err = launch_q_pass<16>(qkv, dO, bias, m, n_mask, dqkv, stats,
                            dbias_part, n_windows, heads, TN, hd, C, scale, s,
                            &per_head);
  if (err != cudaSuccess) return err;
  const long long table = (long long)heads * TN * TN;
  if ((err = sum_parts(dbias_part, per_head, table, table, dbias, s)) !=
      cudaSuccess)
    return err;
  if (hd <= 32)
    return launch_kv_pass<4>(qkv, dO, bias, m, n_mask, stats, dqkv,
                             n_windows, heads, TN, hd, C, scale, s);
  if (hd <= 64)
    return launch_kv_pass<8>(qkv, dO, bias, m, n_mask, stats, dqkv,
                             n_windows, heads, TN, hd, C, scale, s);
  return launch_kv_pass<16>(qkv, dO, bias, m, n_mask, stats, dqkv, n_windows,
                            heads, TN, hd, C, scale, s);
}

struct K5Work {
  size_t dattn, dqkv, stats, dbias_part, cs, wpart, total;
};

K5Work k5_work(int R, int C, int heads, int TN) {
  K5Work w{};
  const int n_windows = TN > 0 ? R / TN : 0;
  int per_head = 1, per_block = 1;
  if (n_windows > 0 && TN > 0 && heads > 0 && C % heads == 0)
    attn32b::q_split(n_windows, heads, TN, C / heads, &per_head, &per_block);
  const size_t cs = size_t(cs_splits(R)) * 3 * C;
  // dwqkv's and dwproj's partials share the area: the larger of the two
  const size_t wq = wgrad_work(R, 3 * C, C), wo = wgrad_work(R, C, C);
  const size_t wp = wq > wo ? wq : wo;
  w.dattn = 0;
  w.dqkv = w.dattn + size_t(R) * C;
  w.stats = w.dqkv + size_t(R) * 3 * C;
  w.dbias_part = w.stats + size_t(R) * heads * 4;
  w.cs = w.dbias_part + size_t(per_head) * heads * TN * TN;
  w.wpart = w.cs + cs;
  w.total = w.wpart + wp;
  return w;
}

// ---- K6's row passes ------------------------------------------------------

// two-pass LayerNorm statistics of a row held as NV float4 a lane
template <int NV>
__device__ __forceinline__ void row_stats(const float4 (&v)[NV], float& mu,
                                          float& rs, float eps) {
  constexpr int C = 128 * NV;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) sum += v[i].x + v[i].y + v[i].z + v[i].w;
  mu = warp_sum(sum) / C;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float d0 = v[i].x - mu, d1 = v[i].y - mu, d2 = v[i].z - mu,
                d3 = v[i].w - mu;
    sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
  }
  rs = rsqrtf(warp_sum(sq) / C + eps);
}

// dx of y = xhat * scale + bias given dy (`_ln_bwd_f32`): gv holds dy on
// entry and dx on return; xh holds xhat.
template <int NV>
__device__ __forceinline__ void ln_bwd_row(float4 (&gv)[NV],
                                           const float4 (&xh)[NV],
                                           const float* __restrict__ scale,
                                           float rs, int lane) {
  constexpr int C = 128 * NV;
  float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 sc = ld4(scale + lane * 4 + 128 * i);
    gv[i] = make_float4(gv[i].x * sc.x, gv[i].y * sc.y, gv[i].z * sc.z,
                        gv[i].w * sc.w);
    m1 += gv[i].x + gv[i].y + gv[i].z + gv[i].w;
    m2 += gv[i].x * xh[i].x + gv[i].y * xh[i].y + gv[i].z * xh[i].z +
          gv[i].w * xh[i].w;
  }
  m1 = warp_sum(m1) / C;
  m2 = warp_sum(m2) / C;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    gv[i] = make_float4((gv[i].x - m1 - xh[i].x * m2) * rs,
                        (gv[i].y - m1 - xh[i].y * m2) * rs,
                        (gv[i].z - m1 - xh[i].z * m2) * rs,
                        (gv[i].w - m1 - xh[i].w * m2) * rs);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// the block's per-lane sums -> part[k * C + c], its 8 warps added in order
template <int NV, int NVEC>
__device__ __forceinline__ void flush_rows(const float4 (&acc)[NVEC][NV],
                                           float* red, float* part, int warp,
                                           int lane) {
  constexpr int C = 128 * NV;
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      *reinterpret_cast<float4*>(red + warp * C + lane * 4 + 128 * i) =
          acc[k][i];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += RW * 32) {
      float v = red[c];
      for (int w = 1; w < RW; ++w) v += red[w * C + c];
      part[k * C + c] = v;
    }
    __syncthreads();
  }
}

// LN1 backward: o = s32 + m, g -> do32; the block's sums of g * xhat1,
// g and do32 (ds1, db1n, dbw2) -> part[block][3][C]
template <int NV>
__global__ void __launch_bounds__(RW * 32)
    ln1_bwd_f32_kernel(const float* __restrict__ s32,
                       const float* __restrict__ m,
                       const float* __restrict__ g,
                       const float* __restrict__ s1,
                       float* __restrict__ do32, float* __restrict__ part,
                       int R, float eps) {
  constexpr int C = 128 * NV;
  __shared__ __align__(16) float red[RW * C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 acc[3][NV];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[k][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = blockIdx.x * RW + warp; r < R; r += gridDim.x * RW) {
    const long long base = (long long)r * C;
    float4 o[NV], gv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane * 4 + 128 * i;
      o[i] = ld4(s32 + base + c);
      add4(o[i], ld4(m + base + c));
      gv[i] = ld4(g + base + c);
    }
    float mu, rs;
    row_stats<NV>(o, mu, rs, eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      o[i] = make_float4((o[i].x - mu) * rs, (o[i].y - mu) * rs,
                         (o[i].z - mu) * rs, (o[i].w - mu) * rs);
      add4(acc[0][i], mul4(gv[i], o[i]));
      add4(acc[1][i], gv[i]);
    }
    ln_bwd_row<NV>(gv, o, s1, rs, lane);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      *reinterpret_cast<float4*>(do32 + base + lane * 4 + 128 * i) = gv[i];
      add4(acc[2][i], gv[i]);
    }
  }
  flush_rows<NV, 3>(acc, red, part + (long long)blockIdx.x * 3 * C, warp,
                    lane);
}

// LN2 backward of dn2 with xhat2 / rsig2 recomputed from s32; ds = do32 +
// that -> dx (row r) and dy (the shifted row), the block's sums of dn2 *
// xhat2 and dn2 (ds2, db2) -> part[block][2][C]
template <int NV>
__global__ void __launch_bounds__(RW * 32)
    ln2_bwd_f32_kernel(const float* __restrict__ s32,
                       const float* __restrict__ dn2,
                       const float* __restrict__ do32,
                       const float* __restrict__ s2, float* __restrict__ dx,
                       float* __restrict__ dy, float* __restrict__ part,
                       int R, int H, int W, int shift, float eps) {
  constexpr int C = 128 * NV;
  __shared__ __align__(16) float red[RW * C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 acc[2][NV];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[k][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = blockIdx.x * RW + warp; r < R; r += gridDim.x * RW) {
    const long long base = (long long)r * C;
    float4 xh[NV], gv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane * 4 + 128 * i;
      xh[i] = ld4(s32 + base + c);
      gv[i] = ld4(dn2 + base + c);
    }
    float mu, rs;
    row_stats<NV>(xh, mu, rs, eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xh[i] = make_float4((xh[i].x - mu) * rs, (xh[i].y - mu) * rs,
                          (xh[i].z - mu) * rs, (xh[i].w - mu) * rs);
      add4(acc[0][i], mul4(gv[i], xh[i]));
      add4(acc[1][i], gv[i]);
    }
    ln_bwd_row<NV>(gv, xh, s2, rs, lane);
    long long ybase = base;
    if (dy) {
      const int w = r % W, h = (r / W) % H, bt = r / (W * H);
      const int hs = h - shift < 0 ? h - shift + H : h - shift;
      const int wsrc = w - shift < 0 ? w - shift + W : w - shift;
      ybase = ((long long)(bt * H + hs) * W + wsrc) * C;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane * 4 + 128 * i;
      float4 d = ld4(do32 + base + c);
      add4(d, gv[i]);
      *reinterpret_cast<float4*>(dx + base + c) = d;
      if (dy) *reinterpret_cast<float4*>(dy + ybase + c) = d;
    }
  }
  flush_rows<NV, 2>(acc, red, part + (long long)blockIdx.x * 2 * C, warp,
                    lane);
}

template <int NV>
cudaError_t launch_rows(bool first, int blocks, cudaStream_t s,
                        const float* s32, const float* m, const float* g,
                        const float* scale, float* do32, const float* dn2,
                        float* dx, float* dy, float* part, int R, int H,
                        int W, int shift, float eps) {
  if (first)
    ln1_bwd_f32_kernel<NV><<<blocks, RW * 32, 0, s>>>(s32, m, g, scale, do32,
                                                      part, R, eps);
  else
    ln2_bwd_f32_kernel<NV><<<blocks, RW * 32, 0, s>>>(
        s32, dn2, do32, scale, dx, dy, part, R, H, W, shift, eps);
  return cudaGetLastError();
}

cudaError_t bwd_rows(int C, bool first, int blocks, cudaStream_t s,
                     const float* s32, const float* m, const float* g,
                     const float* scale, float* do32, const float* dn2,
                     float* dx, float* dy, float* part, int R, int H, int W,
                     int shift, float eps) {
  switch (C) {
    case 128:
      return launch_rows<1>(first, blocks, s, s32, m, g, scale, do32, dn2, dx,
                            dy, part, R, H, W, shift, eps);
    case 256:
      return launch_rows<2>(first, blocks, s, s32, m, g, scale, do32, dn2, dx,
                            dy, part, R, H, W, shift, eps);
    case 512:
      return launch_rows<4>(first, blocks, s, s32, m, g, scale, do32, dn2, dx,
                            dy, part, R, H, W, shift, eps);
    case 1024:
      return launch_rows<8>(first, blocks, s, s32, m, g, scale, do32, dn2, dx,
                            dy, part, R, H, W, shift, eps);
    default:
      return cudaErrorInvalidValue;
  }
}

struct K6Work {
  size_t s32, n2, h, dgelu, m, do32, dn2, rows, cs, wpart, total;
};

K6Work k6_work(int R, int C, int hidden, bool recompute) {
  K6Work w{};
  const size_t rc = size_t(R) * C, rh = size_t(R) * hidden;
  w.s32 = 0;
  w.n2 = w.s32 + rc;
  w.h = w.n2 + rc;
  w.dgelu = w.h + rh;  // then dpre, in place
  w.m = w.dgelu + rh;
  w.do32 = w.m + (recompute ? rc : 0);
  w.dn2 = w.do32 + rc;
  w.rows = w.dn2 + rc;
  w.cs = w.rows + size_t(row_blocks(R)) * 3 * C;
  w.wpart = w.cs + size_t(cs_splits(R)) * hidden;
  w.total = w.wpart + wgrad_work(R, hidden, C);
  return w;
}

F32Wgrad plain_wgrad(const float* A, int lda, const float* B, int ldb, int R,
                     int M, int N) {
  F32Wgrad w{};
  w.A = A;
  w.lda = lda;
  w.a_map = identity_map();
  w.B = B;
  w.ldb = ldb;
  w.b_map = identity_map();
  w.R = R;
  w.M = M;
  w.N = N;
  return w;
}

}  // namespace

long long wgrad_f32_launches(int reset) {
  return reset ? wgrad_count.exchange(0) : wgrad_count.load();
}

// K5 fp32. x: (B, T, H, W, C) fp32 unshifted; g: the output's gradient in
// the forward's (shifted) output layout; qkv (rows, 3C), attn (rows, C):
// K1 fp32's window-order scratch; wqkv_t (C, 3C), wproj_t (C, C): the
// transposed fp32 weights; bias (heads, TN, TN), mask (n_mask, TN, TN)
// fp32. work: `stswin_block_attention_bwd_f32_work` floats. Outputs, fp32
// and overwritten: dx unshifted; dwqkv (3C, C), dbqkv (3C), dwproj (C, C),
// dbproj (C), dbias (heads, TN, TN).
extern "C" int stswin_block_attention_bwd_f32(
    const void* x, const void* g, const void* qkv, const void* attn,
    const void* wqkv_t, const void* wproj_t, const void* bias,
    const void* mask, void* work, void* dx, void* dwqkv, void* dbqkv,
    void* dwproj, void* dbproj, void* dbias, int B, int T, int H, int W,
    int C, int heads, int ws, float scale, int shift, int n_mask,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T * H * W, hd = C / heads, TN = T * ws * ws;
  if (!attn_bwd_f32_takes(TN, hd) || C % heads) return cudaErrorInvalidValue;
  const RowMap win = RowMap{1, T, H, W, ws, 0};
  const RowMap win_shift = RowMap{1, T, H, W, ws, shift};
  const K5Work L = k5_work(M, C, heads, TN);
  float* wk = static_cast<float*>(work);
  float* dattn = wk + L.dattn;
  float* dqkv = wk + L.dqkv;
  const float* gp = static_cast<const float*>(g);

  // 1. dattn (window order) = g (gathered) @ wproj
  F32Gemm p = plain_gemm(gp, C, static_cast<const float*>(wproj_t), nullptr,
                         M, C, C, dattn, C, ACT_NONE);
  p.a_map = win;
  cudaError_t err = gemm_f32(p, s);
  if (err != cudaSuccess) return err;

  // 2. the attention backward: dq, dk, dv into dqkv, dbias
  if ((err = attn_bwd_f32(static_cast<const float*>(qkv), dattn,
                          static_cast<const float*>(bias),
                          static_cast<const float*>(mask), n_mask, dqkv,
                          wk + L.stats, wk + L.dbias_part,
                          static_cast<float*>(dbias), M / TN, heads, TN, hd,
                          C, scale, s)) != cudaSuccess)
    return err;

  // 3. dx (unshifted image) = dqkv @ wqkv, scattered through the shift map
  p = plain_gemm(dqkv, 3 * C, static_cast<const float*>(wqkv_t), nullptr, M,
                 C, 3 * C, static_cast<float*>(dx), C, ACT_NONE);
  p.c_map = win_shift;
  if ((err = gemm_f32(p, s)) != cudaSuccess) return err;

  // 4. the weight and bias gradients
  F32Wgrad w = plain_wgrad(dqkv, 3 * C, static_cast<const float*>(x), C, M,
                           3 * C, C);
  w.b_map = win_shift;
  if ((err = wgrad_f32(w, static_cast<float*>(dwqkv), wk + L.wpart, s)) !=
      cudaSuccess)
    return err;
  w = plain_wgrad(gp, C, static_cast<const float*>(attn), C, M, C, C);
  w.a_map = win;
  if ((err = wgrad_f32(w, static_cast<float*>(dwproj), wk + L.wpart, s)) !=
      cudaSuccess)
    return err;
  if ((err = colsum_f32(dqkv, 3 * C, M, 3 * C, static_cast<float*>(dbqkv),
                        wk + L.cs, s)) != cudaSuccess)
    return err;
  return colsum_f32(gp, C, M, C, static_cast<float*>(dbproj), wk + L.cs, s);
}

// K5 fp32's attention backward alone (`ops/block_attention.attn_bwd_f32`),
// step 2 of the entry above over K5's workspace (`stswin_block_attention_
// bwd_f32_work` floats: the statistics and the dbias partials): qkv (rows,
// 3C) and dO (rows, C) fp32 in window order, bias (heads, TN, TN), mask
// (n_mask, TN, TN) or n_mask <= 1 for none. Outputs, fp32 and overwritten:
// dqkv (rows, 3C), dq and dk scaled; dbias (heads, TN, TN).
extern "C" int stswin_attn_bwd_f32(const void* qkv, const void* dO,
                                   const void* bias, const void* mask,
                                   void* work, void* dqkv, void* dbias, int R,
                                   int C, int heads, int TN, float scale,
                                   int n_mask, void* stream) {
  if (heads <= 0 || C % heads || TN <= 0 || R % TN)
    return cudaErrorInvalidValue;
  const int hd = C / heads;
  if (!attn_bwd_f32_takes(TN, hd)) return cudaErrorInvalidValue;
  const K5Work L = k5_work(R, C, heads, TN);
  float* wk = static_cast<float*>(work);
  return attn_bwd_f32(static_cast<const float*>(qkv),
                      static_cast<const float*>(dO),
                      static_cast<const float*>(bias),
                      static_cast<const float*>(mask), n_mask,
                      static_cast<float*>(dqkv), wk + L.stats,
                      wk + L.dbias_part, static_cast<float*>(dbias), R / TN,
                      heads, TN, hd, C, scale,
                      static_cast<cudaStream_t>(stream));
}

// K6 fp32. x, g: (rows, C) fp32 unshifted (g: the gradient of `out`); y:
// as the forward took it (shifted layout when shift > 0); m_in: row 8's m,
// or null to recompute it (row 7; with it, row 9). w1 (hidden, C), w2 (C,
// hidden) and their transposes w1_t (C, hidden), w2_t (hidden, C), fp32.
// work: `stswin_block_epilogue_bwd_f32_work` floats. Outputs, fp32 and
// overwritten: dx (rows, C); dy (rows, C) in y's layout, only when shift >
// 0; dw1 (hidden, C), db1, dw2 (C, hidden), dbw2, ds1, db1n, ds2, db2.
extern "C" int stswin_block_epilogue_bwd_f32(
    const void* x, const void* y, const void* g, const void* m_in,
    const void* s2, const void* b2, const void* w1, const void* b1,
    const void* w1_t, const void* w2, const void* bw2, const void* w2_t,
    const void* s1, void* work, void* dx, void* dy, void* dw1, void* db1,
    void* dw2, void* dbw2, void* ds1, void* db1n, void* ds2, void* db2,
    int BT, int H, int W, int C, int hidden, int shift, int act, float eps,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = BT * H * W;
  if (C % 128 || C > 1024 || hidden % 4) return cudaErrorInvalidValue;
  const K6Work L = k6_work(R, C, hidden, !m_in);
  float* wk = static_cast<float*>(work);
  float *s32 = wk + L.s32, *n2 = wk + L.n2, *h = wk + L.h;
  float *dgelu = wk + L.dgelu, *do32 = wk + L.do32, *dn2 = wk + L.dn2;
  float* rows = wk + L.rows;
  const int blocks = row_blocks(R);

  // 1. s = x + unshift(y), n2 = LN2(s)
  cudaError_t err = ln_rows_add_f32(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(s2), static_cast<const float*>(b2), s32, n2,
      R, C, H, W, shift, eps, s);
  if (err != cudaSuccess) return err;

  // 2. h = gelu(n2 @ w1^T + b1) and gelu' (fp32); without m, m = h @ w2^T
  // + bw2
  F32Gemm p = plain_gemm(n2, C, static_cast<const float*>(w1),
                         static_cast<const float*>(b1), R, hidden, C, h,
                         hidden, act);
  p.epi = F32_GELU_GRAD;
  p.C2 = dgelu;
  if ((err = gemm_f32(p, s)) != cudaSuccess) return err;
  const float* m = static_cast<const float*>(m_in);
  if (!m) {
    float* mr = wk + L.m;
    if ((err = gemm_f32(plain_gemm(h, hidden, static_cast<const float*>(w2),
                                   static_cast<const float*>(bw2), R, C,
                                   hidden, mr, C, ACT_NONE),
                        s)) != cudaSuccess)
      return err;
    m = mr;
  }

  // 3. LN1 backward -> do (= dm in fp32); ds1, db1n, dbw2
  if ((err = bwd_rows(C, true, blocks, s, s32, m,
                      static_cast<const float*>(g),
                      static_cast<const float*>(s1), do32, nullptr, nullptr,
                      nullptr, rows, R, H, W, shift, eps)) != cudaSuccess)
    return err;
  float* ln1_out[3] = {static_cast<float*>(ds1), static_cast<float*>(db1n),
                       static_cast<float*>(dbw2)};
  for (int k = 0; k < 3; ++k)
    if ((err = sum_parts(rows + k * C, blocks, 3LL * C, C, ln1_out[k], s)) !=
        cudaSuccess)
      return err;

  // 4. dpre = (do @ w2) * gelu', over gelu'; db1 its column sums
  float* dpre = dgelu;
  p = plain_gemm(do32, C, static_cast<const float*>(w2_t), nullptr, R,
                 hidden, C, dpre, hidden, ACT_NONE);
  p.epi = F32_DGELU;
  p.aux = dgelu;
  if ((err = gemm_f32(p, s)) != cudaSuccess) return err;
  if ((err = colsum_f32(dpre, hidden, R, hidden, static_cast<float*>(db1),
                        wk + L.cs, s)) != cudaSuccess)
    return err;

  // 5. dn2 = dpre @ w1
  if ((err = gemm_f32(plain_gemm(dpre, hidden,
                                 static_cast<const float*>(w1_t), nullptr, R,
                                 C, hidden, dn2, C, ACT_NONE),
                      s)) != cudaSuccess)
    return err;

  // 6. LN2 backward, ds = do + it -> dx (and dy through the shift)
  if ((err = bwd_rows(C, false, blocks, s, s32, nullptr, nullptr,
                      static_cast<const float*>(s2), do32, dn2,
                      static_cast<float*>(dx),
                      shift ? static_cast<float*>(dy) : nullptr, rows, R, H,
                      W, shift, eps)) != cudaSuccess)
    return err;
  float* ln2_out[2] = {static_cast<float*>(ds2), static_cast<float*>(db2)};
  for (int k = 0; k < 2; ++k)
    if ((err = sum_parts(rows + k * C, blocks, 2LL * C, C, ln2_out[k], s)) !=
        cudaSuccess)
      return err;

  // 7. dw1 = dpre^T n2 (hidden, C), dw2 = do^T h (C, hidden)
  if ((err = wgrad_f32(plain_wgrad(dpre, hidden, n2, C, R, hidden, C),
                       static_cast<float*>(dw1), wk + L.wpart, s)) !=
      cudaSuccess)
    return err;
  return wgrad_f32(plain_wgrad(do32, C, h, hidden, R, C, hidden),
                   static_cast<float*>(dw2), wk + L.wpart, s);
}

// The fp32 weight-gradient GEMM alone (`ops/gemm.wgrad_f32`): out (M, N) =
// sum_r A[a_map(r)]^T B[b_map(r)], A rows of lda, B rows of ldb; work:
// `stswin_wgrad_f32_work` floats (or null when that is 0).
extern "C" int stswin_wgrad_f32(const void* A, const void* B, void* out,
                                void* work, int R, int M, int N, int lda,
                                int ldb, int a_mode, int b_mode, int T, int H,
                                int W, int ws, int a_shift, int b_shift,
                                void* stream) {
  F32Wgrad w = plain_wgrad(static_cast<const float*>(A), lda,
                           static_cast<const float*>(B), ldb, R, M, N);
  if (a_mode) w.a_map = RowMap{1, T, H, W, ws, a_shift};
  if (b_mode) w.b_map = RowMap{1, T, H, W, ws, b_shift};
  return wgrad_f32(w, static_cast<float*>(out), static_cast<float*>(work),
                   static_cast<cudaStream_t>(stream));
}

// The fixed-order column sums alone: out (N) = sum_r X[r, :N], rows of ld;
// work: `stswin_colsum_f32_work` floats.
extern "C" int stswin_colsum_f32(const void* X, void* out, void* work, int R,
                                 int N, int ld, void* stream) {
  return colsum_f32(static_cast<const float*>(X), ld, R, N,
                    static_cast<float*>(out), static_cast<float*>(work),
                    static_cast<cudaStream_t>(stream));
}

// Queries, not launches: the fp32 scratch each entry above needs, in
// floats, and the shared memory of the attention backward.
extern "C" int stswin_block_attention_bwd_f32_work(int R, int C, int heads,
                                                   int TN, long long* out) {
  *out = static_cast<long long>(k5_work(R, C, heads, TN).total);
  return 0;
}

extern "C" int stswin_block_epilogue_bwd_f32_work(int R, int C, int hidden,
                                                  int recompute,
                                                  long long* out) {
  *out = static_cast<long long>(k6_work(R, C, hidden, recompute).total);
  return 0;
}

extern "C" int stswin_wgrad_f32_work(int R, int M, int N, long long* out) {
  *out = static_cast<long long>(wgrad_work(R, M, N));
  return 0;
}

extern "C" int stswin_colsum_f32_work(int R, int N, long long* out) {
  *out = static_cast<long long>(size_t(cs_splits(R)) * N);
  return 0;
}

extern "C" int stswin_attn_bwd_f32_smem(int TN, int hd, long long* out) {
  *out = attn_bwd_f32_takes(TN, hd)
             ? static_cast<long long>(attn32b::smem_bytes(TN, hd))
             : -1;
  return 0;
}
