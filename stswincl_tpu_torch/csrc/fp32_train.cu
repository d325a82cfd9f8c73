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
// Bound on the H100: the products. Every product runs on the tensor cores
// as a 3xTF32 split (fp32-accurate at a third of the TF32 rate, 164.9
// TFLOP/s; one TF32 pass is not fp32): the fp32 GEMM (`gemm_f32`) and the
// weight gradients (`wgrad_f32`) on the wgmma k tile of fp32_gemm.cuh, K5's
// attention backward (fp32_attention_bwd.cuh) on mma.sync (tf32x3.cuh). K5
// at stage 1 (794 GFLOP: 344 weight gradients, 344 GEMM, 106 attention) at
// least 5.8 ms, K6 with m recomputed (2,062 GFLOP, all products) 12.5 ms,
// K6 with m saved at stage 2 (1,718 GFLOP) 10.4 ms; K6's two weight
// gradients (687 GFLOP) 4.17 ms.
//
// Every reduction is deterministic: no float atomics anywhere. A sum that
// spans blocks is written as one partial a block (or a split of the rows,
// or a row tile) into scratch and summed by a second launch in a fixed
// order (`sum_parts`), so two calls on the same inputs give the same bits.
//
// Design:
//   - `wgrad_f32`: out = sum_r A[a_map(r)]^T B[b_map(r)], the weight
//     gradients, on the fp32 GEMM's wgmma tile with K = r: 128 x 128
//     output tiles, 32-row k tiles, each k tile's 12 wgmma m64n128k8
//     (a_lo b_hi, a_hi b_lo, a_hi b_hi, `split_rn` on both halves) summed
//     from 0 and added to fp32 sums rounded to nearest (`ktile_frags`).
//     Both operands arrive r-major (M- and N-major), and a tf32 wgmma reads
//     its shared-memory operand K-major only. Of the two ways round it,
//     this takes A from registers and transposes B in the producer: A's
//     raw k tile lands by cp.async at a row pitch of 8 mod 32 words, and
//     each consumer thread reads its fragments (any layout will do for
//     registers, conflict-free here) and splits them, as the GEMM's
//     consumers split theirs; B lands raw in its lo slot, and the producer
//     warpgroup, a thread a column, writes it K-major and swizzled as hi,
//     then (after the producers' barrier) as lo. The other way, having
//     the LN2 pass and fc1's epilogue write n2 and h r-minor, would leave
//     do and dpre, and K5's x, dqkv, g and attn, r-major all the same, and
//     the GEMMs that read n2 and h as A would read them strided. A k tile
//     moves about the GEMM's 192 KiB through shared memory. One
//     persistent launch, one block an SM (197 KiB), two consumer
//     warpgroups and a producer warpgroup that loads through the row maps
//     (16 rows a warp a k tile, lanes 0-15 mapping one each: K5's x through
//     the shifted window partition, g through the window partition),
//     walks a queue of up to two weight gradients over the same rows (K5's
//     dwqkv and dwproj, K6's dw1 and dw2: one launch each), their output
//     tiles times `wgrad_splits(R, tiles)` ranges of R, the count that
//     fills the card's waves best (K6 at stage 1 none, 128 tiles; 17 at
//     stage 2; K5 2 / 17), each split's partial summed in order by
//     `sum_parts`. On an H100 at 700 W (`tools/profile_k6_f32.py`) K6's
//     dw1 and dw2 at stage 1 take 8.38-8.52 ms a call, 0.49-0.50 of their
//     bound, where the mma.sync tile they replace took 11.26-11.60 in two
//     launches.
//   - `colsum_f32`: K5's bias gradients, the column sums of a row matrix:
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
//     dwqkv and dwproj in one `wgrad_f32` launch, dbqkv and dbproj on
//     `colsum_f32`.
//   - K6 (`stswin_block_epilogue_bwd_f32`), bf16 K6's seven steps in fp32:
//     s = x + unshift(y) and LN2(s); fc1 writing h and gelu' (F32_GELU_GRAD)
//     and, without a saved m, m = h @ w2^T + bw2; the LN1 backward row pass
//     (do, with the column sums ds1, db1n, dbw2); dpre = (do @ w2) * gelu'
//     (F32_DGELU, in place over gelu'), its epilogue also summing each
//     128-row tile's columns into db1's partials (`sum_parts` adds the
//     R / 128 of them in order; the `colsum_f32` pass over R x hidden it
//     replaces took 0.48 ms at stage 1, the epilogue's sums add 0.17-0.27
//     ms to dpre's 4.7); dn2 = dpre @ w1; the LN2 backward row pass (dx
//     unshifted, dy through the shift, the sums ds2 and db2); dw1 and dw2
//     in one `wgrad_f32` launch. gelu' goes through device memory for both
//     rows (1.34 GB written and read at stage 1, about 0.4 ms each way):
//     fusing it into dpre's epilogue would store the pre-activation in its
//     place, as many bytes, so it stays; fc1 (6.1-6.3 ms) and dpre (4.9-5.0)
//     sit at 2.4-3x their 2.08 ms product bound, the wgmma tile's K = 512
//     regime, not their bytes. In fp32 dm is do itself. The row passes run
//     a fixed grid of at most 1,024 blocks, a warp a row up to C 1024 (a
//     block a row past it, ln_bwd_wide.cuh; any C % 4); each block sums
//     its rows' terms in registers, then its 8 warps in order, into its
//     partial.

#include <atomic>

#include "fp32_attention_bwd.cuh"
#include "fp32_gemm.cuh"
#include "ln_bwd_wide.cuh"

namespace {

std::atomic<long long> wgrad_count{0};

// ---- fixed-order reductions ----------------------------------------------

constexpr int WSPLIT_ROWS = 2048, WSPLIT_MAX = 32;
constexpr int WAVE = 132;  // weight-gradient blocks the H100 holds at once
constexpr int CS_ROWS = 1024;
constexpr int RW = 8;             // warps a row-pass block
constexpr int ROW_BLOCKS = 1024;  // the row passes' grid, at most

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

// One weight gradient: out (M, N) = sum_r A[a_map(r)]^T B[b_map(r)], A
// rows of lda, B rows of ldb.
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

// `map_row` with its five divisions by multiply-high: the loader maps 16
// rows a warp and k tile, and the divisions of the plain form cost as
// many issue slots as the rest of the producer's k tile.
struct FastMap {
  int mode, T, H, W, ws, shift, TN, N, nWin, nWw;
  FastDiv by_TN, by_N, by_ws, by_nWin, by_nWw;
  FastMap() : FastMap(identity_map()) {}
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

using f32t::BK;
using f32t::BM;
using f32t::BN;
using f32t::NACC;
using f32t::STAGES;
using f32t::TILE;

// A launch's weight gradients: at most two, over the same R rows (K5's
// dwqkv and dwproj, K6's dw1 and dw2), their 128 x 128 output tiles times
// the splits of R in one queue.
constexpr int WG_MAX = 2;
// A stage: A's k tile raw, [32 r][128 m] at a row pitch of 8 mod 32 words
// (the fragment reads t * 136 + g are conflict-free), then B's k tile as
// hi and lo, K-major [128 n][32 r], 128-byte swizzled (1024-aligned: the
// A slot is 17 KiB); B arrives raw, [32 r][128 n], in the lo slot.
constexpr int APITCH = BM + 8;
constexpr int A_SLOT = BK * APITCH;  // floats
constexpr int WSTAGE = A_SLOT + 2 * TILE;
constexpr int W_THREADS = 384;
constexpr int W_SMEM = 1024 + STAGES * WSTAGE * 4 + 3 * STAGES * 8;
static_assert(A_SLOT * 4 % 1024 == 0, "B hi and lo 1024-byte aligned");

struct WgradRun {
  F32Wgrad p[WG_MAX];
  FastMap am[WG_MAX], bm[WG_MAX];
  float* dst[WG_MAX];  // out, or the splits' partials [split][M][N]
  int tiles[WG_MAX], tiles_n[WG_MAX];
  int items0, items;  // problem 0's queue entries, all of them
  int splits, chunk;  // chunk: rows a split, a multiple of BK
};

// Queue entry q: problem 0's (split, m tile, n tile) split-major, then
// problem 1's; rows [r0, r1) of the split.
struct WItem {
  int p, split, m0, n0, r0, r1, kts;
};

__device__ __forceinline__ WItem witem(const WgradRun& w, int q) {
  WItem it;
  it.p = q >= w.items0;
  const int i = it.p ? q - w.items0 : q;
  const int tiles = w.tiles[it.p], tn = w.tiles_n[it.p];
  it.split = i / tiles;
  const int t = i - it.split * tiles;
  it.m0 = (t / tn) * BM;
  it.n0 = (t % tn) * BN;
  it.r0 = it.split * w.chunk;
  it.r1 = min(it.r0 + w.chunk, w.p[it.p].R);
  it.kts = (it.r1 - it.r0 + BK - 1) / BK;
  return it;
}

// A block's walk over its (queue entry, k tile) pairs: entries
// blockIdx.x, + gridDim.x, ...; k tile j of the walk in stage j % STAGES.
// Four registers: the consumers' 168 hold their sums, partials and A
// fragments besides (an entry carried along spilled).
struct WWalk {
  int q, kt, j, kts;
};

__device__ __forceinline__ void wstep(WWalk& w, const WgradRun& r) {
  if (++w.kt == w.kts) {
    w.kt = 0;
    w.q += gridDim.x;
    if (w.q < r.items) w.kts = witem(r, w.q).kts;
  }
  ++w.j;
}

__device__ __forceinline__ WWalk wstart(const WgradRun& r) {
  WWalk w{static_cast<int>(blockIdx.x), 0, 0, 0};
  if (w.q < r.items) w.kts = witem(r, w.q).kts;
  return w;
}

// dst[p][split][m][n] (rows of N) = the sum over the split's rows, k tile
// by k tile in ascending r, of A[a_map(r)][m] B[b_map(r)][n]: the fp32
// GEMM's tile (fp32_forms.cu) with K = r. Two consumer warpgroups, each on
// a 64-row half of the 128 x 128 output tile, wait for a stage, split A's
// fragments from the raw r-major tile in registers (a thread reads any
// layout) and run the k tile's 12 wgmma (`f32t::ktile_frags`); the
// producer warpgroup loads A and B by cp.async through their row maps
// (K5's window partition and shift), 16 rows a warp, lanes 0-15 mapping
// one each, then turns B's raw k tile into the K-major hi and lo a tf32
// wgmma reads from shared memory: thread n reads column n (conflict-free),
// writes its hi row, and after the producers' barrier (the raw tile lies
// under lo) its lo row (`split_rn`, 16-byte stores, the swizzle keeping
// them conflict-free).
__global__ void __launch_bounds__(W_THREADS, 1)
    wgrad_f32_kernel(const __grid_constant__ WgradRun r) {
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * WSTAGE);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 128);  // each producer thread's cp.async
      sm90::mbar_init(&ready[s], 128);
      sm90::mbar_init(&empty[s], 8);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the producer warpgroup ----
    // 80 registers a thread, so that each consumer may hold 208: at 168
    // all round a consumer spilled (144 bytes) and K6's dw1 and dw2 took
    // 8.95-9.08 ms at stage 1 on an H100 at 700 W, at 80 / 208 8.31-8.49
    // (72 / 216: 8.78-8.95). 128 x 88 registers freed cover 256 x 40 more.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    const int pt = threadIdx.x - 256, pw = pt >> 5;
    // k tile j's rows r0 + 32 kt + pw + 4 i (i < 8), A's and B's each
    // mapped by one of lanes 0-15, then a row an instruction, lane l its
    // 16 bytes at column 4 l
    WItem lit{};  // the entry of the next k tile to load
    auto load = [&](const WWalk& w) {
      const int s = w.j % STAGES;
      float* as = ring + s * WSTAGE;
      float* braw = as + A_SLOT + TILE;
      if (w.kt == 0) lit = witem(r, w.q);
      const WItem& it = lit;
      const F32Wgrad& P = r.p[it.p];
      const int rr = it.r0 + w.kt * BK + pw + 4 * (lane & 7);
      long long mine = -1;
      if (lane < 16 && rr < it.r1)
        mine = lane < 8 ? r.am[it.p](rr) : r.bm[it.p](rr);
      const int ca = it.m0 + 4 * lane, cb = it.n0 + 4 * lane;
      const bool a_col = ca < P.M, b_col = cb < P.N;
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {  // 8 rows a warp, 4 warps
        const long long ra = __shfl_sync(0xffffffffu, mine, i);
        const long long rb = __shfl_sync(0xffffffffu, mine, 8 + i);
        const bool rin = ra >= 0;
        const int row = pw + 4 * i;
        cp_async16(as + row * APITCH + 4 * lane,
                   P.A + (rin ? ra : 0) * P.lda + (a_col ? ca : 0),
                   rin && a_col);
        cp_async16(braw + row * BN + 4 * lane,
                   P.B + (rin ? rb : 0) * P.ldb + (b_col ? cb : 0),
                   rin && b_col);
      }
      sm90::cp_async_arrive(&full[s]);
    };
    WWalk lw = wstart(r);  // the next k tile to load
    for (int p = 0; p < STAGES - 1 && lw.q < r.items; ++p) {
      load(lw);
      wstep(lw, r);
    }
    for (WWalk sw = wstart(r); sw.q < r.items; wstep(sw, r)) {
      const int s = sw.j % STAGES;
      sm90::mbar_wait(&full[s], (sw.j / STAGES) & 1);
      float* bhi = ring + s * WSTAGE + A_SLOT;
      float* blo = bhi + TILE;
      float x[BK];
#pragma unroll
      for (int k = 0; k < BK; ++k) x[k] = blo[k * BN + pt];
      const int sw8 = pt & 7;
      float4* hrow = reinterpret_cast<float4*>(bhi + pt * BK);
      float4* lrow = reinterpret_cast<float4*>(blo + pt * BK);
#pragma unroll
      for (int u = 0; u < BK / 4; ++u) {
        uint32_t h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = f32t::tf32_rn(x[4 * u + e]);
        hrow[u ^ sw8] =
            make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
      }
      asm volatile("bar.sync 2, 128;\n" ::: "memory");  // the raw tile read
#pragma unroll
      for (int u = 0; u < BK / 4; ++u) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) f32t::split_rn(x[4 * u + e], h[e], l[e]);
        lrow[u ^ sw8] =
            make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      sm90::mbar_arrive(&ready[s]);
      if (lw.q < r.items) {  // into k tile j - 1's stage, once it is free
        if (lw.j >= STAGES)
          sm90::mbar_wait(&empty[lw.j % STAGES], (lw.j / STAGES - 1) & 1);
        load(lw);
        wstep(lw, r);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: wait, split A, 12 wgmma, add, free ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
  const int wg = warp >> 2;
  float sum[NACC], d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) sum[i] = d[i] = 0.0f;
  WWalk cw = wstart(r);
  while (cw.q < r.items) {
    const int s = cw.j % STAGES;
    sm90::mbar_wait(&ready[s], (cw.j / STAGES) & 1);
    const float* as = ring + s * WSTAGE;
    // A (m, k) at as[k * APITCH + m]: the warp's rows wg * 64 + 16 (warp %
    // 4) + g (+ 8), k = 8 kk + t (+ 4)
    const float* a0 =
        as + (lane & 3) * APITCH + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* a = a0 + 8 * kk * APITCH;
      f32t::split_rn(a[0], hi[kk][0], lo[kk][0]);
      f32t::split_rn(a[8], hi[kk][1], lo[kk][1]);
      f32t::split_rn(a[4 * APITCH], hi[kk][2], lo[kk][2]);
      f32t::split_rn(a[4 * APITCH + 8], hi[kk][3], lo[kk][3]);
    }
    const uint32_t sb = smem_u32(as + A_SLOT);
    f32t::ktile_frags(sum, d, hi, lo, sb, sb + TILE * 4);
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    const int q = cw.q;
    wstep(cw, r);
    if (cw.kt != 0) continue;
    // the entry's last k tile: store its sums while the producers load the
    // next entry's
    const WItem it = witem(r, q);
    const F32Wgrad& P = r.p[it.p];
    float* out = r.dst[it.p] + (long long)it.split * P.M * P.N;
    const int mbase = it.m0 + wg * 64;
    f32t::rows8(
        sum, it.n0, [](int, float v) { return v; },
        [&](int row, int n, const float(&o)[8]) {
          const int m = mbase + row;
          if (m >= P.M) return;
          float* c = out + (long long)m * P.N + n;
          if (n + 8 <= P.N) {
            f32t::store8(c, o);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (n + e < P.N) c[e] = o[e];
          }
        });
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] = 0.0f;
  }
}

// The ranges R is split in for a launch of `tiles` 128 x 128 output
// tiles: of 1 .. min(32, R / 2048), the count whose blocks (tiles times
// splits, one an SM) fill their waves of WAVE best, the fewest on a tie.
// It depends on the shapes alone, so every card sums in the same order.
inline int wgrad_splits(int R, long long tiles) {
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

inline long long wgrad_tiles(int M, int N) {
  return (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// The partials' floats of a launch of the weight gradients (M0, N0) and,
// where M1 > 0, (M1, N1) over R rows; 0 when R is not split.
size_t wgrad_work(int R, int M0, int N0, int M1 = 0, int N1 = 0) {
  const bool two = M1 > 0;
  const int splits =
      wgrad_splits(R, wgrad_tiles(M0, N0) + (two ? wgrad_tiles(M1, N1) : 0));
  return splits > 1
             ? size_t(splits) * (size_t(M0) * N0 + (two ? size_t(M1) * N1 : 0))
             : 0;
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// outs[i] (M, N) = sum_r A[a_map(r)]^T B[b_map(r)] for the n (1 or 2)
// weight gradients ps over the same R rows, in one launch; part:
// `wgrad_work` floats (or null when that is 0).
cudaError_t wgrad_f32(const F32Wgrad* ps, int n, float* const* outs,
                      float* part, cudaStream_t s) {
  if (n < 1 || n > WG_MAX) return cudaErrorInvalidValue;
  const int R = ps[0].R;
  WgradRun r{};
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    const F32Wgrad& p = ps[i];
    if (p.R != R || R < 0 || p.M <= 0 || p.N <= 0 || p.M % 4 || p.N % 4 ||
        p.lda % 4 || p.ldb % 4 || !aligned16(p.A) || !aligned16(p.B) ||
        !aligned16(outs[i]))
      return cudaErrorInvalidValue;
    r.p[i] = p;
    r.am[i] = FastMap(p.a_map);
    r.bm[i] = FastMap(p.b_map);
    r.tiles[i] = static_cast<int>(wgrad_tiles(p.M, p.N));
    r.tiles_n[i] = (p.N + BN - 1) / BN;
    tiles += r.tiles[i];
  }
  if (R == 0) {  // no rows: the sums are 0
    for (int i = 0; i < n; ++i) {
      const cudaError_t err = cudaMemsetAsync(
          outs[i], 0, size_t(ps[i].M) * ps[i].N * sizeof(float), s);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  r.splits = wgrad_splits(R, tiles);
  if (r.splits > 1 && !part) return cudaErrorInvalidValue;
  r.chunk = ((R + r.splits - 1) / r.splits + BK - 1) / BK * BK;
  size_t off = 0;
  for (int i = 0; i < n; ++i) {
    r.dst[i] = r.splits > 1 ? part + off : outs[i];
    off += size_t(r.splits) * ps[i].M * ps[i].N;
  }
  r.items0 = r.tiles[0] * r.splits;
  r.items = static_cast<int>(tiles * r.splits);
  static bool allowed[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        W_SMEM);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const int sms = sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  wgrad_f32_kernel<<<r.items < sms ? r.items : sms, W_THREADS, W_SMEM, s>>>(
      r);
  wgrad_count.fetch_add(1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || r.splits == 1) return err;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    const long long mn = (long long)ps[i].M * ps[i].N;
    err = sum_parts(r.dst[i], r.splits, mn, mn, outs[i], s);
  }
  return err;
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

template <int NT, bool TAIL>
cudaError_t launch_q_pass(const float* qkv, const float* dO,
                          const float* bias, const float* mask, int n_mask,
                          float* dqkv, float* stats, float* dbias_part,
                          int n_windows, int heads, int TN, int hd, int C,
                          float scale, cudaStream_t s, int* per_head) {
  static int optin[MAX_DEVICES] = {};
  const size_t bytes = attn32b::q_smem(TN, hd);
  cudaError_t err = opt_in(attn32b::q_kernel<NT, TAIL>, optin, bytes);
  if (err != cudaSuccess) return err;
  int per_block;
  attn32b::q_split(n_windows, heads, TN, hd, per_head, &per_block);
  attn32b::q_kernel<NT, TAIL>
      <<<dim3(*per_head, heads), TN / 16 * 32, bytes, s>>>(
      qkv, dO, bias, mask, n_mask, dqkv, stats, dbias_part, n_windows,
      per_block, heads, TN, hd, C, scale);
  return cudaGetLastError();
}

template <int CT, bool TAIL>
cudaError_t launch_kv_pass(const float* qkv, const float* dO,
                           const float* bias, const float* mask, int n_mask,
                           const float* stats, float* dqkv, int n_windows,
                           int heads, int TN, int hd, int C, float scale,
                           cudaStream_t s) {
  static int optin[MAX_DEVICES] = {};
  const size_t bytes = attn32b::kv_smem(TN, hd);
  cudaError_t err = opt_in(attn32b::kv_kernel<CT, TAIL>, optin, bytes);
  if (err != cudaSuccess) return err;
  attn32b::kv_kernel<CT, TAIL>
      <<<n_windows * heads, TN / 16 * attn32b::col_splits(hd) * 32, bytes,
         s>>>(qkv, dO, bias, mask, n_mask, stats, dqkv, heads, TN, hd, C,
              scale);
  return cudaGetLastError();
}

// The windows the attention backward takes (`ops/block_attention.
// check_backward_window` refuses the rest before K1 runs): exactly those
// of K1's fp32 core, and so of K1's bf16 one (`attn32::takes`): the
// resident passes where they fit (`attn32b::resident`), the streamed ones
// elsewhere.
bool attn_bwd_f32_takes(int TN, int hd) { return attn32::takes(TN, hd); }

// launches of the streamed passes since the last reset (a query pass and
// a key pass each; `stswin_attn_bwd_f32_streamed_launches`)
std::atomic<long long> attn_bwd_streamed_launches{0};

template <int NT>
cudaError_t launch_qs_pass(const float* qkv, const float* dO,
                           const float* bias, const float* mask, int n_mask,
                           float* dqkv, float* pds, float* dbias_part,
                           int n_windows, int heads, int TN, int hd, int C,
                           float scale, cudaStream_t s, int* per_head) {
  static int optin[MAX_DEVICES] = {};
  const size_t bytes = attn32b::qs_smem(TN);
  cudaError_t err = opt_in(attn32b::qs_kernel<NT>, optin, bytes);
  if (err != cudaSuccess) return err;
  int per_block;
  attn32b::q_split(n_windows, heads, TN, hd, per_head, &per_block);
  const long long pairs = (long long)n_windows * heads;
  attn32b::qs_kernel<NT><<<dim3(*per_head, heads), TN / 16 * 32, bytes, s>>>(
      qkv, dO, bias, mask, n_mask, dqkv, pds, pds + pairs * TN * TN,
      dbias_part, n_windows, per_block, heads, TN, hd, C, scale);
  return cudaGetLastError();
}

cudaError_t launch_kvs_pass(const float* qkv, const float* dO,
                            const float* pds, float* dqkv, int n_windows,
                            int heads, int TN, int hd, int C, float scale,
                            cudaStream_t s) {
  static int optin[MAX_DEVICES] = {};
  const size_t bytes = attn32b::kvs_smem(TN);
  cudaError_t err = opt_in(attn32b::kvs_kernel, optin, bytes);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)n_windows * heads;
  const long long blocks = pairs * ((hd + attn32b::KC - 1) / attn32b::KC);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn32b::kvs_kernel<<<static_cast<unsigned>(blocks), TN / 16 * 32, bytes,
                        s>>>(qkv, dO, pds, pds + pairs * TN * TN, dqkv,
                             heads, TN, hd, C, scale);
  return cudaGetLastError();
}

// The streamed passes: the query pass (P and dS into pds, the dbias
// partials), the partials summed in order, the key pass.
cudaError_t attn_bwd_f32_streamed(const float* qkv, const float* dO,
                                  const float* bias, const float* m,
                                  int n_mask, float* dqkv, float* pds,
                                  float* dbias_part, float* dbias,
                                  int n_windows, int heads, int TN, int hd,
                                  int C, float scale, cudaStream_t s) {
  int per_head = 0;
  cudaError_t err;
  switch (attn32::score_tiles(TN)) {
    case 4:
      err = launch_qs_pass<4>(qkv, dO, bias, m, n_mask, dqkv, pds,
                              dbias_part, n_windows, heads, TN, hd, C, scale,
                              s, &per_head);
      break;
    case 8:
      err = launch_qs_pass<8>(qkv, dO, bias, m, n_mask, dqkv, pds,
                              dbias_part, n_windows, heads, TN, hd, C, scale,
                              s, &per_head);
      break;
    case 16:
      err = launch_qs_pass<16>(qkv, dO, bias, m, n_mask, dqkv, pds,
                               dbias_part, n_windows, heads, TN, hd, C, scale,
                               s, &per_head);
      break;
    default:
      err = launch_qs_pass<22>(qkv, dO, bias, m, n_mask, dqkv, pds,
                               dbias_part, n_windows, heads, TN, hd, C, scale,
                               s, &per_head);
  }
  if (err != cudaSuccess) return err;
  const long long table = (long long)heads * TN * TN;
  if ((err = sum_parts(dbias_part, per_head, table, table, dbias, s)) !=
      cudaSuccess)
    return err;
  err = launch_kvs_pass(qkv, dO, pds, dqkv, n_windows, heads, TN, hd, C,
                        scale, s);
  if (err == cudaSuccess) ++attn_bwd_streamed_launches;
  return err;
}

template <bool TAIL>
cudaError_t attn_bwd_f32_passes(const float* qkv, const float* dO,
                                const float* bias, const float* m,
                                int n_mask, float* dqkv, float* stats,
                                float* dbias_part, float* dbias,
                                int n_windows, int heads, int TN, int hd,
                                int C, float scale, cudaStream_t s) {
  int per_head = 0;
  cudaError_t err;
  if (TN <= 32)
    err = launch_q_pass<4, TAIL>(qkv, dO, bias, m, n_mask, dqkv, stats,
                                 dbias_part, n_windows, heads, TN, hd, C,
                                 scale, s, &per_head);
  else if (TN <= 64)
    err = launch_q_pass<8, TAIL>(qkv, dO, bias, m, n_mask, dqkv, stats,
                                 dbias_part, n_windows, heads, TN, hd, C,
                                 scale, s, &per_head);
  else
    err = launch_q_pass<16, TAIL>(qkv, dO, bias, m, n_mask, dqkv, stats,
                                  dbias_part, n_windows, heads, TN, hd, C,
                                  scale, s, &per_head);
  if (err != cudaSuccess) return err;
  const long long table = (long long)heads * TN * TN;
  if ((err = sum_parts(dbias_part, per_head, table, table, dbias, s)) !=
      cudaSuccess)
    return err;
  if (hd <= 32)
    return launch_kv_pass<4, TAIL>(qkv, dO, bias, m, n_mask, stats, dqkv,
                                   n_windows, heads, TN, hd, C, scale, s);
  if (hd <= 64)
    return launch_kv_pass<8, TAIL>(qkv, dO, bias, m, n_mask, stats, dqkv,
                                   n_windows, heads, TN, hd, C, scale, s);
  return launch_kv_pass<16, TAIL>(qkv, dO, bias, m, n_mask, stats, dqkv,
                                  n_windows, heads, TN, hd, C, scale, s);
}

// dq, dk, dv into dqkv and dbias: the query pass, the dbias partials
// summed in order, the key pass; head dims off 32 in their TAIL
// instances; the streamed passes where the resident ones do not fit.
// stats: (windows, heads, TN, 4) floats (the resident passes); pds: 2 x
// windows x heads x TN x TN floats, P then dS (the streamed ones);
// dbias_part: per_head (`attn32b::q_split`) x heads x TN x TN floats.
cudaError_t attn_bwd_f32(const float* qkv, const float* dO, const float* bias,
                         const float* mask, int n_mask, float* dqkv,
                         float* stats, float* pds, float* dbias_part,
                         float* dbias, int n_windows, int heads, int TN,
                         int hd, int C, float scale, cudaStream_t s) {
  if (!attn_bwd_f32_takes(TN, hd) || n_windows <= 0)
    return cudaErrorInvalidValue;
  const float* m = n_mask > 1 ? mask : nullptr;
  if (!attn32b::resident(TN, hd))
    return attn_bwd_f32_streamed(qkv, dO, bias, m, n_mask, dqkv, pds,
                                 dbias_part, dbias, n_windows, heads, TN, hd,
                                 C, scale, s);
  return hd % 32
             ? attn_bwd_f32_passes<true>(qkv, dO, bias, m, n_mask, dqkv,
                                         stats, dbias_part, dbias, n_windows,
                                         heads, TN, hd, C, scale, s)
             : attn_bwd_f32_passes<false>(qkv, dO, bias, m, n_mask, dqkv,
                                          stats, dbias_part, dbias,
                                          n_windows, heads, TN, hd, C, scale,
                                          s);
}

struct K5Work {
  size_t dattn, dqkv, stats, pds, dbias_part, cs, wpart, total;
};

K5Work k5_work(int R, int C, int heads, int TN) {
  K5Work w{};
  const int n_windows = TN > 0 ? R / TN : 0;
  int per_head = 1, per_block = 1;
  bool streamed = false;
  if (n_windows > 0 && TN > 0 && heads > 0 && C % heads == 0) {
    attn32b::q_split(n_windows, heads, TN, C / heads, &per_head, &per_block);
    streamed = !attn32b::resident(TN, C / heads);
  }
  const size_t cs = size_t(cs_splits(R)) * 3 * C;
  const size_t wp = wgrad_work(R, 3 * C, C, C, C);  // dwqkv and dwproj
  w.dattn = 0;
  w.dqkv = w.dattn + size_t(R) * C;
  w.stats = w.dqkv + size_t(R) * 3 * C;
  w.pds = w.stats + size_t(R) * heads * 4;
  // P and dS of every (window, head), where the streamed passes run
  w.dbias_part =
      w.pds + (streamed ? size_t(2) * n_windows * heads * TN * TN : 0);
  w.cs = w.dbias_part + size_t(per_head) * heads * TN * TN;
  w.wpart = w.cs + cs;
  w.total = w.wpart + wp;
  return w;
}

// ---- K6's row passes ------------------------------------------------------

// Whether the lane's float4 i (columns lane * 4 + 128 i ..) lies in the
// row: of a C off 128 the last (C % 128) / 4 lanes' last one idles.
__device__ __forceinline__ bool live4(int i, int lane, int C) {
  return lane * 4 + 128 * i < C;
}

// two-pass LayerNorm statistics of a row held as ceil(C / 128) float4 a
// lane (NV the most)
template <int NV>
__device__ __forceinline__ void row_stats(const float4 (&v)[NV], float& mu,
                                          float& rs, float eps, int C,
                                          int lane) {
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (live4(i, lane, C)) sum += v[i].x + v[i].y + v[i].z + v[i].w;
  mu = warp_sum(sum) / C;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (live4(i, lane, C)) {
      const float d0 = v[i].x - mu, d1 = v[i].y - mu, d2 = v[i].z - mu,
                  d3 = v[i].w - mu;
      sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
    }
  }
  rs = rsqrtf(warp_sum(sq) / C + eps);
}

// dx of y = xhat * scale + bias given dy (`_ln_bwd_f32`): gv holds dy on
// entry and dx on return; xh holds xhat.
template <int NV>
__device__ __forceinline__ void ln_bwd_row(float4 (&gv)[NV],
                                           const float4 (&xh)[NV],
                                           const float* __restrict__ scale,
                                           float rs, int lane, int C) {
  float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (!live4(i, lane, C)) continue;
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
                                           int lane, int C) {
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (live4(i, lane, C))
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
                       int R, int C, float eps) {
  __shared__ __align__(16) float red[RW * 128 * NV];
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
      o[i] = gv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live4(i, lane, C)) {
        const int c = lane * 4 + 128 * i;
        o[i] = ld4(s32 + base + c);
        add4(o[i], ld4(m + base + c));
        gv[i] = ld4(g + base + c);
      }
    }
    float mu, rs;
    row_stats<NV>(o, mu, rs, eps, C, lane);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      o[i] = make_float4((o[i].x - mu) * rs, (o[i].y - mu) * rs,
                         (o[i].z - mu) * rs, (o[i].w - mu) * rs);
      add4(acc[0][i], mul4(gv[i], o[i]));
      add4(acc[1][i], gv[i]);
    }
    ln_bwd_row<NV>(gv, o, s1, rs, lane, C);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live4(i, lane, C)) {
        *reinterpret_cast<float4*>(do32 + base + lane * 4 + 128 * i) = gv[i];
        add4(acc[2][i], gv[i]);
      }
    }
  }
  flush_rows<NV, 3>(acc, red, part + (long long)blockIdx.x * 3 * C, warp,
                    lane, C);
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
                       int R, int C, int H, int W, int shift, float eps) {
  __shared__ __align__(16) float red[RW * 128 * NV];
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
      xh[i] = gv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live4(i, lane, C)) {
        const int c = lane * 4 + 128 * i;
        xh[i] = ld4(s32 + base + c);
        gv[i] = ld4(dn2 + base + c);
      }
    }
    float mu, rs;
    row_stats<NV>(xh, mu, rs, eps, C, lane);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xh[i] = make_float4((xh[i].x - mu) * rs, (xh[i].y - mu) * rs,
                          (xh[i].z - mu) * rs, (xh[i].w - mu) * rs);
      add4(acc[0][i], mul4(gv[i], xh[i]));
      add4(acc[1][i], gv[i]);
    }
    ln_bwd_row<NV>(gv, xh, s2, rs, lane, C);
    long long ybase = base;
    if (dy) {
      const int w = r % W, h = (r / W) % H, bt = r / (W * H);
      const int hs = h - shift < 0 ? h - shift + H : h - shift;
      const int wsrc = w - shift < 0 ? w - shift + W : w - shift;
      ybase = ((long long)(bt * H + hs) * W + wsrc) * C;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live4(i, lane, C)) {
        const int c = lane * 4 + 128 * i;
        float4 d = ld4(do32 + base + c);
        add4(d, gv[i]);
        *reinterpret_cast<float4*>(dx + base + c) = d;
        if (dy) *reinterpret_cast<float4*>(dy + ybase + c) = d;
      }
    }
  }
  flush_rows<NV, 2>(acc, red, part + (long long)blockIdx.x * 2 * C, warp,
                    lane, C);
}

template <int NV>
cudaError_t launch_rows(bool first, int blocks, cudaStream_t s,
                        const float* s32, const float* m, const float* g,
                        const float* scale, float* do32, const float* dn2,
                        float* dx, float* dy, float* part, int R, int C,
                        int H, int W, int shift, float eps) {
  if (first)
    ln1_bwd_f32_kernel<NV><<<blocks, RW * 32, 0, s>>>(s32, m, g, scale, do32,
                                                      part, R, C, eps);
  else
    ln2_bwd_f32_kernel<NV><<<blocks, RW * 32, 0, s>>>(
        s32, dn2, do32, scale, dx, dy, part, R, C, H, W, shift, eps);
  return cudaGetLastError();
}

// K6 fp32's row pass (LN1's with `first`, else LN2's) at any C % 4: a
// warp a row templated on the next of 128, 256, 512, 1024 channels, else a
// block a row (ln_bwd_wide.cuh); the blocks' sums -> part[block][k][C].
cudaError_t bwd_rows(int C, bool first, int blocks, cudaStream_t s,
                     const float* s32, const float* m, const float* g,
                     const float* scale, float* do32, const float* dn2,
                     float* dx, float* dy, float* part, int R, int H, int W,
                     int shift, float eps) {
  if (C <= 0 || C % 4) return cudaErrorInvalidValue;
  if (C <= 128)
    return launch_rows<1>(first, blocks, s, s32, m, g, scale, do32, dn2, dx,
                          dy, part, R, C, H, W, shift, eps);
  if (C <= 256)
    return launch_rows<2>(first, blocks, s, s32, m, g, scale, do32, dn2, dx,
                          dy, part, R, C, H, W, shift, eps);
  if (C <= 512)
    return launch_rows<4>(first, blocks, s, s32, m, g, scale, do32, dn2, dx,
                          dy, part, R, C, H, W, shift, eps);
  if (C <= 1024)
    return launch_rows<8>(first, blocks, s, s32, m, g, scale, do32, dn2, dx,
                          dy, part, R, C, H, W, shift, eps);
  if (first)
    k6wide::ln1_bwd_kernel<float><<<blocks, k6wide::THREADS, 0, s>>>(
        s32, m, g, scale, static_cast<float*>(nullptr), do32, part, R, C,
        eps);
  else
    k6wide::ln2_bwd_kernel<float><<<blocks, k6wide::THREADS, 0, s>>>(
        s32, dn2, do32, scale, dx, dy, part, R, C, H, W, shift, eps);
  return cudaGetLastError();
}

struct K6Work {
  size_t s32, n2, h, dgelu, m, do32, dn2, rows, cols, wpart, total;
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
  w.cols = w.rows + size_t(row_blocks(R)) * 3 * C;
  w.wpart = w.cols + size_t(f32_col_tiles(R)) * hidden;  // db1's partials
  w.total = w.wpart + wgrad_work(R, hidden, C, C, hidden);
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

cudaError_t sum_parts(const float* part, int parts, long long stride,
                      long long len, float* out, cudaStream_t s) {
  sum_parts_kernel<<<static_cast<unsigned>((len + 255) / 256), 256, 0, s>>>(
      part, parts, stride, len, out);
  return cudaGetLastError();
}

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
                          wk + L.stats, wk + L.pds, wk + L.dbias_part,
                          static_cast<float*>(dbias), M / TN, heads, TN, hd,
                          C, scale, s)) != cudaSuccess)
    return err;

  // 3. dx (unshifted image) = dqkv @ wqkv, scattered through the shift map
  p = plain_gemm(dqkv, 3 * C, static_cast<const float*>(wqkv_t), nullptr, M,
                 C, 3 * C, static_cast<float*>(dx), C, ACT_NONE);
  p.c_map = win_shift;
  if ((err = gemm_f32(p, s)) != cudaSuccess) return err;

  // 4. the weight gradients dwqkv = dqkv^T x (x through the shifted window
  // map) and dwproj = g^T attn (g through the window map) in one launch,
  // then the bias gradients
  F32Wgrad w[2] = {
      plain_wgrad(dqkv, 3 * C, static_cast<const float*>(x), C, M, 3 * C, C),
      plain_wgrad(gp, C, static_cast<const float*>(attn), C, M, C, C)};
  w[0].b_map = win_shift;
  w[1].a_map = win;
  float* const wout[2] = {static_cast<float*>(dwqkv),
                          static_cast<float*>(dwproj)};
  if ((err = wgrad_f32(w, 2, wout, wk + L.wpart, s)) != cudaSuccess)
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
                      wk + L.pds, wk + L.dbias_part,
                      static_cast<float*>(dbias), R / TN,
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
  if (C % 4 || hidden % 4) return cudaErrorInvalidValue;
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

  // 4. dpre = (do @ w2) * gelu', over gelu'; db1 its column sums, each
  // row tile's taken in the epilogue, then the partials in order
  float* dpre = dgelu;
  p = plain_gemm(do32, C, static_cast<const float*>(w2_t), nullptr, R,
                 hidden, C, dpre, hidden, ACT_NONE);
  p.epi = F32_DGELU;
  p.aux = dgelu;
  p.colpart = wk + L.cols;
  if ((err = gemm_f32(p, s)) != cudaSuccess) return err;
  if ((err = sum_parts(p.colpart, f32_col_tiles(R), hidden, hidden,
                       static_cast<float*>(db1), s)) != cudaSuccess)
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

  // 7. dw1 = dpre^T n2 (hidden, C) and dw2 = do^T h (C, hidden), one launch
  const F32Wgrad w[2] = {plain_wgrad(dpre, hidden, n2, C, R, hidden, C),
                         plain_wgrad(do32, C, h, hidden, R, C, hidden)};
  float* const wout[2] = {static_cast<float*>(dw1), static_cast<float*>(dw2)};
  return wgrad_f32(w, 2, wout, wk + L.wpart, s);
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
  float* const outs[1] = {static_cast<float*>(out)};
  return wgrad_f32(&w, 1, outs, static_cast<float*>(work),
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

extern "C" int stswin_attn_bwd_f32_smem(int TN, int hd, long long* out) {
  *out = attn_bwd_f32_takes(TN, hd)
             ? static_cast<long long>(attn32b::smem_bytes(TN, hd))
             : -1;
  return 0;
}

// A query, not a launch: the streamed attention backward's runs (a query
// pass and a key pass each) since the last reset.
extern "C" int stswin_attn_bwd_f32_streamed_launches(int reset,
                                                     long long* out) {
  *out = reset ? attn_bwd_streamed_launches.exchange(0)
               : attn_bwd_streamed_launches.load();
  return 0;
}
