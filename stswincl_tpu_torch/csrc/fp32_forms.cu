// The fp32 forms of K1, K2 and K3, on one fp32 GEMM, and of rows 10 and 11
// on K1's fp32 attention core: what an fp32 model serves and evaluates
// through on the card, and the forward it trains through (the backward
// forms are in fp32_train.cu, row 16's fp32 form in fp32_whole_block.cu).
//
// Replaces the fp32 instances of the dtype-generic TPU kernels, which load
// x.dtype, accumulate in fp32 and store x.dtype
// (`pallas_block_attention.py:229-231`, `:274-275`):
//   K1 stswincl_tpu/ops/pallas_block_attention.py
//        fused_swin_block_attention (:320) -> _full_kernel (:179);
//   K2 stswincl_tpu/ops/pallas_add_ln_mlp.py
//        fused_swin_block_epilogue (:895) -> _epilogue_kernel (:704) and
//        fused_swin_block_epilogue_shifted (:1012) -> _epi_shifted_kernel
//        (:940), the serving form, and with its m output
//        _fused_epilogue_fwd_with_m (:802) -> _epilogue_kernel_with_m
//        (:752), Pallas row 8;
//   K3 stswincl_tpu/ops/pallas_patch_merge.py
//        fused_patch_merge (:122) -> _kernel (:41);
//   row 10 stswincl_tpu/ops/pallas_block_attention.py
//        windowed_attention_image (:128) -> _row_kernel (:44): attention on
//        the image-layout qkv (the 'pallas' route);
//   row 11 stswincl_tpu/ops/pallas_attention.py
//        fused_window_attention (:118) -> _attn_kernel (:38): attention on
//        partitioned (Bw, heads, TN, hd) q, k, v (the 'pallas_windows'
//        route).
// Their bf16 forms (block_attention.cu, epilogue.cu, patch_merge.cu) run
// bf16 operands on the tensor cores; nothing of them is shared here but the
// row map and the GELU of common.cuh.
//
// Bound on the H100. The tensor cores have no fp32 product and one TF32
// pass rounds each operand to 10 mantissa bits (relative error about
// 2^-11), which an fp32 model does not ask for, so every product here is a
// 3xTF32 split (three TF32 products of the operands' high and low halves,
// fp32-accurate at a third of the TF32 rate, 164.9 TFLOP/s; the attention's
// on mma.sync, tf32x3.cuh, the GEMMs' on wgmma, fp32_gemm.cuh). The GEMMs:
// K1's two products at the serving stage 1 (86 GFLOP) at least 0.52 ms,
// K2 (172 GFLOP) 1.04 ms, K3 (43 GFLOP) 0.26 ms; fp32 FMA on the CUDA
// cores (67 TFLOP/s) would need 2.5x that. The attention (rows 10 and 11
// at stage 1, and K1's: 10.7 GFLOP, 336 MB of q, k, v and output): 0.065
// ms of products against 0.100 ms of bytes, so it is bounded by its bytes.
//
// Design:
//   - `gemm_f32`: C[c_map(m), n] = epilogue(sum_k A[a_map(m), k] Wt[n, k] +
//     bias[n]), the products of all three, on the tile of fp32_gemm.cuh
//     (`f32t::ktile`: 3xTF32 on wgmma m64n128k8, A from registers, each
//     k tile's sum from zero added to fp32 sums). One persistent kernel
//     (`tile_f32_kernel`, also row 17's implicit GEMM, `conv_f32`), one
//     block an SM (its 192 KiB ring) walking 128 x 128 output tiles,
//     warp-specialised as the bf16 Hopper GEMM (gemm_sm90.cu):
//       two consumer warpgroups, each on a 64-row half, do nothing but
//       wait for a split k tile, issue its 12 wgmma, add its sum and free
//       the stage. A warp that issues wgmma stalls until the tensor cores
//       take them (the card measured about 1,100 cycles of a k tile's
//       1,564 in the issue), so work in the same warps does not overlap
//       the products;
//       a producer warpgroup fills a four-stage ring of 32-deep k tiles
//       and splits each Wt tile into hi (in place) and lo: Wt by 2-D
//       TMA, 128-byte swizzled; A by 2-D TMA under the identity row map,
//       else by cp.async through the row map into the same swizzle (K1's
//       qkv gathers the shifted windows from the clip: no rolled copy is
//       formed; one 4-D TMA box a whole window made K1's qkv 4-37 %
//       slower than cp.async on an H100 at 700 W, so there is none). It
//       splits k tile j, then starts k tile j + 3's loads into k tile j -
//       1's stage once the consumers free it (`full`, `ready` and `empty`
//       mbarriers a stage).
//     At 384 threads ptxas holds a thread to 168 registers (at 288, with
//     one producer warp, it did the same); a consumer keeps 64 sums, the
//     k tile's 64 partials (dead outside the k tile: its first wgmma
//     writes them) and 32 A fragment halves. The producer
//     runs into the next tile while the consumers store the last; C rows
//     scatter through the C row map (K1's proj back to the image layout).
//     No split-K, no float atomics: two calls give the same bits.
//     Epilogues (`F32Epi`, fp32_gemm.cuh), a kernel instance each (with
//     every kind's code unrolled in one instance the epilogue took 17-22k
//     cycles a tile on the card, about 5k of them its transposes; an
//     instance each cut the K = 512 products' times by up to 14 %), from
//     the accumulators after a transpose within each quad (8 consecutive
//     columns of one row a lane, stored
//     whole): act(v) stored, v added into C (K2's residual s + MLP), K6's
//     gelu(v) and gelu'(v) from one erf evaluation, and v times an aux
//     matrix (K6's dpre = dh * gelu') with, where asked, the column sums
//     of each 128-row tile (db1's partials: a warp's 16 rows by shuffles,
//     `col_sum8`, then the 8 warps in order through 4 KiB of shared
//     memory), so no pass over R x hidden sums db1. Ragged M, N and K are
//     zero-filled on load and masked on store; K is a multiple of 4.
//   - the attention (`attn_f32_kernel`, the core `attn32::pairs` of
//     fp32_attention.cuh): persistent blocks of TN / 16 warps, as many as
//     the SMs hold (one at stage 1, whose pair of q, k and v in fp32 rows
//     of hd + 4 takes 198 KiB at TN 128 x hd 128; two at stage 2, 98 KiB
//     at TN 32 x hd 256), each walking its share of the (window, head)
//     pairs. A warp owns 16 query rows: mma.sync m16n8k8 tf32, three
//     passes a product, forms its 16 x TN scores in registers, where the
//     scale, + the tiled relative bias, + the window's mask for SW-MSA,
//     the row max and sum (quad shuffles), exp and the multiply by the
//     reciprocal of the sum run; P stays fp32 in those registers and is P
//     V's A fragment (the keys of a k step taken in the accumulator's
//     order), so it is never stored; the output leaves from the P V
//     accumulators. A pair's loads hide behind the pair before it: the
//     next pair's q and k are copied in while this pair's softmax and P V
//     run, its v while the next scores are formed. The three callers
//     differ only in where a (window, head, token) row lives, so the
//     kernel is one template over an address functor: K1 reads its
//     window-order qkv buffer (the identity map); row 10 gathers straight
//     from the image-layout qkv through the window partition and scatters
//     its output back to the image (no partitioned copy is formed); row 11
//     reads the head-major tensors, window b taking mask b % n_mask.
//     Where q, k and v of a pair do not fit the block (hd past 144 at TN
//     128, past 104 at TN 176, past 600 at TN 32), the same blocks run
//     the streamed pair (`attn32::pairs_streamed`): q and k in 32-column
//     chunks, then v in 64-column chunks, one ring of three slots (864 TN
//     bytes), two chunks in flight; the resident pair's products, each
//     score summed over the same k steps in the same order. Bound as
//     above: the same products and bytes; the chunks re-read nothing.
//     Every window K1's bf16 core takes (`attn32::takes`), no other.
//   - K2's and K3's row passes: a warp a row, fp32 in and out: K2's
//     s = x + y read through the inverse cyclic shift and LN2(s), and
//     LN1(s + m) after fc2 has added m into s (row 8: fc2 writes m, and
//     the LN1 pass adds it); K3's 2x2 regroup in the reference chunk order
//     with the twin's single-pass variance.

#include <atomic>

#include "fp32_attention.cuh"
#include "fp32_gemm.cuh"

namespace {

// ---- the fp32 GEMM and row 17's implicit GEMM: one persistent kernel ----

std::atomic<long long> f32_gemm_launches{0};

// Row 17: the k tiles its consumers summed, over every (row tile, column
// tile) of every launch since the last reset (`stswin_conv_f32_k_tiles`):
// what the kernel did not skip, read back on the card.
__device__ unsigned long long conv_k_tiles_summed;

using f32t::BM;
using f32t::BN;
using f32t::BK;
using f32t::NACC;
using f32t::STAGE;
using f32t::STAGES;
using f32t::TILE;
using sm90::cp_async_arrive;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::tma_load;

// Two consumer warpgroups and one producer warpgroup: 384 threads, at
// which ptxas holds a thread to 168 registers; a consumer's 64 sums, 64
// k-tile partials and 32 A fragment halves fit.
constexpr int THREADS = 384;
// the ring, its barriers, then F32_DGELU's column sums: a consumer warp's
// 16-row sums of the tile's 128 columns each, twice (tiles alternate)
constexpr int SMEM = 1024 + f32t::RING_BYTES + 3 * STAGES * 8 + 2 * 8 * BN * 4;

// How A arrives: one 2-D TMA box a stage (the identity row map), or
// cp.async through the row map (or row 17's tap map).
enum Gather { GATHER_NONE = 0, GATHER_ROWS = 1 };

struct Maps {
  CUtensorMap a, b;
};

// The kernel's instances: the GEMM's by epilogue (`F32Epi`), row 17's.
constexpr int E_CONV = F32_DGELU + 1;

struct Run {
  F32Gemm g;  // the GEMM (CONV false)
  F32Conv c;  // row 17 (CONV true)
  int M, N, K;
  int gather;
  int vec;  // the epilogue may store 8 columns as two 16-byte stores
};

// Row 17: the taps of tile m0's pixels that reach into the image, a bit a
// tap (one warp; every lane gets the mask). A k tile all of whose taps are
// outside reads only the zero padding: it adds nothing and is skipped by
// every role, decided once a tile.
__device__ __forceinline__ uint32_t conv_live(const F32Conv& c, int M, int m0,
                                              int lane) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < BM / 32; ++i) {
    const int m = m0 + lane + 32 * i;
    if (m < M) {
      const int w = m % c.W, h = (m / c.W) % c.H;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hh = h + c.d * (tap / 3 - 1), ww = w + c.d * (tap % 3 - 1);
        if (hh >= 0 && hh < c.H && ww >= 0 && ww < c.W) bits |= 1u << tap;
      }
    }
  }
  return __reduce_or_sync(0xffffffffu, bits);
}

// whether k tile kt (k in [32 kt, 32 kt + 32) of K = 9 Cin) reads a live tap
__device__ __forceinline__ bool kt_live(uint32_t live, int kt, int Cin, int K) {
  const int k0 = kt * BK, k1 = min(k0 + BK, K) - 1;
  const int t0 = k0 / Cin, t1 = k1 / Cin;
  return live & (((2u << t1) - 1) & ~((1u << t0) - 1));
}

// A warp's sums over its 16 rows of 8 consecutive columns, v the lane's
// values from `rows8` (lane 4 g + t: row g + 8 (t >> 1), columns 8 (t & 1)
// on from the caller's dst): halved across lanes 16, 8, 4 apart (each keeps
// 4, 2, 1 columns and adds its partner's), then the two row halves (lanes
// 2 apart) added; lane 4 g + t (t < 2) writes column g of its 8 to dst[g].
// A fixed tree: the same bits every call.
__device__ __forceinline__ void col_sum8(const float (&v)[8], float* dst,
                                         int lane) {
  const unsigned all = 0xffffffffu;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (b4 ? v[i + 4] : v[i]) +
           __shfl_xor_sync(all, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (b3 ? a[i + 2] : a[i]) +
           __shfl_xor_sync(all, b3 ? a[i] : a[i + 2], 8);
  float c = (b2 ? b[1] : b[0]) + __shfl_xor_sync(all, b2 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(all, c, 2);
  if (!(lane & 2)) dst[lane >> 2] = c;
}

// Position j of a block's walk over its (output tile, k tile) pairs: tiles
// blockIdx.x, + gridDim.x, ...; each tile's k tiles in order, row 17's
// dead ones skipped. Every warp walks alike (k tile j sits in stage j %
// STAGES), so the loads, the splits and the sums agree on the sequence.
struct Walk {
  int tile, kt, j;
  uint32_t live;  // row 17: the tile's live taps
};

template <bool CONV>
__device__ __forceinline__ void step(Walk& w, const Run& r, int tiles,
                                     int tiles_n, int KT) {
  do {
    if (++w.kt == KT) {
      w.kt = 0;
      w.tile += gridDim.x;
      if (CONV && w.tile < tiles)
        w.live = conv_live(r.c, r.M, (w.tile / tiles_n) * BM,
                           threadIdx.x & 31);
    }
  } while (CONV && w.tile < tiles && !kt_live(w.live, w.kt, r.c.Cin, r.K));
  ++w.j;
}

template <bool CONV>
__device__ __forceinline__ Walk walk_start(const Run& r, int tiles,
                                           int tiles_n, int KT) {
  Walk w{static_cast<int>(blockIdx.x), -1, -1, 0};
  if (CONV && w.tile < tiles)
    w.live = conv_live(r.c, r.M, (w.tile / tiles_n) * BM, threadIdx.x & 31);
  step<CONV>(w, r, tiles, tiles_n, KT);
  return w;
}

// What a producer thread loads of its walk's current tile: A row `row`
// (its source row, or row 17's pixel).
struct Loader {
  int tile, row;
  long long src;  // row * lda, or row 17's image * H
  int ph, pw;     // row 17's pixel
  bool rok;
};

template <bool CONV>
__device__ __forceinline__ void loader_tile(Loader& L, const Run& r, int tile,
                                            int tiles_n) {
  L.tile = tile;
  const int m = (tile / tiles_n) * BM + L.row;
  L.rok = m < r.M;
  if (CONV) {
    const int mm = L.rok ? m : 0;
    L.pw = mm % r.c.W;
    L.ph = (mm / r.c.W) % r.c.H;
    L.src = (long long)(mm / (r.c.W * r.c.H)) * r.c.H;
    return;
  }
  L.src = L.rok && r.gather != GATHER_NONE ? map_row(r.g.a_map, m) * r.g.lda
                                           : 0;
}

// Start the loads of the walk's k tile into its stage, by the producer
// warpgroup: its thread 0 issues the TMA boxes (Wt; A under the identity
// map); where A goes row by row, each thread its row's
// eight 16-byte chunks by cp.async (row 17: each chunk's tap and channel;
// the padding and K's tail zero-filled), counted on the stage's `full`
// barrier.
template <bool CONV>
__device__ __forceinline__ void load_ktile(const Walk& w, Loader& L,
                                           const Run& r, const Maps& maps,
                                           float* ring, uint64_t* full,
                                           int tiles_n) {
  if (L.tile != w.tile) loader_tile<CONV>(L, r, w.tile, tiles_n);
  const int s = w.j % STAGES;
  float* sa = ring + s * STAGE;
  float* sb = sa + TILE;
  const int m0 = (w.tile / tiles_n) * BM, n0 = (w.tile % tiles_n) * BN;
  const int k0 = w.kt * BK;
  const bool by_rows = CONV || r.gather != GATHER_NONE;
  if (L.row == 0) {
    mbar_expect_tx(&full[s], TILE * 4 * (by_rows ? 1 : 2));
    tma_load(sb, &maps.b, k0, n0, &full[s]);
    if (!by_rows) tma_load(sa, &maps.a, k0, m0, &full[s]);
  }
  if (by_rows) {
    int tap = 0, ch = 0;
    if (CONV) {
      tap = k0 / r.c.Cin;
      ch = k0 - tap * r.c.Cin;
    }
#pragma unroll
    for (int c = 0; c < BK / 4; ++c) {
      const int k = k0 + 4 * c;
      bool ok = L.rok && k < r.K;
      const float* src;
      if (CONV) {
        const int hh = L.ph + r.c.d * (tap / 3 - 1);
        const int ww = L.pw + r.c.d * (tap % 3 - 1);
        ok = ok && hh >= 0 && hh < r.c.H && ww >= 0 && ww < r.c.W;
        src = ok ? r.c.x + ((L.src + hh) * r.c.W + ww) * r.c.Cin + ch : r.c.x;
        ch += 4;  // Cin % 4 == 0: the next chunk's tap and channel
        while (ch >= r.c.Cin) {
          ch -= r.c.Cin;
          ++tap;
        }
      } else {
        src = r.g.A + L.src + (ok ? k : 0);
      }
      cp_async16(sa + L.row * BK + (((c ^ L.row) & 7) << 2), src, ok);
    }
  }
  if (CONV || r.gather != GATHER_NONE) cp_async_arrive(&full[s]);
}

// Two consumer warpgroups (warps 0-7), each on a 64-row half of the output
// tile, then the producer warpgroup (warps 8-11). A k tile flows through a
// stage's three mbarriers: `full` (its A and Wt landed), `ready` (the
// producers split Wt into hi and lo), `empty` (the consumers' wgmma are done
// with it). The producers split k tile j, then start the loads of k tile
// j + 3 into k tile j - 1's stage once the consumers free it: the split of
// the next k tile runs while the consumers sum this one.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    tile_f32_kernel(const __grid_constant__ Maps maps,
                    const __grid_constant__ Run r) {
  constexpr bool CONV = EPI == E_CONV;
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  float* colred = reinterpret_cast<float*>(empty + STAGES);  // [2][8][BN]

  const int M = r.M, N = r.N;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int KT = (r.K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // + each producer thread's cp.async
      mbar_init(&full[s], CONV || r.gather != GATHER_NONE ? 1 + 128 : 1);
      mbar_init(&ready[s], 128);
      mbar_init(&empty[s], 8);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- the producer warpgroup ----
    const int pt = threadIdx.x - 256;
    Loader L;
    L.tile = -1;
    L.row = pt;
    Walk lw = walk_start<CONV>(r, tiles, tiles_n, KT);  // the next to load
    for (int p = 0; p < STAGES - 1 && lw.tile < tiles; ++p) {
      load_ktile<CONV>(lw, L, r, maps, ring, full, tiles_n);
      step<CONV>(lw, r, tiles, tiles_n, KT);
    }
    for (Walk sw = walk_start<CONV>(r, tiles, tiles_n, KT); sw.tile < tiles;
         step<CONV>(sw, r, tiles, tiles_n, KT)) {
      const int s = sw.j % STAGES;
      mbar_wait(&full[s], (sw.j / STAGES) & 1);
      float* st = ring + s * STAGE;
      f32t::split_b(st + TILE, st + 2 * TILE, pt, 128);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&ready[s]);
      if (lw.tile < tiles) {  // into k tile j - 1's stage, once it is free
        if (lw.j >= STAGES)
          mbar_wait(&empty[lw.j % STAGES], (lw.j / STAGES - 1) & 1);
        load_ktile<CONV>(lw, L, r, maps, ring, full, tiles_n);
        step<CONV>(lw, r, tiles, tiles_n, KT);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: wait, 12 wgmma, add, free the stage ----
  const int wg = warp >> 2;
  float sum[NACC], d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) sum[i] = d[i] = 0.0f;
  Walk cw = walk_start<CONV>(r, tiles, tiles_n, KT);
  unsigned long long summed = 0;  // row 17: the tile's k tiles summed
  int parity = 0;                 // F32_DGELU: the half of colred in use
  while (cw.tile < tiles) {
    const int s = cw.j % STAGES;
    mbar_wait(&ready[s], (cw.j / STAGES) & 1);
    const float* st = ring + s * STAGE;
    const uint32_t sb = smem_u32(st + TILE);
    f32t::ktile(sum, d, st + wg * 64 * BK, sb, sb + TILE * 4);
    if (lane == 0) mbar_arrive(&empty[s]);
    ++summed;
    const int tile = cw.tile;
    step<CONV>(cw, r, tiles, tiles_n, KT);
    if (cw.tile == tile) continue;
    // the tile's last k tile: the epilogue, while the producers split and
    // load the next tile's
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const int rbase = m0 + wg * 64;
    if (CONV) {
      if (threadIdx.x == 0) atomicAdd(&conv_k_tiles_summed, summed);
      // the twin's order: sum * scale + shift, + residual, ReLU, each
      // rounded as PyTorch rounds it
      const F32Conv& c = r.c;
      f32t::rows8(
          sum, n0,
          [&](int n, float v) {
            return n < N ? __fadd_rn(__fmul_rn(v, c.scale[n]), c.shift[n])
                         : 0.0f;
          },
          [&](int row, int n, const float(&o)[8]) {
            const int m = rbase + row;
            if (m >= M) return;
            const long long at = (long long)m * N + n;
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = o[e];
            if (r.vec && n + 8 <= N) {
              if (c.res) {
                float rv[8];
                f32t::load8(c.res + at, rv);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], rv[e]);
              }
              if (c.relu)
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.0f);
              f32t::store8(c.out + at, v);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e)
                if (n + e < N) {
                  float x = v[e];
                  if (c.res) x = __fadd_rn(x, c.res[at + e]);
                  if (c.relu) x = fmaxf(x, 0.0f);
                  c.out[at + e] = x;
                }
            }
          });
    } else if (EPI == F32_DGELU) {
      // dpre = v * gelu', and with colpart db1's partial of this row tile:
      // each warp's 16 rows summed by `col_sum8`, then the 8 warps in
      // order. The tiles alternate between two halves of colred, so one
      // barrier a tile orders the writes before the reads and the reads
      // before the next writes to the same half.
      const F32Gemm& p = r.g;
      const bool cols = p.colpart != nullptr;
      float* red = colred + parity * 8 * BN;
      parity ^= 1;
      f32t::rows8(
          sum, n0,
          [&](int n, float v) {
            return v + (p.bias && n < N ? p.bias[n] : 0.0f);
          },
          [&](int row, int n, const float(&o)[8]) {
            const int m = rbase + row;
            float v[8];
            if (m < M) {
              const long long crow = map_row(p.c_map, m) * p.ldc + n;
              if (r.vec && n + 8 <= N) {
                f32t::load8(p.aux + crow, v);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = o[e] * v[e];
                f32t::store8(p.C + crow, v);
              } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  v[e] = n + e < N ? o[e] * p.aux[crow + e] : 0.0f;
                  if (n + e < N) p.C[crow + e] = v[e];
                }
              }
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = 0.0f;
            }
            if (cols) col_sum8(v, red + warp * BN + (n - n0), lane);
          });
      if (cols) {
        sm90::consumer_sync();
        const int c = threadIdx.x;
        if (c < BN && n0 + c < N) {
          float v = red[c];
#pragma unroll
          for (int w = 1; w < 8; ++w) v += red[w * BN + c];
          p.colpart[(long long)(m0 / BM) * N + n0 + c] = v;
        }
      }
    } else {
      const F32Gemm& p = r.g;
      f32t::rows8(
          sum, n0,
          [&](int n, float v) {
            return v + (p.bias && n < N ? p.bias[n] : 0.0f);
          },
          [&](int row, int n, const float(&o)[8]) {
            const int m = rbase + row;
            if (m >= M) return;
            const long long crow = map_row(p.c_map, m) * p.ldc + n;
            float* cp = p.C + crow;
            if (r.vec && n + 8 <= N) {
              float v[8];
              if (EPI == F32_RESID) {
                f32t::load8(cp, v);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] += o[e];
              } else if (EPI == F32_GELU_GRAD) {
                float g2[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  const float2 gg = gelu_and_grad(o[e], p.act);
                  v[e] = gg.x;
                  g2[e] = gg.y;
                }
                f32t::store8(p.C2 + crow, g2);
              } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = activate(o[e], p.act);
              }
              f32t::store8(cp, v);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                if (n + e >= N) break;
                if (EPI == F32_RESID) {
                  cp[e] += o[e];
                } else if (EPI == F32_GELU_GRAD) {
                  const float2 gg = gelu_and_grad(o[e], p.act);
                  cp[e] = gg.x;
                  p.C2[crow + e] = gg.y;
                } else {
                  cp[e] = activate(o[e], p.act);
                }
              }
            }
          });
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] = 0.0f;
    summed = 0;
  }
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <int EPI>
cudaError_t launch_tile(const Maps& maps, const Run& r, cudaStream_t s) {
  static bool ready[MAX_DEVICES] = {};  // the opt-in, once a device
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_f32_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int sms = sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  const long long tiles =
      (long long)((r.M + BM - 1) / BM) * ((r.N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  tile_f32_kernel<EPI><<<grid, THREADS, SMEM, s>>>(maps, r);
  return cudaGetLastError();
}

}  // namespace

cudaError_t gemm_f32(const F32Gemm& p, cudaStream_t s) {
  if (p.M < 0 || p.N <= 0 || p.K <= 0 || p.K % 4 || p.lda % 4 ||
      !aligned16(p.A) || !aligned16(p.Wt) || p.epi < F32_ACT ||
      p.epi > F32_DGELU ||
      (p.epi == F32_GELU_GRAD && (!p.C2 || p.act == ACT_NONE)) ||
      (p.epi == F32_DGELU && !p.aux) || (p.colpart && p.epi != F32_DGELU))
    return cudaErrorInvalidValue;
  if (p.M == 0) return cudaSuccess;
  Run r{};
  r.g = p;
  r.M = p.M;
  r.N = p.N;
  r.K = p.K;
  r.vec = p.ldc % 4 == 0 && aligned16(p.C) && (!p.C2 || aligned16(p.C2)) &&
          (!p.aux || aligned16(p.aux));
  Maps maps;
  if (!f32t::encode(&maps.b, p.Wt, p.N, p.K, p.K, BN))
    return cudaErrorInvalidValue;
  r.gather = p.a_map.mode ? GATHER_ROWS : GATHER_NONE;
  if (r.gather == GATHER_ROWS)
    maps.a = maps.b;  // unused: A goes by cp.async
  else if (!f32t::encode(&maps.a, p.A, p.M, p.K, p.lda, BM))
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (p.epi) {  // an instance an epilogue: each holds only its own code
    case F32_RESID:
      err = launch_tile<F32_RESID>(maps, r, s);
      break;
    case F32_GELU_GRAD:
      err = launch_tile<F32_GELU_GRAD>(maps, r, s);
      break;
    case F32_DGELU:
      err = launch_tile<F32_DGELU>(maps, r, s);
      break;
    default:
      err = launch_tile<F32_ACT>(maps, r, s);
  }
  f32_gemm_launches.fetch_add(1);
  return err;
}

cudaError_t conv_f32(const F32Conv& c, cudaStream_t s) {
  if (c.N <= 0 || c.H <= 0 || c.W <= 0 || c.Cin <= 0 || c.Cin % 4 ||
      c.Cout <= 0 || c.d < 1 || !aligned16(c.x) || !aligned16(c.wt))
    return cudaErrorInvalidValue;
  const long long M = (long long)c.N * c.H * c.W;
  if (M > (1LL << 31) - BM || 9LL * c.Cin > (1LL << 30))
    return cudaErrorInvalidValue;
  Run r{};
  r.c = c;
  r.M = static_cast<int>(M);
  r.N = c.Cout;
  r.K = 9 * c.Cin;
  r.vec = c.Cout % 4 == 0 && aligned16(c.out) && (!c.res || aligned16(c.res));
  Maps maps;
  if (!f32t::encode(&maps.b, c.wt, c.Cout, r.K, r.K, BN))
    return cudaErrorInvalidValue;
  maps.a = maps.b;
  return launch_tile<E_CONV>(maps, r, s);
}

namespace {

// ---- the attention: K1's, row 10's and row 11's ------------------------

// Persistent blocks of one pair's TN / 16 warps (at most NT * 16
// threads: the registers a thread may use follow the block's size), each
// running pairs blockIdx.x, + gridDim.x, ... through the core's pipeline.
template <int NT, class Addr>
__global__ void __launch_bounds__(NT * 16, 1)
    attn_f32_kernel(const Addr a, const float* __restrict__ bias,
                    const float* __restrict__ mask, int n_mask, int heads,
                    int total, int TN, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn32::pairs<NT>(a, blockIdx.x, total, gridDim.x, heads,
                    reinterpret_cast<float*>(smem), threadIdx.x, blockDim.x,
                    1, bias, mask, n_mask, TN, hd, scale);
}

// The same blocks over the streamed pair (`attn32::pairs_streamed`): the
// windows whose q, k and v do not fit one block.
template <int NT, class Addr>
__global__ void __launch_bounds__(NT * 16, 1)
    attn_f32_streamed_kernel(const Addr a, const float* __restrict__ bias,
                             const float* __restrict__ mask, int n_mask,
                             int heads, int total, int TN, int hd,
                             float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn32::pairs_streamed<NT>(a, blockIdx.x, total, gridDim.x, heads,
                             reinterpret_cast<float*>(smem), threadIdx.x,
                             blockDim.x, 1, bias, mask, n_mask, TN, hd,
                             scale);
}

// launches of the streamed instance since the last reset
// (`stswin_attn_f32_streamed_launches`)
std::atomic<long long> attn_streamed_launches{0};

template <int NT, class Addr>
cudaError_t launch_attn(const Addr& a, int n_windows, int heads, int TN,
                        int hd, const float* bias, const float* mask,
                        int n_mask, float scale, cudaStream_t s) {
  const bool resident = attn32::resident(TN, hd);
  const auto kernel = resident ? attn_f32_kernel<NT, Addr>
                               : attn_f32_streamed_kernel<NT, Addr>;
  const size_t bytes = attn32::plan_bytes(TN, hd);
  static int optins[2][MAX_DEVICES] = {};
  int* optin = optins[resident ? 0 : 1];
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!optin[dev]) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    optin[dev] = most;
  }
  if (bytes > static_cast<size_t>(optin[dev])) return cudaErrorInvalidValue;
  const int threads = TN * 2, total = n_windows * heads;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0 || !sm_count()) return cudaErrorInvalidConfiguration;
  const int grid = total < per_sm * sm_count() ? total : per_sm * sm_count();
  kernel<<<grid, threads, bytes, s>>>(a, bias, mask, n_mask, heads, total,
                                      TN, hd, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess && !resident) ++attn_streamed_launches;
  return err;
}

// softmax(q k^T * scale + bias (+ mask)) v for every (window, head) of
// n_windows windows of TN tokens, read and written through `a`; mask
// (n_mask, TN, TN) indexed by window % n_mask when n_mask > 1.
template <class Addr>
cudaError_t attention_f32(const Addr& a, int n_windows, int heads, int TN,
                          int hd, const float* bias, const float* mask,
                          int n_mask, float scale, cudaStream_t s) {
  if (!attn32::takes(TN, hd) || heads <= 0 || n_windows < 0)
    return cudaErrorInvalidValue;
  if (n_windows == 0) return cudaSuccess;
  const float* m = n_mask > 1 ? mask : nullptr;
  switch (attn32::score_tiles(TN)) {
    case 4:
      return launch_attn<4>(a, n_windows, heads, TN, hd, bias, m, n_mask,
                            scale, s);
    case 8:
      return launch_attn<8>(a, n_windows, heads, TN, hd, bias, m, n_mask,
                            scale, s);
    case 16:
      return launch_attn<16>(a, n_windows, heads, TN, hd, bias, m, n_mask,
                             scale, s);
    default:
      return launch_attn<22>(a, n_windows, heads, TN, hd, bias, m, n_mask,
                             scale, s);
  }
}

// ---- the row passes -----------------------------------------------------

constexpr int ROW_WARPS = 8;

// K2's LayerNorms, two-pass (`layer_norm_f32`). ADD: s = x[r] + y[unshift
// (r)] is written to s32 and normalised; else the row of s32 is, after
// s32 += m where m is given (row 8: LN1 of s + the saved m). C % 4 == 0.
template <bool ADD>
__global__ void __launch_bounds__(ROW_WARPS * 32)
    ln_rows_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ m,
                       const float* __restrict__ g,
                       const float* __restrict__ b, float* __restrict__ s32,
                       float* __restrict__ out, int R, int C, int H, int W,
                       int shift, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + warp;
  if (r >= R) return;
  float* srow = s32 + (long long)r * C;
  float sum = 0.0f;
  if (ADD) {
    const int w = r % W, h = (r / W) % H, bt = r / (W * H);
    const int hs = h - shift < 0 ? h - shift + H : h - shift;
    const int wsrc = w - shift < 0 ? w - shift + W : w - shift;
    const float* xr = x + (long long)r * C;
    const float* yr = y + ((long long)(bt * H + hs) * W + wsrc) * C;
    for (int c = lane * 4; c < C; c += 128) {
      const float4 xv = ld4(xr + c), yv = ld4(yr + c);
      const float4 sv =
          make_float4(xv.x + yv.x, xv.y + yv.y, xv.z + yv.z, xv.w + yv.w);
      *reinterpret_cast<float4*>(srow + c) = sv;
      sum += sum4(sv);
    }
  } else if (m) {
    const float* mrow = m + (long long)r * C;
    for (int c = lane * 4; c < C; c += 128) {
      const float4 sv = ld4(srow + c), mv = ld4(mrow + c);
      const float4 ov =
          make_float4(sv.x + mv.x, sv.y + mv.y, sv.z + mv.z, sv.w + mv.w);
      *reinterpret_cast<float4*>(srow + c) = ov;
      sum += sum4(ov);
    }
  } else {
    for (int c = lane * 4; c < C; c += 128) sum += sum4(ld4(srow + c));
  }
  ln_row_f32(srow, sum, g, b, out + (long long)r * C, C, eps, lane);
}

// K3's LayerNorm over the 2x2 regroup [x0 | x1 | x2 | x3] (x0 = (2i, 2j),
// x1 = (2i+1, 2j), x2 = (2i, 2j+1), x3 = (2i+1, 2j+1)), the single-pass
// variance of `patch_merge_ref`; the row is read twice (the second time
// from L1 / L2). C % 4 == 0.
__global__ void __launch_bounds__(ROW_WARPS * 32)
    patch_merge_ln_f32_kernel(const float* __restrict__ x,
                              const float* __restrict__ g,
                              const float* __restrict__ b,
                              float* __restrict__ n, int BT, int H, int W,
                              int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H2 = H / 2, W2 = W / 2;
  const long long R = (long long)BT * H2 * W2;
  const long long ro = (long long)blockIdx.x * ROW_WARPS + warp;
  if (ro >= R) return;
  const int j = ro % W2, i = (ro / W2) % H2;
  const long long bt = ro / ((long long)W2 * H2);
  const float* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int di = q & 1, dj = q >> 1;
    src[q] = x + ((bt * H + 2 * i + di) * W + 2 * j + dj) * C;
  }
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = ld4(src[q] + c);
      sum += sum4(v);
      sq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  const float inv_n = 1.0f / (4 * C);
  const float mu = warp_sum(sum) * inv_n;
  const float var = warp_sum(sq) * inv_n - mu * mu;
  const float rs = rsqrtf(var + eps);
  float* out = n + ro * 4 * C;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int c = lane * 4; c < C; c += 128) {
      const float4 v = ld4(src[q] + c);
      const int k = q * C + c;
      *reinterpret_cast<float4*>(out + k) = make_float4(
          (v.x - mu) * rs * g[k] + b[k], (v.y - mu) * rs * g[k + 1] + b[k + 1],
          (v.z - mu) * rs * g[k + 2] + b[k + 2],
          (v.w - mu) * rs * g[k + 3] + b[k + 3]);
    }
}

}  // namespace

F32Gemm plain_gemm(const float* A, int lda, const float* Wt,
                   const float* bias, int M, int N, int K, float* C, int ldc,
                   int act) {
  F32Gemm g{};
  g.A = A;
  g.lda = lda;
  g.a_map = identity_map();
  g.Wt = Wt;
  g.bias = bias;
  g.M = M;
  g.N = N;
  g.K = K;
  g.C = C;
  g.ldc = ldc;
  g.c_map = identity_map();
  g.act = act;
  g.epi = F32_ACT;
  return g;
}

cudaError_t ln_rows_add_f32(const float* x, const float* y, const float* g,
                            const float* b, float* s32, float* out, int R,
                            int C, int H, int W, int shift, float eps,
                            cudaStream_t s) {
  if (C % 4) return cudaErrorInvalidValue;
  const int blocks = (R + ROW_WARPS - 1) / ROW_WARPS;
  ln_rows_f32_kernel<true><<<blocks, ROW_WARPS * 32, 0, s>>>(
      x, y, nullptr, g, b, s32, out, R, C, H, W, shift, eps);
  return cudaGetLastError();
}

// K1 fp32. x: (B, T, H, W, C) fp32, unshifted; wqkv (3C, C), wproj (C, C)
// fp32; bqkv, bproj, bias (heads, TN, TN) and mask (n_mask, TN, TN) fp32.
// Scratch: qkv_buf (rows, 3C), attn_buf (rows, C) fp32, window order. out:
// (B, T, H, W, C) fp32, in the shifted layout when shift > 0.
extern "C" int stswin_block_attention_f32(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* bias, const void* mask, void* qkv_buf,
    void* attn_buf, void* out, int B, int T, int H, int W, int C, int heads,
    int ws, float scale, int shift, int n_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T * H * W, hd = C / heads, TN = T * ws * ws;
  const int nWin = (H / ws) * (W / ws);
  float* qkv = static_cast<float*>(qkv_buf);
  float* attn = static_cast<float*>(attn_buf);

  F32Gemm g = plain_gemm(static_cast<const float*>(x), C,
                         static_cast<const float*>(wqkv),
                         static_cast<const float*>(bqkv), M, 3 * C, C, qkv,
                         3 * C, ACT_NONE);
  g.a_map = RowMap{1, T, H, W, ws, shift};  // the shifted window partition
  cudaError_t err = gemm_f32(g, s);
  if (err != cudaSuccess) return err;

  err = attention_f32(attn32::MappedRows{qkv, attn, identity_map(), TN, hd, C},
                      B * nWin, heads, TN, hd,
                      static_cast<const float*>(bias),
                      static_cast<const float*>(mask), n_mask, scale, s);
  if (err != cudaSuccess) return err;

  g = plain_gemm(attn, C, static_cast<const float*>(wproj),
                 static_cast<const float*>(bproj), M, C, C,
                 static_cast<float*>(out), C, ACT_NONE);
  g.c_map = RowMap{1, T, H, W, ws, 0};  // window order -> (shifted) image
  return gemm_f32(g, s);
}

// K2 fp32: the serving form, and with `m_out` Pallas row 8 (the training
// forward that saves m, `_fused_epilogue_fwd_with_m`). x, y: (BT, H, W, C)
// rows fp32 (y in the shifted layout when shift > 0); w1 (hidden, C), w2
// (C, hidden) fp32; the vectors fp32. Scratch: s32, n2 (rows, C), hid
// (rows, hidden) fp32. out: (rows, C) fp32, unshifted; m_out (rows, C)
// fp32 or null: fc2 + bias written to it (in fp32 the "rounding" of m is
// the identity), then LN1 of s + m, `_epilogue_kernel_with_m`'s order
// (`pallas_add_ln_mlp.py:752-799`).
extern "C" int stswin_block_epilogue_f32(
    const void* x, const void* y, const void* s2, const void* b2,
    const void* w1, const void* b1, const void* w2, const void* bw2,
    const void* s1, const void* b1n, void* s32, void* n2, void* hid,
    void* out, void* m_out, int BT, int H, int W, int C, int hidden,
    int shift, int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 || hidden % 4) return cudaErrorInvalidValue;
  const int R = BT * H * W;
  const int blocks = (R + ROW_WARPS - 1) / ROW_WARPS;
  float* s32p = static_cast<float*>(s32);
  float* n2p = static_cast<float*>(n2);
  float* hidp = static_cast<float*>(hid);
  float* mp = static_cast<float*>(m_out);
  cudaError_t err = ln_rows_add_f32(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(s2), static_cast<const float*>(b2), s32p,
      n2p, R, C, H, W, shift, eps, s);
  if (err != cudaSuccess) return err;

  F32Gemm g = plain_gemm(n2p, C, static_cast<const float*>(w1),
                         static_cast<const float*>(b1), R, hidden, C, hidp,
                         hidden, act);
  err = gemm_f32(g, s);
  if (err != cudaSuccess) return err;
  g = plain_gemm(hidp, hidden, static_cast<const float*>(w2),
                 static_cast<const float*>(bw2), R, C, hidden,
                 mp ? mp : s32p, C, ACT_NONE);
  // serving: s += fc2 + bias, the fp32 MLP sum unrounded; row 8: m = it
  if (!mp) g.epi = F32_RESID;
  err = gemm_f32(g, s);
  if (err != cudaSuccess) return err;

  ln_rows_f32_kernel<false><<<blocks, ROW_WARPS * 32, 0, s>>>(
      nullptr, nullptr, mp, static_cast<const float*>(s1),
      static_cast<const float*>(b1n), s32p, static_cast<float*>(out), R, C,
      H, W, 0, eps);
  return cudaGetLastError();
}

// K3 fp32. x: (BT, H, W, C) fp32, H and W even, C % 4 == 0; scale, bias
// (4C) fp32; w (2C, 4C) fp32; n_buf (rows, 4C) fp32 scratch; out (BT, H/2,
// W/2, 2C) fp32.
extern "C" int stswin_patch_merge_f32(const void* x, const void* scale,
                                      const void* bias, const void* w,
                                      void* n_buf, void* out, int BT, int H,
                                      int W, int C, float eps, void* stream) {
  if (BT <= 0 || H < 2 || W < 2 || H % 2 || W % 2 || C <= 0 || C % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = (long long)BT * (H / 2) * (W / 2);
  const unsigned blocks =
      static_cast<unsigned>((R + ROW_WARPS - 1) / ROW_WARPS);
  float* np = static_cast<float*>(n_buf);
  patch_merge_ln_f32_kernel<<<blocks, ROW_WARPS * 32, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), np, BT, H, W, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemm_f32(plain_gemm(np, 4 * C, static_cast<const float*>(w),
                             nullptr, static_cast<int>(R), 2 * C, 4 * C,
                             static_cast<float*>(out), 2 * C, ACT_NONE),
                  s);
}

// Row 10 fp32. qkv (B, T, H, W, 3C) fp32, out (B, T, H, W, C) fp32, both
// in the image layout (qkv already rolled for SW-MSA); bias (heads, TN, TN)
// fp32; mask (nH * nW, TN, TN) fp32, one entry per window of an image
// (index i * nW + j), when n_mask > 1. The arguments of the bf16 entry
// `stswin_window_attention_image`.
extern "C" int stswin_window_attention_image_f32(
    const void* qkv, const void* bias, const void* mask, void* out, int B,
    int T, int H, int W, int C, int heads, int ws, float scale, int n_mask,
    void* stream) {
  if (heads <= 0 || C % heads || ws <= 0 || H % ws || W % ws)
    return cudaErrorInvalidValue;
  const int TN = T * ws * ws, hd = C / heads;
  return attention_f32(
      attn32::MappedRows{static_cast<const float*>(qkv),
                         static_cast<float*>(out), RowMap{1, T, H, W, ws, 0},
                         TN, hd, C},
      B * (H / ws) * (W / ws), heads, TN, hd,
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      n_mask, scale, static_cast<cudaStream_t>(stream));
}

// Row 11 fp32. q, k, v, out: (Bw, heads, TN, hd) fp32, windows minor;
// mask (n_mask, TN, TN) fp32 indexed by window % n_mask, when n_mask > 1.
// The arguments of the bf16 entry `stswin_window_attention_heads`.
extern "C" int stswin_window_attention_heads_f32(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, void* out, int Bw, int heads, int TN, int hd,
    float scale, int n_mask, void* stream) {
  const attn32::HeadMajor a{{static_cast<const float*>(q),
                             static_cast<const float*>(k),
                             static_cast<const float*>(v)},
                            static_cast<float*>(out), heads, TN, hd};
  return attention_f32(a, Bw, heads, TN, hd, static_cast<const float*>(bias),
                       static_cast<const float*>(mask), n_mask, scale,
                       static_cast<cudaStream_t>(stream));
}

// The fp32 GEMM alone (`ops/gemm.linear_f32`): C[c_map(m)] = the epilogue
// `epi` (F32Epi) of A[a_map(m)] @ Wt^T + bias, with C2 and aux the second
// output and input of F32_GELU_GRAD and F32_DGELU (else null); F32_DGELU
// with colsum (N) also its column sums, the epilogue's per-row-tile
// partials in work (`stswin_gemm_f32_colsum_work` floats) summed in
// order. The row maps (mode 1: the window partition over (T, H, W, ws)
// with its shift) share the grid.
extern "C" int stswin_gemm_f32(const void* A, const void* Wt,
                               const void* bias, void* C, void* C2,
                               const void* aux, void* colsum, void* work,
                               int M, int N, int K, int lda, int ldc,
                               int act, int epi, int a_mode, int c_mode,
                               int T, int H, int W, int ws, int a_shift,
                               int c_shift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  F32Gemm g = plain_gemm(static_cast<const float*>(A), lda,
                         static_cast<const float*>(Wt),
                         static_cast<const float*>(bias), M, N, K,
                         static_cast<float*>(C), ldc, act);
  g.epi = epi;
  g.C2 = static_cast<float*>(C2);
  g.aux = static_cast<const float*>(aux);
  if (colsum) {
    if (!work || M <= 0) return cudaErrorInvalidValue;
    g.colpart = static_cast<float*>(work);
  }
  if (a_mode) g.a_map = RowMap{1, T, H, W, ws, a_shift};
  if (c_mode) g.c_map = RowMap{1, T, H, W, ws, c_shift};
  const cudaError_t err = gemm_f32(g, s);
  if (err != cudaSuccess || !colsum) return err;
  return sum_parts(g.colpart, f32_col_tiles(M), N, N,
                   static_cast<float*>(colsum), s);
}

// A query, not a launch: the floats of `stswin_gemm_f32`'s column-sum
// partials.
extern "C" int stswin_gemm_f32_colsum_work(int M, int N, long long* out) {
  *out = static_cast<long long>(f32_col_tiles(M)) * N;
  return 0;
}

// The fp32 GEMMs' launches (a query, not a launch), those inside the fp32
// entries of K1-K3, K5, K6 and rows 12-13 included, since the last call
// with `reset` set: out[0] the fp32 GEMM's, out[1] the fp32 weight-gradient
// GEMM's (fp32_train.cu), out[2] row 17's fp32 implicit GEMM's
// (fp32_offpath.cu); `reset` then sets the counts to 0.
extern "C" int stswin_gemm_f32_launches(long long* out, int reset) {
  out[0] = reset ? f32_gemm_launches.exchange(0) : f32_gemm_launches.load();
  out[1] = wgrad_f32_launches(reset);
  out[2] = conv_f32_launches(reset);
  return 0;
}

// Row 17's k tiles summed on the current device (a query, not a launch;
// the caller synchronises first): *out the count since the last call with
// `reset` set, which then sets it to 0.
extern "C" int stswin_conv_f32_k_tiles(long long* out, int reset) {
  unsigned long long n = 0;
  cudaError_t err = cudaMemcpyFromSymbol(&n, conv_k_tiles_summed, sizeof n);
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(conv_k_tiles_summed, &zero, sizeof zero);
  }
  *out = static_cast<long long>(n);
  return err;
}

// Queries, not launches. The shared memory of the fp32 attention core's
// instance for a (TN, hd) window (`attn32::plan_bytes`; -1 for a window it
// refuses), what `ops/attention.py` `_attn_f32_smem_bytes` plans; and the
// launches of its streamed instance since the last reset.
extern "C" int stswin_attn_f32_smem(int TN, int hd, long long* out) {
  *out = attn32::takes(TN, hd)
             ? static_cast<long long>(attn32::plan_bytes(TN, hd))
             : -1;
  return 0;
}

extern "C" int stswin_attn_f32_streamed_launches(int reset, long long* out) {
  *out = reset ? attn_streamed_launches.exchange(0)
               : attn_streamed_launches.load();
  return 0;
}
