// Row 16: the whole W-MSA swin block in ONE launch,
//   qkv = x Wqkv + bqkv -> window attention -> y = attn Wproj + bproj,
//   s = x + y (fp32), out = LN1(s + m), m = fc2(GELU(fc1(LN2(s)))).
//
// Replaces: stswincl_tpu/ops/pallas_swin_block.py
//   fused_whole_swin_block (:229) -> _whole_kernel (:63), shift 0 only.
//
// Rounding, as the TPU kernel rounds: qkv, each head's output, y, the
// LN2 output and the GELU output to bf16 (:88, :115, :122, :135, :138);
// m to bf16 before the residual add (:142; K2 as served adds the fp32 m,
// so this kernel and the K1 + K2 pair differ in m's last bit, as in the
// JAX package); scores scaled in fp32 after the product (:106), the
// softmax as e * (1 / sum) (:112), no mask (W-MSA's single zero mask is
// skipped, :108).
//
// Bound on the H100: 24 R C^2 + 4 R TN C flops for R token rows (268
// GFLOP at the stage-1 serving shape), against R C * 4 bytes of x and out
// and 24 C^2 bytes of weights: compute-bound on the tensor cores.
//
// Design. The TPU kernel kept a row band (T x ws x W x C) and every weight
// resident in up to 100 MB of VMEM; one SM has 227 KB of shared memory,
// so this kernel tiles by windows and streams the weights (6.3 MB at stage
// 1, 25 MB at stage 2: they live in the 50 MB L2). One block an SM owns a
// tile of whole windows in window order at a time: as many as fit TM =
// 128 token rows (one stage-1 window of TN 128, four stage-2 windows of TN
// 32, two of TN 48, one of TN 80-112), or one window of TN 144-176 whose
// products run over two 128-row tiles (MT = 2), the rows past the windows
// masked. Every step is row-local or window-local, so blocks never wait
// for each other and one launch covers the block call. The grid is
// persistent (one block a workspace slot; `stswin_whole_block_slots`
// sizes them from the occupancy API) and each tile runs seven phases:
//   1. qkv on the Hopper GEMM tile (sm90_tile.cuh, the tile of
//      gemm_sm90.cu: wgmma m64n128k16 from a TMA ring of 64-deep k tiles),
//      A = x by one 4-D TMA box a window where the windows tile 128 rows
//      (TN 16, 32, 64, 128), else through the window partition's row map
//      by cp.async (each producer lane 4 rows of a stage, counted on the
//      stage's `full` barrier), as K1's qkv product reads it
//      (gemm_sm90.cu's GATHER_WINDOWS / GATHER_ROWS); ceil(3C / 128)
//      output tiles, the last one's columns past 3C masked;
//   2. attention of each (window, head) by K1's core on the consumer
//      warps, over the slot's qkv: the register-resident pair
//      (`attn::pair_core`, attention_core.cuh) where q, k and v fit beside
//      the ring's barriers, as many pairs at once as its shared memory and
//      the 8 warps (TN / 16 a pair) hold (one at stage 1, four at stage
//      2); past that the streamed pair (`attn::pairs_streamed`, a ring of
//      864 TN bytes a pair). Past 128 tokens a pair has more 16-row slabs
//      than the 8 warps: each warp takes a further slab of the same pair
//      (the cores' SLABS form), so every row is computed as K1 computes
//      it;
//   3. proj with the bias -> bf16 y;
//   4. s = x + y (fp32, kept) and LN2(s), one warp a row;
//   5. fc1 with the bias and GELU (the erf polynomial) in the epilogue;
//   6. fc2 with the bias -> bf16 m;
//   7. LN1(s + m), one warp a row, scattered back to the image layout.
// Warp-specialised as gemm_sm90: one producer warp keeps the ring full
// with TMA (weights by 2-D boxes from L2, zero-filled past N and K; its
// warpgroup gives its registers to the consumers, which so hold 232 a
// thread), two consumer warpgroups own the 64-row halves of each 128 x 128
// output tile and run every epilogue from the accumulator registers
// through the quad transpose, then the attention and LN phases. The ring
// runs on across phases and tiles: the producer fetches the next product's
// weight tiles while the consumers finish a phase, but A tiles that the
// consumers write (the attention output, LN2(s), h: generic stores into
// the slot's workspace) only after the consumers' proxy fence and their
// arrival on the `ready` barrier.
// Shared memory holds one phase at a time: the ring (6 stages of 32 KB,
// its depth the bytes each SM keeps in flight from L2) or the attention
// core's pairs (105 KB a resident pair at stage 1, 51 KB at stage 2); the
// producer fills no stage from the end of a tile's qkv product until the
// consumers leave its attention phase.
// Every product sums k in the order of gemm_sm90's (`mma_ktile`, BK 64,
// the k tile past K zero-filled) with the same epilogue arithmetic, the
// attention is K1's core (its resident and streamed pairs give the same
// bits) and the LN passes are K2's `ln_rows_kernel` lane for lane (s = x
// + y formed in the LN2 pass, s + m in the LN1 pass; a row of up to 1024
// channels held in registers, a wider one read again from the fp32 s for
// each pass, as K2 reads it), so the output carries the bits of the K1 +
// K2 pair with m rounded (K2's `m_out` form). The epilogues read nothing
// but each lane's 32 bias values, loaded while the last k tile's products
// run: every other load moved to the LN passes (a load in the epilogue
// waits a round trip per column group, and held in registers ahead of the
// stores they spilled).
// What does not fit on chip goes to the slot's workspace (MT x 128 rows),
// reused tile after tile: qkv (rows x 3C), then y (rows x C), then the
// GELU output (rows x hidden, row stride max(3C, hidden)), bf16; the
// attention output, then LN2(s), then m (rows x C bf16); s (rows x C
// fp32); 0.875 MiB a slot at stage 1, 1.75 MiB at stage 2, 4.4 MiB at C
// 2560.
// Device memory sees x read by phases 1 and 4 and the output written
// once; the K1 + K2 pair also writes and reads y and every intermediate
// for every row.

#pragma once

#include "attention_core.cuh"
#include "sm90_tile.cuh"

namespace whole_block {

using namespace sm90;

constexpr int TM = BM;        // token rows of one product tile
// two consumer warpgroups and a producer warpgroup, of which one warp
// issues the TMA loads: its registers go to the consumers (`setmaxnreg`)
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGES = 6;
constexpr int RING = STAGES * (TILE_A + TILE_B);
constexpr int BARS = 128;  // full / empty a stage and `ready`, 8 bytes each
constexpr int SMEM_MAX = 232448;  // shared memory one block may use, sm_90

// The windows the kernel takes: K1's core's (16-token tiles up to 176,
// head dims of 8).
__host__ __device__ inline bool takes_window(int TN, int hd) {
  return TN > 0 && TN % 16 == 0 && TN <= 16 * attn::MAX_NT && hd > 0 &&
         hd % 8 == 0;
}

// The dynamic shared memory of one block: 1024 bytes of alignment slack,
// then one region that holds the ring in the product phases and `group`
// attention pairs of `pair` bytes in the attention phase (as many as the
// consumer warps, pt a pair, and the shared memory hold), then the
// barriers. A pair is resident where its q, k and v fit that room, else
// streamed.
struct Layout {
  size_t pair, region, total;
  int group, pt;
  bool streamed;
};

__host__ __device__ inline Layout whole_layout(int TN, int hd) {
  Layout L;
  const size_t room = SMEM_MAX - 1024 - BARS;
  L.streamed = attn::pair_smem(TN, hd).total > room;
  L.pair = L.streamed ? attn::streamed_bytes(TN)
                      : attn::pair_smem(TN, hd).total;
  L.pt = TN / 16 * 32 < CONSUMERS ? TN / 16 * 32 : CONSUMERS;
  L.group = CONSUMERS / L.pt;
  while (L.group > 0 && L.group * L.pair > room) --L.group;
  L.region = L.group * L.pair > RING ? L.group * L.pair : RING;
  L.total = 1024 + L.region + BARS;
  return L;
}

struct WholeMaps {
  CUtensorMap x;             // (64, ws, ws, T) boxes of the image
  CUtensorMap narrow, hid;   // 64 x 128 boxes of the slots' workspace rows
  CUtensorMap wqkv, wproj, w1, w2;  // 64 x 128 boxes of the (N, K) weights
};

struct WholeParams {
  const bf16* x;
  bf16* out;
  const float* bqkv;
  const float* bproj;
  const float* bias;  // (heads, TN, TN)
  const float* s2;
  const float* b2;
  const float* b1;
  const float* bw2;
  const float* s1;
  const float* b1n;
  bf16* ws_wide;    // (slots, slot_rows, wide) bf16: qkv (stride 3C), y, h
  bf16* ws_narrow;  // (slots, slot_rows, C) bf16
  float* ws_s;      // (slots, slot_rows, C) fp32
  RowMap img;       // window-order row -> image row (shift 0)
  int M, C, hidden, wide, heads, TN, hd, tiles, act, group, pt;
  int tile_rows, slot_rows;
  int rows_x;    // phase 1 reads x through the row map (cp.async)
  int streamed;  // the attention phase runs the streamed pair
  size_t pair, region;
  float scale, eps;
};

__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  uint4 o;
  o.x = pack_bf16(v[0], v[1]);
  o.y = pack_bf16(v[2], v[3]);
  o.z = pack_bf16(v[4], v[5]);
  o.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = o;
}

// This lane's bias of the 128 x 128 tile's columns n0 .. n0 + 127 in the
// accumulator layout: b[j] = (bias[n0 + 8j + 2t], bias[n0 + 8j + 2t + 1]),
// t = lane % 4 (a 16-byte aligned fp32 vector of N; with WIDE 0 past N,
// else N % 128 == 0).
template <bool WIDE>
__device__ __forceinline__ void load_bias(float2 (&b)[BN / 8],
                                          const float* bias, int n0, int N,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    b[j] = !WIDE || n < N ? *reinterpret_cast<const float2*>(bias + n)
                          : make_float2(0.0f, 0.0f);
  }
}

// The warpgroup accumulator of consumer warp `warp` (0-7), lane `lane`,
// plus the bias `b` (`load_bias`), handed to epi(row, col, v) as 8
// consecutive fp32 columns of one row of the 128 x 128 tile: each lane
// keeps one row. acc[4j + 2h + e] is row (warp % 4) * 16 + lane / 4 + 8h,
// column 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN block; the bias
// is added there, as gemm_sm90's epilogue adds it, then a transpose within
// each quad of lanes leaves lane t with word t of every lane of the quad,
// for each pair of 8-column blocks.
template <class Epi>
__device__ __forceinline__ void rows8(const float (&acc)[NACC],
                                      const float2 (&b)[BN / 8], int warp,
                                      int lane, Epi epi) {
  const int t = lane & 3;
  const int r =
      (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * (t >> 1);
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    uint32_t x[4], y[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = 2 * jj + (w & 1), h = w >> 1;
      x[w] = __float_as_uint(acc[4 * j + 2 * h] + b[j].x);
      y[w] = __float_as_uint(acc[4 * j + 2 * h + 1] + b[j].y);
    }
    quad_transpose(x, t);
    quad_transpose(y, t);
    float v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(x[e]);
      v[2 * e + 1] = __uint_as_float(y[e]);
    }
    epi(r, 8 * (2 * jj + (t & 1)), v);
  }
}

// the consumer threads' generic stores of a phase (to the workspace, and
// to the shared memory the ring reuses), then their arrival on `ready`:
// the producer may then read what they wrote, and write over what they
// read, by TMA
__device__ __forceinline__ void release(uint64_t* ready) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  mbar_arrive(ready);
}

// The LN passes, one consumer warp a row, for the first `rows` rows of the
// tile (C % 8 == 0), in the order of K2's `ln_rows_kernel` (epilogue.cu):
// lane l takes columns 2l + 64i below C, its sum over i, the warp sum, the
// mean as sum / C, the centred squares the same way, and the output
// bf16((s - mu) * rs * g + b), tile row r to row map_row(map, d0 + r) of
// dst. ADD (LN2): s = x + y in fp32, x the tile's rows of the image
// (map_row(img, m0 + r)) and y the tile's (row stride C), written to s32;
// else (LN1): s = s32 + m. Up to 1024 channels a row stays in registers
// between the passes; past them each pass reads it again (s32, and m),
// as K2's kernel does at every width. Without WIDE, C % 64 == 0 and C <=
// 1024.
template <bool ADD, bool WIDE>
__device__ __forceinline__ void ln_rows(const bf16* __restrict__ x,
                                        const RowMap& img,
                                        const bf16* __restrict__ add,
                                        float* s32, int C,
                                        const float* __restrict__ g,
                                        const float* __restrict__ b,
                                        float eps, bf16* dst,
                                        const RowMap& map, int d0, int m0,
                                        int rows, int warp, int lane) {
  const int nv = (C + 63) / 64;
  for (int r = warp; r < rows; r += 8) {
    const bf16* ar = add + (long long)r * C;
    float* sr = s32 + (long long)r * C;
    const bf16* xr = ADD ? x + map_row(img, m0 + r) * C : nullptr;
    bf16* orow = dst + map_row(map, d0 + r) * C;
    if (WIDE && C > 1024) {
      // s (LN2: as pass 1 wrote it) or s + m (LN1) at columns c, c + 1
      const auto row = [&](int c) {
        float2 v = *reinterpret_cast<const float2*>(sr + c);
        if (!ADD) {
          const float2 av = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ar + c));
          v.x += av.x;
          v.y += av.y;
        }
        return v;
      };
      float sum = 0.0f;
      for (int c = lane * 2; c < C; c += 64) {
        float2 v;
        if (ADD) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xr + c));
          const float2 av = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ar + c));
          v = make_float2(xv.x + av.x, xv.y + av.y);
          *reinterpret_cast<float2*>(sr + c) = v;
        } else {
          v = row(c);
        }
        sum += v.x + v.y;
      }
      const float mu = warp_sum(sum) / C;
      float sq = 0.0f;
      for (int c = lane * 2; c < C; c += 64) {
        const float2 v = row(c);
        const float e0 = v.x - mu, e1 = v.y - mu;
        sq += e0 * e0 + e1 * e1;
      }
      const float rs = rsqrtf(warp_sum(sq) / C + eps);
      for (int c = lane * 2; c < C; c += 64) {
        const float2 v = row(c);
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            (v.x - mu) * rs * g[c] + b[c],
            (v.y - mu) * rs * g[c + 1] + b[c + 1]);
      }
      continue;
    }
    float2 v[16];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nv && (!WIDE || lane * 2 + 64 * i < C)) {
        const int c = lane * 2 + 64 * i;
        const float2 av = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ar + c));
        if (ADD) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xr + c));
          v[i] = make_float2(xv.x + av.x, xv.y + av.y);
          *reinterpret_cast<float2*>(sr + c) = v[i];
        } else {
          const float2 sv = *reinterpret_cast<const float2*>(sr + c);
          v[i] = make_float2(sv.x + av.x, sv.y + av.y);
        }
        sum += v[i].x + v[i].y;
      }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nv && (!WIDE || lane * 2 + 64 * i < C)) {
        const float e0 = v[i].x - mu, e1 = v[i].y - mu;
        sq += e0 * e0 + e1 * e1;
      }
    const float rs = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nv && (!WIDE || lane * 2 + 64 * i < C)) {
        const int c = lane * 2 + 64 * i;
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            (v[i].x - mu) * rs * g[c] + b[c],
            (v[i].y - mu) * rs * g[c + 1] + b[c + 1]);
      }
  }
}

// The consumers' half of one product tile of columns n0 .. n0 + 127: the
// k tiles of the ring into acc, each stage released to the producer once
// its products are done; this lane's bias columns (of N) load while the
// last k tile's products run. With `rows_x` a stage may have come by
// cp.async (phase 1's x through the row map): the generic-proxy writes
// are fenced before wgmma reads them.
template <bool WIDE>
__device__ __forceinline__ void consume(float (&acc)[NACC],
                                       float2 (&bias2)[BN / 8],
                                       const float* bias, int n0, int N,
                                       int ktiles, uint64_t* full,
                                       uint64_t* empty, uint32_t a_base,
                                       uint32_t b_base, int& stage,
                                       uint32_t& phase, int lane,
                                       bool rows_x) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  int prev = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&full[stage], phase);
    if (WIDE && rows_x)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mma_ktile(acc, a_base + stage * TILE_A, b_base + stage * TILE_B);
    if (kt == ktiles - 1) load_bias<WIDE>(bias2, bias, n0, N, lane);
    wgmma_wait<1>();  // the previous k tile's products are done
    if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(&empty[prev]);
}

// The producer's half of one product phase: for each of `ntiles` output
// column tiles and each of the MT 128-row product tiles of the tile,
// `ktiles` stages, each a 64 x 128 box of the weight `wmap` at (k, n)
// (zero past N and K) and the A tile. With `amap` null that is x at the
// tile's rows m0 ..: one 4-D box of x a window (`windows` whole windows of
// TN rows, image windows from bw0), or with `p.rows_x` each lane's 4 rows
// of the stage through the window row map by cp.async (zero past `valid`
// rows and past C), as gemm_sm90's GATHER_ROWS copies them. Else the 64 x
// 128 box of the slot's workspace rows from `arow` + 128 mt in `amap`,
// written by the consumers: those wait for `ready` (parity `*ready_par`),
// while the first stages' weight boxes already load, unless `prefetch` is
// false (the attention phase holds the ring's shared memory): then every
// box waits. With `p.rows_x` every lane arrives on each stage's `full`
// barrier (counted 1 + 32). Without WIDE, x always comes by boxes.
template <int MT, bool WIDE>
__device__ __forceinline__ void produce(
    const WholeMaps& maps, const CUtensorMap* wmap, int ntiles, int ktiles,
    const CUtensorMap* amap, int arow, int m0, int valid, int windows,
    int bw0, const WholeParams& p, bf16* sA, bf16* sB, uint64_t* full,
    uint64_t* empty, uint64_t* ready, uint32_t* ready_par, int& stage,
    uint32_t& phase, int lane, bool prefetch = true) {
  const RowMap& m = p.img;
  const int nWw = m.W / m.ws, nWin = (m.H / m.ws) * nWw;
  const bool rows_x = WIDE && p.rows_x;
  const int a_bytes =
      amap ? TILE_A : (rows_x ? 0 : windows * p.TN * BK * 2);
  bool wait = amap != nullptr;
  if (wait && !prefetch) {
    mbar_wait(ready, *ready_par);
    *ready_par ^= 1;
    asm volatile("fence.proxy.async;\n" ::: "memory");
    wait = false;
  }
  int pend_stage[STAGES], pend_k[STAGES], npend = 0;
  for (int nt = 0; nt < ntiles; ++nt)
    for (int mt = 0; mt < MT; ++mt) {
      // this lane's rows of x for the row-map copies
      long long xr[4];
      bool xok[4];
      if (!amap && rows_x) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = mt * TM + lane + 32 * i;
          xok[i] = r < valid;
          xr[i] = xok[i] ? map_row(m, m0 + r) * p.C : 0;
        }
      }
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[stage], TILE_B + a_bytes);
          tma_load(sB + stage * BN * BK, wmap, kt * BK, nt * BN, &full[stage]);
          if (!amap && !rows_x) {
            for (int wl = 0; wl < windows; ++wl) {
              const int bw = bw0 + wl, b = bw / nWin, win = bw % nWin;
              tma_load_4d(sA + stage * BM * BK + wl * p.TN * BK, &maps.x,
                          kt * BK, (win % nWw) * m.ws, (win / nWw) * m.ws,
                          b * m.T, &full[stage]);
            }
          } else if (amap && !wait) {
            tma_load(sA + stage * BM * BK, amap, kt * BK, arow + mt * TM,
                     &full[stage]);
          }
        }
        if (!amap && rows_x) {
          bf16* dst = sA + stage * BM * BK;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = lane + 32 * i;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int k = kt * BK + c * 8;
              const bool ok = xok[i] && k < p.C;
              cp_async16(dst + r * BK + ((c ^ (r & 7)) << 3),
                         p.x + xr[i] + (ok ? k : 0), ok);
            }
          }
        }
        if (rows_x) cp_async_arrive(&full[stage]);
        if (wait) {
          pend_stage[npend] = stage;
          pend_k[npend] = mt * ktiles + kt;
          if (++npend == STAGES ||
              (nt == ntiles - 1 && mt == MT - 1 && kt == ktiles - 1)) {
            mbar_wait(ready, *ready_par);
            *ready_par ^= 1;
            asm volatile("fence.proxy.async;\n" ::: "memory");
            if (lane == 0)
              for (int i = 0; i < npend; ++i) {
                const int pm = MT > 1 ? pend_k[i] / ktiles : 0;
                tma_load(sA + pend_stage[i] * BM * BK, amap,
                         (pend_k[i] - pm * ktiles) * BK, arow + pm * TM,
                         &full[pend_stage[i]]);
              }
            wait = false;
          }
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
}

// NT: the attention core's score registers (16-key tiles); past 128
// tokens (NT 11) a tile is one window over MT = 2 product tiles and the
// attention's 8 warps take further slabs of their pair (SLABS). WIDE: the
// instance for every shape K1 + K2 take (the masks, x by the row map, the
// streamed pair, rows past 1024 channels); without it, the first kernel's
// shapes (C % 128 up to 1024, hidden % 128, TN dividing 128, hd % 16, a
// resident pair) on the first kernel's code: the widened instance's
// spills (ptxas 264-396 bytes of stores against 64-76) cost those shapes
// 4-7 % on the H100 (PERF.md, PR 27).
template <int NT, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
    whole_block_kernel(const __grid_constant__ WholeMaps maps,
                       const WholeParams p) {
  constexpr bool SLABS = NT > 8;
  constexpr int MT = SLABS ? 2 : 1;
  static_assert(WIDE || !SLABS, "past 128 tokens only the wide instance");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + STAGES * TILE_A);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.region);
  uint64_t* empty = full + STAGES;
  uint64_t* ready = empty + STAGES;
  unsigned char* attn_smem = smem;  // the ring's, idle in that phase

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.C, TN = p.TN;
  const int kc = (C + BK - 1) / BK, kh = (p.hidden + BK - 1) / BK;
  const int nc = (C + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // + each producer lane's cp.async where x comes by the row map
      mbar_init(&full[s], WIDE && p.rows_x ? 1 + 32 : 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(ready, CONSUMERS);  // every consumer thread, after its stores
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  // rows a tile and a slot: 128 each but past 128 tokens (WIDE)
  const int tile_rows = WIDE ? p.tile_rows : TM;
  const int slot_row = blockIdx.x * (WIDE ? p.slot_rows : TM);
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > 8) return;
    // ---- producer warp: the ring, phase after phase, tile after tile ----
    uint32_t ready_par = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = t * tile_rows;
      const int valid = p.M - m0 < tile_rows ? p.M - m0 : tile_rows;
      produce<MT, WIDE>(maps, &maps.wqkv, (3 * C + BN - 1) / BN, kc,
                        nullptr, 0, m0, valid, valid / TN, m0 / TN, p, sA,
                        sB, full, empty, ready, &ready_par, stage, phase,
                        lane);
      produce<MT, WIDE>(maps, &maps.wproj, nc, kc, &maps.narrow, slot_row,
                        m0, valid, 0, 0, p, sA, sB, full, empty, ready,
                        &ready_par, stage, phase, lane, false);
      produce<MT, WIDE>(maps, &maps.w1, (p.hidden + BN - 1) / BN, kc,
                        &maps.narrow, slot_row, m0, valid, 0, 0, p, sA, sB,
                        full, empty, ready, &ready_par, stage, phase, lane);
      produce<MT, WIDE>(maps, &maps.w2, nc, kh, &maps.hid, slot_row, m0,
                        valid, 0, 0, p, sA, sB, full, empty, ready,
                        &ready_par, stage, phase, lane);
    }
    return;
  }

  // ---- consumer warpgroups: wg owns rows wg * 64 .. + 63 of each product
  // tile, then the attention and the LN rows ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ct = threadIdx.x;  // 0 .. 255
  const uint32_t a_base = smem_u32(sA) + (warp >> 2) * 64 * BK * 2;
  const uint32_t b_base = smem_u32(sB);
  bf16* wide = p.ws_wide + (long long)slot_row * p.wide;
  bf16* narrow = p.ws_narrow + (long long)slot_row * C;
  float* s32 = p.ws_s + (long long)slot_row * C;
  const RowMap id{0, 1, 1, 1, 1, 0};
  const attn::MappedRows heads_io{wide, narrow, id, TN, p.hd, C};
  const int pt = p.pt, pslot = ct / pt;  // the attention's pairs
  const bool rows_x = WIDE && p.rows_x;
  float acc[NACC];
  float2 bias2[BN / 8];

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int m0 = t * tile_rows;
    // the last tile may hold fewer windows, and past 128 tokens the second
    // product tile holds fewer rows: rows past `valid` are neither stored
    // nor normalised
    const int valid = p.M - m0 < tile_rows ? p.M - m0 : tile_rows;

    // 1. qkv = bf16(x Wqkv + bqkv), (rows, 3C) in window order
    for (int nt = 0; nt < (3 * C + BN - 1) / BN; ++nt)
      for (int mt = 0; mt < MT; ++mt) {
        consume<WIDE>(acc, bias2, p.bqkv, nt * BN, 3 * C, kc, full, empty,
                      a_base, b_base, stage, phase, lane, rows_x);
        rows8(acc, bias2, warp, lane, [&](int r, int c, float(&v)[8]) {
          r += mt * TM;
          if (r >= valid || (WIDE && nt * BN + c >= 3 * C))
            return;
          store8(wide + (long long)r * 3 * C + nt * BN + c, v);
        });
      }
    consumer_sync();

    // 2. attention of each (window, head) of the tile -> (rows, C) bf16
    const int pairs = valid / TN * p.heads;
    if (WIDE && p.streamed) {
      if (pslot < p.group)
        attn::pairs_streamed<NT, attn::MappedRows, SLABS>(
            heads_io, pslot, pairs, p.group, p.heads,
            reinterpret_cast<bf16*>(attn_smem + pslot * p.pair),
            ct - pslot * pt, pt, 2 + pslot, p.bias, nullptr, 0, TN, p.hd,
            p.scale);
      consumer_sync();
    } else {
      for (int p0 = 0; p0 < pairs; p0 += p.group) {
        const int pair = p0 + pslot;
        if (pslot < p.group && pair < pairs)
          attn::pair_core<NT, attn::MappedRows, SLABS>(
              heads_io, pair / p.heads, pair % p.heads,
              attn_smem + pslot * p.pair, ct - pslot * pt, pt, 2 + pslot,
              p.bias, nullptr, 0, TN, p.hd, p.scale);
        consumer_sync();
      }
    }
    release(ready);

    // 3. y = bf16(attn Wproj + bproj), (rows, C) over qkv (no longer read)
    for (int nt = 0; nt < nc; ++nt)
      for (int mt = 0; mt < MT; ++mt) {
        consume<WIDE>(acc, bias2, p.bproj, nt * BN, C, kc, full, empty,
                      a_base, b_base, stage, phase, lane, rows_x);
        rows8(acc, bias2, warp, lane, [&](int r, int c, float(&v)[8]) {
          r += mt * TM;
          if (r >= valid || (WIDE && nt * BN + c >= C))
            return;
          store8(wide + (long long)r * C + nt * BN + c, v);
        });
      }
    consumer_sync();

    // 4. s = x + y in fp32; LN2(s) -> bf16, over the attention output
    ln_rows<true, WIDE>(p.x, p.img, wide, s32, C, p.s2, p.b2, p.eps, narrow,
                        id, 0, m0, valid, warp, lane);
    release(ready);

    // 5. GELU(LN2(s) W1 + b1) -> bf16 (rows, hidden), over qkv
    for (int nt = 0; nt < (p.hidden + BN - 1) / BN; ++nt)
      for (int mt = 0; mt < MT; ++mt) {
        consume<WIDE>(acc, bias2, p.b1, nt * BN, p.hidden, kc, full, empty,
                      a_base, b_base, stage, phase, lane, rows_x);
        rows8(acc, bias2, warp, lane, [&](int r, int c, float(&v)[8]) {
          r += mt * TM;
          if (r >= valid || (WIDE && nt * BN + c >= p.hidden))
            return;
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = activate(v[e], p.act);
          store8(wide + (long long)r * p.wide + nt * BN + c, v);
        });
      }
    release(ready);

    // 6. m = bf16(h W2 + bw2), (rows, C) over LN2(s) (no longer read)
    for (int nt = 0; nt < nc; ++nt)
      for (int mt = 0; mt < MT; ++mt) {
        consume<WIDE>(acc, bias2, p.bw2, nt * BN, C, kh, full, empty,
                      a_base, b_base, stage, phase, lane, rows_x);
        rows8(acc, bias2, warp, lane, [&](int r, int c, float(&v)[8]) {
          r += mt * TM;
          if (r >= valid || (WIDE && nt * BN + c >= C))
            return;
          store8(narrow + (long long)r * C + nt * BN + c, v);
        });
      }
    consumer_sync();

    // 7. out = bf16(LN1(s + m)), back to the image layout
    ln_rows<false, WIDE>(nullptr, p.img, narrow, s32, C, p.s1, p.b1n, p.eps,
                         p.out, p.img, m0, m0, valid, warp, lane);
  }
}

// The kernel with score registers of NT 16-key tiles for windows of TN
// tokens of head_dim hd: launched with `maps` and `p` on `stream`, or with
// `per_sm` the blocks one SM holds written there.
template <int NT, bool WIDE>
cudaError_t run(int TN, int hd, const WholeMaps* maps, const WholeParams* p,
                int grid, cudaStream_t stream, int* per_sm) {
  const Layout L = whole_layout(TN, hd);
  if (L.group < 1) return cudaErrorInvalidValue;
  // once an instance and device: the most a block may use
  static bool allowed[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        whole_block_kernel<NT, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  if (per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, whole_block_kernel<NT, WIDE>, THREADS, L.total);
  whole_block_kernel<NT, WIDE><<<grid, THREADS, L.total, stream>>>(*maps,
                                                                   *p);
  return cudaGetLastError();
}

// The wide instances (swin_block_wide.cu, a translation unit of their own
// so that the two sets build in parallel): run<NT, true> for windows of TN
// tokens, NT 8 up to 128 tokens, MAX_NT past them.
cudaError_t run_wide(int TN, int hd, const WholeMaps* maps,
                     const WholeParams* p, int grid, cudaStream_t stream,
                     int* per_sm);

}  // namespace whole_block
