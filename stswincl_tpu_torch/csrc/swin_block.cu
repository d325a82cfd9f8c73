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
// tile of TM = 128 token rows in window order at a time (one stage-1
// window of TN 128, or four stage-2 windows of TN 32); every step is
// row-local or window-local, so blocks never wait for each other and one
// launch covers the block call. The grid is persistent (one block a
// workspace slot; `stswin_whole_block_slots` sizes them from the occupancy
// API) and each tile runs seven phases:
//   1. qkv on the Hopper GEMM tile (sm90_tile.cuh, the tile of
//      gemm_sm90.cu: wgmma m64n128k16 from a TMA ring of 64-deep k tiles),
//      A = x by one 4-D TMA box a window (the window partition, as K1's
//      qkv product reads it), 3C / 128 output tiles;
//   2. attention of each (window, head) by the register-resident core of
//      K1 (`attn::pair_core`, attention_core.cuh) on the consumer warps,
//      over the slot's qkv, as many pairs at once as its shared memory
//      holds (one at stage 1, four at stage 2);
//   3. proj with the bias -> bf16 y;
//   4. s = x + y (fp32, kept) and LN2(s), one warp a row;
//   5. fc1 with the bias and GELU (the erf polynomial) in the epilogue;
//   6. fc2 with the bias -> bf16 m;
//   7. LN1(s + m), one warp a row, scattered back to the image layout.
// Warp-specialised as gemm_sm90: one producer warp keeps the ring full
// with TMA (weights by 2-D boxes from L2; its warpgroup gives its
// registers to the consumers, which so hold 232 a thread), two consumer
// warpgroups own the 64-row halves of each 128 x 128 output tile and run
// every epilogue from the accumulator registers through the quad
// transpose, then the attention and LN phases. The ring runs on across
// phases and tiles: the producer fetches the next product's weight tiles
// while the consumers finish a phase, but A tiles that the consumers
// write (the attention output, LN2(s), h: generic stores into the slot's
// workspace) only after the consumers' proxy fence and their arrival on
// the `ready` barrier.
// Shared memory holds one phase at a time: the ring (6 stages of 32 KB,
// its depth the bytes each SM keeps in flight from L2) or the attention
// core's q, k and v (105 KB a pair at stage 1, 51 KB at stage 2); the
// producer fills no stage from the end of a tile's qkv product until the
// consumers leave its attention phase.
// Every product sums k in the order of gemm_sm90's (`mma_ktile`, BK 64)
// with the same epilogue arithmetic, the attention is K1's core and the LN
// passes are K2's `ln_rows_kernel` lane for lane (s = x + y formed in the
// LN2 pass, s + m in the LN1 pass), so the output carries the bits of the
// K1 + K2 pair with m rounded (K2's `m_out` form). The epilogues read
// nothing but each lane's 32 bias values, loaded while the last k tile's
// products run: every other load moved to the LN passes (a load in the
// epilogue waits a round trip per column group, and held in registers
// ahead of the stores they spilled).
// What does not fit on chip goes to the slot's workspace, reused tile
// after tile: qkv (TM x 3C), then y (TM x C), then the GELU output (TM x
// hidden, row stride max(3C, hidden)), bf16; the attention output, then
// LN2(s), then m (TM x C bf16); s (TM x C fp32); 0.875 MiB a slot at stage
// 1, 1.75 MiB at stage 2.
// Device memory sees x read by phases 1 and 4 and the output written
// once; the K1 + K2 pair also writes and reads y and every intermediate
// for every row.

#include "attention_core.cuh"
#include "sm90_tile.cuh"

namespace {

using namespace sm90;

constexpr int TM = BM;        // token rows a tile (whole windows)
// two consumer warpgroups and a producer warpgroup, of which one warp
// issues the TMA loads: its registers go to the consumers (`setmaxnreg`)
constexpr int THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGES = 6;
constexpr int RING = STAGES * (TILE_A + TILE_B);
constexpr int BARS = 128;  // full / empty a stage and `ready`, 8 bytes each
constexpr int SMEM_MAX = 232448;  // shared memory one block may use, sm_90

// The dynamic shared memory of one block: 1024 bytes of alignment slack,
// then one region that holds the ring in the product phases and `group`
// attention pairs of `pair` bytes in the attention phase (as many as the
// consumer warps and the shared memory hold), then the barriers.
struct Layout {
  size_t pair, region, total;
  int group;
};

__host__ __device__ inline Layout whole_layout(int TN, int hd) {
  Layout L;
  L.pair = attn::pair_smem(TN, hd).total;
  const size_t room = SMEM_MAX - 1024 - BARS;
  L.group = 256 / (TN / 16 * 32);
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
  bf16* ws_wide;    // (slots, TM, wide) bf16: qkv (stride 3C), y (C), h
  bf16* ws_narrow;  // (slots, TM, C) bf16
  float* ws_s;      // (slots, TM, C) fp32
  RowMap img;       // window-order row -> image row (shift 0)
  int M, C, hidden, wide, heads, TN, hd, tiles, act, group;
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
// t = lane % 4 (a 16-byte aligned fp32 vector, every column below N).
__device__ __forceinline__ void load_bias(float2 (&b)[BN / 8],
                                          const float* bias, int n0,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    b[j] = *reinterpret_cast<const float2*>(bias + n0 + 8 * j +
                                            2 * (lane & 3));
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
// tile (C % 64 == 0, C <= 1024), in the order of K2's `ln_rows_kernel`
// (epilogue.cu): lane l takes columns 2l + 64i, its sum over i, the warp
// sum, the mean as sum / C, the centred squares the same way, and the
// output bf16((s - mu) * rs * g + b), tile row r to row map_row(map, d0 +
// r) of dst. ADD (LN2): s = x + y in fp32, x the tile's rows of the image
// (map_row(img, m0 + r)) and y the tile's (row stride C), written to s32;
// else (LN1): s = s32 + m.
template <bool ADD>
__device__ __forceinline__ void ln_rows(const bf16* __restrict__ x,
                                        const RowMap& img,
                                        const bf16* __restrict__ add,
                                        float* s32, int C,
                                        const float* __restrict__ g,
                                        const float* __restrict__ b,
                                        float eps, bf16* dst,
                                        const RowMap& map, int d0, int m0,
                                        int rows, int warp, int lane) {
  const int nv = C / 64;
  for (int r = warp; r < rows; r += 8) {
    const bf16* ar = add + (long long)r * C;
    float* sr = s32 + (long long)r * C;
    const bf16* xr = ADD ? x + map_row(img, m0 + r) * C : nullptr;
    float2 v[16];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nv) {
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
      if (i < nv) {
        const float e0 = v[i].x - mu, e1 = v[i].y - mu;
        sq += e0 * e0 + e1 * e1;
      }
    const float rs = rsqrtf(warp_sum(sq) / C + eps);
    bf16* orow = dst + map_row(map, d0 + r) * C;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nv) {
        const int c = lane * 2 + 64 * i;
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            (v[i].x - mu) * rs * g[c] + b[c],
            (v[i].y - mu) * rs * g[c + 1] + b[c + 1]);
      }
  }
}

// The consumers' half of one product tile of columns n0 .. n0 + 127: the
// k tiles of the ring into acc, each stage released to the producer once
// its products are done; this lane's bias columns load while the last k
// tile's products run.
__device__ __forceinline__ void consume(float (&acc)[NACC],
                                       float2 (&bias2)[BN / 8],
                                       const float* bias, int n0, int ktiles,
                                       uint64_t* full, uint64_t* empty,
                                       uint32_t a_base, uint32_t b_base,
                                       int& stage, uint32_t& phase,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  int prev = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&full[stage], phase);
    mma_ktile(acc, a_base + stage * TILE_A, b_base + stage * TILE_B);
    if (kt == ktiles - 1) load_bias(bias2, bias, n0, lane);
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

// The producer's half of one product phase: `ntiles` x `ktiles` stages,
// each a 64 x 128 box of the weight `wmap` at (k, n) and the A tile: with
// `amap` null one 4-D box of x a window of the tile (`windows` whole
// windows of TN rows, image windows from bw0), else the 64 x 128 box of
// the slot's workspace rows from `arow` in `amap`, written by the
// consumers: those wait for `ready` (parity `*ready_par`), while the first
// stages' weight boxes already load, unless `prefetch` is false (the
// attention phase holds the ring's shared memory): then every box waits.
__device__ __forceinline__ void produce(
    const WholeMaps& maps, const CUtensorMap* wmap, int ntiles, int ktiles,
    const CUtensorMap* amap, int arow, int windows, int bw0,
    const WholeParams& p, bf16* sA, bf16* sB, uint64_t* full,
    uint64_t* empty, uint64_t* ready, uint32_t* ready_par, int& stage,
    uint32_t& phase, int lane, bool prefetch = true) {
  const RowMap& m = p.img;
  const int nWw = m.W / m.ws, nWin = (m.H / m.ws) * nWw;
  const int a_bytes = amap ? TILE_A : windows * p.TN * BK * 2;
  bool wait = amap != nullptr;
  if (wait && !prefetch) {
    mbar_wait(ready, *ready_par);
    *ready_par ^= 1;
    asm volatile("fence.proxy.async;\n" ::: "memory");
    wait = false;
  }
  int pend_stage[STAGES], pend_k[STAGES], npend = 0;
  for (int nt = 0; nt < ntiles; ++nt)
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[stage], TILE_B + a_bytes);
        tma_load(sB + stage * BN * BK, wmap, kt * BK, nt * BN, &full[stage]);
        if (!amap) {
          for (int wl = 0; wl < windows; ++wl) {
            const int bw = bw0 + wl, b = bw / nWin, win = bw % nWin;
            tma_load_4d(sA + stage * BM * BK + wl * p.TN * BK, &maps.x,
                        kt * BK, (win % nWw) * m.ws, (win / nWw) * m.ws,
                        b * m.T, &full[stage]);
          }
        } else if (!wait) {
          tma_load(sA + stage * BM * BK, amap, kt * BK, arow, &full[stage]);
        }
      }
      if (wait) {
        pend_stage[npend] = stage;
        pend_k[npend] = kt;
        if (++npend == STAGES || (nt == ntiles - 1 && kt == ktiles - 1)) {
          mbar_wait(ready, *ready_par);
          *ready_par ^= 1;
          asm volatile("fence.proxy.async;\n" ::: "memory");
          if (lane == 0)
            for (int i = 0; i < npend; ++i)
              tma_load(sA + pend_stage[i] * BM * BK, amap, pend_k[i] * BK,
                       arow, &full[pend_stage[i]]);
          wait = false;
        }
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    whole_block_kernel(const __grid_constant__ WholeMaps maps,
                       const WholeParams p) {
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
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(ready, 256);  // every consumer thread, after its stores
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  const int slot_row = blockIdx.x * TM;  // the slot's workspace rows
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > 8) return;
    // ---- producer warp: the ring, phase after phase, tile after tile ----
    uint32_t ready_par = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = t * TM;
      const int windows = (p.M - m0 < TM ? p.M - m0 : TM) / TN;
      produce(maps, &maps.wqkv, 3 * C / BN, C / BK, nullptr, 0, windows,
              m0 / TN, p, sA, sB, full, empty, ready, &ready_par, stage,
              phase, lane);
      produce(maps, &maps.wproj, C / BN, C / BK, &maps.narrow, slot_row, 0,
              0, p, sA, sB, full, empty, ready, &ready_par, stage, phase,
              lane, false);
      produce(maps, &maps.w1, p.hidden / BN, C / BK, &maps.narrow, slot_row,
              0, 0, p, sA, sB, full, empty, ready, &ready_par, stage, phase,
              lane);
      produce(maps, &maps.w2, C / BN, p.hidden / BK, &maps.hid, slot_row, 0,
              0, p, sA, sB, full, empty, ready, &ready_par, stage, phase,
              lane);
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
  const int pt = TN / 16 * 32, pslot = ct / pt;  // the attention's pairs
  float acc[NACC];
  float2 bias2[BN / 8];

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int m0 = t * TM;
    // the last tile may hold fewer windows: rows past `valid` are neither
    // stored nor normalised
    const int valid = p.M - m0 < TM ? p.M - m0 : TM;

    // 1. qkv = bf16(x Wqkv + bqkv), (TM, 3C) in window order
    for (int nt = 0; nt < 3 * C / BN; ++nt) {
      consume(acc, bias2, p.bqkv, nt * BN, C / BK, full, empty, a_base,
              b_base, stage, phase, lane);
      rows8(acc, bias2, warp, lane, [&](int r, int c, float(&v)[8]) {
        if (r >= valid) return;
        store8(wide + (long long)r * 3 * C + nt * BN + c, v);
      });
    }
    consumer_sync();

    // 2. attention of each (window, head) of the tile -> (TM, C) bf16
    const int pairs = valid / TN * p.heads;
    for (int p0 = 0; p0 < pairs; p0 += p.group) {
      const int pair = p0 + pslot;
      if (pslot < p.group && pair < pairs)
        attn::pair_core<NT>(heads_io, pair / p.heads, pair % p.heads,
                              attn_smem + pslot * p.pair, ct - pslot * pt,
                              pt, 2 + pslot, p.bias, nullptr, 0, TN, p.hd,
                              p.scale);
      consumer_sync();
    }
    release(ready);

    // 3. y = bf16(attn Wproj + bproj), (TM, C) over qkv (no longer read)
    for (int nt = 0; nt < C / BN; ++nt) {
      consume(acc, bias2, p.bproj, nt * BN, C / BK, full, empty, a_base,
              b_base, stage, phase, lane);
      rows8(acc, bias2, warp, lane, [&](int r, int c, float(&v)[8]) {
        if (r >= valid) return;
        store8(wide + (long long)r * C + nt * BN + c, v);
      });
    }
    consumer_sync();

    // 4. s = x + y in fp32; LN2(s) -> bf16, over the attention output
    ln_rows<true>(p.x, p.img, wide, s32, C, p.s2, p.b2, p.eps, narrow, id, 0,
                  m0, valid, warp, lane);
    release(ready);

    // 5. GELU(LN2(s) W1 + b1) -> bf16 (TM, hidden), over qkv
    for (int nt = 0; nt < p.hidden / BN; ++nt) {
      consume(acc, bias2, p.b1, nt * BN, C / BK, full, empty, a_base, b_base,
              stage, phase, lane);
      rows8(acc, bias2, warp, lane, [&](int r, int c, float(&v)[8]) {
        if (r >= valid) return;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = activate(v[e], p.act);
        store8(wide + (long long)r * p.wide + nt * BN + c, v);
      });
    }
    release(ready);

    // 6. m = bf16(h W2 + bw2), (TM, C) over LN2(s) (no longer read)
    for (int nt = 0; nt < C / BN; ++nt) {
      consume(acc, bias2, p.bw2, nt * BN, p.hidden / BK, full, empty, a_base,
              b_base, stage, phase, lane);
      rows8(acc, bias2, warp, lane, [&](int r, int c, float(&v)[8]) {
        if (r >= valid) return;
        store8(narrow + (long long)r * C + nt * BN + c, v);
      });
    }
    consumer_sync();

    // 7. out = bf16(LN1(s + m)), back to the image layout
    ln_rows<false>(nullptr, p.img, narrow, s32, C, p.s1, p.b1n, p.eps, p.out,
                   p.img, m0, m0, valid, warp, lane);
  }
}

// The kernel with score registers of NT 16-key tiles for windows of TN
// tokens of head_dim hd: launched with `maps` and `p` on `stream`, or with
// `per_sm` the blocks one SM holds written there.
template <int NT>
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
        whole_block_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  if (per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, whole_block_kernel<NT>, THREADS, L.total);
  whole_block_kernel<NT><<<grid, THREADS, L.total, stream>>>(*maps, *p);
  return cudaGetLastError();
}

// run<NT> for windows of TN tokens (TN divides 128)
cudaError_t run_for(int TN, int hd, const WholeMaps* maps,
                    const WholeParams* p, int grid, cudaStream_t stream,
                    int* per_sm) {
  if (TN <= 32) return run<2>(TN, hd, maps, p, grid, stream, per_sm);
  if (TN <= 64) return run<4>(TN, hd, maps, p, grid, stream, per_sm);
  return run<8>(TN, hd, maps, p, grid, stream, per_sm);
}

}  // namespace

// The workspace slots `stswin_whole_block` wants for windows of TN = T *
// ws * ws tokens and head_dim C / heads: the blocks of the kernel the card
// holds at once (SMs times resident blocks an SM), written to `*slots`.
extern "C" int stswin_whole_block_slots(int T, int C, int heads, int ws,
                                        int* slots) {
  if (heads <= 0 || C % heads) return cudaErrorInvalidValue;
  const int TN = T * ws * ws;
  if (TN <= 0 || TN % 16 || TM % TN) return cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err =
      run_for(TN, C / heads, nullptr, nullptr, 0, nullptr, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0 || !sm_count()) return cudaErrorInvalidConfiguration;
  *slots = per_sm * sm_count();
  return cudaSuccess;
}

// The shared memory `stswin_whole_block` launches with for windows of TN
// tokens of head_dim hd: `*total` bytes a block, in which `*group`
// attention pairs share the ring's region (0: no pair fits). No CUDA call.
extern "C" int stswin_whole_block_layout(int TN, int hd, int* group,
                                         long long* total) {
  if (TN <= 0 || TN % 16 || TM % TN || hd <= 0 || hd % 16)
    return cudaErrorInvalidValue;
  const Layout L = whole_layout(TN, hd);
  *group = L.group;
  *total = static_cast<long long>(L.total);
  return cudaSuccess;
}

// x, out: (B, T, H, W, C) bf16, image layout; wqkv (3C, C), wproj (C, C),
// w1 (hidden, C), w2 (C, hidden) bf16 in the torch Linear layout; bqkv,
// bproj, s2, b2, b1, bw2, s1, b1n fp32; bias (heads, TN, TN) fp32, TN =
// T * ws * ws. Workspace of `slots` slots: ws_wide (slots, 128,
// max(3C, hidden)) bf16, ws_narrow (slots, 128, C) bf16, ws_s (slots, 128,
// C) fp32. x, the weights, the fp32 vectors and the workspace 16-byte
// aligned. Takes C % 128 == 0, C <= 1024, hidden % 128 == 0, 128 % TN ==
// 0, head_dim and TN multiples of 16, at least one attention pair beside
// the ring in shared memory, and returns cudaErrorInvalidValue on anything
// else.
extern "C" int stswin_whole_block(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* bias, const void* s2, const void* b2,
    const void* w1, const void* b1, const void* w2, const void* bw2,
    const void* s1, const void* b1n, void* ws_wide, void* ws_narrow,
    void* ws_s, void* out, int B, int T, int H, int W, int C, int hidden,
    int heads, int ws, int slots, int act, float scale, float eps,
    void* stream) {
  WholeParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bproj = static_cast<const float*>(bproj);
  p.bias = static_cast<const float*>(bias);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.b1 = static_cast<const float*>(b1);
  p.bw2 = static_cast<const float*>(bw2);
  p.s1 = static_cast<const float*>(s1);
  p.b1n = static_cast<const float*>(b1n);
  p.ws_wide = static_cast<bf16*>(ws_wide);
  p.ws_narrow = static_cast<bf16*>(ws_narrow);
  p.ws_s = static_cast<float*>(ws_s);
  p.img = RowMap{1, T, H, W, ws, 0};
  p.M = B * T * H * W;
  p.C = C;
  p.hidden = hidden;
  p.wide = 3 * C > hidden ? 3 * C : hidden;
  p.heads = heads;
  p.TN = T * ws * ws;
  p.hd = heads > 0 ? C / heads : 0;
  p.tiles = (p.M + TM - 1) / TM;
  p.act = act;
  p.scale = scale;
  p.eps = eps;
  for (const void* q : {x, wqkv, bqkv, wproj, bproj, s2, b2, w1, b1, w2, bw2,
                        s1, b1n})
    if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorInvalidValue;
  if (C % 128 || C > 1024 || hidden % 128 || heads <= 0 || C % heads ||
      p.hd % 16 || p.TN <= 0 || p.TN % 16 || TM % p.TN || ws <= 0 ||
      H % ws || W % ws || slots <= 0 || p.M <= 0)
    return cudaErrorInvalidValue;
  const Layout L = whole_layout(p.TN, p.hd);
  if (L.group < 1) return cudaErrorInvalidValue;
  p.group = L.group;
  p.pair = L.pair;
  p.region = L.region;
  WholeMaps maps;
  const int grid = p.tiles < slots ? p.tiles : slots;
  if (!encode_boxes(&maps.x, p.x, p.M, C, C, H, W, ws, ws, T) ||
      !encode(&maps.narrow, p.ws_narrow, grid * TM, C, C, BM) ||
      !encode(&maps.hid, p.ws_wide, grid * TM, hidden, p.wide, BM) ||
      !encode(&maps.wqkv, static_cast<const bf16*>(wqkv), 3 * C, C, C, BN) ||
      !encode(&maps.wproj, static_cast<const bf16*>(wproj), C, C, C, BN) ||
      !encode(&maps.w1, static_cast<const bf16*>(w1), hidden, C, C, BN) ||
      !encode(&maps.w2, static_cast<const bf16*>(w2), C, hidden, hidden, BN))
    return cudaErrorInvalidValue;
  return run_for(p.TN, p.hd, &maps, &p, grid,
                 static_cast<cudaStream_t>(stream), nullptr);
}
