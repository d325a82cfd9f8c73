// Row 16's fp32 form: the whole W-MSA swin block in ONE launch, fp32,
//   qkv = x Wqkv + bqkv -> window attention -> y = attn Wproj + bproj,
//   s = x + y, out = LN1(s + m), m = fc2(GELU(fc1(LN2(s)))).
//
// Replaces the fp32 instance of the dtype-generic TPU kernel
// stswincl_tpu/ops/pallas_swin_block.py
//   fused_whole_swin_block (:229) -> _whole_kernel (:63), shift 0 only,
// which loads x.dtype, accumulates in fp32 and stores x.dtype: in fp32 its
// roundings (:88, :115, :122, :135, :138, m at :142) are the identity, so
// this kernel computes the fp32 K1 + K2 pair (fp32_forms.cu) in one launch.
// Every product runs on the fp32 GEMM's tile (`f32t::ktile`,
// fp32_gemm.cuh: 3xTF32 on wgmma, each 32-deep k tile summed from zero and
// added to fp32 sums) over the same k tiles as `gemm_f32`, with its
// epilogue arithmetic; the attention is K1's fp32 core (`attn32::pairs`,
// fp32_attention.cuh); the LN passes are K2's fp32 row passes
// (`ln_row_f32`), s = x + y formed in proj's epilogue as K2's first pass
// forms it and fc2 + bias added into s as K2's serving fc2 adds it: so the
// output carries the bits of the fp32 pair. No float atomics: two calls
// give the same bits. The bf16 form (swin_block.cu) runs bf16 operands on
// wgmma; nothing of it is shared here but the sm90 building blocks.
//
// Bound on the H100: the products, 24 R C^2 + 4 R TN C flops for R token
// rows (268 GFLOP at the stage-1 serving shape), every one fp32-accurate
// as 3xTF32 on the tensor cores (164.9 TFLOP/s): at least 1.63 ms; x and
// out are R C * 8 bytes.
//
// Design, simple and right first: persistent blocks of 256 threads (two
// warpgroups), one a workspace slot (`stswin_whole_block_f32_slots` sizes
// them from the occupancy API), each owning a tile of whole windows in
// window order at a time: as many as fit TM = 128 token rows (one stage-1
// window of TN 128, four stage-2 windows of TN 32, two of TN 48), or one
// window of TN 144-176 whose products run over two 128-row tiles (MT = 2),
// the rows past the windows masked. Every phase is row-local or
// window-local, so blocks never wait for each other and one launch covers
// the block call. Each tile runs seven phases through the slot's fp32
// workspace, the block meeting on its barrier between them:
//   1. qkv: A = x read through the window partition's row map (no
//      partitioned copy), ceil(3C / 128) column tiles -> wide (rows x 3C);
//   2. attention of each (window, head) of the tile by the fp32 core, as
//      many pairs at once as the 8 warps (TN / 16 a pair, at most 8) and
//      shared memory hold: one resident pair of 198 KiB of q, k and v at
//      stage 1 (TN 128), two of 98 KiB at stage 2 (TN 32, 4 of the 8
//      warps), each group of warps walking its pairs with the next pair's
//      loads in flight; where the resident pair does not fit, the streamed
//      pair (`attn32::pairs_streamed`, 864 TN bytes); past 128 tokens the
//      8 warps take further 16-row slabs of their pair (the cores' SLABS
//      form, the same bits) -> narrow (rows x C);
//   3. proj, whose epilogue adds x: s = x + (attn Wproj + bproj) -> s;
//   4. LN2(s), a warp a row -> narrow;
//   5. fc1 with the bias and GELU (the erf polynomial) -> wide (rows x
//      hidden, row stride max(3C, hidden));
//   6. fc2 with the bias, added into s;
//   7. LN1(s), a warp a row, scattered back to the image layout.
// A product phase (`product`) is the GEMM tile without the GEMM kernel's
// producer warpgroup: every thread copies its share of each A and Wt k
// tile by cp.async into a four-stage ring in the 128-byte swizzle (zero
// past the tile's rows, past N and past K, as the GEMM's TMA fills them),
// the block splits each landed Wt tile, hi in place and lo beside
// (`f32t::split_b`), and
// each warpgroup runs `ktile` on its 64 rows, then stores 8 consecutive
// columns a lane below N.
// Shared memory holds one phase at a time: the ring (192 KiB + 1 KiB of
// alignment) or the attention pairs' q, k and v (198 KiB at stage 1). The
// slot's workspace is 1.5 MiB at stage 1 and 3 MiB at stage 2 (wide,
// narrow and s in fp32; MT x 128 rows), reused tile after tile. Device
// memory sees x read in phases 1 and 3 and the output written once; the
// pair also writes y and every intermediate of the epilogue for every row,
// and reads them back.

#pragma once

#include "fp32_attention.cuh"
#include "fp32_gemm.cuh"

namespace whole_block_f32 {

using f32t::BK;
using f32t::BN;
using f32t::NACC;
using f32t::STAGE;
using f32t::STAGES;
using f32t::TILE;

constexpr int TM = f32t::BM;  // token rows of one product tile
constexpr int THREADS = 256;  // two warpgroups
constexpr int SMEM_MAX = 232448;  // shared memory one block may use, sm_90
// the product phases' ring: the fp32 GEMM tile's three stages of A and B
// k tiles with their lo halves, 1024-byte aligned
constexpr size_t RING = 1024 + f32t::RING_BYTES;

// The dynamic shared memory of one block: the ring in the product phases,
// `group` attention pairs of `pair` bytes each in the attention phase (as
// many as the block's warps, pt threads a pair, and shared memory hold),
// in the same region. A pair is the resident one where the fp32 core's
// fits a block (`attn32::resident`), else the streamed one.
struct Layout {
  size_t pair, total;
  int group, pt;
  bool streamed;
};

inline Layout whole_layout(int TN, int hd) {
  Layout L;
  L.streamed = !attn32::resident(TN, hd);
  L.pair = L.streamed ? attn32::streamed_bytes(TN) : attn32::smem_bytes(TN, hd);
  L.pt = TN * 2 < THREADS ? TN * 2 : THREADS;
  L.group = THREADS / L.pt;
  while (L.group > 0 && L.group * L.pair > SMEM_MAX) --L.group;
  const size_t pairs = L.group * L.pair;
  L.total = pairs > RING ? pairs : RING;
  return L;
}

struct WholeF32 {
  const float* x;
  const float* wqkv;
  const float* bqkv;
  const float* wproj;
  const float* bproj;
  const float* bias;  // (heads, TN, TN)
  const float* s2;
  const float* b2;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* bw2;
  const float* s1;
  const float* b1n;
  float* out;
  float* ws_wide;    // (slots, slot_rows, wide): qkv (row stride 3C), then h
  float* ws_narrow;  // (slots, slot_rows, C): the attention output, LN2(s)
  float* ws_s;       // (slots, slot_rows, C): s, then s + m
  RowMap img;        // window-order row -> image row (shift 0)
  int M, C, hidden, wide, heads, TN, hd, tiles, act;
  int tile_rows, slot_rows;
  int group, pt, pair_floats;  // attention pairs at once, their threads,
                               // each pair's smem
  int streamed;
  float scale, eps;
};

// One product phase of a 128-row product tile: for each 128-wide column
// tile n0 of N (N % 8 == 0) the tile's sums over K (K % 8 == 0) on the
// fp32 GEMM's k tiles (`f32t::ktile`, as `gemm_f32` sums them, the k tile
// past K zero), then epi(r, n, o) with o[e] = sum + bias[n + e], 8
// consecutive columns below N of tile row r < valid. Every thread loads
// row threadIdx.x / 2 of the A and Wt k tiles (half its 16-byte chunks) by
// cp.async into the swizzled ring; `a_row` is the start of that A row,
// `a_ok` false for a row past `valid` (zero-filled). Each landed Wt tile
// is split by the whole block, then each warpgroup runs its 64 rows.
// Without WIDE, N % 128 == 0 and K % 32 == 0: no mask.
template <bool WIDE, class Epi>
__device__ __forceinline__ void product(float* ring, const float* a_row,
                                        bool a_ok,
                                        const float* __restrict__ Wt, int N,
                                        int K, const float* __restrict__ bias,
                                        int valid, Epi epi) {
  const int tid = threadIdx.x, lr = tid >> 1, c0 = (tid & 1) * 4;
  const int wg = tid >> 7, KT = WIDE ? (K + BK - 1) / BK : K / BK;
  float sum[NACC], d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) d[i] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += BN) {
    __syncthreads();  // the ring's last readers, and the phase before, done
    const bool b_ok = !WIDE || n0 + lr < N;
    const float* b_row = Wt + (long long)(b_ok ? n0 + lr : 0) * K;
    auto load = [&](int s, int kt) {
      float* sa = ring + s * STAGE;
#pragma unroll
      for (int c = c0; c < c0 + 4; ++c) {
        const int at = lr * BK + (((c ^ lr) & 7) << 2);
        const int k = kt * BK + 4 * c;
        if (WIDE) {
          const bool in = k < K;
          cp_async16(sa + at, a_row + (in ? k : 0), a_ok && in);
          cp_async16(sa + TILE + at, b_row + (in ? k : 0), b_ok && in);
        } else {
          cp_async16(sa + at, a_row + k, a_ok);
          cp_async16(sa + TILE + at, b_row + k);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load(s, s);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt) {
      // k tile kt has landed (this thread's copies); after the barrier every
      // thread's have, and every warpgroup is done with the stage refilled
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
      __syncthreads();
      const int next = kt + STAGES - 1;
      if (next < KT) load(next % STAGES, next);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      float* st = ring + (kt % STAGES) * STAGE;
      f32t::split_b(st + TILE, st + 2 * TILE, tid, THREADS);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t sb = smem_u32(st + TILE);
      f32t::ktile(sum, d, st + wg * 64 * BK, sb, sb + TILE * 4);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    f32t::rows8(
        sum, n0,
        [&](int n, float v) { return !WIDE || n < N ? v + bias[n] : v; },
        [&](int row, int n, const float(&o)[8]) {
          const int r = wg * 64 + row;
          if (r < valid && (!WIDE || n < N)) epi(r, n, o);
        });
  }
}

// LayerNorm of the first `valid` rows of s32 (rows of C), a warp a row,
// tile row r to row map_row(map, d0 + r) of dst: K2's fp32 LN pass (any C
// % 4, the row read again for each pass).
__device__ __forceinline__ void ln_rows(const float* s32, int C,
                                        const float* __restrict__ g,
                                        const float* __restrict__ b,
                                        float eps, float* dst,
                                        const RowMap& map, int d0,
                                        int valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < valid; r += THREADS / 32) {
    const float* srow = s32 + (long long)r * C;
    float sum = 0.0f;
    for (int c = lane * 4; c < C; c += 128) sum += sum4(ld4(srow + c));
    ln_row_f32(srow, sum, g, b, dst + map_row(map, d0 + r) * C, C, eps,
               lane);
  }
}

// NT: the fp32 core's 8-key score tiles; past 128 tokens (NT 22) a tile is
// one window over MT = 2 product tiles and the attention's 8 warps take
// further slabs of their pair (SLABS). WIDE: the instance for every shape
// K1 + K2 take (the masks, the streamed pair); without it, the first
// form's shapes (C % 128 up to 1024, hidden % 128, TN dividing 128, hd %
// 32, a resident pair) on the first form's code: with the streamed pair
// beside the resident one the NT 16 instance spilled 596 bytes (64
// before), 6-7 % slower at the stage-1 serving shape (PERF.md, PR 27).
template <int NT, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
    whole_block_f32_kernel(const WholeF32 p) {
  constexpr bool SLABS = NT > 16;
  constexpr int MT = SLABS ? 2 : 1;
  static_assert(WIDE || !SLABS, "past 128 tokens only the wide instance");
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  float* attn_smem = reinterpret_cast<float*>(smem);  // the ring's, idle
  const int tid = threadIdx.x, lr = tid >> 1;
  const int C = p.C, TN = p.TN;
  float* wide = p.ws_wide + (long long)blockIdx.x * p.slot_rows * p.wide;
  float* narrow = p.ws_narrow + (long long)blockIdx.x * p.slot_rows * C;
  float* s32 = p.ws_s + (long long)blockIdx.x * p.slot_rows * C;
  const RowMap id{0, 1, 1, 1, 1, 0};
  const attn32::MappedRows heads_io{wide, narrow, id, TN, p.hd, C};
  const int tile_rows = WIDE ? p.tile_rows : TM;

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int m0 = t * tile_rows;
    // the last tile may hold fewer windows, and past 128 tokens the second
    // product tile holds fewer rows: rows past `valid` are neither loaded
    // nor stored
    const int valid = p.M - m0 < tile_rows ? p.M - m0 : tile_rows;

    // 1. qkv = x Wqkv + bqkv, (rows, 3C) in window order
    for (int mt = 0; mt < MT; ++mt) {
      const int ar = mt * TM + lr;  // the A row this thread copies
      const bool ok = ar < valid;
      const float* x_row =
          p.x + (ok ? map_row(p.img, m0 + ar) : 0) * (long long)C;
      product<WIDE>(
          ring, x_row, ok, p.wqkv, 3 * C, C, p.bqkv, valid - mt * TM,
          [&](int r, int n, const float(&o)[8]) {
            f32t::store8(wide + (long long)(mt * TM + r) * 3 * C + n, o);
          });
    }

    // 2. attention of each (window, head) of the tile -> (rows, C): group
    // gi of pt threads runs pairs gi, gi + group, ... in its own region
    __syncthreads();  // qkv written, the ring's last readers done
    const int pt = p.pt, gi = tid / pt, pairs = valid / TN * p.heads;
    if (gi < p.group) {
      float* base = attn_smem + gi * p.pair_floats;
      if (WIDE && p.streamed)
        attn32::pairs_streamed<NT, attn32::MappedRows, SLABS>(
            heads_io, gi, pairs, p.group, p.heads, base, tid - gi * pt, pt,
            1 + gi, p.bias, nullptr, 0, TN, p.hd, p.scale);
      else
        attn32::pairs<NT, attn32::MappedRows, SLABS>(
            heads_io, gi, pairs, p.group, p.heads, base, tid - gi * pt, pt,
            1 + gi, p.bias, nullptr, 0, TN, p.hd, p.scale);
    }

    // 3. s = x + (attn Wproj + bproj), x read back through the row map
    for (int mt = 0; mt < MT; ++mt) {
      const int ar = mt * TM + lr;
      product<WIDE>(
          ring, narrow + (long long)ar * C, ar < valid, p.wproj, C, C,
          p.bproj, valid - mt * TM, [&](int r, int n, const float(&o)[8]) {
            r += mt * TM;
            float v[8];
            f32t::load8(p.x + map_row(p.img, m0 + r) * C + n, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += o[e];
            f32t::store8(s32 + (long long)r * C + n, v);
          });
    }
    __syncthreads();

    // 4. LN2(s) -> narrow, over the attention output
    ln_rows(s32, C, p.s2, p.b2, p.eps, narrow, id, 0, valid);

    // 5. h = GELU(LN2(s) W1 + b1) -> wide, over qkv
    for (int mt = 0; mt < MT; ++mt) {
      const int ar = mt * TM + lr;
      product<WIDE>(
          ring, narrow + (long long)ar * C, ar < valid, p.w1, p.hidden, C,
          p.b1, valid - mt * TM, [&](int r, int n, const float(&o)[8]) {
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = activate(o[e], p.act);
            f32t::store8(wide + (long long)(mt * TM + r) * p.wide + n, v);
          });
    }

    // 6. s += h W2 + bw2: the fp32 MLP sum, unrounded
    for (int mt = 0; mt < MT; ++mt) {
      const int ar = mt * TM + lr;
      product<WIDE>(
          ring, wide + (long long)ar * p.wide, ar < valid, p.w2, C,
          p.hidden, p.bw2, valid - mt * TM,
          [&](int r, int n, const float(&o)[8]) {
            float* sr = s32 + (long long)(mt * TM + r) * C + n;
            float v[8];
            f32t::load8(sr, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += o[e];
            f32t::store8(sr, v);
          });
    }
    __syncthreads();

    // 7. out = LN1(s + m), back to the image layout
    ln_rows(s32, C, p.s1, p.b1n, p.eps, p.out, p.img, m0, valid);
  }
}

// The kernel with NT 8-key score tiles for windows of TN tokens of
// head_dim hd: launched with `p` on `stream`, or with `per_sm` the blocks
// one SM holds written there.
template <int NT, bool WIDE>
cudaError_t run(int TN, int hd, const WholeF32* p, int grid,
                cudaStream_t stream, int* per_sm) {
  const Layout L = whole_layout(TN, hd);
  if (L.group < 1) return cudaErrorInvalidValue;
  // once an instance and device: the most a block may use
  static bool allowed[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        whole_block_f32_kernel<NT, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  if (per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, whole_block_f32_kernel<NT, WIDE>, THREADS, L.total);
  whole_block_f32_kernel<NT, WIDE><<<grid, THREADS, L.total, stream>>>(*p);
  return cudaGetLastError();
}

// The wide instances (fp32_whole_block_wide.cu, a translation unit of
// their own so that the two sets build in parallel): run<NT, true> for
// windows of TN tokens, NT 16 up to 128 tokens, 22 past them.
cudaError_t run_wide(int TN, int hd, const WholeF32* p, int grid,
                     cudaStream_t stream, int* per_sm);

}  // namespace whole_block_f32
