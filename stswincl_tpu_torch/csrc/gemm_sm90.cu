// The Hopper GEMMs of K1-K3, K5 and K6, and of the conv (row 17, its
// EPI_CONV form: conv.cu says how the image arrives): wgmma on TMA-fed,
// 128-byte-swizzled shared memory, warp-specialised.
//
// Replaces (with the kernels that call it): the matmuls of
//   stswincl_tpu/ops/pallas_block_attention.py _full_kernel (:179), the qkv
//   and proj products of K1, and _full_bwd_kernel (:405), K5's input- and
//   weight-gradient products; of
//   stswincl_tpu/ops/pallas_add_ln_mlp.py _epilogue_kernel (:704) /
//   _epi_shifted_kernel (:940) / _epilogue_kernel_with_m (:752), fc1 and fc2
//   of K2, and _epi_bwd_kernel (:181) / _epi_bwd_slice_kernel (:425), K6's
//   fc1 recompute, dh, dn2 and weight gradients. The TPU ran them on its
//   128 x 128 matrix unit out of VMEM blocks.
//
// Bound on the H100: at the swin shapes (M = 10^4..10^5 token rows, N and K
// 512..4096) the products are bound by the tensor cores (989 TFLOP/s bf16
// dense), far above the 295 flops a byte where device memory would bound
// them. The port's first GEMM (wmma fragments on mma.sync, loaded by every
// thread, a two-stage cp.async ring) reached 8-22 % of that peak. Design,
// for the rate (the building blocks in sm90_tile.cuh, which the
// whole-block kernel of swin_block.cu shares):
//   - wgmma.mma_async m64n128k16 bf16 -> fp32: two consumer warpgroups own
//     the 64-row halves of a 128 x 128 output tile, with both operands
//     read by the tensor cores straight from shared memory through
//     descriptors (128-byte swizzle, K-major: A rows and the torch Linear
//     weight rows both have K contiguous);
//   - a ring of k tiles of 64 (128 bytes: one swizzle span), filled by one
//     producer warp with TMA (cp.async.bulk.tensor, zero fill past M, N
//     and K), completion counted on a `full` mbarrier per stage and
//     release on an `empty` one;
//   - persistent: a grid of at most two blocks an SM walks the tiles, and
//     the producer runs ahead into the next tile while the consumers store
//     the last; two blocks an SM also overlap one's epilogue with the
//     other's main loop.
// A gathered A (K1's qkv product reads x through the window partition and
// the SW-MSA cyclic shift, K5's dattn product g through the window
// partition): TMA on sm_90 copies boxes, not row lists. A window is a (ws x
// ws x T) box of the (BT, H, W, C) image, its rows in window order, so
// where a 128-row tile holds whole windows (TN divides 128 and is a
// multiple of 8, each box 1024-byte aligned: both stages) the producer
// issues one 4-D TMA box per window. The shift wraps the last window row
// and column round the image edge, which no box can follow: a tile holding
// such a window, and any other row map, goes by cp.async instead, each lane
// copying rows into the same swizzled layout (16-byte chunk c of row r at
// chunk c ^ (r % 8)) and its copies counted on the stage's `full` barrier
// (cp.async.mbarrier.arrive.noinc). Wt always comes by TMA.
// Two blocks an SM, one's epilogue under the other's main loop, measured
// faster than a wider tile or a deeper ring at one block an SM.
// The epilogue works from the accumulator registers: bias, the GELU of
// `activate` (erf polynomial or tanh), then a transpose within each quad
// of lanes so that a lane holds 8 consecutive columns of one row, stored
// whole: bf16, or fp32 (the residual add), each row through the C row map
// (K1's proj and K5's dx scatter back to the image layout). Stores of 4 and
// 8 bytes straight from the accumulator layout took about 40 % of the time.
//
// EPI_GELU_BWD (K6 with the saved m, Pallas row 9): two products over one
// 128 x 128 tile of (token rows, hidden columns), pre = n2 @ w1^T + b1 and
// dh = dm @ w2 (through the transposed copy of w2, so both are K-major),
// accumulated by the same warpgroups in two register sets, 64 + 64 fp32 a
// thread; one block an SM (__launch_bounds__(288, 1) leaves the consumers
// up to 224 registers) and a deeper ring. The epilogue evaluates the erf
// polynomial once (`gelu_and_grad`) and writes h = bf16(gelu(pre)) where
// asked, dpre = bf16(dh * gelu'(pre)) and the fp32 column sums of dh *
// gelu'(pre) (db1): gelu' never leaves the registers, where it used to
// cross device memory as a (rows, hidden) fp32 tensor, written once and
// read once: at stage 2 on an H100 SXM the pair took 1.955 ms against
// 2.040 for gelu' through memory (tools/profile_gemm.py). K6 with m
// recomputed (row 7) needs h for m before dm exists, so its fc1 runs ahead
// and writes gelu' (EPI_GELU_GRAD) for dh's epilogue to read (EPI_DGELU):
// running fc1 again in the pair measured slower (3.639 against 3.061 ms).
//
// The weight gradients (`wgrad_sm90_kernel`): Cw[m, n] = sum_r A[a_map(r),
// m] B[b_map(r), n] over the 10^4..10^5 token rows r. r is the reduction
// index and m, n are the contiguous ones, so both operands sit MN-major in
// shared memory: the TMA box is (64 columns, 64 rows) of the row-major
// activation, 128-byte swizzled, and wgmma reads it through its transpose
// bits (imm-trans-a = imm-trans-b = 1) with an MN-major descriptor (8-row
// k groups 1024 bytes apart, 64-column halves one box apart): no
// transposed copy of an activation is formed. Where a row map gathers the
// rows (K5: x through the shifted window partition for dwqkv, g through
// the window partition for dwproj), a 64-row k tile is one frame of a
// window at stage 1 (a (64, 8, 8, 1) box of the image) or two whole
// windows at stage 2 ((64, 4, 4, 2) boxes); tiles a shifted window wraps,
// and other maps, go by cp.async into the same swizzle. The output is only
// 16-256 tiles of 128 x 128, so the reduction is split over blocks until
// two blocks an SM are in flight (5 splits for dwqkv at stage 1: 240
// blocks). The splits' fp32 partials meet in 16-byte vector reductions
// (`red_add_f32x4`) straight from the accumulator registers, after the
// quad transpose: 16 a thread, against 8 x 256 scalar atomics a warp
// before. A per-split workspace and a second pass would give the same sum
// in a fixed order, but cost a workspace of splits x M x N fp32 and a
// launch; the reductions need neither, and their order (so the last bits
// of the sum) varies from run to run, as before.

#include <atomic>
#include <cstdint>

#include "gemm_sm90.cuh"
#include "sm90_tile.cuh"

namespace {

// Launches since the last reset, counted on the host where each kernel is
// launched: slot `epi` for gemm_sm90, slot W_SLOT for the weight-gradient
// GEMM. K1-K3, K5 and K6 launch these from their C entries, where no
// Python wrapper sees them; `stswin_gemm_sm90_launches` reads the counts.
constexpr int W_SLOT = EPI_CONV + 1;
std::atomic<long long> launch_counts[W_SLOT + 1];

using namespace sm90;

constexpr int THREADS = 288;  // two consumer warpgroups + one producer warp
constexpr int COLBUF = 8 * BN * 4;  // a consumer warp's column sums

template <int EPI>
struct Cfg {
  static constexpr bool DUAL = EPI == EPI_GELU_BWD;
  static constexpr int STAGES = DUAL ? 5 : 3;
  static constexpr int BLOCKS = DUAL ? 1 : 2;  // an SM
  static constexpr int SMEM =
      STAGES * (TILE_A + TILE_B) + 2 * STAGES * 8 + COLBUF + 1024;
};

// cs[par][e]: this lane's sum over its two rows of column 8 (2 jj + par) +
// 2 t + e of the warp's 16 x BN block; summed over the warp's 8 row
// groups and kept in the warp's slot of the column-sum buffer
__device__ __forceinline__ void colsum_warp(float (&cs)[2][2], float* cb,
                                            int jj, int lane) {
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        cs[par][e] += __shfl_xor_sync(0xffffffffu, cs[par][e], o);
      if (lane < 4) cb[8 * (2 * jj + par) + 2 * lane + e] = cs[par][e];
    }
}

// the 8 consumer warps' column sums of the tile into colsum[n0 ..)
__device__ __forceinline__ void colsum_flush(const float* colbuf,
                                             float* colsum, int n0, int N) {
  consumer_sync();
  const int c = threadIdx.x;
  if (c < BN && n0 + c < N) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += colbuf[w * BN + c];
    atomicAdd(colsum + n0 + c, s);
  }
  consumer_sync();
}

// EPI_CONV: the patch of output tile row m0 (image img, top-left pixel
// (h0, w0)), and whether tap `tap`'s box over it reaches into the image: a
// box wholly in the zero padding adds nothing to the product, so neither
// the producer nor the consumers spend a stage on it.
__device__ __forceinline__ void conv_patch(const ConvGeom& g, int m0, int& img,
                                           int& h0, int& w0) {
  const int pt = m0 / BM, per = g.ph * g.pw;
  img = pt / per;
  const int q = pt - img * per, row = q / g.pw;
  h0 = row * g.bh;
  w0 = (q - row * g.pw) * g.bw;
}
__device__ __forceinline__ bool conv_tap_live(const ConvGeom& g, int tap,
                                              int h0, int w0) {
  const int y = h0 + (tap / 3 - 1) * g.d, x = w0 + (tap % 3 - 1) * g.d;
  return y < g.H && y + g.bh > 0 && x < g.W && x + g.bw > 0;
}

// How A arrives: one 2-D TMA box a stage (the identity row map); through
// the row map by cp.async; or, where the tile's rows are whole windows
// (TN a multiple of 8 dividing 128), a TMA box per window of the 4-D
// image, the tiles whose windows the shift wraps by cp.async.
enum Gather { GATHER_NONE = 0, GATHER_ROWS = 1, GATHER_WINDOWS = 2 };

struct Maps {
  CUtensorMap a, b;    // a: 2-D rows, 4-D image (GATHER_WINDOWS,
                       // EPI_CONV), or unused
  CUtensorMap a2, b2;  // EPI_GELU_BWD's second product
};

template <int EPI>
__global__ void __launch_bounds__(THREADS, Cfg<EPI>::BLOCKS)
    gemm_sm90_kernel(const __grid_constant__ Maps maps, const GemmParams p,
                     int gather) {
  constexpr bool DUAL = Cfg<EPI>::DUAL;
  constexpr bool CONV = EPI == EPI_CONV;
  constexpr int STAGES = Cfg<EPI>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + STAGES * TILE_A);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * (TILE_A + TILE_B));
  uint64_t* empty = full + STAGES;
  float* colbuf = reinterpret_cast<float*>(empty + STAGES);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * tiles_n;
  const int KT = (p.K + BK - 1) / BK;
  const int KTT = DUAL ? 2 * KT : KT;  // k tiles a tile, both products

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], gather ? 1 + 32 : 1);  // + each lane's cp.async
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer warp: fill the ring, tile after tile ----
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      if (CONV) {
        // one 4-D box (64 channels, bw, bh, 1) of the image a live tap and
        // channel block, at the tap's offset: TMA zero-fills what lies
        // outside the image (the conv's padding, any dilation) and the
        // channels past Cin
        const ConvGeom& g = p.conv;
        int img, h0, w0;
        conv_patch(g, m0, img, h0, w0);
        for (int kt = 0; kt < KTT; ++kt) {
          const int tap = kt / g.cb;
          if (!conv_tap_live(g, tap, h0, w0)) continue;
          mbar_wait(&empty[stage], phase ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&full[stage], TILE_A + TILE_B);
            tma_load(sB + stage * BN * BK, &maps.b, kt * BK, n0, &full[stage]);
            tma_load_4d(sA + stage * BM * BK, &maps.a, (kt - tap * g.cb) * BK,
                        w0 + (tap % 3 - 1) * g.d, h0 + (tap / 3 - 1) * g.d,
                        img, &full[stage]);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        continue;
      }
      long long arow[4];
      bool aok[4];
      // GATHER_WINDOWS: the tile's rows are whole windows (TN divides BM);
      // each window is one (ws x ws x T) TMA box of the image unless the
      // cyclic shift wraps it round the image edge
      const RowMap& wm = p.a_map;
      const int TN = wm.T * wm.ws * wm.ws;
      const int nWw = wm.W / max(wm.ws, 1), nWin = (wm.H / max(wm.ws, 1)) * nWw;
      int windows = 0;  // whole windows of the tile below M, by TMA
      if (gather == GATHER_WINDOWS) {
        windows = min(BM, p.M - m0) / TN;
        for (int wl = 0; wl < windows; ++wl) {
          const int win = (m0 / TN + wl) % nWin;
          if ((win / nWw) * wm.ws + wm.shift + wm.ws > wm.H ||
              (win % nWw) * wm.ws + wm.shift + wm.ws > wm.W)
            windows = 0;  // a wrapped window: the tile goes by cp.async
        }
      }
      if (gather && !windows) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + lane + 32 * i;
          aok[i] = m < p.M;
          arow[i] = aok[i] ? map_row(p.a_map, m) * p.lda : 0;
        }
      }
      for (int kt = 0; kt < KTT; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        const bool second = DUAL && kt >= KT;
        const int k0 = (second ? kt - KT : kt) * BK;
        if (lane == 0) {
          mbar_expect_tx(&full[stage],
                         TILE_B + (!gather ? TILE_A : windows * TN * BK * 2));
          tma_load(sB + stage * BN * BK, second ? &maps.b2 : &maps.b, k0, n0,
                   &full[stage]);
          if (!gather)
            tma_load(sA + stage * BM * BK, second ? &maps.a2 : &maps.a, k0,
                     m0, &full[stage]);
          for (int wl = 0; wl < windows; ++wl) {
            const int bw = m0 / TN + wl, b = bw / nWin, win = bw % nWin;
            tma_load_4d(sA + stage * BM * BK + wl * TN * BK, &maps.a, k0,
                        (win % nWw) * wm.ws + wm.shift,
                        (win / nWw) * wm.ws + wm.shift, b * wm.T,
                        &full[stage]);
          }
        }
        if (gather && !windows) {
          bf16* dst = sA + stage * BM * BK;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = lane + 32 * i;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int k = k0 + c * 8;
              const bool ok = aok[i] && k < p.K;
              cp_async16(dst + r * BK + ((c ^ (r & 7)) << 3),
                         p.A + arow[i] + (ok ? k : 0), ok);
            }
          }
        }
        if (gather) cp_async_arrive(&full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns rows wg * 64 .. + 63 of the tile ----
  const int wg = warp >> 2;
  const uint32_t a_base = smem_u32(sA) + wg * 64 * BK * 2;
  const uint32_t b_base = smem_u32(sB);
  int stage = 0;
  uint32_t phase = 0;
  float acc[NACC], acc2[NACC];  // acc2: EPI_GELU_BWD's dh
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    int img = 0, h0 = 0, w0 = 0;
    if (CONV) conv_patch(p.conv, m0, img, h0, w0);
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      acc[i] = 0.0f;
      if (DUAL) acc2[i] = 0.0f;
    }
    int prev = 0, done = 0;
    for (int kt = 0; kt < KTT; ++kt) {
      if (CONV && !conv_tap_live(p.conv, kt / p.conv.cb, h0, w0)) continue;
      mbar_wait(&full[stage], phase);
      // cp.async wrote A through the generic proxy; wgmma reads through
      // the async proxy
      if (gather) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t sa = a_base + stage * TILE_A, sb = b_base + stage * TILE_B;
      if (DUAL && kt >= KT)
        mma_ktile(acc2, sa, sb);
      else
        mma_ktile(acc, sa, sb);
      wgmma_wait<1>();  // the previous k tile's products are done
      if (done++ > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (DUAL) fence_acc(acc2);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: acc[4j + 2h + e] is row (warp % 4) * 16 + lane / 4 + 8h,
    // column 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN block. For
    // each pair of 8-column blocks (2jj, 2jj + 1) the quad of lanes holds
    // four words a lane (w: block 2jj + (w & 1), row half w >> 1, two
    // columns); a transpose within the quad leaves lane t with word t of
    // every lane: 8 consecutive columns of one row, stored whole (16 bytes
    // of bf16, 32 of fp32) rather than in 4- or 8-byte pieces
    const int t = lane & 3;
    const int r0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    long long orow[2];
    bool rok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (CONV) {  // tile row r is pixel (h0 + r / bw, w0 + r % bw)
        const int r = r0 - m0 + 8 * h;
        const int y = h0 + r / p.conv.bw, x = w0 + r % p.conv.bw;
        rok[h] = y < p.conv.H && x < p.conv.W;
        orow[h] = rok[h] ? ((long long)(img * p.conv.H + y) * p.conv.W + x) *
                               p.ldc
                         : 0;
      } else {
        rok[h] = r0 + 8 * h < p.M;
        orow[h] = rok[h] ? map_row(p.c_map, r0 + 8 * h) * p.ldc : 0;
      }
    }
    const long long my_row = (t >> 1) ? orow[1] : orow[0];
    const bool my_rok = (t >> 1) ? rok[1] : rok[0];
    float* cb = colbuf + warp * BN;
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      float v[4][2];  // word w of this lane, before the transpose
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = 2 * jj + (w & 1), h = w >> 1;
        const int n = n0 + 8 * j + 2 * t;
        const float2 b = p.bias && n < p.N
                             ? *reinterpret_cast<const float2*>(p.bias + n)
                             : make_float2(0.0f, 0.0f);
        if (CONV) {  // the folded BatchNorm: sum * scale + shift
          const float2 sc =
              n < p.N ? *reinterpret_cast<const float2*>(p.conv.scale + n)
                      : make_float2(0.0f, 0.0f);
          v[w][0] = acc[4 * j + 2 * h] * sc.x + b.x;
          v[w][1] = acc[4 * j + 2 * h + 1] * sc.y + b.y;
        } else {
          v[w][0] = acc[4 * j + 2 * h] + b.x;
          v[w][1] = acc[4 * j + 2 * h + 1] + b.y;
        }
      }
      const int n = n0 + 8 * (2 * jj + (t & 1));  // this lane's 8 columns
      const bool ok = my_rok && n < p.N;
      if (EPI == EPI_BF16) {
        uint32_t word[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          word[w] = pack_bf16(activate(v[w][0], p.act),
                                activate(v[w][1], p.act));
        quad_transpose(word, t);
        if (ok)
          *reinterpret_cast<uint4*>(p.C + my_row + n) =
              make_uint4(word[0], word[1], word[2], word[3]);
      } else if (EPI == EPI_GELU_GRAD) {
        uint32_t word[4], x[4], y[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 g0 = gelu_and_grad(v[w][0], p.act);
          const float2 g1 = gelu_and_grad(v[w][1], p.act);
          word[w] = pack_bf16(g0.x, g1.x);
          x[w] = __float_as_uint(g0.y);
          y[w] = __float_as_uint(g1.y);
        }
        quad_transpose(word, t);
        quad_transpose(x, t);
        quad_transpose(y, t);
        if (ok) {
          *reinterpret_cast<uint4*>(p.C + my_row + n) =
              make_uint4(word[0], word[1], word[2], word[3]);
          float4* dst = reinterpret_cast<float4*>(p.Cf + my_row + n);
          dst[0] = make_float4(__uint_as_float(x[0]), __uint_as_float(y[0]),
                               __uint_as_float(x[1]), __uint_as_float(y[1]));
          dst[1] = make_float4(__uint_as_float(x[2]), __uint_as_float(y[2]),
                               __uint_as_float(x[3]), __uint_as_float(y[3]));
        }
      } else if (EPI == EPI_DGELU || EPI == EPI_GELU_BWD) {
        // d = dh * gelu'(pre): gelu' from aux (EPI_DGELU) or from the
        // registers; rows past M and columns past N add nothing to colsum
        uint32_t word[4], hw[4];
        float cs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = 2 * jj + (w & 1), h = w >> 1;
          const int nn = n0 + 8 * j + 2 * t;
          const bool live = rok[h] && nn < p.N;
          float d[2];
          if (EPI == EPI_DGELU) {
            const float2 a =
                live ? *reinterpret_cast<const float2*>(p.aux + orow[h] + nn)
                     : make_float2(0.0f, 0.0f);
            d[0] = v[w][0] * a.x;
            d[1] = v[w][1] * a.y;
          } else {
            const float2 g0 = gelu_and_grad(v[w][0], p.act);
            const float2 g1 = gelu_and_grad(v[w][1], p.act);
            hw[w] = pack_bf16(g0.x, g1.x);
            d[0] = live ? acc2[4 * j + 2 * h] * g0.y : 0.0f;
            d[1] = live ? acc2[4 * j + 2 * h + 1] * g1.y : 0.0f;
          }
          word[w] = pack_bf16(d[0], d[1]);
          cs[w & 1][0] += d[0];
          cs[w & 1][1] += d[1];
        }
        colsum_warp(cs, cb, jj, lane);
        quad_transpose(word, t);
        if (ok)
          *reinterpret_cast<uint4*>(p.C + my_row + n) =
              make_uint4(word[0], word[1], word[2], word[3]);
        if (EPI == EPI_GELU_BWD && p.C2) {
          quad_transpose(hw, t);
          if (ok)
            *reinterpret_cast<uint4*>(p.C2 + my_row + n) =
                make_uint4(hw[0], hw[1], hw[2], hw[3]);
        }
      } else if (EPI == EPI_CONV) {
        // transposed in fp32, so that the residual is added before the
        // one rounding to bf16, as the twin does
        uint32_t x[4], y[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          x[w] = __float_as_uint(v[w][0]);
          y[w] = __float_as_uint(v[w][1]);
        }
        quad_transpose(x, t);
        quad_transpose(y, t);
        if (ok) {
          float o[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[2 * e] = __uint_as_float(x[e]);
            o[2 * e + 1] = __uint_as_float(y[e]);
          }
          if (p.conv.res) {
            __align__(16) bf16 rv[8];
            *reinterpret_cast<uint4*>(rv) =
                *reinterpret_cast<const uint4*>(p.conv.res + my_row + n);
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] += __bfloat162float(rv[e]);
          }
          uint32_t word[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            word[e] = p.conv.relu ? pack_bf16(fmaxf(o[2 * e], 0.0f),
                                              fmaxf(o[2 * e + 1], 0.0f))
                                  : pack_bf16(o[2 * e], o[2 * e + 1]);
          *reinterpret_cast<uint4*>(p.C + my_row + n) =
              make_uint4(word[0], word[1], word[2], word[3]);
        }
      } else {
        uint32_t x[4], y[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          x[w] = __float_as_uint(v[w][0]);
          y[w] = __float_as_uint(v[w][1]);
        }
        quad_transpose(x, t);
        quad_transpose(y, t);
        if (ok) {
          float4* dst = reinterpret_cast<float4*>(p.Cf + my_row + n);
          float4 lo = make_float4(__uint_as_float(x[0]), __uint_as_float(y[0]),
                                  __uint_as_float(x[1]), __uint_as_float(y[1]));
          float4 hi = make_float4(__uint_as_float(x[2]), __uint_as_float(y[2]),
                                  __uint_as_float(x[3]), __uint_as_float(y[3]));
          if (EPI == EPI_RESID_F32) {
            const float4 s0 = dst[0], s1 = dst[1];
            lo.x += s0.x; lo.y += s0.y; lo.z += s0.z; lo.w += s0.w;
            hi.x += s1.x; hi.y += s1.y; hi.z += s1.z; hi.w += s1.w;
          }
          dst[0] = lo;
          dst[1] = hi;
        }
      }
    }
    if (EPI == EPI_DGELU || EPI == EPI_GELU_BWD)
      colsum_flush(colbuf, p.colsum, n0, p.N);
  }
}

// ---- the weight-gradient GEMM ----------------------------------------------

constexpr int W_STAGES = 3;  // 32 KB a stage: two blocks an SM
constexpr int W_SMEM = W_STAGES * (TILE_A + TILE_B) + 2 * W_STAGES * 8 + 1024;
constexpr int W_HALF = 64 * BK;  // bf16 of one 64-column half of a stage

// How an operand's 64-row k tile arrives: two 2-D TMA boxes (the identity
// row map); 4-D TMA boxes of whole windows or frames of one window; or
// cp.async through the row map (any other map, a tile a shifted window
// wraps, the ragged last tile of a gathered operand).
enum Load { LOAD_TMA = 0, LOAD_WINDOWS = 1, LOAD_ROWS = 2 };

struct Operand {
  const bf16* p;
  long long ld;
  RowMap map;
  int load, box_rows;  // LOAD_WINDOWS: rows of one box
};

struct WgradMaps {
  CUtensorMap a, b;
};

// Whether the k tile at row r0 goes by window boxes: below R, and no box
// wrapped by the shift.
__device__ __forceinline__ bool boxes_fit(const Operand& o, int r0, int R) {
  if (o.load != LOAD_WINDOWS || r0 + BK > R) return false;
  const RowMap& m = o.map;
  const int TN = m.T * m.ws * m.ws;
  const int nWw = m.W / m.ws, nWin = (m.H / m.ws) * nWw;
  for (int i = 0; i < BK / o.box_rows; ++i) {
    const int win = ((r0 + i * o.box_rows) / TN) % nWin;
    if ((win / nWw) * m.ws + m.shift + m.ws > m.H ||
        (win % nWw) * m.ws + m.shift + m.ws > m.W)
      return false;
  }
  return true;
}

// Lane 0: the TMA boxes of one operand's k tile (columns col0 .. + 127,
// rows r0 .. + 63) into dst, two 64-column halves W_HALF apart.
__device__ __forceinline__ void load_boxes(const Operand& o,
                                           const CUtensorMap* map, bf16* dst,
                                           int col0, int r0, uint64_t* bar) {
  if (o.load == LOAD_TMA) {
    for (int half = 0; half < 2; ++half)
      tma_load(dst + half * W_HALF, map, col0 + 64 * half, r0, bar);
    return;
  }
  const RowMap& m = o.map;
  const int N = m.ws * m.ws, TN = m.T * N;
  const int nWw = m.W / m.ws, nWin = (m.H / m.ws) * nWw;
  for (int i = 0; i < BK / o.box_rows; ++i) {
    const int r = r0 + i * o.box_rows, bw = r / TN;
    const int b = bw / nWin, win = bw % nWin, f = (r - bw * TN) / N;
    for (int half = 0; half < 2; ++half)
      tma_load_4d(dst + half * W_HALF + i * o.box_rows * 64, map,
                  col0 + 64 * half, (win % nWw) * m.ws + m.shift,
                  (win / nWw) * m.ws + m.shift, b * m.T + f, bar);
  }
}

// Every lane: the k tile's 64 rows x 16 chunks through the row map by
// cp.async, into the layout TMA's 128-byte swizzle gives (rows past R
// zero-filled).
__device__ __forceinline__ void load_rows(const Operand& o, bf16* dst,
                                          int col0, int r0, int R,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i, row = r0 + r;
    const bool ok = row < R;
    const bf16* src = o.p + (ok ? map_row(o.map, row) : 0) * o.ld + col0;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int half = c >> 3, cc = c & 7;
      cp_async16(dst + half * W_HALF + r * 64 + ((cc ^ (r & 7)) << 3),
                 src + c * 8, ok);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    wgrad_sm90_kernel(const __grid_constant__ WgradMaps maps,
                      const Operand oa, const Operand ob, int R, int N,
                      float* __restrict__ Cw, long long ldc,
                      int kt_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + W_STAGES * TILE_A);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + W_STAGES * (TILE_A + TILE_B));
  uint64_t* empty = full + W_STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_n = N / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int KT = (R + BK - 1) / BK;
  const int kt0 = blockIdx.y * kt_per_split;
  const int kt1 = min(KT, kt0 + kt_per_split);
  const bool rows = oa.load != LOAD_TMA || ob.load != LOAD_TMA;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], rows ? 1 + 32 : 1);  // + each lane's cp.async
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer warp ----
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      const int r0 = kt * BK;
      const bool a_box = oa.load == LOAD_TMA || boxes_fit(oa, r0, R);
      const bool b_box = ob.load == LOAD_TMA || boxes_fit(ob, r0, R);
      bf16* da = sA + stage * (TILE_A / 2);
      bf16* db = sB + stage * (TILE_B / 2);
      if (lane == 0) {
        mbar_expect_tx(&full[stage], (a_box ? TILE_A : 0) + (b_box ? TILE_B : 0));
        if (a_box) load_boxes(oa, &maps.a, da, m0, r0, &full[stage]);
        if (b_box) load_boxes(ob, &maps.b, db, n0, r0, &full[stage]);
      }
      if (!a_box) load_rows(oa, da, m0, r0, R, lane);
      if (!b_box) load_rows(ob, db, n0, r0, R, lane);
      if (rows) cp_async_arrive(&full[stage]);
      if (++stage == W_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns output rows m0 + wg * 64 .. + 63,
  // the 64-column half wg of the A tile ----
  const int wg = warp >> 2;
  const uint32_t a_base = smem_u32(sA) + wg * W_HALF * 2;
  const uint32_t b_base = smem_u32(sB);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    mbar_wait(&full[stage], phase);
    if (rows) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    fence_acc(acc);
    wgmma_fence();
    // k step kk: rows 16 kk .. + 15 of the stage, two 8-row groups
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma<1>(acc,
               sw128_mn_desc(a_base + stage * TILE_A + kk * 2048, W_HALF * 2),
               sw128_mn_desc(b_base + stage * TILE_B + kk * 2048, W_HALF * 2));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    if (kt > kt0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == W_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the split's partial sums, 8 consecutive columns of one row a lane
  // after the quad transpose (as the GEMM's epilogue), added by two
  // 16-byte reductions
  const int t = lane & 3;
  const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * (t >> 1);
  float* out = Cw + (long long)row * ldc + n0;
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    uint32_t x[4], y[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = 2 * jj + (w & 1), h = w >> 1;
      x[w] = __float_as_uint(acc[4 * j + 2 * h]);
      y[w] = __float_as_uint(acc[4 * j + 2 * h + 1]);
    }
    quad_transpose(x, t);
    quad_transpose(y, t);
    float* dst = out + 8 * (2 * jj + (t & 1));
    red_add_f32x4(dst, make_float4(__uint_as_float(x[0]), __uint_as_float(y[0]),
                                   __uint_as_float(x[1]), __uint_as_float(y[1])));
    red_add_f32x4(dst + 4,
                  make_float4(__uint_as_float(x[2]), __uint_as_float(y[2]),
                              __uint_as_float(x[3]), __uint_as_float(y[3])));
  }
}

// ---- host side ---------------------------------------------------------------

template <int EPI>
cudaError_t launch(const GemmParams& p, int gather, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_sm90_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<EPI>::SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int sms = sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  Maps maps;
  if (!encode(&maps.b, p.Wt, p.N, p.K, p.K, BN)) return cudaErrorInvalidValue;
  const ConvGeom& g = p.conv;
  if (EPI == EPI_CONV) {
    const int images = p.M / BM / (g.ph * g.pw);
    if (!encode_boxes(&maps.a, p.A, images * g.H * g.W, p.lda, p.lda, g.H,
                      g.W, g.bw, g.bh, 1))
      return cudaErrorInvalidValue;
  } else if (gather == GATHER_ROWS)
    maps.a = maps.b;
  else if (gather == GATHER_WINDOWS
               ? !encode_boxes(&maps.a, p.A, p.M, p.K, p.lda, p.a_map.H,
                               p.a_map.W, p.a_map.ws, p.a_map.ws, p.a_map.T)
               : !encode(&maps.a, p.A, p.M, p.K, p.lda, BM))
    return cudaErrorInvalidValue;
  if (Cfg<EPI>::DUAL) {
    if (!encode(&maps.a2, p.A2, p.M, p.K, p.lda, BM) ||
        !encode(&maps.b2, p.Wt2, p.N, p.K, p.K, BN))
      return cudaErrorInvalidValue;
  } else {
    maps.a2 = maps.b2 = maps.b;
  }
  const long long tiles =
      (long long)((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  const long long most = (long long)Cfg<EPI>::BLOCKS * sms;
  const int grid = static_cast<int>(tiles < most ? tiles : most);
  gemm_sm90_kernel<EPI><<<grid, THREADS, Cfg<EPI>::SMEM, s>>>(maps, p, gather);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launch_counts[EPI];
  return err;
}

// How a weight-gradient operand loads (the host's half of `Load`):
// identity rows by 2-D TMA; a window map whose 64-row k tiles are whole
// windows (TN <= 64) or whole frames of one window (ws * ws dividing 64)
// by 4-D boxes; any other map by cp.async.
Operand operand(const bf16* ptr, long long ld, const RowMap& m, int R) {
  Operand o{ptr, ld, m, LOAD_TMA, 0};
  if (!m.mode) return o;
  o.load = LOAD_ROWS;
  const int N = m.ws * m.ws, TN = m.T * N;
  if (R % (m.H * m.W)) return o;
  if (TN <= BK && BK % TN == 0 && TN % 8 == 0) {
    o.load = LOAD_WINDOWS;
    o.box_rows = TN;
  } else if (N <= BK && BK % N == 0 && N % 8 == 0 && m.T % (BK / N) == 0) {
    o.load = LOAD_WINDOWS;
    o.box_rows = BK;
  }
  return o;
}

bool encode_operand(CUtensorMap* map, const Operand& o, int R, int cols) {
  if (o.load == LOAD_ROWS) return true;
  if (o.load == LOAD_TMA) return encode(map, o.p, R, cols, o.ld, BK);
  return encode_boxes(map, o.p, R, cols, o.ld, o.map.H, o.map.W, o.map.ws,
                      o.map.ws, o.box_rows / (o.map.ws * o.map.ws));
}

}  // namespace

cudaError_t gemm_sm90(const GemmParams& p, int epi, cudaStream_t stream) {
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.N % 8 || p.K % 8 || p.lda % 8 ||
      p.ldc % 8 || !aligned(p.A) || !aligned(p.Wt))
    return cudaErrorInvalidValue;
  int gather = GATHER_NONE;
  if (p.a_map.mode) {
    const RowMap& m = p.a_map;
    const int TN = m.T * m.ws * m.ws;
    gather = BM % TN == 0 && TN % 8 == 0 && p.M % (m.H * m.W) == 0
                 ? GATHER_WINDOWS
                 : GATHER_ROWS;
  }
  switch (epi) {
    case EPI_BF16:
      return launch<EPI_BF16>(p, gather, stream);
    case EPI_RESID_F32:
      return launch<EPI_RESID_F32>(p, gather, stream);
    case EPI_F32:
      return launch<EPI_F32>(p, gather, stream);
    case EPI_GELU_GRAD:
      return launch<EPI_GELU_GRAD>(p, gather, stream);
    case EPI_DGELU:
      if (!p.aux || !p.colsum) return cudaErrorInvalidValue;
      return launch<EPI_DGELU>(p, gather, stream);
    case EPI_GELU_BWD:
      if (gather || !p.A2 || !p.Wt2 || !p.colsum || !aligned(p.A2) ||
          !aligned(p.Wt2))
        return cudaErrorInvalidValue;
      return launch<EPI_GELU_BWD>(p, gather, stream);
    case EPI_CONV: {
      const ConvGeom& g = p.conv;
      if (gather || !p.conv.scale || (g.res && !aligned(g.res)) || g.H <= 0 ||
          g.W <= 0 || g.d < 1 || g.bh * g.bw != BM || g.bw > 256 ||
          g.ph != (g.H + g.bh - 1) / g.bh || g.pw != (g.W + g.bw - 1) / g.bw ||
          g.cb < 1 || p.K != 9 * g.cb * BK || p.M % (BM * g.ph * g.pw))
        return cudaErrorInvalidValue;
      return launch<EPI_CONV>(p, gather, stream);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t gemm_wgrad_sm90(const WgradParams& p, cudaStream_t stream) {
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (p.R <= 0 || p.M <= 0 || p.N <= 0 || p.M % BM || p.N % BN ||
      p.lda % 8 || p.ldb % 8 || p.ldc % 4 || !aligned(p.A) || !aligned(p.B) ||
      !aligned(p.Cw))
    return cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        W_SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int sms = sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  const Operand oa = operand(p.A, p.lda, p.a_map, p.R);
  const Operand ob = operand(p.B, p.ldb, p.b_map, p.R);
  WgradMaps maps;
  if (!encode_operand(&maps.a, oa, p.R, p.M) ||
      !encode_operand(&maps.b, ob, p.R, p.N))
    return cudaErrorInvalidValue;
  // split the row reduction until two blocks an SM are in flight (not
  // more: a second wave would idle most of the card), keeping at least 8
  // k tiles a split
  const int KT = (p.R + BK - 1) / BK;
  const int tiles = (p.M / BM) * (p.N / BN);
  int splits = 2 * sms / tiles;
  splits = splits < 1 ? 1 : splits;
  splits = splits < KT / 8 ? splits : (KT / 8 > 1 ? KT / 8 : 1);
  const int per = (KT + splits - 1) / splits;
  splits = (KT + per - 1) / per;
  wgrad_sm90_kernel<<<dim3(tiles, splits), THREADS, W_SMEM, stream>>>(
      maps, oa, ob, p.R, p.N, p.Cw, p.ldc, per);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launch_counts[W_SLOT];
  return err;
}

// The GEMM alone, for its tests and its profile: A (rows, K) bf16 of row
// stride lda, read through the row map (a_mode, T, H, W, ws, a_shift);
// Wt (N, K) bf16; bias (N,) fp32 or null; C (bf16: epi 0, 2, 3) and Cf
// (fp32: epi 1 adds into it, epi 4 overwrites it, epi 2 writes gelu') of
// row stride ldc, written through the row map (c_mode, T, H, W, ws,
// c_shift); aux (fp32, C's layout) and colsum (N,) fp32 of epi 3.
extern "C" int stswin_gemm_sm90(const void* A, const void* Wt,
                                const void* bias, void* C, void* Cf,
                                const void* aux, void* colsum, int M, int N,
                                int K, int lda, int ldc, int epi, int act,
                                int a_mode, int c_mode, int T, int H, int W,
                                int ws, int a_shift, int c_shift,
                                void* stream) {
  if (epi >= EPI_GELU_BWD) return cudaErrorInvalidValue;
  GemmParams g{};
  g.A = static_cast<const bf16*>(A);
  g.lda = lda;
  g.a_map = a_mode ? RowMap{1, T, H, W, ws, a_shift} : identity_map();
  g.Wt = static_cast<const bf16*>(Wt);
  g.bias = static_cast<const float*>(bias);
  g.M = M;
  g.N = N;
  g.K = K;
  g.C = static_cast<bf16*>(C);
  g.Cf = static_cast<float*>(Cf);
  g.ldc = ldc;
  g.c_map = c_mode ? RowMap{1, T, H, W, ws, c_shift} : identity_map();
  g.act = act;
  g.aux = static_cast<const float*>(aux);
  g.colsum = static_cast<float*>(colsum);
  return gemm_sm90(g, epi, static_cast<cudaStream_t>(stream));
}

// K6's fused dh / pre product alone (EPI_GELU_BWD), for its tests: n2, dm
// (rows, C) bf16; w1 (hidden, C), w2_t (hidden, C) bf16; b1 (hidden,) fp32;
// out: dpre (rows, hidden) bf16, h (rows, hidden) bf16 or null, db1
// (hidden,) fp32 added into.
extern "C" int stswin_gelu_bwd_sm90(const void* n2, const void* dm,
                                    const void* w1, const void* w2_t,
                                    const void* b1, void* dpre, void* h,
                                    void* db1, int M, int N, int K, int act,
                                    void* stream) {
  GemmParams g{};
  g.A = static_cast<const bf16*>(n2);
  g.lda = K;
  g.a_map = identity_map();
  g.Wt = static_cast<const bf16*>(w1);
  g.bias = static_cast<const float*>(b1);
  g.M = M;
  g.N = N;
  g.K = K;
  g.C = static_cast<bf16*>(dpre);
  g.ldc = N;
  g.c_map = identity_map();
  g.act = act;
  g.A2 = static_cast<const bf16*>(dm);
  g.Wt2 = static_cast<const bf16*>(w2_t);
  g.C2 = static_cast<bf16*>(h);
  g.colsum = static_cast<float*>(db1);
  return gemm_sm90(g, EPI_GELU_BWD, static_cast<cudaStream_t>(stream));
}

// The weight-gradient GEMM alone, for its tests and its profile: Cw (M, N)
// fp32 += A[a_rows(r)]^T B[b_rows(r)] over r < R; A (rows, M), B (rows, N)
// bf16 of row strides lda, ldb, each read through its row map (mode, T, H,
// W, ws, shift). The caller zeroes Cw.
extern "C" int stswin_wgrad_sm90(const void* A, const void* B, void* Cw,
                                 int R, int M, int N, int lda, int ldb,
                                 int a_mode, int b_mode, int T, int H, int W,
                                 int ws, int a_shift, int b_shift,
                                 void* stream) {
  WgradParams w{};
  w.A = static_cast<const bf16*>(A);
  w.lda = lda;
  w.a_map = a_mode ? RowMap{1, T, H, W, ws, a_shift} : identity_map();
  w.B = static_cast<const bf16*>(B);
  w.ldb = ldb;
  w.b_map = b_mode ? RowMap{1, T, H, W, ws, b_shift} : identity_map();
  w.R = R;
  w.M = M;
  w.N = N;
  w.Cw = static_cast<float*>(Cw);
  w.ldc = N;
  return gemm_wgrad_sm90(w, static_cast<cudaStream_t>(stream));
}

// The launch counts (a query, not a launch): out[0..6] the launches of
// gemm_sm90 by epilogue (EPI_BF16 .. EPI_CONV), out[7] those of the
// weight-gradient GEMM, since the last call with `reset` set; `reset` then
// sets them to 0.
extern "C" int stswin_gemm_sm90_launches(long long* out, int reset) {
  for (int i = 0; i <= W_SLOT; ++i)
    out[i] = reset ? launch_counts[i].exchange(0) : launch_counts[i].load();
  return 0;
}
