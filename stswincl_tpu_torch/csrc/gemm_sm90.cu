// The Hopper GEMM of K1 and K2: wgmma on TMA-fed, 128-byte-swizzled shared
// memory, warp-specialised and persistent.
//
// Replaces (with the kernels that call it): the matmuls of
//   stswincl_tpu/ops/pallas_block_attention.py _full_kernel (:179), the qkv
//   and proj products of K1, and of
//   stswincl_tpu/ops/pallas_add_ln_mlp.py _epilogue_kernel (:704) /
//   _epi_shifted_kernel (:940) / _epilogue_kernel_with_m (:752), fc1 and fc2
//   of K2. The TPU ran them on its 128 x 128 matrix unit out of VMEM blocks.
//
// Bound on the H100: at the swin shapes (M = 10^4..10^5 token rows, N and K
// 512..4096) the products are bound by the tensor cores (989 TFLOP/s bf16
// dense), far above the 295 flops a byte where device memory would bound
// them. The older wmma tile (gemm_tile.cuh: mma.sync fragments loaded with
// ldmatrix by every thread, a two-stage cp.async ring) reached 11-17 % of
// that peak. Design, for the rate:
//   - wgmma.mma_async m64n128k16 bf16 -> fp32: two consumer warpgroups own
//     the 64-row halves of a 128 x 128 output tile, with both operands
//     read by the tensor cores straight from shared memory through
//     descriptors (128-byte swizzle, K-major: A rows and the torch Linear
//     weight rows both have K contiguous);
//   - a ring of STAGES k tiles of 64 (128 bytes: one swizzle span), filled
//     by one producer warp with TMA (cp.async.bulk.tensor, zero fill past
//     M, N and K), completion counted on a `full` mbarrier per stage and
//     release on an `empty` one;
//   - persistent: a grid of at most two blocks an SM walks the tiles, and
//     the producer runs ahead into the next tile while the consumers store
//     the last; two blocks an SM also overlap one's epilogue with the
//     other's main loop.
// A gathered A (K1's qkv product reads x through the window partition and
// the SW-MSA cyclic shift): TMA on sm_90 copies boxes, not row lists. A
// window is a (ws x ws x T) box of the (BT, H, W, C) image, its rows in
// window order, so where a 128-row tile holds whole windows (TN divides
// 128 and is a multiple of 8, each box 1024-byte aligned: both stages)
// the producer issues one 4-D TMA box per window. The shift wraps the
// last window row and column round the image edge, which no box can
// follow: a tile holding such a window,
// and any other row map, goes by cp.async instead, each lane copying
// rows into the same swizzled layout (16-byte chunk c of row r at chunk
// c ^ (r % 8)) and its copies counted on the stage's `full` barrier
// (cp.async.mbarrier.arrive.noinc). Wt always comes by TMA.
// Two blocks an SM, one's epilogue under the other's main loop, measured
// faster than a wider tile or a deeper ring at one block an SM.
// The epilogue works from the accumulator registers: bias, the GELU of
// `activate` (erf polynomial or tanh), then a transpose within each quad
// of lanes so that a lane holds 8 consecutive columns of one row, stored
// whole: bf16, or the fp32 residual add, each row through the C row map
// (K1's proj scatters back to the image layout). Stores of 4 and 8 bytes
// straight from the accumulator layout took about 40 % of the time.

#include <cuda.h>

#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int NACC = BN / 2;  // fp32 accumulators a consumer thread
constexpr int THREADS = 288;  // two consumer warpgroups + one producer warp
constexpr int TILE_A = BM * BK * 2, TILE_B = BN * BK * 2;  // bytes
constexpr int SMEM_BYTES = STAGES * (TILE_A + TILE_B) + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete. A phase that never
// completes is a fault of this kernel: after 10 s the wait traps, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  uint64_t t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      const uint64_t t = global_ns();
      if (!t0)
        t0 = t;
      else if (t - t0 > 10000000000ull)
        __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// One (64 channels, ws, ws, T frames) box of the (BT, H, W, C) image: a
// window's TN rows in window order (frame, row, column).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c, int w, int h, int bt,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(bt),
      "r"(smem_u32(bar))
      : "memory");
}

// The stage's `full` barrier counts this lane's cp.async copies: it sees
// one arrival when all of them have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (SBO), the start address in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32, the warpgroup's layout) += A (64 x 16) B (16 x 128)
__device__ __forceinline__ void wgmma(float (&d)[NACC], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// A 4 x 4 transpose of 32-bit words across the quad of lanes 4q .. 4q + 3:
// lane t holds row t (w[0..3]) and ends with column t (word t of lanes
// 0..3, in lane order). Round k swaps with lane t ^ k the word each needs.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
  uint32_t out[4] = {w[0], w[1], w[2], w[3]};
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const int i = t ^ k;  // the partner's lane and the word it wants
    const uint32_t send = i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = j == i ? got : out[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = out[j];
}

// How A arrives: one 2-D TMA box a stage (the identity row map); through
// the row map by cp.async; or, where the tile's rows are whole windows
// (TN a multiple of 8 dividing 128), a TMA box per window of the 4-D
// image, the tiles whose windows the shift wraps by cp.async.
enum Gather { GATHER_NONE = 0, GATHER_ROWS = 1, GATHER_WINDOWS = 2 };

struct Maps {
  CUtensorMap a, b;  // a: 2-D rows, 4-D image (GATHER_WINDOWS), or unused
};

template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_sm90_kernel(const __grid_constant__ Maps maps, const GemmParams p,
                     int gather) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + STAGES * TILE_A);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * (TILE_A + TILE_B));
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * tiles_n;
  const int KT = (p.K + BK - 1) / BK;

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
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        const int k0 = kt * BK;
        if (lane == 0) {
          mbar_expect_tx(&full[stage],
                         TILE_B + (!gather ? TILE_A : windows * TN * BK * 2));
          tma_load(sB + stage * BN * BK, &maps.b, k0, n0, &full[stage]);
          if (!gather)
            tma_load(sA + stage * BM * BK, &maps.a, k0, m0, &full[stage]);
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
  float acc[NACC];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      // cp.async wrote A through the generic proxy; wgmma reads through
      // the async proxy
      if (gather) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma(acc, sw128_desc(a_base + stage * TILE_A + kk * 32),
              sw128_desc(b_base + stage * TILE_B + kk * 32));
      wgmma_commit();
      fence_acc(acc);
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
      rok[h] = r0 + 8 * h < p.M;
      orow[h] = rok[h] ? map_row(p.c_map, r0 + 8 * h) * p.ldc : 0;
    }
    const long long my_row = (t >> 1) ? orow[1] : orow[0];
    const bool my_rok = (t >> 1) ? rok[1] : rok[0];
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
        v[w][0] = acc[4 * j + 2 * h] + b.x;
        v[w][1] = acc[4 * j + 2 * h + 1] + b.y;
      }
      const int n = n0 + 8 * (2 * jj + (t & 1));  // this lane's 8 columns
      const bool ok = my_rok && n < p.N;
      if (EPI == EPI_BF16) {
        uint32_t word[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          __nv_bfloat162 pair = __floats2bfloat162_rn(
              activate(v[w][0], p.act), activate(v[w][1], p.act));
          word[w] = *reinterpret_cast<uint32_t*>(&pair);
        }
        quad_transpose(word, t);
        if (ok)
          *reinterpret_cast<uint4*>(p.C + my_row + n) =
              make_uint4(word[0], word[1], word[2], word[3]);
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
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda at link time.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault) != cudaSuccess)
      f = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A (rows, K) bf16 matrix of row stride ld (elements) as 64 x 128 boxes
// of 128-byte-swizzled rows, zero-filled past its edges.
bool encode(CUtensorMap* map, const bf16* base, int rows, int K,
            long long ld) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<bf16*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (BT, H, W, K) image under A's window row map as (64, ws, ws, T)
// boxes, for GATHER_WINDOWS.
bool encode_image(CUtensorMap* map, const GemmParams& p) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const RowMap& m = p.a_map;
  const cuuint64_t row = static_cast<cuuint64_t>(p.lda) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.K),
                              static_cast<cuuint64_t>(m.W),
                              static_cast<cuuint64_t>(m.H),
                              static_cast<cuuint64_t>(p.M) / (m.H * m.W)};
  const cuuint64_t strides[3] = {row, row * m.W, row * m.W * m.H};
  const cuuint32_t box[4] = {BK, static_cast<cuuint32_t>(m.ws),
                             static_cast<cuuint32_t>(m.ws),
                             static_cast<cuuint32_t>(m.T)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<bf16*>(p.A), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI>
cudaError_t launch(const GemmParams& p, int gather, cudaStream_t s) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(gemm_sm90_kernel<EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  Maps maps;
  if (!encode(&maps.b, p.Wt, p.N, p.K, p.K)) return cudaErrorInvalidValue;
  if (gather == GATHER_ROWS)
    maps.a = maps.b;
  else if (gather == GATHER_WINDOWS ? !encode_image(&maps.a, p)
                                    : !encode(&maps.a, p.A, p.M, p.K, p.lda))
    return cudaErrorInvalidValue;
  const long long tiles =
      (long long)((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < 2LL * sms ? tiles : 2LL * sms);
  gemm_sm90_kernel<EPI><<<grid, THREADS, SMEM_BYTES, s>>>(maps, p, gather);
  return cudaGetLastError();
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
    gather = BM % TN == 0 && TN % 8 == 0 && p.lda == p.K &&
                     p.M % (m.H * m.W) == 0
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
    default:
      return cudaErrorInvalidValue;
  }
}

// The GEMM alone, for its tests and its profile: A (rows, K) bf16 of row
// stride lda, read through the row map (a_mode, T, H, W, ws, a_shift);
// Wt (N, K) bf16; bias (N,) fp32 or null; C (bf16, epi 0) or Cf (fp32,
// epi 1 adds into it, epi 4 overwrites) of row stride ldc, written through
// the row map (c_mode, T, H, W, ws, 0).
extern "C" int stswin_gemm_sm90(const void* A, const void* Wt,
                                const void* bias, void* C, void* Cf, int M,
                                int N, int K, int lda, int ldc, int epi,
                                int act, int a_mode, int c_mode, int T, int H,
                                int W, int ws, int a_shift, void* stream) {
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
  g.c_map = c_mode ? RowMap{1, T, H, W, ws, 0} : identity_map();
  g.act = act;
  return gemm_sm90(g, epi, static_cast<cudaStream_t>(stream));
}
