// The Hopper GEMM tile: the building blocks of the wgmma + TMA GEMMs of
// gemm_sm90.cu (K1-K3, K5, K6, the conv of row 17, the weight gradients)
// and of the whole-block kernel (row 16, swin_block.cu), which runs the same
// tile in every product phase of its one launch: mbarriers, TMA loads
// (2-D boxes of a row-major matrix, 4-D boxes of a (frames, H, W, C) image),
// the 128-byte-swizzled wgmma descriptors, the k tile of four m64n128k16
// products (`mma_ktile`, so every caller sums k in the same order), and
// the host's tensor-map encoders. gemm_sm90.cu says why the tile is built
// so.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "common.cuh"

namespace sm90 {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int NACC = BN / 2;  // fp32 accumulators a consumer thread
constexpr int TILE_A = BM * BK * 2, TILE_B = BN * BK * 2;  // bytes

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

// One (64 channels, ws, ws, frames) box of the (BT, H, W, C) image: a
// window's rows in window order (frame, row, column).
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

// wgmma shared-memory descriptors, 128-byte swizzle, start address in
// 16-byte units. K-major: 8-row groups 1024 bytes apart (SBO). MN-major
// (the weight gradients): 8-row k groups 1024 bytes apart (SBO), the
// 64-column halves of a 128-wide operand `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr,
                                                  uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
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

// d (64 x 128 fp32, the warpgroup's layout) += A (64 x 16) B (16 x 128);
// TRANS 0: both operands K-major, 1: both MN-major
template <int TRANS>
__device__ __forceinline__ void wgmma(float (&d)[NACC], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS));
}

// the 256 consumer threads (warps 0-7) meet on barrier 1
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One k tile of the stage at shared addresses sa (A: the warpgroup's 64
// rows) and sb (B: 128 rows), both K-major: acc += A B^T over its 64 k as
// four m64n128k16 products in k order, committed as one group.
__device__ __forceinline__ void mma_ktile(float (&acc)[NACC], uint32_t sa,
                                          uint32_t sb) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma<0>(acc, sw128_desc(sa + kk * 32), sw128_desc(sb + kk * 32));
  wgmma_commit();
  fence_acc(acc);
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda at link time.
inline EncodeTiled encode_tiled() {
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

// A (rows, cols) bf16 matrix of row stride ld (elements) as boxes of 64
// columns x box_rows rows, 128-byte swizzled, zero-filled past its edges.
inline bool encode(CUtensorMap* map, const bf16* base, int rows, int cols,
            long long ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<bf16*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (frames, H, W, cols) image of `rows` pixel rows of stride ld as
// (64, bw, bh, bf) boxes, zero-filled past its edges (at negative
// coordinates too): a window of a window row map m is a (64, ws, ws,
// frames) box, a conv tap's patch a (64, bw, bh, 1) one.
inline bool encode_boxes(CUtensorMap* map, const bf16* base, int rows, int cols,
                  long long ld, int H, int W, int bw, int bh, int bf) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(ld) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(rows) / (H * W)};
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(bf)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<bf16*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
