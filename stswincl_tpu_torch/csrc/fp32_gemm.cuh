// The fp32 product tile: fp32-accurate products as 3xTF32 on Hopper's
// tensor cores (wgmma), the one k-tile function every fp32 product of the
// port outside the attention cores sums k through: the fp32 GEMM of
// fp32_forms.cu (K1-K3, and the fp32 backward forms of fp32_train.cu and
// rows 12 and 13 of fp32_offpath.cu through it), row 17's fp32 implicit
// GEMM (`conv_f32`, on the GEMM's kernel), row 16's four product phases
// (fp32_whole_block.cu) and the weight gradients (`wgrad_f32`,
// fp32_train.cu, K = the token rows, A's fragments from its r-major tile
// through `ktile_frags`). Also the LN2 row pass of fp32_forms.cu and K2's
// LayerNorm row, shared with row 16.
//
// Why 3xTF32 on wgmma. The tensor cores have no fp32 product, and one TF32
// pass keeps 10 of an operand's 23 mantissa bits, which an fp32 model does
// not ask for; fp32 FMA on the CUDA cores is bounded by their 67 TFLOP/s
// and the FMA tile before this one reached 23-32. Split each operand x into
// hi and lo = x - hi; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi is
// fp32-accurate at a third of the TF32 rate: 494.7 / 3 = 164.9 TFLOP/s on
// the H100 through wgmma (485.7 measured on the card, from shared memory
// or with A from registers), against about 100 through mma.sync
// (`tools/profile_mma_rate.py`).
//
// The k tile (`ktile`): 32 fp32 of k (128 bytes, one 128-byte swizzle span)
// of a 128 x 128 output tile, two warpgroups on its 64-row halves, each
// issuing 12 `wgmma.m64n128k8.f32.tf32.tf32`: a_lo b_hi over the four k8
// steps (the first from zero), then a_hi b_lo, then a_hi b_hi, so the small
// terms are summed first. The tensor cores' accumulation drops the bits
// past its sum's last (a bias toward zero that drifts over a long chain:
// 5.7e-5 against the 2e-5 bound over an 8,192-row weight-gradient chain on
// the card), so each k tile's sum is formed from zero and added to a second
// register set of fp32 sums, rounded to nearest: 64 + 64 accumulators a
// thread.
//
// The split, route (a), shaped by shared memory's bandwidth: hi = x
// rounded to TF32 to nearest and lo = x - hi rounded the same way
// (`split_rn`). A's fragments are read from the swizzled stage a thread at
// a time (conflict-free scalar loads) and split in registers, and the
// wgmma reads A from registers; Wt's k tile, shared by both warpgroups,
// is split once, hi in place and lo into a sibling buffer at the same
// offsets (an elementwise pass keeps the swizzle). A k tile then moves
// about 192 KiB through shared memory (the loads, Wt's split, A's
// fragments, the wgmma's reads of Wt hi and lo): 1,536 cycles at 128
// bytes a cycle, under the 1,564 its products take at the wgmma rate;
// splitting both operands there moved 272 KiB and held the GEMM to 42-76
// TFLOP/s. lo is rounded, not left to the wgmma's truncation, because a
// sum of the step (phase 11 (e): two ranks' fp32 step against one
// process's) sees every input move by ulps when the BatchNorm statistics
// are summed in another order, and a truncated lo turns that into a
// coarser, one-sided move of the products: on the card the gate read
// 1.15-1.39 of its bound with lo truncated (1.07-1.37 with hi truncated
// too), 0.80 rounded. No transposed or split copy of either operand
// reaches device memory: both operands are K-major already (A's rows, the
// torch Linear weight (N, K), row 17's tap-major weight (Cout, 9 Cin)).
// Every caller calls `ktile` on the same k tiles, zero-filled past K, so
// every caller sums k in the same order: row 16's fp32 form carries the
// bits of the fp32 K1 + K2 pair.
// `tests/test_torch_tf32x3.py` emulates this arithmetic in PyTorch.
#pragma once

#include "common.cuh"
#include "sm90_tile.cuh"

// C[c_map(m), n] = epilogue(sum_k A[a_map(m), k] Wt[n, k] + bias[n]), every
// sum fp32-accurate (3xTF32, `f32t::ktile`). Epilogues, v = the sum +
// bias:
//   F32_ACT        C = act(v);
//   F32_RESID      C += v (K2's residual s + MLP);
//   F32_GELU_GRAD  C = gelu(v), C2 = gelu'(v), one erf evaluation (act
//                  names the GELU; K6's fc1);
//   F32_DGELU      C = v * aux (K6's dpre = dh * gelu'); aux may be C;
//                  with colpart, the column sums of v * aux over each
//                  128-row tile i into colpart[i * N + n] (db1's
//                  per-row-tile partials, in a fixed order; rows past M
//                  add 0), `f32_col_tiles(M)` of them.
// C2 and aux share C's row map and ldc.
enum F32Epi { F32_ACT = 0, F32_RESID = 1, F32_GELU_GRAD = 2, F32_DGELU = 3 };

struct F32Gemm {
  const float* A;
  long long lda;
  RowMap a_map;
  const float* Wt;    // (N, K), rows of K
  const float* bias;  // (N,) or null
  int M, N, K;
  float* C;
  long long ldc;
  RowMap c_map;
  int act;
  int epi;
  float* C2;
  const float* aux;
  float* colpart;
};

// Requires K % 4 == 0, lda % 4 == 0 and A, Wt 16-byte aligned; M and N
// ragged.
cudaError_t gemm_f32(const F32Gemm& p, cudaStream_t s);

// The 128-row tiles of M rows: F32_DGELU's column-sum partials.
inline int f32_col_tiles(int M) { return (M + 127) / 128; }

F32Gemm plain_gemm(const float* A, int lda, const float* Wt,
                   const float* bias, int M, int N, int K, float* C, int ldc,
                   int act);

// Row 17's fp32 implicit GEMM on the GEMM's kernel: out[m, c] = relu?(
// sum_k A[m, k] wt[c, k] * scale[c] + shift[c] (+ res[m, c])), m the NHWC
// output pixel, k = tap * Cin + channel (tap = 3 ky + kx, the pixel at
// (h + d (ky - 1), w + d (kx - 1)), zero in the padding). Cin % 4 == 0,
// d >= 1, x and wt 16-byte aligned.
struct F32Conv {
  const float* x;      // (N, H, W, Cin)
  const float* wt;     // (Cout, 9 Cin)
  const float* scale;  // (Cout,)
  const float* shift;  // (Cout,)
  const float* res;    // (N, H, W, Cout) or null
  float* out;          // (N, H, W, Cout)
  int N, H, W, Cin, Cout, d, relu;
};

cudaError_t conv_f32(const F32Conv& c, cudaStream_t s);

// K2's first row pass: s32 = x[r] + y[unshift(r)], out = LN2(s32), fp32,
// one warp a row; C % 4 == 0.
cudaError_t ln_rows_add_f32(const float* x, const float* y, const float* g,
                            const float* b, float* s32, float* out, int R,
                            int C, int H, int W, int shift, float eps,
                            cudaStream_t s);

// The fp32 weight-gradient GEMM's launches since the last reset
// (fp32_train.cu); `reset` sets the count to 0 after reading it.
long long wgrad_f32_launches(int reset);

// Row 17's fp32 implicit-GEMM launches since the last reset
// (fp32_offpath.cu), counted as a GEMM form of their own.
long long conv_f32_launches(int reset);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float sum4(float4 v) {
  return v.x + v.y + v.z + v.w;
}

namespace f32t {

constexpr int BM = 128, BN = 128, BK = 32;  // BK fp32: one 128-byte span
constexpr int NACC = BN / 2;  // fp32 sums (and k-tile partials) a thread
constexpr int TILE = BM * BK;  // floats of an A or B k tile (16 KiB)
constexpr int STAGE = 3 * TILE;  // a ring stage: A, B (then its hi), B lo
constexpr int STAGES = 4;
constexpr int RING_BYTES = STAGES * STAGE * 4;  // 192 KiB, 1024-aligned

// d (64 x 128 fp32, the warpgroup's accumulator layout) = a b (the first
// product of a k tile, its outputs only) or d += a b (`wgmma_tf32_add`):
// a (64 x 8 tf32) from registers, a[0] row g col t, a[1] row g + 8 col t,
// a[2] row g col t + 4, a[3] row g + 8 col t + 4 of the warp's 16 rows (g
// = lane / 4, t = lane % 4); b (8 x 128 tf32) K-major in shared memory,
// 128-byte swizzle, descriptor db.
__device__ __forceinline__ void wgmma_tf32_set(float (&d)[NACC],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 0, "
      "1, 1;\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_tf32_add(float (&d)[NACC],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, "
      "1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// x rounded to TF32 to nearest, ties away from zero (the magnitude bits
// plus half of the last kept bit, the low 13 cleared), as a TF32 operand
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x -> (hi, lo): hi = x rounded to TF32, lo = x - hi (exact in fp32) rounded
// to TF32 too, so that the wgmma reads both as they are. (The attention
// core's `tf32x3::split` leaves lo to the wgmma, which truncates it: a
// tiny change of an input then moves a product by up to lo's last TF32
// bit, always the same way; here by half of it, either way.)
__device__ __forceinline__ void split_rn(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// B's k tile (128 rows of 32 floats, swizzled) split in place, `n`
// threads from index `i`: hi (`split_rn`) over x, lo into `lo` at the same
// offset (an elementwise pass keeps the swizzle). The caller orders the
// writes before the wgmma reads (fence.proxy.async, then a barrier).
__device__ __forceinline__ void split_b(float* x, float* lo, int i, int n) {
  float4* xv = reinterpret_cast<float4*>(x);
  float4* lv = reinterpret_cast<float4*>(lo);
  for (int c = i; c < TILE / 4; c += n) {
    const float4 v = xv[c];
    uint32_t h[4], l[4];
    split_rn(v.x, h[0], l[0]);
    split_rn(v.y, h[1], l[1]);
    split_rn(v.z, h[2], l[2]);
    split_rn(v.w, h[3], l[3]);
    xv[c] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
    lv[c] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The k tile's products, by the calling warpgroup (all 128 threads): sum +=
// A B^T over 32 k, fp32-accurate, from A's fragments split in registers
// (hi[kk], lo[kk]: the k8 step kk's a[0..3], a[0] row g col t, a[1] row g
// + 8 col t, a[2] row g col t + 4, a[3] row g + 8 col t + 4 of the warp's
// 16 rows) and B's halves in shared memory (sb, sl: the stage's B hi and B
// lo, K-major, 128-byte swizzled). 12 wgmma in one group: a_lo b_hi over
// the four k8 steps (the first from zero), then a_hi b_lo, then a_hi b_hi,
// so the small terms are summed first; then the k tile's sum is added to
// the fp32 sums, rounded to nearest. d: the k tile's partial, scratch.
// Returns with the wgmma done: the stage may be reused. Every fp32 product
// of the port outside the attention cores sums its k tiles here: the GEMM
// and row 16 through `ktile`, the weight gradients (fp32_train.cu) from
// their r-major A.
__device__ __forceinline__ void ktile_frags(float (&sum)[NACC],
                                            float (&d)[NACC],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4], uint32_t sb,
                                            uint32_t sl) {
  sm90::wgmma_fence();
  wgmma_tf32_set(d, lo[0], sm90::sw128_desc(sb));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma_tf32_add(d, lo[kk], sm90::sw128_desc(sb + kk * 32));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tf32_add(d, hi[kk], sm90::sw128_desc(sl + kk * 32));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tf32_add(d, hi[kk], sm90::sw128_desc(sb + kk * 32));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_acc(d);
  fence_frag(hi);
  fence_frag(lo);
#pragma unroll
  for (int i = 0; i < NACC; ++i) sum[i] += d[i];
}

// The k tile of a K-major A: sa, the warpgroup's 64 rows of the stage's A
// (raw, swizzled, 1024-byte aligned), read a fragment a thread
// (conflict-free scalar loads) and split in registers; then `ktile_frags`.
__device__ __forceinline__ void ktile(float (&sum)[NACC], float (&d)[NACC],
                                      const float* sa, uint32_t sb,
                                      uint32_t sl) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const float* r0 = sa + (((threadIdx.x >> 5) & 3) * 16 + g) * BK + (lane & 3);
  const float* r1 = r0 + 8 * BK;
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c0 = ((2 * kk) ^ g) << 2, c1 = ((2 * kk + 1) ^ g) << 2;
    split_rn(r0[c0], hi[kk][0], lo[kk][0]);
    split_rn(r1[c0], hi[kk][1], lo[kk][1]);
    split_rn(r0[c1], hi[kk][2], lo[kk][2]);
    split_rn(r1[c1], hi[kk][3], lo[kk][3]);
  }
  ktile_frags(sum, d, hi, lo, sb, sl);
}

// The warpgroup's 64 x 128 sums as runs of 8 columns: for each pair of
// 8-column blocks, pre(n, v) maps the sum v of column n0 + n' (n' < 128;
// the bias, the folded BatchNorm), then a transpose within each quad of
// lanes leaves lane t 8 consecutive columns of one row, and out(row, n, o)
// gets them: row the warpgroup row ((warp % 4) * 16 + lane / 4 + 8 (t /
// 2)), n the first column, o[0..7]. Stored whole: stores of 4 and 8 bytes
// from the accumulator layout cost the bf16 GEMM about 40 %.
template <class Pre, class Out>
__device__ __forceinline__ void rows8(const float (&sum)[NACC], int n0,
                                      Pre pre, Out out) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * (t >> 1);
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    uint32_t x[4], y[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = 2 * jj + (w & 1), h = w >> 1, n = n0 + 8 * j + 2 * t;
      x[w] = __float_as_uint(pre(n, sum[4 * j + 2 * h]));
      y[w] = __float_as_uint(pre(n + 1, sum[4 * j + 2 * h + 1]));
    }
    quad_transpose(x, t);
    quad_transpose(y, t);
    float o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * e] = __uint_as_float(x[e]);
      o[2 * e + 1] = __uint_as_float(y[e]);
    }
    out(row, n0 + 8 * (2 * jj + (t & 1)), o);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ---- host side ----------------------------------------------------------

// A (rows, cols) fp32 matrix of row stride ld (elements) as boxes of 32
// columns x box_rows rows, 128-byte swizzled, zero-filled past its edges.
inline bool encode(CUtensorMap* map, const float* base, int rows, int cols,
                   long long ld, int box_rows) {
  sm90::EncodeTiled fn = sm90::encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace f32t

// The tail of K2's fp32 LayerNorm of one row of C (C % 4 == 0) by one
// warp, lane l on columns 4l + 128i: `sum` is the lane's sum of its
// columns of `srow`; the mean is the warp's sum / C, then the centred
// squares the same way (two-pass, `layer_norm_f32`), and orow =
// (s - mu) * rs * g + b.
__device__ __forceinline__ void ln_row_f32(const float* srow, float sum,
                                           const float* __restrict__ g,
                                           const float* __restrict__ b,
                                           float* orow, int C, float eps,
                                           int lane) {
  const float mu = warp_sum(sum) / C;
  float sq = 0.0f;
  for (int c = lane * 4; c < C; c += 128) {
    const float4 v = ld4(srow + c);
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
  }
  const float rs = rsqrtf(warp_sum(sq) / C + eps);
  for (int c = lane * 4; c < C; c += 128) {
    const float4 v = ld4(srow + c);
    *reinterpret_cast<float4*>(orow + c) = make_float4(
        (v.x - mu) * rs * g[c] + b[c], (v.y - mu) * rs * g[c + 1] + b[c + 1],
        (v.z - mu) * rs * g[c + 2] + b[c + 2],
        (v.w - mu) * rs * g[c + 3] + b[c + 3]);
  }
}
