// The fp32 GEMM and the LN2 row pass of fp32_forms.cu, shared with the fp32
// backward forms of fp32_train.cu and the fp32 forms of rows 12 and 13
// (fp32_offpath.cu); the GEMM's 128 x 128 tile and K2's LayerNorm row,
// shared with row 16's fp32 form (fp32_whole_block.cu); the tile, read
// through a tap map, is row 17's fp32 form (fp32_offpath.cu).
#pragma once
#include "common.cuh"

// C[c_map(m), n] = epilogue(sum_k A[a_map(m), k] Wt[n, k] + bias[n]), every
// sum in fp32 FMA with k in order. Epilogues, v = the sum + bias:
//   F32_ACT        C = act(v);
//   F32_RESID      C += v (K2's residual s + MLP);
//   F32_GELU_GRAD  C = gelu(v), C2 = gelu'(v), one erf evaluation (act
//                  names the GELU; K6's fc1);
//   F32_DGELU      C = v * aux (K6's dpre = dh * gelu'); aux may be C.
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
};

// Requires K % 4 == 0 and lda % 4 == 0; M and N ragged.
cudaError_t gemm_f32(const F32Gemm& p, cudaStream_t s);

F32Gemm plain_gemm(const float* A, int lda, const float* Wt,
                   const float* bias, int M, int N, int K, float* C, int ldc,
                   int act);

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

// ---- the GEMM's tile: 128 x 128 outputs a block of 256 threads ----------

constexpr int F32_BM = 128, F32_BN = 128, F32_BK = 8;
constexpr int F32_LD = F32_BK + 4;  // a shared row: 8 floats + 4 of padding
constexpr int F32_STAGES = 3;
constexpr int F32_THREADS = 256;

// The tile's three-stage cp.async ring of A and Wt k tiles (36 KiB).
struct F32Tile {
  float a[F32_STAGES][F32_BM][F32_LD];
  float b[F32_STAGES][F32_BN][F32_LD];
};

// The A row a thread loads, k by k: `at(k, ok)` returns the address of
// element k of the row (k < K, a multiple of 4) and sets `ok` false where
// the 16-byte chunk there is to be zero-filled; the address is valid
// either way. A plain row of K floats: element k at row + k.
struct F32Row {
  const float* row;
  bool ok;
  __device__ __forceinline__ const float* at(int k, bool& valid) const {
    valid = ok;
    return row + k;
  }
};

// acc[i][j] = sum_k A(ty + 16 i, k) Wt(tx + 16 j, k) for thread (tx, ty) =
// (tid % 16, tid / 16) of the block's 256, k ascending, one fmaf a term,
// through the ring in `sm`. Thread tid loads row tid / 2 of both tiles, the
// 16-byte chunk at column (tid % 2) * 4: `a` reads that row of A through
// its address functor (`F32Row`, or row 17's tap map, fp32_offpath.cu),
// `b_row` points at the start of that row of Wt (rows of K floats, 16-byte
// aligned), or, with `b_ok` false, at any valid address (the row is
// zero-filled). K % 4 == 0. The caller meets the block before reusing
// `sm`.
template <class ARow>
__device__ __forceinline__ void f32_tile_sums(F32Tile& sm, const ARow& a,
                                              const float* b_row, bool b_ok,
                                              int K, float (&acc)[8][8]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 1, lc = (tid & 1) * 4;
  const float* b_src = b_row + lc;
  const int nk = (K + F32_BK - 1) / F32_BK;
  auto load = [&](int stage, int kt) {
    const int k = kt * F32_BK;
    const bool kin = k + lc < K;  // K % 4 == 0: a chunk is whole or out
    bool a_ok;
    const float* a_src = a.at(kin ? k + lc : lc, a_ok);
    cp_async16(&sm.a[stage][lr][lc], a_src, a_ok && kin);
    cp_async16(&sm.b[stage][lr][lc], kin ? b_src + k : b_src, b_ok && kin);
  };
#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed (this thread's copies); after the barrier every
    // thread's have, and every thread is done with the stage refilled next
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // STAGES - 2
    __syncthreads();
    const int next = kt + F32_STAGES - 1;
    if (next < nk) load(next % F32_STAGES, next);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int s = kt % F32_STAGES;
#pragma unroll
    for (int kk = 0; kk < F32_BK; kk += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sm.a[s][ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(&sm.b[s][tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = acc[i][j];
          v = fmaf(a[i].x, b[j].x, v);
          v = fmaf(a[i].y, b[j].y, v);
          v = fmaf(a[i].z, b[j].z, v);
          acc[i][j] = fmaf(a[i].w, b[j].w, v);
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The plain form: `a_row` points at the start of the A row this thread
// loads, or, with `a_ok` false, at any valid address.
__device__ __forceinline__ void f32_tile_sums(F32Tile& sm, const float* a_row,
                                              bool a_ok, const float* b_row,
                                              bool b_ok, int K,
                                              float (&acc)[8][8]) {
  f32_tile_sums(sm, F32Row{a_row, a_ok}, b_row, b_ok, K, acc);
}

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
