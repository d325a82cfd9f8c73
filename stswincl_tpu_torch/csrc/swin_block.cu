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
// so this kernel tiles by windows instead and streams the weights (6.3 MB
// at stage 1, 25 MB at stage 2: they live in the 50 MB L2). One block of
// 256 threads owns TM = 128 token rows in window order: one stage-1
// window (TN 128) or four stage-2 windows (TN 32). Every step of the block
// is row-local or window-local, so blocks never wait for each other and
// one launch covers the block call. A persistent grid (one block per
// workspace slot, `slots` = the SMs times the blocks one SM holds, as
// `stswin_whole_block_slots` reports from the occupancy API) walks
// over the tiles; each tile runs seven phases split by block barriers:
//   1. qkv: 3C/128 GEMM tiles (`tile::mma`, gemm_tile.cuh), A rows
//      gathered from the image layout through the window partition;
//   2. attention, window by window and head by head, the core shared
//      with K1 and rows 10-11 (`attn::attend`, attention_core.cuh);
//   3. proj; the epilogue adds x (fp32) and keeps s;
//   4. LN2, one warp per row;
//   5. fc1 with the bias and GELU (the erf polynomial) in the epilogue;
//   6. fc2; the epilogue adds bf16(m) into s;
//   7. LN1, one warp per row, scattered back to the image layout.
// What does not fit on chip goes to the slot's workspace, reused tile
// after tile (so it stays warm in L2): qkv then the GELU output
// (TM x max(3C, hidden) bf16), the attention output then LN2(s)
// (TM x C bf16) and s (TM x C fp32); 0.875 MiB a slot at stage 1, 1.75
// MiB at stage 2. Device memory sees x read by phases 1 and 3 and the
// output written once; the K1 + K2 pair also writes and reads qkv, the
// attention output, y, s, LN2(s) and the hidden activation for every row.
// Shared memory holds one phase at a time: the GEMM's two k stages (40 KB)
// or one (window, head) of attention (203 KB at stage 1, 85 KB at stage
// 2). The GEMMs are mma.sync, as everywhere in the port: wgmma / TMA and
// overlap of one phase's loads with another's math are later work.

#include "attention_core.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace nvcuda;

constexpr int TM = tile::BM;  // token rows a tile (whole windows)

struct WholeParams {
  const bf16* x;
  bf16* out;
  const bf16* wqkv;
  const float* bqkv;
  const bf16* wproj;
  const float* bproj;
  const float* bias;  // (heads, TN, TN)
  const float* s2;
  const float* b2;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* bw2;
  const float* s1;
  const float* b1n;
  bf16* ws_wide;    // (slots, TM, wide) bf16
  bf16* ws_narrow;  // (slots, TM, C) bf16
  float* ws_s;      // (slots, TM, C) fp32
  RowMap img;       // window-order row -> image row (shift 0)
  int M, C, hidden, wide, heads, TN, hd, tiles, act;
  float scale, eps;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}

__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  __align__(16) bf16 o[8];
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(o[e]);
}

// Hand each lane's 8 consecutive fp32 sums of the 128 x 128 tile to
// epi(tile row, tile column, v), one 16 x 16 fragment at a time staged in
// the (idle) GEMM shared memory. The caller synchronises the block before
// the next `tile::mma` reuses it.
template <class Epi>
__device__ __forceinline__ void epilogue(tile::Acc (&acc)[2][4],
                                         tile::Smem& sm, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  float* st = tile::staging(sm, warp);
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = st[r * 16 + c0 + e];
      epi(wm * 32 + i * 16 + r, wn * 64 + j * 16 + c0, v);
      __syncwarp();
    }
}

// bf16(LayerNorm(s[r])) for the first `rows` of the TM rows of fp32 s
// (row stride C <= 1024), one warp a row, fp32 two-pass statistics; tile
// row r goes to row map_row(map, m0 + r) of dst.
__device__ __forceinline__ void ln_tile(const float* s, int C,
                                        const float* __restrict__ g,
                                        const float* __restrict__ b,
                                        float eps, bf16* dst,
                                        const RowMap& map, int m0, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = C / 128;
  const float inv_c = 1.0f / C;
  for (int r = warp; r < rows; r += tile::THREADS / 32) {
    const float* row = s + (long long)r * C;
    float4 v[8];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < nv) {
        v[i] = *reinterpret_cast<const float4*>(row + i * 128 + lane * 4);
        sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      }
    const float mu = warp_sum(sum) * inv_c;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < nv) {
        v[i].x -= mu;
        v[i].y -= mu;
        v[i].z -= mu;
        v[i].w -= mu;
        sq += (v[i].x * v[i].x + v[i].y * v[i].y) +
              (v[i].z * v[i].z + v[i].w * v[i].w);
      }
    const float rs = rsqrtf(warp_sum(sq) * inv_c + eps);
    bf16* orow = dst + map_row(map, m0 + r) * C;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < nv) {
        const int c = i * 128 + lane * 4;
        __align__(8) __nv_bfloat162 o[2];
        o[0] = __floats2bfloat162_rn(v[i].x * rs * g[c] + b[c],
                                     v[i].y * rs * g[c + 1] + b[c + 1]);
        o[1] = __floats2bfloat162_rn(v[i].z * rs * g[c + 2] + b[c + 2],
                                     v[i].w * rs * g[c + 3] + b[c + 3]);
        *reinterpret_cast<uint2*>(orow + c) = *reinterpret_cast<const uint2*>(o);
      }
  }
}

__global__ void __launch_bounds__(tile::THREADS)
    whole_block_kernel(const __grid_constant__ WholeParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile::Smem& gs = *reinterpret_cast<tile::Smem*>(smem);
  const int C = p.C;
  const RowMap id{0, 1, 1, 1, 1, 0};
  bf16* wide = p.ws_wide + (long long)blockIdx.x * TM * p.wide;
  bf16* narrow = p.ws_narrow + (long long)blockIdx.x * TM * C;
  float* s32 = p.ws_s + (long long)blockIdx.x * TM * C;
  const attn::MappedRows heads_io{wide, narrow, id, p.TN, p.hd, C};
  tile::Acc acc[2][4];

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int m0 = t * TM;
    // the last tile may hold fewer windows; its rows past M stay zero
    const int valid = p.M - m0 < TM ? p.M - m0 : TM;

    // 1. qkv = bf16(x Wqkv + bqkv), (TM, 3C) in window order
    for (int n0 = 0; n0 < 3 * C; n0 += tile::BN) {
      tile::mma(p.x, C, p.img, m0, p.M, p.wqkv, n0, C, gs, acc);
      epilogue(acc, gs, [&](int r, int n, float(&v)[8]) {
        n += n0;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += p.bqkv[n + e];
        store8(wide + (long long)r * 3 * C + n, v);
      });
      __syncthreads();
    }

    // 2. attention of each (window, head) -> (TM, C) bf16
    for (int w = 0; w < valid / p.TN; ++w)
      for (int h = 0; h < p.heads; ++h) {
        attn::attend(heads_io, w, h, smem, p.bias, nullptr, 0, p.TN, p.hd,
                     p.scale);
        __syncthreads();
      }

    // 3. y = bf16(attn Wproj + bproj); s = x + y in fp32
    for (int n0 = 0; n0 < C; n0 += tile::BN) {
      tile::mma(narrow, C, id, 0, TM, p.wproj, n0, C, gs, acc);
      epilogue(acc, gs, [&](int r, int n, float(&v)[8]) {
        n += n0;
        float xv[8];
        if (r < valid) {
          load8(p.x + map_row(p.img, m0 + r) * C + n, xv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = xv[e] + round_bf16(v[e] + p.bproj[n + e]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.0f;
        }
        float4* dst = reinterpret_cast<float4*>(s32 + (long long)r * C + n);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      });
      __syncthreads();
    }

    // 4. LN2(s) -> bf16, over the attention output (no longer read)
    ln_tile(s32, C, p.s2, p.b2, p.eps, narrow, id, 0, TM);
    __syncthreads();

    // 5. GELU(LN2(s) W1 + b1) -> bf16 (TM, hidden), over qkv
    for (int n0 = 0; n0 < p.hidden; n0 += tile::BN) {
      tile::mma(narrow, C, id, 0, TM, p.w1, n0, C, gs, acc);
      epilogue(acc, gs, [&](int r, int n, float(&v)[8]) {
        n += n0;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = activate(v[e] + p.b1[n + e], p.act);
        store8(wide + (long long)r * p.hidden + n, v);
      });
      __syncthreads();
    }

    // 6. m = bf16(h W2 + bw2); s += m
    for (int n0 = 0; n0 < C; n0 += tile::BN) {
      tile::mma(wide, p.hidden, id, 0, TM, p.w2, n0, p.hidden, gs, acc);
      epilogue(acc, gs, [&](int r, int n, float(&v)[8]) {
        n += n0;
        float4* dst = reinterpret_cast<float4*>(s32 + (long long)r * C + n);
        float4 a = dst[0], b = dst[1];
        a.x += round_bf16(v[0] + p.bw2[n]);
        a.y += round_bf16(v[1] + p.bw2[n + 1]);
        a.z += round_bf16(v[2] + p.bw2[n + 2]);
        a.w += round_bf16(v[3] + p.bw2[n + 3]);
        b.x += round_bf16(v[4] + p.bw2[n + 4]);
        b.y += round_bf16(v[5] + p.bw2[n + 5]);
        b.z += round_bf16(v[6] + p.bw2[n + 6]);
        b.w += round_bf16(v[7] + p.bw2[n + 7]);
        dst[0] = a;
        dst[1] = b;
      });
      __syncthreads();
    }

    // 7. out = bf16(LN1(s + m)), back to the image layout
    ln_tile(s32, C, p.s1, p.b1n, p.eps, p.out, p.img, m0, valid);
    __syncthreads();
  }
}

// Dynamic shared memory of one block: the GEMM's stages or one (window,
// head) of attention, whichever is larger.
size_t whole_block_smem(int TN, int hd) {
  const size_t attn_bytes = attn::attn_smem(TN, hd).total;
  return attn_bytes > sizeof(tile::Smem) ? attn_bytes : sizeof(tile::Smem);
}

}  // namespace

// The workspace slots `stswin_whole_block` wants for windows of TN = T *
// ws * ws tokens and head_dim C / heads: the blocks of the kernel the card
// holds at once (SMs times resident blocks an SM), written to `*slots`.
extern "C" int stswin_whole_block_slots(int T, int C, int heads, int ws,
                                        int* slots) {
  if (heads <= 0 || C % heads) return cudaErrorInvalidValue;
  const size_t bytes = whole_block_smem(T * ws * ws, C / heads);
  cudaError_t err = cudaFuncSetAttribute(
      whole_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, whole_block_kernel, tile::THREADS, bytes);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  *slots = per_sm * sms;
  return cudaSuccess;
}

// x, out: (B, T, H, W, C) bf16, image layout; wqkv (3C, C), wproj (C, C),
// w1 (hidden, C), w2 (C, hidden) bf16 in the torch Linear layout; bqkv,
// bproj, s2, b2, b1, bw2, s1, b1n fp32; bias (heads, TN, TN) fp32, TN =
// T * ws * ws. Workspace of `slots` slots: ws_wide (slots, 128,
// max(3C, hidden)) bf16, ws_narrow (slots, 128, C) bf16, ws_s (slots, 128,
// C) fp32. Takes C % 128 == 0, C <= 1024, hidden % 128 == 0, 128 % TN == 0,
// head_dim and TN multiples of 16, and returns cudaErrorInvalidValue on
// anything else.
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
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.wproj = static_cast<const bf16*>(wproj);
  p.bproj = static_cast<const float*>(bproj);
  p.bias = static_cast<const float*>(bias);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
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
  if (C % 128 || C > 1024 || hidden % 128 || heads <= 0 || C % heads ||
      p.hd % 16 || p.TN % 16 || TM % p.TN || H % ws || W % ws || slots <= 0)
    return cudaErrorInvalidValue;
  const size_t bytes = whole_block_smem(p.TN, p.hd);
  cudaError_t err = cudaFuncSetAttribute(
      whole_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < slots ? p.tiles : slots;
  whole_block_kernel<<<grid, tile::THREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
