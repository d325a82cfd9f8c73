// Row 17: y = [ReLU](conv3x3(x, w; dilation d, stride 1, pad d) * scale
// + shift [+ residual]), NHWC bf16 in and out, fp32 accumulation and
// epilogue (inference-folded BatchNorm as scale / shift).
//
// Replaces: stswincl_tpu/ops/pallas_conv.py conv3x3_bn_act (:132) ->
//   _conv_kernel (:71).
//
// Bound on the H100: the tensor cores. 2 * N*H*W * Cout * 9*Cin flops
// against (N*H*W * (Cin + Cout [+ Cout]) + 9*Cin*Cout) * 2 bytes: about
// 1,000 flops a byte at Cin = Cout = 512, far above the card's 295.
//
// Design: an implicit GEMM on the port's GEMM tile (gemm_tile.cuh), no
// padded or im2col copy of x. M = N*H*W output pixels, N = Cout, K = 9*Cin
// ordered tap by tap (tap = 3 ky + kx); the wrapper rearranges w (OIHW)
// to (Cout, 9*Cin), tap-major, the tile's Wt layout. A k tile of 32
// channels lies within one tap (Cin % 32 == 0), so each thread gathers its
// two 16-byte A chunks from pixel (h + (ky - 1) d, w + (kx - 1) d) of the
// same image; a pixel in the padding is zero-filled by cp.async with a
// source size of 0 (from a valid address, x itself), so any dilation works,
// d >= H / 2 included, where most taps read padding. The TPU kernel
// pre-padded x and pre-sliced its three column taps in XLA (Mosaic could
// not slice the sublane axis at kx * d) and double-buffered halo row bands
// into VMEM; none of that is needed here. The epilogue stages each 16 x 16
// accumulator fragment in shared memory: * scale + shift, + residual,
// ReLU in fp32, then one 16-byte bf16 store per lane.

#include "gemm_tile.cuh"

namespace {

struct ConvParams {
  const bf16* x;      // (N, H, W, Cin)
  const bf16* wt;     // (Cout, 9 * Cin), tap-major
  const float* scale;  // (Cout,)
  const float* shift;  // (Cout,)
  const bf16* res;    // (N, H, W, Cout) or null
  bf16* out;          // (N, H, W, Cout)
  int M, H, W, Cin, Cout, d, relu;
};

__global__ void __launch_bounds__(tile::THREADS) conv_kernel(ConvParams p) {
  using namespace nvcuda;
  __shared__ __align__(128) tile::Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * tile::BM, n0 = blockIdx.x * tile::BN;
  const int K = 9 * p.Cin;

  // each thread copies two 16-byte chunks of A and of Wt per k tile; its
  // A rows are output pixels (n, h, w), read at the tap's offset
  const bf16* a_src[2];
  const bf16* w_src[2];
  int ph[2], pw[2], s_off[2];
  bool a_ok[2], w_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int r, col;
    tile::chunk(tid, i, r, col);
    const int m = m0 + r;
    a_ok[i] = m < p.M;
    const int mm = a_ok[i] ? m : 0;
    pw[i] = mm % p.W;
    ph[i] = (mm / p.W) % p.H;
    a_src[i] = p.x + (long long)mm * p.Cin + col;
    w_ok[i] = n0 + r < p.Cout;
    w_src[i] = p.wt + (long long)(w_ok[i] ? n0 + r : 0) * K + col;
    s_off[i] = r * tile::LDS + col;
  }
  auto load = [&](int stage, int kt) {
    const int k0 = kt * tile::BK;
    const int tap = k0 / p.Cin, ci = k0 - tap * p.Cin;
    const int dy = (tap / 3 - 1) * p.d, dx = (tap % 3 - 1) * p.d;
    const long long off = ((long long)dy * p.W + dx) * p.Cin + ci;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = ph[i] + dy, w = pw[i] + dx;
      const bool ok = a_ok[i] && h >= 0 && h < p.H && w >= 0 && w < p.W;
      tile::cp_async16(&sm.A[stage][s_off[i]], ok ? a_src[i] + off : p.x, ok);
      tile::cp_async16(&sm.W[stage][s_off[i]], w_src[i] + k0, w_ok[i]);
    }
    tile::cp_async_commit();
  };
  tile::Acc acc[2][4];
  tile::mainloop(K / tile::BK, load, sm, acc);

  float* st = tile::staging(sm, warp);
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c0;
      // Cout % 8 == 0: a lane's 8 channels lie all below Cout or all past
      if (m < p.M && n < p.Cout) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = st[r * 16 + c0 + e] * p.scale[n + e] + p.shift[n + e];
        const long long o = (long long)m * p.Cout + n;
        if (p.res) {
          __align__(16) bf16 rv[8];
          *reinterpret_cast<uint4*>(rv) =
              *reinterpret_cast<const uint4*>(p.res + o);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(rv[e]);
        }
        __align__(16) bf16 ov[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ov[e] = __float2bfloat16(p.relu ? fmaxf(v[e], 0.0f) : v[e]);
        *reinterpret_cast<uint4*>(p.out + o) =
            *reinterpret_cast<const uint4*>(ov);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x (N, H, W, Cin), wt (Cout, 9 * Cin) tap-major, residual (N, H, W, Cout)
// or null, out (N, H, W, Cout): bf16; scale, shift (Cout,) fp32. Cin a
// multiple of 32, Cout of 8, dilation >= 1.
extern "C" int stswin_conv3x3_bn_act(const void* x, const void* wt,
                                     const void* scale, const void* shift,
                                     const void* residual, void* out, int N,
                                     int H, int W, int Cin, int Cout,
                                     int dilation, int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % tile::BK ||
      Cout <= 0 || Cout % 8 || dilation < 1)
    return cudaErrorInvalidValue;
  const long long M = (long long)N * H * W;
  if ((M + tile::BM - 1) / tile::BM > 65535) return cudaErrorInvalidValue;
  ConvParams p{static_cast<const bf16*>(x),
               static_cast<const bf16*>(wt),
               static_cast<const float*>(scale),
               static_cast<const float*>(shift),
               static_cast<const bf16*>(residual),
               static_cast<bf16*>(out),
               static_cast<int>(M), H, W, Cin, Cout, dilation, relu};
  const dim3 grid((Cout + tile::BN - 1) / tile::BN,
                  static_cast<unsigned>((M + tile::BM - 1) / tile::BM));
  conv_kernel<<<grid, tile::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return cudaGetLastError();
}
