// Window attention: the per-(window, head) core of K1 and of the two
// standalone attention kernels of the `attn_impl` routes 'pallas' and
// 'pallas_windows'.
//
// Replaces:
//   row 10, stswincl_tpu/ops/pallas_block_attention.py
//     windowed_attention_image (:128) -> _row_kernel (:44): attention on the
//     image-layout qkv (B, T, H, W, 3C), output (B, T, H, W, C);
//   row 11, stswincl_tpu/ops/pallas_attention.py
//     fused_window_attention (:118) / _pallas_attention (:77) ->
//     _attn_kernel (:38): attention on partitioned q, k, v
//     (Bw, heads, TN, hd), windows minor (Bw = batch * nW + window);
//   and the attention step of K1 (block_attention.cu).
//
// Contract (`attend_tiled`): bf16 q k^T with fp32 accumulation, the scale
// applied to the fp32 scores, + the fp32 tiled relative bias (heads, TN,
// TN), + the window's mask (window % n_mask) when there is one per window,
// a max-subtracted exp, the row sum applied as a reciprocal multiply, P
// rounded to bf16 before P V, the output in bf16.
//
// Bound on the H100: device memory. Per (window, head) two TN x TN x hd
// products (TN 128, hd 128 at stage 1; TN 32, hd 256 at stage 2), 64 flops
// a byte of q, k, v and the output at stage 1, far below the card's 295;
// the bias and mask tables (256 KB and 5 MB at stage 1) stay in L2. So the
// design keeps the scores off shared memory and keeps enough loads in
// flight (`attn::pair_core` in attention_core.cuh says how a pair's
// warps keep the scores, softmax and P in registers):
//   - shared memory holds q, k and v of the block's (window, head) pairs,
//     copied with cp.async (105 KB at stage 1, so two blocks an SM, one's
//     loads overlapping the other's products); a pair's warps meet on their
//     own named barrier;
//   - at stage 2 (TN 32: two warps a pair) a block takes two (window,
//     head) pairs, so it still has four warps and two blocks fit an SM.
// The three callers differ only in where a (window, head, token) row
// lives, so the core is one template over an address functor
// (attention_core.cuh); each pair maps its TN rows once, into shared
// memory, before any load:
//   MappedRows: token rows of a (rows, 3C) qkv matrix and a (rows, C)
//     output read through a RowMap: the identity for K1's window-order
//     buffers, the window partition for row 10, which so gathers straight
//     from the image layout and scatters its output back to it: no
//     partitioned copy is formed (that copy is the plain twin's work);
//   HeadMajor: three (Bw, heads, TN, hd) tensors and a (Bw, heads, TN, hd)
//     output (row 11).
// The score registers are sized at compile time: NT, the most 16-key
// tiles a variant takes (2, 4, 8 or 11; TN <= 176, `attn::MAX_NT`).

#include "attention_core.cuh"

namespace {

using attn::HeadMajor;
using attn::MappedRows;
using attn::MAX_NT;
using attn::PairSmem;
using attn::pair_smem;

constexpr size_t PAIR_TARGET = 113 * 1024;  // half an SM's shared memory

// One block: `group` (window, head) pairs, TN / 16 warps each; the pair of
// block b and slot g is b * group + g (pair = window * heads + head). Up
// to 256 threads, two blocks an SM (128 registers a thread), but 352 (11
// warps, one pair) for the widest windows.
template <int NT, class Addr>
__global__ void __launch_bounds__(NT > 8 ? 352 : 256, NT > 8 ? 1 : 2)
    window_attention_mma_kernel(
    Addr a, const float* __restrict__ bias, const float* __restrict__ mask,
    int n_mask, int n_pairs, int heads, int TN, int hd, int group,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PairSmem L = pair_smem(TN, hd);
  const int pt = TN / 16 * 32;  // threads a pair
  const int slot = threadIdx.x / pt;
  const int pair = blockIdx.x * group + slot;
  if (pair >= n_pairs) return;
  // the pair's warps meet on their own barrier (1 + slot; 0 is the block's)
  attn::pair_core<NT>(a, pair / heads, pair % heads, smem + slot * L.total,
                        threadIdx.x - slot * pt, pt, 1 + slot, bias, mask,
                        n_mask, TN, hd, scale);
}

template <int NT, class Addr>
cudaError_t launch_nt(const Addr& a, int n_pairs, int heads, int TN, int hd,
                      const float* bias, const float* mask, int n_mask,
                      float scale, cudaStream_t s) {
  const PairSmem L = pair_smem(TN, hd);
  const int pt = TN / 16 * 32;
  int group = 256 / pt;
  const int fit = static_cast<int>(PAIR_TARGET / L.total);
  if (group > fit) group = fit;
  if (group < 1) group = 1;
  const size_t bytes = group * L.total;
  // once per instance: let it ask for the most shared memory a block may
  static int optin = 0;
  if (!optin) {
    int dev = 0, most = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_attention_mma_kernel<NT, Addr>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return err;
    optin = most;
  }
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  window_attention_mma_kernel<NT, Addr>
      <<<(n_pairs + group - 1) / group, group * pt, bytes, s>>>(
          a, bias, mask, n_mask, n_pairs, heads, TN, hd, group, scale);
  return cudaGetLastError();
}

template <class Addr>
cudaError_t launch(const Addr& a, int n_windows, int heads, int TN, int hd,
                   const float* bias, const float* mask, int n_mask,
                   float scale, cudaStream_t s) {
  if (TN <= 0 || TN % 16 || TN > 16 * MAX_NT || hd <= 0 || hd % 16)
    return cudaErrorInvalidValue;
  const float* m = n_mask > 1 ? mask : nullptr;
  const int n_pairs = n_windows * heads, nt = TN / 16;
  if (nt <= 2)
    return launch_nt<2>(a, n_pairs, heads, TN, hd, bias, m, n_mask, scale, s);
  if (nt <= 4)
    return launch_nt<4>(a, n_pairs, heads, TN, hd, bias, m, n_mask, scale, s);
  if (nt <= 8)
    return launch_nt<8>(a, n_pairs, heads, TN, hd, bias, m, n_mask, scale, s);
  return launch_nt<MAX_NT>(a, n_pairs, heads, TN, hd, bias, m, n_mask, scale,
                           s);
}

}  // namespace

cudaError_t window_attention_rows(const bf16* qkv, bf16* out, RowMap map,
                                  int n_windows, int heads, int TN, int hd,
                                  int C, const float* bias, const float* mask,
                                  int n_mask, float scale,
                                  cudaStream_t stream) {
  return launch(MappedRows{qkv, out, map, TN, hd, C}, n_windows, heads, TN,
                hd, bias, mask, n_mask, scale, stream);
}

// Row 10. qkv (B, T, H, W, 3C) bf16, out (B, T, H, W, C) bf16, both in the
// image layout; mask (nH * nW, TN, TN), one entry per window of an image
// (index i * nW + j, the same for every batch element), when n_mask > 1.
extern "C" int stswin_window_attention_image(
    const void* qkv, const void* bias, const void* mask, void* out, int B,
    int T, int H, int W, int C, int heads, int ws, float scale, int n_mask,
    void* stream) {
  const int TN = T * ws * ws, n_windows = B * (H / ws) * (W / ws);
  return window_attention_rows(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      RowMap{1, T, H, W, ws, 0}, n_windows, heads, TN, C / heads, C,
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      n_mask, scale, static_cast<cudaStream_t>(stream));
}

// Row 11. q, k, v, out: (Bw, heads, TN, hd) bf16; mask (n_mask, TN, TN)
// indexed by window % n_mask (windows minor), when n_mask > 1.
extern "C" int stswin_window_attention_heads(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, void* out, int Bw, int heads, int TN, int hd,
    float scale, int n_mask, void* stream) {
  HeadMajor a{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v)},
              static_cast<bf16*>(out), heads, TN, hd};
  return launch(a, Bw, heads, TN, hd, static_cast<const float*>(bias),
                static_cast<const float*>(mask), n_mask, scale,
                static_cast<cudaStream_t>(stream));
}
