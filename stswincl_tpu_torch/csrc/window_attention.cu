// Window attention: the per-(window, head) core shared by K1 and by the two
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
// Bound on the H100: per (window, head) two TN x TN x hd products (TN 128,
// hd 128 at stage 1; TN 32, hd 256 at stage 2) and a TN x TN fp32 softmax.
// Device memory sees q, k, v and the output once each; the bias and mask
// tables (256 KB and 5 MB at stage 1) stay in L2. The block is bound by
// shared-memory traffic and the fp32 softmax, as long as the scores never
// leave the SM.
//
// Design: one block per (window, head), the grid K1's core always used.
// q, k, v of the block go to shared memory with 16-byte loads (each row is
// hd contiguous bf16 in every layout), the fp32 scores and the bf16 P stay
// there (203 KB at stage 1, opted in above 48 KB), wmma 16x16x16 bf16
// fragments compute both products, and the output leaves in 16-byte
// stores. The three callers differ only in where a (window, head, token)
// row lives, so the body is one template over an address functor; the
// block maps each of its TN rows once, into shared memory, before any
// load, so a gather (integer divisions per row) costs TN address
// computations a block, not one per 16-byte chunk:
//   MappedRows: token rows of a (rows, 3C) qkv matrix and a (rows, C)
//     output read through a RowMap: the identity for K1's window-order
//     buffers, the window partition for row 10, which so gathers straight
//     from the image layout and scatters its output back to it: no
//     partitioned copy is formed (that copy is the plain twin's work);
//   HeadMajor: three (Bw, heads, TN, hd) tensors and a (Bw, heads, TN, hd)
//     output (row 11).

#include "attention_core.cuh"

namespace {

using attn::AttnSmem;
using attn::attn_smem;
using attn::HeadMajor;
using attn::MappedRows;

template <class Addr>
__global__ void __launch_bounds__(ATT_THREADS)
    window_attention_kernel(Addr a, const float* __restrict__ bias,
                            const float* __restrict__ mask, int n_mask,
                            int TN, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn::attend(a, blockIdx.x, blockIdx.y, smem, bias, mask, n_mask, TN, hd,
               scale);
}

template <class Addr>
cudaError_t launch(const Addr& a, int n_windows, int heads, int TN, int hd,
                   const float* bias, const float* mask, int n_mask,
                   float scale, cudaStream_t s) {
  const AttnSmem L = attn_smem(TN, hd);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<Addr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  window_attention_kernel<Addr>
      <<<dim3(n_windows, heads), ATT_THREADS, L.total, s>>>(
          a, bias, n_mask > 1 ? mask : nullptr, n_mask, TN, hd, scale);
  return cudaGetLastError();
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
