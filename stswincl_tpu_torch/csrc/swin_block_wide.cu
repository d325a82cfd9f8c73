// Row 16's wide instances (swin_block.cuh, `WIDE` true): every shape K1 +
// K2 take, in a translation unit of their own so that they build beside
// the first kernel's instances (swin_block.cu) in parallel.

#include "swin_block.cuh"

namespace whole_block {

cudaError_t run_wide(int TN, int hd, const WholeMaps* maps,
                     const WholeParams* p, int grid, cudaStream_t stream,
                     int* per_sm) {
  if (TN <= TM) return run<8, true>(TN, hd, maps, p, grid, stream, per_sm);
  return run<attn::MAX_NT, true>(TN, hd, maps, p, grid, stream, per_sm);
}

}  // namespace whole_block
