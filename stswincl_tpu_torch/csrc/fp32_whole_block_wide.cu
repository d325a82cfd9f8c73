// Row 16's fp32 wide instances (fp32_whole_block.cuh, `WIDE` true): every
// shape K1 + K2 take, in a translation unit of their own so that they
// build beside the first form's instances (fp32_whole_block.cu) in
// parallel.

#include "fp32_whole_block.cuh"

namespace whole_block_f32 {

cudaError_t run_wide(int TN, int hd, const WholeF32* p, int grid,
                     cudaStream_t stream, int* per_sm) {
  if (TN <= TM) return run<16, true>(TN, hd, p, grid, stream, per_sm);
  return run<22, true>(TN, hd, p, grid, stream, per_sm);
}

}  // namespace whole_block_f32
