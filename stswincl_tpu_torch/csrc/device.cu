// The library's own CUDA runtime (linked statically into the shared
// library) keeps a current device per host thread, apart from PyTorch's.
// `kernels.launch` sets it to the device of the tensors it launches on,
// once a thread and device change: a rank on cuda:N, and autograd's
// device threads, whose runtime device starts at 0.
#include <cuda_runtime.h>

extern "C" int stswin_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
