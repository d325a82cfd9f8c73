"""The tensor cores' TF32 rate through mma.sync, the instruction the fp32
attention core and `wgrad_f32` run their 3xTF32 products on.

    python3 -m stswincl_tpu_torch.tools.profile_mma_rate [--iters 20000]

A kernel of nothing but `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`
on eight independent accumulators a warp (no loads, no dependence between
consecutive instructions), two blocks an SM, at 4, 8 and 16 warps an SM;
CUDA-event time of one launch after a warm-up, TFLOP/s and share of the
H100's dense TF32 peak (494.7 TFLOP/s, which `wgmma` reaches and mma.sync
need not). A third of the rate is the ceiling of a 3xTF32 product on
mma.sync. The kernel is built here from its source below by the toolkit's
`nvcc` into the package's build directory; it is a measurement, not a
kernel of the port. Prints the card's name and power limit. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from stswincl_tpu_torch import kernels

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = 5u, b1 = threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[u][0]), "+f"(d[u][1]), "+f"(d[u][2]), "+f"(d[u][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
  for (int u = 0; u < 8; ++u) s += d[u][0] + d[u][1] + d[u][2] + d[u][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(float* out, int blocks, int threads, int iters) {
  rate<<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""
PEAK_TF32 = 494.7e12
MMA_FLOP = 2 * 16 * 8 * 8


def build() -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / "mma_rate.cu"
    lib = kernels.BUILD_DIR / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
    so.mma_rate.restype = ctypes.c_int
    return so


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mma_rate needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    so = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 2 * sms
    out = torch.empty(blocks * 512, device="cuda")
    rates = {}
    for warps in (4, 8, 16):
        threads = warps * 32 // 2
        if so.mma_rate(out.data_ptr(), blocks, threads, 10):
            raise RuntimeError("mma_rate: launch failed")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        so.mma_rate(out.data_ptr(), blocks, threads, args.iters)
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        flops = blocks * threads // 32 * args.iters * 8 * MMA_FLOP
        rates[warps] = flops / ms * 1e-9
        share = rates[warps] * 1e12 / PEAK_TF32
        print(f"mma.sync m16n8k8 tf32, {warps:2d} warps an SM: "
              f"{rates[warps]:.1f} TFLOP/s ({share:.3f} of the TF32 peak; "
              f"3xTF32 on it at most {rates[warps] / 3:.1f}) on {smi}",
              flush=True)
    return rates


if __name__ == "__main__":
    main()
