"""The tensor cores' TF32 rate through mma.sync and through wgmma, the
instructions the port's 3xTF32 products run on.

    python3 -m stswincl_tpu_torch.tools.profile_mma_rate [--iters 20000]

mma.sync (the fp32 attention cores): a kernel of nothing but
`mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` on eight independent
accumulators a warp (no loads, no dependence between consecutive
instructions), two blocks an SM, at 4, 8 and 16 warps an SM.

wgmma (the fp32 GEMM tile, `csrc/fp32_gemm.cuh`): one block an SM of two
warpgroups, each issuing `wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32
.tf32` on a 128 x 32 B tile and its own 64 x 32 A tile in shared memory
(128-byte swizzle, the tile's descriptors), groups of 12 (a k tile's
three passes of four k8 steps) with one group in flight behind the one
issued: "from shared memory" (both operands from shared memory: the
instruction's own rate, the bound's TF32 rate) and "A from registers"
(as the tile issues it); and "as the tile" (A from registers, each group
summed from zero, waited for and added to fp32 sums: `f32t::ktile`
without the loads and the split that feed it).

CUDA-event time of one launch after a warm-up, TFLOP/s and share of the
H100's dense TF32 peak (494.7 TFLOP/s). A third of the rate is the
ceiling of a 3xTF32 product on that instruction. The kernels are built
here from their source below (the wgmma ones on the tile's own wrappers,
`-I csrc`) by the toolkit's `nvcc` into the package's build directory;
they are measurements, not kernels of the port. Prints the card's name
and power limit. Needs a CUDA card.
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

#include "fp32_gemm.cuh"

// d += a b, both from shared memory (descriptors), m64n128k8 tf32
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1;\n"
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
      : "l"(da), "l"(db));
}

// MODE 0: A from shared memory; 1: A from registers (the tile's wrapper);
// 2: as the tile (each group from zero, waited for, added to fp32 sums)
template <int MODE>
__global__ void __launch_bounds__(256, 1) wgmma_rate(float* out, int iters) {
  extern __shared__ unsigned char raw[];
  float* s = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  for (int i = threadIdx.x; i < 4 * 64 * 32; i += 256)
    s[i] = 1.0f + (i % 7) * 0.125f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint32_t sa = smem_u32(s) + wg * 8192, sb = smem_u32(s) + 16384;
  float d[64], sum[64];
  for (int i = 0; i < 64; ++i) d[i] = sum[i] = 0.0f;
  uint32_t a[4][4];
  for (int k = 0; k < 4; ++k)
    for (int j = 0; j < 4; ++j)
      a[k][j] = __float_as_uint(1.0f + ((threadIdx.x + k + j) & 3) * 0.25f);
  for (int it = 0; it < iters; ++it) {
    sm90::fence_acc(d);
    sm90::wgmma_fence();
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sm90::sw128_desc(sb + kk * 32);
        if (MODE == 0)
          wgmma_ss(d, sm90::sw128_desc(sa + kk * 32), db);
        else if (MODE == 2 && pass == 0 && kk == 0)
          f32t::wgmma_tf32_set(d, a[kk], db);
        else
          f32t::wgmma_tf32_add(d, a[kk], db);
      }
    sm90::wgmma_commit();
    if (MODE == 2) {
      sm90::wgmma_wait<0>();
      sm90::fence_acc(d);
      for (int i = 0; i < 64; ++i) sum[i] += d[i];
    } else {
      sm90::wgmma_wait<1>();
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc(d);
  float t = 0.0f;
  for (int i = 0; i < 64; ++i) t += d[i] + sum[i];
  out[blockIdx.x * 256 + threadIdx.x] = t;
}

extern "C" int wgmma_rate_run(float* out, int blocks, int iters, int mode) {
  const int smem = 1024 + 4 * 64 * 32 * 4;  // two A tiles, B
  cudaError_t e = cudaSuccess;
  switch (mode) {
    case 0:
      e = cudaFuncSetAttribute(wgmma_rate<0>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      wgmma_rate<0><<<blocks, 256, smem>>>(out, iters);
      break;
    case 1:
      e = cudaFuncSetAttribute(wgmma_rate<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      wgmma_rate<1><<<blocks, 256, smem>>>(out, iters);
      break;
    default:
      e = cudaFuncSetAttribute(wgmma_rate<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      wgmma_rate<2><<<blocks, 256, smem>>>(out, iters);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}
"""
PEAK_TF32 = 494.7e12
MMA_FLOP = 2 * 16 * 8 * 8
WGMMA_FLOP = 2 * 64 * 128 * 8
WGMMA_MODES = ("from shared memory", "A from registers", "as the tile")


def build() -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / "mma_rate.cu"
    lib = kernels.BUILD_DIR / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                    str(kernels.CSRC), "-shared", "-o", str(lib), str(src)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    so.mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
    so.mma_rate.restype = ctypes.c_int
    so.wgmma_rate_run.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
    so.wgmma_rate_run.restype = ctypes.c_int
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
    wg_iters = max(1, args.iters // 10)
    for mode, name in enumerate(WGMMA_MODES):
        if so.wgmma_rate_run(out.data_ptr(), sms, 10, mode):
            raise RuntimeError("wgmma_rate: launch failed")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        so.wgmma_rate_run(out.data_ptr(), sms, wg_iters, mode)
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        flops = sms * 2 * wg_iters * 12 * WGMMA_FLOP
        rates[f"wgmma {name}"] = rate = flops / ms * 1e-9
        print(f"wgmma m64n128k8 tf32, {name}: {rate:.1f} TFLOP/s "
              f"({rate * 1e12 / PEAK_TF32:.3f} of the TF32 peak; 3xTF32 on "
              f"it at most {rate / 3:.1f}) on {smi}", flush=True)
    return rates


if __name__ == "__main__":
    main()
