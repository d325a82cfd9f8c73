"""Build, load and call the hand-written Hopper kernels in `../csrc/`.

The CUDA sources have a plain C interface. At first use each is compiled
by its own `nvcc`, all started together, and the objects are linked into
one shared library, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -I csrc -c -o <tmp>/<name>.o csrc/<name>.cu
    nvcc -shared -o _build/libstswin_kernels_<hash>.so <tmp>/*.o

The file name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is loaded as it is. Nothing here runs at
import time: a machine without `nvcc` or a GPU imports the package, and
only a call that launches a kernel needs them.

Each C entry launches on the stream it is given (the caller passes
`torch.cuda.current_stream()`), allocates nothing and returns
`cudaGetLastError()`; `launch` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry name -> argument types (pointers, then ints/floats, then stream)
SIGNATURES = {
    "stswin_block_attention": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P],
    "stswin_block_attention_bwd": [_P] * 16 + [_I] * 7 + [_F, _I, _I, _P],
    "stswin_block_epilogue": [_P] * 15 + [_I] * 7 + [_F, _P],
    "stswin_block_epilogue_bwd": [_P] * 32 + [_I] * 7 + [_F, _P],
    "stswin_patch_merge": [_P] * 6 + [_I] * 4 + [_F, _P],
    "stswin_upsample_argmax": [_P] * 6 + [_I] * 7 + [_P],
    "stswin_window_attention_image": [_P] * 4 + [_I] * 7 + [_F, _I, _P],
    "stswin_window_attention_heads": [_P] * 6 + [_I] * 4 + [_F, _I, _P],
    "stswin_whole_block": [_P] * 18 + [_I] * 10 + [_F, _F, _P],
    # a query, not a launch: (T, C, heads, ws, int* slots), no stream
    "stswin_whole_block_slots": [_I] * 4 + [ctypes.POINTER(_I)],
    # a query, not a launch: (TN, hd, int* group, long long* total)
    "stswin_whole_block_layout": [_I] * 2 + [ctypes.POINTER(_I),
                                            ctypes.POINTER(ctypes.c_longlong)],
    "stswin_add_ln_mlp": [_P] * 13 + [_I] * 4 + [_F, _P],
    "stswin_add_layer_norm": [_P] * 6 + [_I] * 2 + [_F, _P],
    "stswin_mlp": [_P] * 7 + [_I] * 4 + [_P],
    "stswin_layer_norm": [_P] * 4 + [_I] * 2 + [_F, _P],
    "stswin_conv3x3_bn_act": [_P] * 6 + [_I] * 9 + [_P],
    "stswin_gemm_sm90": [_P] * 7 + [_I] * 15 + [_P],
    "stswin_gelu_bwd_sm90": [_P] * 8 + [_I] * 4 + [_P],
    "stswin_wgrad_sm90": [_P] * 3 + [_I] * 13 + [_P],
    # a query, not a launch: (long long* counts, int reset), no stream
    "stswin_gemm_sm90_launches": [ctypes.POINTER(ctypes.c_longlong), _I],
}

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last nvcc run in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "on a machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstswin_kernels_{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists:
    one `nvcc` a source, all at once, then one link. `verbose` adds
    `-Xptxas -v` (registers, shared memory, spills per kernel) and prints
    the compiler's output."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    ptxas = ("-Xptxas", "-v") if verbose else ()
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, jobs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-I", str(CSRC), "-c", "-o",
                   obj, str(src)]
            objs.append(obj)
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, so.name)
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(lib, so)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print("".join(log))
    return so


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:  # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def use_kernels(flag: bool | None, x: torch.Tensor) -> bool:
    """A model's `kernels` argument: None means "the kernels iff x is on
    CUDA"; True or False forces the kernel or the plain route."""
    return x.is_cuda if flag is None else flag


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def needs_grad(*tensors) -> bool:
    """True when autograd will ask for a gradient of one of `tensors`:
    the wrappers then go through their autograd Function."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry `name` on the current CUDA stream of `device`; raise on
    a CUDA error reported by the launch. The library's own CUDA runtime
    launches on its current device, device 0: the kernels serve one card."""
    if device.index not in (None, 0):
        raise ValueError(f"{name}: the kernels run on cuda:0, got {device}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(load(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(cond: bool, msg) -> None:
    """Raise ValueError(msg) unless cond; `msg` a string or, where forming
    it would cost a launch's host time, a function that returns it."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


# The checks below form their messages only when they fail: a wrapper
# calls them on every launch, and rows 14-15 take 0.05-0.3 ms on the card.
def require_bf16_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels compute in bfloat16 only."""
    for t in tensors:
        if t.dtype == torch.float32:
            raise NotImplementedError(
                f"{name}: the CUDA kernel takes bfloat16 activations and "
                "weights; float32 runs the plain twin on the CPU")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: dtype {t.dtype}")


def require_f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")


def require_on(device: torch.device, name: str, *tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: tensor on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input "
                             f"{tuple(t.shape)}")
