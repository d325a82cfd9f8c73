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
`cudaGetLastError()`; `launch` raises if that is not 0. The library
carries its own CUDA runtime, whose current device is its own per host
thread: `launch` sets it to the tensors' device whenever that differs from
the one last set on the calling thread (`stswin_set_device`), so a rank on
`cuda:N` and autograd's device threads launch on the right card. The C
side keeps each device query and shared-memory opt-in per device.
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
_LLP = ctypes.POINTER(ctypes.c_longlong)
# C entry name -> argument types (pointers, then ints/floats, then stream)
SIGNATURES = {
    "stswin_block_attention": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P],
    "stswin_block_attention_f32": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P],
    "stswin_block_attention_bwd": [_P] * 17 + [_I] * 7 + [_F, _I, _I, _P],
    "stswin_block_epilogue": [_P] * 15 + [_I] * 7 + [_F, _P],
    "stswin_block_epilogue_f32": [_P] * 15 + [_I] * 7 + [_F, _P],
    "stswin_block_epilogue_bwd": [_P] * 33 + [_I] * 7 + [_F, _P],
    "stswin_patch_merge": [_P] * 6 + [_I] * 4 + [_F, _P],
    "stswin_patch_merge_f32": [_P] * 6 + [_I] * 4 + [_F, _P],
    "stswin_upsample_argmax": [_P] * 6 + [_I] * 7 + [_P],
    "stswin_window_attention_image": [_P] * 4 + [_I] * 7 + [_F, _I, _P],
    "stswin_window_attention_heads": [_P] * 6 + [_I] * 4 + [_F, _I, _P],
    "stswin_window_attention_image_f32": [_P] * 4 + [_I] * 7 + [_F, _I, _P],
    "stswin_window_attention_heads_f32": [_P] * 6 + [_I] * 4 + [_F, _I, _P],
    "stswin_whole_block": [_P] * 18 + [_I] * 10 + [_F, _F, _P],
    "stswin_whole_block_f32": [_P] * 18 + [_I] * 10 + [_F, _F, _P],
    # queries, not launches: (T, C, heads, ws, int* slots), no stream
    "stswin_whole_block_slots": [_I] * 4 + [ctypes.POINTER(_I)],
    "stswin_whole_block_f32_slots": [_I] * 4 + [ctypes.POINTER(_I)],
    # queries, not launches: (TN, hd, int* group, long long* total)
    "stswin_whole_block_layout": [_I] * 2 + [ctypes.POINTER(_I), _LLP],
    "stswin_whole_block_f32_layout": [_I] * 2 + [ctypes.POINTER(_I), _LLP],
    "stswin_add_ln_mlp": [_P] * 13 + [_I] * 4 + [_F, _P],
    "stswin_add_layer_norm": [_P] * 6 + [_I] * 2 + [_F, _P],
    "stswin_mlp": [_P] * 7 + [_I] * 4 + [_P],
    "stswin_layer_norm": [_P] * 4 + [_I] * 2 + [_F, _P],
    "stswin_conv3x3_bn_act": [_P] * 6 + [_I] * 9 + [_P],
    "stswin_mlp_f32": [_P] * 7 + [_I] * 4 + [_P],
    "stswin_add_ln_mlp_f32": [_P] * 12 + [_I] * 4 + [_F, _P],
    "stswin_add_layer_norm_f32": [_P] * 6 + [_I] * 2 + [_F, _P],
    "stswin_layer_norm_f32": [_P] * 4 + [_I] * 2 + [_F, _P],
    "stswin_conv3x3_bn_act_f32": [_P] * 6 + [_I] * 7 + [_P],
    "stswin_gemm_sm90": [_P] * 8 + [_I] * 15 + [_P],
    "stswin_gelu_bwd_sm90": [_P] * 9 + [_I] * 4 + [_P],
    "stswin_wgrad_sm90": [_P] * 4 + [_I] * 13 + [_P],
    # queries, not launches: the bf16 backwards' workspace in floats (the
    # partials their fixed-order sums add)
    "stswin_block_attention_bwd_work": [_I] * 4 + [_LLP],
    "stswin_block_epilogue_bwd_work": [_I] * 3 + [_LLP],
    "stswin_wgrad_sm90_work": [_I] * 3 + [_LLP],
    # a query, not a launch: (long long* counts, int reset), no stream
    "stswin_gemm_sm90_launches": [ctypes.POINTER(ctypes.c_longlong), _I],
    "stswin_gemm_f32": [_P] * 8 + [_I] * 15 + [_P],
    # a query, not a launch: (long long* counts, int reset), no stream
    "stswin_gemm_f32_launches": [ctypes.POINTER(ctypes.c_longlong), _I],
    # a query, not a launch: (long long* count, int reset), no stream
    "stswin_conv_f32_k_tiles": [ctypes.POINTER(ctypes.c_longlong), _I],
    "stswin_block_attention_bwd_f32": [_P] * 15 + [_I] * 7 + [_F, _I, _I,
                                                              _P],
    "stswin_attn_bwd_f32": [_P] * 7 + [_I] * 4 + [_F, _I, _P],
    "stswin_attn_bwd": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    "stswin_block_epilogue_bwd_f32": [_P] * 24 + [_I] * 7 + [_F, _P],
    "stswin_wgrad_f32": [_P] * 4 + [_I] * 13 + [_P],
    # queries, not launches: the fp32 scratch of an entry in floats, and
    # the attention backward's shared memory (-1: a window it refuses)
    "stswin_block_attention_bwd_f32_work": [_I] * 4 + [_LLP],
    "stswin_block_epilogue_bwd_f32_work": [_I] * 4 + [_LLP],
    "stswin_wgrad_f32_work": [_I] * 3 + [_LLP],
    "stswin_gemm_f32_colsum_work": [_I] * 2 + [_LLP],
    "stswin_attn_bwd_f32_smem": [_I] * 2 + [_LLP],
    # queries, not launches: the fp32 attention core's shared memory for a
    # (TN, hd) window (-1: a window it refuses), and the launches of the
    # streamed forms (int reset, long long* count), no stream
    "stswin_attn_f32_smem": [_I] * 2 + [_LLP],
    "stswin_attn_f32_streamed_launches": [_I, _LLP],
    "stswin_attn_bwd_f32_streamed_launches": [_I, _LLP],
    # the same for the bf16 core (its streamed instance), and the bf16
    # attention backward's workspace (floats) and runs of its two passes
    "stswin_attn_smem": [_I] * 2 + [_LLP],
    "stswin_attn_streamed_launches": [_I, _LLP],
    "stswin_attn_bwd_work": [_I] * 4 + [_LLP],
    "stswin_attn_bwd_passes_launches": [_I, _LLP],
    # row 16's launches whose attention phase ran the streamed pair
    "stswin_whole_block_streamed_launches": [_I, _LLP],
    "stswin_whole_block_f32_streamed_launches": [_I, _LLP],
    # sets the library runtime's current device of the calling thread
    "stswin_set_device": [_I],
}

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90

_lock = threading.Lock()
_lib = None
_thread = threading.local()  # .device: the index last set on this thread
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


def use_device(device: torch.device) -> int:
    """Make `device` the library runtime's current device on the calling
    thread, if it is not the one last set there; returns its index."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if getattr(_thread, "device", None) != index:
        err = load().stswin_set_device(index)
        if err != 0:
            raise RuntimeError(f"stswin_set_device({index}): CUDA error "
                               f"{err}")
        _thread.device = index
    return index


def query(name: str, *args: int) -> int:
    """Call C query `name` (ints in, one long long out): a size the library
    computes from shapes, such as the scratch of an fp32 backward entry."""
    out = ctypes.c_longlong()
    err = getattr(load(), name)(*args, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{name}: error {err}")
    return out.value


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry `name` on the current CUDA stream of `device`, with the
    library runtime's current device set to it (`use_device`); raise on a
    CUDA error reported by the launch."""
    lib = load()
    use_device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(cond: bool, msg) -> None:
    """Raise ValueError(msg) unless cond; `msg` a string or, where forming
    it would cost a launch's host time, a function that returns it."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


# The checks below form their messages only when they fail: a wrapper
# calls them on every launch, and rows 14-15 take 0.05-0.3 ms on the card.
def require_bf16(name: str, row: str, *tensors: torch.Tensor) -> None:
    """The bf16 form `name` takes bfloat16 only; `row` names what it ports
    ("Pallas row 12"). Every kernel's fp32 form is a function of its own,
    to which the public wrapper sends an fp32 CUDA tensor, so an fp32
    tensor here is a caller's slip."""
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} ({row}): the bf16 form takes bfloat16, "
                             f"got {t.dtype}")


def require_form(name: str, row, *tensors: torch.Tensor) -> None:
    """The dtype a kernel form takes: `row` None for an fp32 form
    (`require_f32`), else the bf16 kernel that ports `row`
    (`require_bf16`)."""
    if row is None:
        require_f32(name, *tensors)
    else:
        require_bf16(name, row, *tensors)


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
