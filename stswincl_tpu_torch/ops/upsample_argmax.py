"""K4: fused full-resolution bilinear upsample + class argmax.

Counterpart of `upsample_argmax_pallas` in
`stswincl_tpu/ops/pallas_upsample_argmax.py` and of the einsum branch of
`composed_upsample_argmax_cf`. `upsample_argmax` launches the CUDA kernel
in `csrc/upsample_argmax.cu` on a CUDA tensor and runs the plain twin
`upsample_argmax_ref` on a CPU tensor. Ties go to the first class.

`exact=True` keeps every product input in fp32 (the protocol an fp32
model's streaming uses); otherwise the logits, both matrices and the
intermediate t are rounded to bf16 first, as the TPU kernel's bf16 matmul
inputs are, with fp32 sums.
"""

from __future__ import annotations

import torch

from stswincl_tpu_torch import kernels


def upsample_argmax_ref(lcf: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor,
                        exact: bool = False) -> torch.Tensor:
    """lcf: (B, C, h, w); mh: (OH, h); mw: (OW, w) -> (B, OH, OW) int32."""
    def rnd(t):
        t = t.float()
        return t if exact else t.to(torch.bfloat16).float()
    t = rnd(torch.einsum("oh,bchw->bcow", rnd(mh), rnd(lcf)))
    y = torch.einsum("pw,bcow->bcop", rnd(mw), t)
    return torch.argmax(y, dim=1).to(torch.int32)


def interp_spans(m: torch.Tensor) -> torch.Tensor:
    """(rows, 2) int32 [lo, hi) of the nonzero columns of each row of the
    (rows, n) matrix m, on m's device and without a host sync; an all-zero
    row gets the empty span [0, 0). The span covers every nonzero of its
    row, zeros between them included."""
    n = m.shape[1]
    col = torch.arange(n, device=m.device)
    nz = m != 0
    hi = torch.where(nz, col + 1, 0).amax(dim=1)
    lo = torch.minimum(torch.where(nz, col, n).amin(dim=1), hi)
    return torch.stack([lo, hi], dim=1).to(torch.int32)


def upsample_argmax(lcf: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor,
                    exact: bool = False, spans=None) -> torch.Tensor:
    """lcf: (B, C, h, w) fp32 logits; mh: (OH, h), mw: (OW, w) fp32
    interpolation matrices -> (B, OH, OW) int32 predictions. `spans`:
    (interp_spans(mh), interp_spans(mw)), or None to compute them here."""
    if lcf.device.type == "cpu":
        return upsample_argmax_ref(lcf, mh, mw, exact)
    name = "upsample_argmax"
    kernels.require(lcf.is_cuda, f"{name}: no kernel for device "
                    f"{lcf.device}")
    kernels.require(lcf.dim() == 4, f"{name}: lcf must be (B, C, h, w)")
    B, C, h, w = lcf.shape
    kernels.require_f32(name, lcf, mh, mw)
    kernels.require_on(lcf.device, name, lcf, mh, mw)
    kernels.require(mh.dim() == 2 and mh.shape[1] == h and mw.dim() == 2
                    and mw.shape[1] == w,
                    f"{name}: matrices {tuple(mh.shape)}, {tuple(mw.shape)}"
                    f" do not match ({h}, {w})")
    kernels.require(w * 128 * 4 + 16 * (h + w) * 4 <= kernels.SMEM_LIMIT,
                    f"{name}: input width {w} does not fit shared memory")
    OH, OW = mh.shape[0], mw.shape[0]
    sh, sw = (interp_spans(mh), interp_spans(mw)) if spans is None else spans
    kernels.require(sh.dtype == torch.int32 and sw.dtype == torch.int32
                    and tuple(sh.shape) == (OH, 2)
                    and tuple(sw.shape) == (OW, 2),
                    f"{name}: spans must be int32 (OH, 2) and (OW, 2)")
    kernels.require_on(lcf.device, name, sh, sw)
    out = torch.empty((B, OH, OW), dtype=torch.int32, device=lcf.device)
    P = kernels.ptr
    kernels.launch("stswin_upsample_argmax", lcf.device, P(lcf), P(mh),
                   P(mw), P(sh), P(sw), P(out), B, C, h, w, OH, OW,
                   1 if exact else 0)
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
