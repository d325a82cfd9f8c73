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


def upsample_argmax(lcf: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor,
                    exact: bool = False) -> torch.Tensor:
    """lcf: (B, C, h, w) fp32 logits; mh: (OH, h), mw: (OW, w) fp32
    interpolation matrices -> (B, OH, OW) int32 predictions."""
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
    out = torch.empty((B, OH, OW), dtype=torch.int32, device=lcf.device)
    P = kernels.ptr
    kernels.launch("stswin_upsample_argmax", lcf.device, P(lcf), P(mh),
                   P(mw), P(out), B, C, h, w, OH, OW, 1 if exact else 0)
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
