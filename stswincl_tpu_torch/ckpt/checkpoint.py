"""Checkpoints of the port, and the translations between training stages.

Counterpart of `stswincl_tpu/ckpt/checkpoint.py` in the port's own format:
one `torch.save` file `step_<n>.pt` a step under the checkpoint directory,
holding a mapping of tensors and plain values (for stage 2, both models'
`state_dict`s, the optimizer's and the step; `ContrastTrainState
.state_dict`). Files are written to a temporary name and renamed, so a
reader never sees half of one, and read back with `weights_only=True`.
Reading the JAX package's Orbax checkpoints is out of scope: the port
cannot import Orbax without JAX (`ckpt/from_jax.py` takes JAX variables
that are already in memory).

Stage hand-offs work on `state_dict`s with the JAX semantics (`:97-143`):
the encoder subtrees of a segmentation model (`SEG_ENCODER_SUBTREES`) go
under the contrastive encoder's `segmentor.` prefix and back; a tolerant
merge keeps the destination's own value for every entry that is absent or
of another shape there and returns those names.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")

SEG_ENCODER_SUBTREES = (
    "resnet", "swin", "aspp", "project1", "project2", "project3",
)


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(ckpt_dir: str, step: int, state: Mapping) -> str:
    """Save the mapping `state` (tensors copied to the CPU) as
    `ckpt_dir/step_<step>.pt`; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    map_location="cpu") -> Dict:
    """Load `ckpt_dir/step_<step>.pt` (default: the latest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return torch.load(_step_path(ckpt_dir, step), map_location=map_location,
                      weights_only=True)


def _merge(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor],
           skipped: List[str]) -> Dict[str, torch.Tensor]:
    """Copy the entries of `src` over `dst` where present and of the same
    shape; the others go to `skipped`. As in the JAX tree merge, an entry
    missing in `dst` is reported by its shortest name prefix (module) that
    `dst` lacks, once for the whole module."""
    out = dict(dst)
    present = {".".join(k.split(".")[:i]) for k in dst
               for i in range(1, k.count(".") + 2)}
    for k, v in src.items():
        if k not in out:
            parts = k.split(".")
            head = next(".".join(parts[:i]) for i in range(1, len(parts) + 1)
                        if ".".join(parts[:i]) not in present)
            entry = f"{head} (missing in target)"
            if entry not in skipped:
                skipped.append(entry)
        elif tuple(out[k].shape) != tuple(v.shape):
            skipped.append(f"{k} (shape mismatch)")
        else:
            out[k] = v
    return out


def _subtree(name: str) -> str:
    return name.split(".", 1)[0]


def translate_seg_to_pretrain(seg_sd: Mapping[str, torch.Tensor],
                              enc_init_sd: Mapping[str, torch.Tensor]
                              ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Segmentation model state -> `ContrastEncoder` state: the encoder
    subtrees initialise `segmentor.*`; the projectors (and anything else)
    keep `enc_init_sd`'s values (`load_model_full` semantics,
    `PixPro_swin_v5.py:162-183`). Returns (state, skipped names)."""
    skipped: List[str] = []
    if not any(_subtree(k) == "segmentor" for k in enc_init_sd):
        return dict(enc_init_sd), skipped
    src = {f"segmentor.{k}": v for k, v in seg_sd.items()
           if _subtree(k) in SEG_ENCODER_SUBTREES}
    return _merge(enc_init_sd, src, skipped), skipped


def translate_pretrain_to_seg(enc_sd: Mapping[str, torch.Tensor],
                              seg_init_sd: Mapping[str, torch.Tensor]
                              ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """`ContrastEncoder` state -> segmentation model state: `segmentor.*`
    back into the encoder subtrees; the classifier (and anything absent
    from the encoder) keeps `seg_init_sd`'s values (`load_model_mswin_CL`
    semantics, `seg18/utils/LoadModel.py:6-49`). Returns (state, skipped
    names)."""
    skipped: List[str] = []
    src = {k.split(".", 1)[1]: v for k, v in enc_sd.items()
           if _subtree(k) == "segmentor"
           and _subtree(k.split(".", 1)[1]) in SEG_ENCODER_SUBTREES}
    return _merge(seg_init_sd, src, skipped), skipped
