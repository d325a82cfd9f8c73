"""Reference PyTorch checkpoints -> the port's `state_dict`.

Counterpart of `stswincl_tpu/ckpt/torch_import.py`: the same key mapping
from the reference's `state_dict` names to the model's names, so that a
checkpoint trained with the reference gives the same logits here. Where
the JAX importer builds flax trees and transposes each tensor to its
layout (conv OIHW -> HWIO, linear (out, in) -> (in, out)), the port's
modules hold torch's own layouts, so every tensor is copied as it is:
only the names change.

Formats:
  * segmentation `state_dict`s (`.t7`, a bare `state_dict`, possibly with
    DataParallel's `module.` prefix, `seg18/utils/summary.py:83-88`);
  * pretraining dicts (`ckpt_epoch_N.pth`, whose `model` holds
    `pixpro.encoder_1/2/3`, `pixpro.proj1/2/3`, `pixpro.projector` and the
    momentum `*_k_*` twins, `main_pretrain_swinv5.py:87-103`), with the
    prefix translation of `load_model_mswin_CL`
    (`seg18/utils/LoadModel.py:6-49`): encoder_1 -> resnet, encoder_2 ->
    swin, encoder_3 -> aspp, proj1/2/3 -> project1/2/3;
  * torchvision's ResNet18 ImageNet `state_dict` (stem, layer1, layer2).

BatchNorm weight / bias / running_mean / running_var keep their names
under the port's module paths; `num_batches_tracked` and the derived
buffers (`attn_mask`, `relative_position_index`) are dropped. As the
reference's `load_model*` loaders do (`strict=False`), a key that maps to
nothing is returned in a list rather than raised.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# the JAX tree's leaf name -> the port's
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         "relative_position_bias_table": "relative_position_bias_table"}

StateDict = Dict[str, torch.Tensor]


def _tensor(value) -> torch.Tensor:
    """A float32 CPU copy of a torch tensor or an array."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(value), dtype=torch.float32)


def _set(sd: StateDict, path: Tuple[str, ...], value) -> None:
    """Store `value` under the port name of the JAX tree path `path`."""
    sd[".".join(path[:-1] + (_LEAF[path[-1]],))] = _tensor(value)


def _convbn(sd: StateDict, dst: Tuple[str, ...], value, kind: str) -> None:
    """Route one tensor of a Conv / BN pair to its port name."""
    leaf = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
            "bn.weight": ("bn", "scale"), "bn.bias": ("bn", "bias"),
            "bn.running_mean": ("bn", "mean"),
            "bn.running_var": ("bn", "var")}.get(kind)
    if leaf is None:
        raise KeyError(kind)
    _set(sd, dst + leaf, value)


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")

_RESNET_BLOCK_SUB = {"conv1": "cb1", "bn1": "cb1", "conv2": "cb2",
                     "bn2": "cb2", "downsample.0": "downsample",
                     "downsample.1": "downsample"}

_ASPP_MAP = {
    "conv_1x1_1": "branch_1x1", "bn_conv_1x1_1": "branch_1x1",
    "conv_3x3_1": "branch_r6", "bn_conv_3x3_1": "branch_r6",
    "conv_3x3_2": "branch_r12", "bn_conv_3x3_2": "branch_r12",
    "conv_3x3_3": "branch_r18", "bn_conv_3x3_3": "branch_r18",
    "conv_1x1_2": "branch_img", "bn_conv_1x1_2": "branch_img",
    "conv_1x1_3": "fuse", "bn_conv_1x1_3": "fuse",
}


def _route_block(dst: Tuple[str, ...], sub: str, leaf: str, value,
                 sd: StateDict) -> bool:
    """A BasicBlock tensor (conv1 / bn1 / conv2 / bn2 / downsample.0-1)."""
    if leaf == "num_batches_tracked":
        return True
    if sub in ("conv1", "conv2", "downsample.0"):
        _convbn(sd, dst + (_RESNET_BLOCK_SUB[sub],), value, "conv.weight")
        return True
    if sub in ("bn1", "bn2", "downsample.1"):
        _convbn(sd, dst + (_RESNET_BLOCK_SUB[sub],), value, f"bn.{leaf}")
        return True
    return False


def _import_resnet(key: str, value, sd: StateDict) -> bool:
    """`resnet.*` keys; True if consumed."""
    parts = key.split(".")
    if parts[0] != "resnet":
        return False
    rest = parts[1:]
    # torchvision's stem and early layers under a nested Sequential:
    # resnet.resnet.{0=conv1, 1=bn1, 4=layer1, 5=layer2}...
    if rest[0] == "resnet":
        idx = rest[1]
        if idx == "0" and rest[2] == "weight":
            _set(sd, ("resnet", "stem", "conv", "kernel"), value)
            return True
        if idx == "1":
            if rest[2] in _BN_LEAVES:  # not num_batches_tracked
                _convbn(sd, ("resnet", "stem"), value, f"bn.{rest[2]}")
            return True
        if idx in ("4", "5"):
            layer = {"4": "layer1", "5": "layer2"}[idx]
            return _route_block(("resnet", f"{layer}_{rest[2]}"),
                                ".".join(rest[3:-1]), rest[-1], value, sd)
        return True  # relu / maxpool hold no tensors
    # the dilated stages: resnet.layer4.{b}..., resnet.layer5.{b}...
    if rest[0] in ("layer4", "layer5"):
        return _route_block(("resnet", f"{rest[0]}_{rest[1]}"),
                            ".".join(rest[2:-1]), rest[-1], value, sd)
    return False


def _import_swin(key: str, value, sd: StateDict) -> bool:
    parts = key.split(".")
    if parts[0] != "swin":
        return False
    rest = parts[1:]
    if rest[0] == "layers":
        i, which = rest[1], rest[2]  # layer index, 0 (W) or 1 (SW)
        name = f"layers_{i}_" + ("w" if which == "0" else "sw")
        sub, leaf = rest[3], rest[-1]
        if sub == "attn_mask":  # a derived buffer
            return True
        if sub == "attn":
            field = rest[4]
            if field == "relative_position_bias_table":
                _set(sd, ("swin", name, "attn", field), value)
            elif field in ("qkv", "proj"):
                _set(sd, ("swin", name, "attn", field,
                          "kernel" if leaf == "weight" else "bias"), value)
            # relative_position_index: a derived constant
            return True
        if sub in ("norm1", "norm2"):
            _set(sd, ("swin", name, sub,
                      "scale" if leaf == "weight" else "bias"), value)
            return True
        if sub == "mlp":
            _set(sd, ("swin", name, "mlp", rest[4],
                      "kernel" if leaf == "weight" else "bias"), value)
            return True
        return False
    if rest[0] == "downsample":
        sub, leaf = rest[1], rest[-1]
        if sub == "norm":
            _set(sd, ("swin", "downsample", "norm",
                      "scale" if leaf == "weight" else "bias"), value)
        elif sub == "reduction":
            _set(sd, ("swin", "downsample", "reduction", "kernel"), value)
        return True
    return False


def _import_aspp(key: str, value, sd: StateDict) -> bool:
    parts = key.split(".")
    if parts[0] != "aspp":
        return False
    sub, leaf = parts[1], parts[-1]
    if sub == "conv_1x1_4":
        _set(sd, ("aspp", "out_conv",
                  "kernel" if leaf == "weight" else "bias"), value)
        return True
    if sub in _ASPP_MAP:
        if leaf == "num_batches_tracked":
            return True
        kind = f"conv.{leaf}" if sub.startswith("conv") else f"bn.{leaf}"
        _convbn(sd, ("aspp", _ASPP_MAP[sub]), value, kind)
        return True
    return False


def _import_project(key: str, value, sd: StateDict) -> bool:
    parts = key.split(".")
    if parts[0] not in ("project1", "project2", "project3", "project"):
        return False
    proj, idx, leaf = parts[0], parts[1], parts[-1]
    if leaf == "num_batches_tracked":
        return True
    _convbn(sd, (proj,), value, "conv.weight" if idx == "0" else f"bn.{leaf}")
    return True


def _import_classifier(key: str, value, sd: StateDict) -> bool:
    parts = key.split(".")
    if parts[0] != "classifier":
        return False
    idx, leaf = parts[1], parts[-1]
    if leaf == "num_batches_tracked":
        return True
    if idx == "0":
        _set(sd, ("classifier", "conv1", "kernel"), value)
    elif idx == "1":
        _convbn(sd, ("classifier",), value, f"bn.{leaf}")
    elif idx == "3":
        _set(sd, ("classifier", "conv2",
                  "kernel" if leaf == "weight" else "bias"), value)
    return True


def _import_projector(key: str, value, sd: StateDict) -> bool:
    """The MLP2d projector: projector.{linear1, bn1, linear2}.*"""
    parts = key.split(".")
    if parts[0] != "projector":
        return False
    sub, leaf = parts[1], parts[-1]
    if leaf == "num_batches_tracked":
        return True
    if sub in ("linear1", "linear2"):
        _set(sd, ("projector", sub,
                  "kernel" if leaf == "weight" else "bias"), value)
    elif sub == "bn1" and leaf in _BN_LEAVES:
        _set(sd, ("projector", "bn1", {"weight": "scale", "bias": "bias",
                                       "running_mean": "mean",
                                       "running_var": "var"}[leaf]), value)
    return True


def import_torchvision_resnet18(state_dict: Mapping
                                ) -> Tuple[StateDict, List[str]]:
    """A torchvision resnet18 ImageNet `state_dict` -> the stem, layer1 and
    layer2 entries of the port's `ResNet18OS8` (the part the reference
    initialises from ImageNet, `seg18/net/Ours/resnet.py:98-102`; the
    dilated layer4 / layer5 keep their init). Returns (entries named
    within the ResNet module, unmatched keys); layer3, layer4 and fc are
    skipped, not reported."""
    remapped = {}
    unmatched = []
    for key, value in state_dict.items():
        for src, dst in (("conv1.", "resnet.resnet.0."),
                         ("bn1.", "resnet.resnet.1."),
                         ("layer1.", "resnet.resnet.4."),
                         ("layer2.", "resnet.resnet.5.")):
            if key.startswith(src):
                remapped[dst + key[len(src):]] = value
                break
        else:
            if not key.startswith(("layer3.", "layer4.", "fc.")):
                unmatched.append(key)
    sd: StateDict = {}
    for key, value in remapped.items():
        if not _import_resnet(key, value, sd):
            unmatched.append(key)
    return {k[len("resnet."):]: v for k, v in sd.items()}, unmatched


def import_tswinplus_state_dict(state_dict: Mapping
                                ) -> Tuple[StateDict, List[str]]:
    """A reference TswinPlus / TswinPlusv5 `state_dict` -> (the port's
    `TswinPlus` entries, unmatched keys)."""
    sd: StateDict = {}
    unmatched = []
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if not (_import_resnet(key, value, sd) or _import_swin(key, value, sd)
                or _import_aspp(key, value, sd)
                or _import_project(key, value, sd)
                or _import_classifier(key, value, sd)):
            unmatched.append(key)
    return sd, unmatched


# the prefix translation of load_model_mswin_CL (seg18/utils/LoadModel.py:6-49)
_PIXPRO_PREFIX = {
    "pixpro.encoder_1.": "resnet.",
    "pixpro.encoder_2.": "swin.",
    "pixpro.encoder_3.": "aspp.",
    "pixpro.proj1.": "project1.",
    "pixpro.proj2.": "project2.",
    "pixpro.proj3.": "project3.",
    "pixpro.projector.": "projector.",
    # the bare naming (not wrapped in ConsistencyLoss)
    "encoder_1.": "resnet.",
    "encoder_2.": "swin.",
    "encoder_3.": "aspp.",
    "proj1.": "project1.",
    "proj2.": "project2.",
    "proj3.": "project3.",
}


def import_pixpro_state_dict(state_dict: Mapping,
                             include_momentum: bool = False
                             ) -> Tuple[StateDict, List[str]]:
    """A reference pretraining (PixPro) `state_dict` -> (the port's
    `TswinPlus` entries plus the projector's `projector.*`, unmatched
    keys). The query branch goes through the `load_model_mswin_CL` prefix
    table; the momentum branch (`*_k_*`, `projector_k`) is skipped, or
    with `include_momentum` mapped in its place."""
    remapped = {}
    unmatched = []
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        is_momentum = ("_k_" in key.split(".")[0] + "." or
                       key.startswith(("pixpro.encoder_k", "pixpro.proj_k",
                                       "pixpro.projector_k", "encoder_k",
                                       "proj_k", "projector_k")))
        if is_momentum != include_momentum:
            continue
        if include_momentum:
            key = (key.replace("encoder_k_", "encoder_")
                      .replace("proj_k_", "proj")
                      .replace("projk", "proj")
                      .replace("projector_k", "projector"))
        for prefix, target in _PIXPRO_PREFIX.items():
            if key.startswith(prefix):
                remapped[target + key[len(prefix):]] = value
                break
        else:
            unmatched.append(key)
    sd, um2 = import_tswinplus_state_dict(remapped)
    for key, value in remapped.items():
        if key.startswith("projector."):
            _import_projector(key, value, sd)
    unmatched += [k for k in um2 if not k.startswith("projector.")]
    return sd, unmatched


def load_torch_file(path: str) -> StateDict:
    """The tensors of a reference PyTorch checkpoint: a bare `state_dict`
    or a dict whose "model" holds one (pretraining's `ckpt_epoch_N.pth`,
    whose "opt" is an `argparse.Namespace`, the one non-tensor type the
    unpickler admits)."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("model", raw)
    return {k: v for k, v in sd.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


def import_reference(path: str) -> Tuple[StateDict, List[str]]:
    """A reference `.pth` -> (the port's entries, unmatched keys), through
    the pretraining importer where its keys carry the PixPro prefixes."""
    ref = load_torch_file(path)
    if any(k.startswith(("pixpro.", "encoder_")) for k in ref):
        return import_pixpro_state_dict(ref)
    return import_tswinplus_state_dict(ref)
