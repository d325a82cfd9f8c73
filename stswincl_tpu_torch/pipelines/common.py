"""Model, dataset and loader construction from the configs.

Counterpart of `stswincl_tpu/pipelines/common.py` (`resolve_dtype`,
`build_model`, `build_seg_dataset`, `build_contrast_dataset`,
`build_loader`, `init_model_variables`). The configs are the port's
copies of the JAX package's dataclasses (`stswincl_tpu_torch/configs.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from stswincl_tpu_torch.configs import DataConfig, ModelConfig
from stswincl_tpu_torch.data.cadis import CADIS_CLASS_NUM, CadisDataset
from stswincl_tpu_torch.data.contrastive import ContrastiveClipDataset
from stswincl_tpu_torch.data.endovis18 import EndovisDataset
from stswincl_tpu_torch.data.loader import (Loader, SyntheticContrastDataset,
                                            SyntheticSegDataset)
from stswincl_tpu_torch.models.init import init_weights
from stswincl_tpu_torch.models.stswin import DeepLabV3Plus, TswinPlus
from stswincl_tpu_torch.parallel import distributed as pdist


def resolve_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def resolve_device(device, who: str) -> torch.device:
    """`device` as a torch.device; a CUDA device on a machine without one
    raises (the entry points run on the card unless asked for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    return device


def build_model(model_cfg: ModelConfig, data_cfg: DataConfig,
                device="cuda") -> Tuple[Union[TswinPlus, DeepLabV3Plus], int]:
    """The model the configs name, on `device`, and its class count, as
    the JAX `build_model` (`:29-45`) returns them: `arch` 'swinPlus' a
    TswinPlus (its swin windows built for `data_cfg.crop_hw`, `remat` as
    configured), 'puredeeplab18' the DeepLabV3+ pre-stage with ResNet18-OS8
    of width `swin_dim // 8`, so that its resnet entries fit the swinPlus
    run that warm-starts from it. Parameters are created uninitialised:
    load them (`ckpt.load_from_jax`) or initialise them
    (`models.init.init_weights`). The default device is the card; a
    machine without one raises unless the caller asks for the CPU.

    The model is built with `kernels=None`, the kernels iff the input is
    on the card, in both dtypes and on every `attn_impl`: an fp32 model
    serves and evaluates on the fp32 forms of K1-K3 ('pallas' on row 10's,
    'pallas_windows' on row 11's in place of K1's, `whole_block` on row
    16's for the W-MSA blocks) and K4's exact form, and trains on the fp32
    forms of K1-K3 (K2 with its m output, Pallas row 8, where
    `mlp_output_saved`) and of K5 and K6, as the JAX package sends an fp32
    model through its dtype-generic TPU kernels. An unknown `arch` raises
    ValueError."""
    num_classes = model_cfg.num_classes
    if data_cfg.dataset == "cadis":
        num_classes = CADIS_CLASS_NUM[data_cfg.tag]
    if model_cfg.arch not in ("swinPlus", "puredeeplab18"):
        raise ValueError(f"unknown arch {model_cfg.arch!r}")
    device = resolve_device(device, "build_model")
    dtype = resolve_dtype(model_cfg.dtype)
    if model_cfg.arch == "puredeeplab18":
        model = DeepLabV3Plus(num_classes, width=model_cfg.swin_dim // 8,
                              dtype=dtype)
    else:
        model = TswinPlus(num_classes, swin_dim=model_cfg.swin_dim,
                          num_heads=model_cfg.num_heads,
                          gelu_exact=model_cfg.gelu_exact,
                          swin_depths=tuple(model_cfg.swin_depths),
                          dtype=dtype,
                          input_hw=tuple(data_cfg.crop_hw),
                          attn_impl=model_cfg.attn_impl,
                          remat=model_cfg.remat)
    return model.to(device), num_classes


def init_model_variables(model: torch.nn.Module, data_cfg: DataConfig
                         ) -> torch.nn.Module:
    """Seed `model`'s weights from `data_cfg.seed` in place (the JAX
    `init_model_variables` draws them from `jax.random.key(seed)`; the
    port's draws come from a CPU `torch.Generator`, so they do not depend
    on the device). Returns the model."""
    return init_weights(model, torch.Generator().manual_seed(data_cfg.seed))


def build_seg_dataset(cfg: DataConfig, split: str):
    """The segmentation dataset the config names for `split`: the
    synthetic set (64 train / 8 eval clips at `crop_hw`), `CadisDataset`
    or `EndovisDataset`."""
    if cfg.dataset == "synthetic":
        return SyntheticSegDataset(
            length=64 if split == "train" else 8, t=cfg.t,
            hw=cfg.crop_hw, num_classes=cfg.num_classes)
    if cfg.dataset == "cadis":
        return CadisDataset(cfg.root, split, tag=cfg.tag, t=cfg.t,
                            step=cfg.step, crop_hw=cfg.crop_hw,
                            base_hw=cfg.base_hw)
    return EndovisDataset(cfg.root, split, t=cfg.t, crop_hw=cfg.crop_hw,
                          base_hw=cfg.base_hw, num_classes=cfg.num_classes)


def build_contrast_dataset(cfg: DataConfig):
    """The six-view dataset the config names: the synthetic set (32
    samples at `crop_hw`) or `ContrastiveClipDataset` on EndoVis18 or
    CaDIS."""
    if cfg.dataset == "synthetic":
        return SyntheticContrastDataset(length=32, t=cfg.t, hw=cfg.crop_hw,
                                        num_classes=cfg.num_classes)
    name = "cadis" if cfg.dataset == "cadis" else "endovis18"
    return ContrastiveClipDataset(cfg.root, name, tag=cfg.tag,
                                  crop_hw=cfg.crop_hw,
                                  rand_augment=cfg.rand_augment)


def build_loader(dataset, cfg: DataConfig, shuffle: bool = True,
                 batch_size: Optional[int] = None,
                 shard_index: Optional[int] = None,
                 num_shards: Optional[int] = None) -> Loader:
    """A `Loader` on `dataset` with the config's batch, seed and workers.
    The shard index and count default to the torch process group's rank
    and world size (0 and 1 without one), where the JAX package reads
    `jax.process_index()` and `jax.process_count()`."""
    if shard_index is None:
        shard_index = pdist.rank()
    if num_shards is None:
        num_shards = pdist.world_size()
    return Loader(dataset, batch_size=batch_size or cfg.batch_size,
                  shuffle=shuffle, seed=cfg.seed,
                  num_workers=cfg.num_workers, shard_index=shard_index,
                  num_shards=num_shards)
