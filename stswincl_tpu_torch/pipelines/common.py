"""Model, dataset and loader construction from the configs.

Counterpart of `stswincl_tpu/pipelines/common.py` (`resolve_dtype`,
`build_model`, `build_contrast_dataset`, `build_loader`). The configs are
the port's copies of the JAX package's dataclasses
(`stswincl_tpu_torch/configs.py`). The segmentation datasets and variable
initialisation are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from stswincl_tpu_torch.configs import DataConfig, ModelConfig
from stswincl_tpu_torch.data.cadis import CADIS_CLASS_NUM
from stswincl_tpu_torch.data.contrastive import ContrastiveClipDataset
from stswincl_tpu_torch.data.loader import Loader, SyntheticContrastDataset
from stswincl_tpu_torch.models.stswin import TswinPlus


def resolve_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def build_model(model_cfg: ModelConfig, data_cfg: DataConfig,
                device="cuda") -> Tuple[TswinPlus, int]:
    """The model the configs name, on `device`, and its class count, as
    the JAX `build_model` (`:29-45`) returns them. The swin windows are
    built for `data_cfg.crop_hw`. Parameters are created uninitialised:
    load them (`ckpt.load_from_jax`) or initialise them
    (`models.init.init_weights`). The default device is the card; a
    machine without one raises unless the caller asks for the CPU.

    The CUDA kernels compute in bfloat16 only. With `model_cfg.dtype ==
    "float32"` the model is built with `kernels=False` on purpose: it runs
    on the kernels' plain PyTorch twins on any device, as the JAX package
    runs fp32 off the TPU on its 'einsum' route, and no kernel launches.
    With "bfloat16" it is built with `kernels=None`: the kernels iff the
    input is on the card."""
    num_classes = model_cfg.num_classes
    if data_cfg.dataset == "cadis":
        num_classes = CADIS_CLASS_NUM[data_cfg.tag]
    if model_cfg.arch == "puredeeplab18":
        raise NotImplementedError("arch 'puredeeplab18' (DeepLabV3Plus) is "
                                  "not ported yet: ROADMAP Queue 1 item 6")
    if model_cfg.arch != "swinPlus":
        raise ValueError(f"unknown arch {model_cfg.arch!r}")
    if model_cfg.remat:
        raise NotImplementedError("remat (recomputing the swin blocks in the "
                                  "backward) is not ported yet")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' "
                           "to build the model on the CPU")
    dtype = resolve_dtype(model_cfg.dtype)
    model = TswinPlus(num_classes, swin_dim=model_cfg.swin_dim,
                      num_heads=model_cfg.num_heads,
                      gelu_exact=model_cfg.gelu_exact,
                      swin_depths=tuple(model_cfg.swin_depths),
                      dtype=dtype,
                      input_hw=tuple(data_cfg.crop_hw),
                      kernels=False if dtype == torch.float32 else None,
                      attn_impl=model_cfg.attn_impl)
    return model.to(device), num_classes


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
    grouped = dist.is_available() and dist.is_initialized()
    if shard_index is None:
        shard_index = dist.get_rank() if grouped else 0
    if num_shards is None:
        num_shards = dist.get_world_size() if grouped else 1
    return Loader(dataset, batch_size=batch_size or cfg.batch_size,
                  shuffle=shuffle, seed=cfg.seed,
                  num_workers=cfg.num_workers, shard_index=shard_index,
                  num_shards=num_shards)
