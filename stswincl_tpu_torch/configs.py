"""Dataclass configuration of the port.

A copy of `stswincl_tpu/configs.py` (standard library only): the same
dataclasses, fields and defaults, and the same `to_json`, `load_config`
and `apply_overrides`. The port keeps its own copy so that it imports
nothing of the JAX package; `tests/test_torch_package.py` holds the two
copies equal.

Canonical hyperparameters mirror the shipped launchers (BASELINE.md):
stage-1 Adam 3e-4 / batch 8 / t=4 / OHEM; stage-2 LARS base-lr 1.0
(linearly scaled), wd 1e-5, warmup 5 epochs, 150 epochs, batch 4, momentum
0.99; stage-3 SGD 1e-3 poly / 200 epochs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class DataConfig:
    dataset: str = "endovis18"          # endovis18 | cadis | synthetic
    root: str = ""
    tag: str = "1"                       # CaDIS experiment tag
    t: int = 4
    step: int = 1
    crop_hw: Tuple[int, int] = (512, 640)
    base_hw: Tuple[int, int] = (540, 672)
    num_classes: int = 12
    batch_size: int = 8
    num_workers: int = 4
    seed: int = 0
    # optional RandAugment config string for the contrastive clip views
    # (e.g. "rand-m9-mstd0.5"); None = reference behavior (menu unwired)
    rand_augment: Optional[str] = None


@dataclass
class ModelConfig:
    arch: str = "swinPlus"               # swinPlus | puredeeplab18
    num_classes: int = 12
    swin_dim: int = 512
    swin_depths: Tuple[int, int] = (3, 3)  # layers per stage; (3,3)=reference
    num_heads: int = 4
    attn_impl: str = "auto"              # auto|einsum|pallas|pallas_full
    gelu_exact: bool = True              # erf (torch parity) vs tanh approx
    remat: bool = False                  # checkpoint swin blocks (memory)
    dtype: str = "bfloat16"              # compute dtype; params stay fp32


@dataclass
class SegTrainConfig:
    """Stage 1 (intra-video) and stage 3 (fine-tune) training."""
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: str = "adam"              # adam (stage 1) | sgd (stage 3)
    lr: float = 3e-4
    head_lr_mult: float = 1.0            # x10 = the reference's intended head group
    lr_scheduler: str = "constant"       # constant | poly | cos | step
    momentum: float = 0.9
    weight_decay: float = 1e-4
    loss: str = "ohem"                   # ohem | dice | ce
    ohem_thresh: float = 0.7
    num_epochs: int = 400
    early_stop_epochs: int = 200
    warmup_epochs: int = 0
    eval_every: int = 1
    ckpt_dir: str = "checkpoints/seg"
    log_dir: str = "logs/seg"
    init_checkpoint: Optional[str] = None        # warm start (tolerant merge)
    pretrain_checkpoint: Optional[str] = None    # stage-2 ckpt for stage 3
    torch_checkpoint: Optional[str] = None       # reference .pth/.t7 import
    imagenet_checkpoint: Optional[str] = None    # torchvision resnet18 .pth
    test_checkpoint: Optional[str] = None        # ckpt dir the `test` cmd loads
    resume: bool = False
    eval_hw: Tuple[int, int] = (1024, 1280)
    viz_dir: Optional[str] = None                # per-frame prediction PNG dumps
    # `test` command: serve sliding-window frames through the
    # feature-cached StreamingSegmenter (bit-equal predictions, ~2x
    # faster steady-state); discontinuities fall back to full-clip eval
    streaming_eval: bool = False


@dataclass
class ContrastTrainConfig:
    """Stage 2 (inter-video pixel-contrastive pretraining)."""
    data: DataConfig = field(default_factory=lambda: DataConfig(
        crop_hw=(256, 448), batch_size=4))
    model: ModelConfig = field(default_factory=ModelConfig)
    base_lr: float = 1.0                 # linearly scaled by batch*world/256
    weight_decay: float = 1e-5
    warmup_epochs: int = 5
    warmup_multiplier: float = 100.0
    num_epochs: int = 150
    momentum: float = 0.99               # pixpro EMA momentum (cosine ramp)
    pixpro_ins_loss_weight: float = 0.0  # >0 enables the instance branch
    lars_trust_coef: float = 1e-3
    lr_scheduler: str = "cosine"
    init_checkpoint: Optional[str] = None   # stage-1 seg ckpt (required path)
    ckpt_dir: str = "checkpoints/contrast"
    log_dir: str = "logs/contrast"
    save_every_epochs: int = 10
    resume: bool = False


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def _from_dict(cls, d):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config field {k} for {cls.__name__}")
        ft = fields[k].type
        if isinstance(v, dict) and k == "data":
            v = _from_dict(DataConfig, v)
        elif isinstance(v, dict) and k == "model":
            v = _from_dict(ModelConfig, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def load_config(cls, path: str):
    with open(path) as f:
        return _from_dict(cls, json.load(f))


def apply_overrides(cfg, overrides):
    """Apply `key=value` / `data.key=value` CLI overrides."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        old = getattr(obj, leaf)
        if isinstance(old, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        elif isinstance(old, tuple):
            val = tuple(int(x) for x in raw.strip("()").split(","))
        else:
            val = raw
        setattr(obj, leaf, val)
    return cfg
