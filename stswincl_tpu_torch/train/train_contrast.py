"""Inter-video pixel-contrastive pretraining step (stage 2).

Counterpart of `stswincl_tpu/train/train_contrast.py` (after the
reference's `main_pretrain_swinv5.py` and `PixPro_swin_v5.py:140-597`).
The state holds two `ContrastEncoder`s: the query model, which the
optimizer trains, and the key model, an exact copy at creation that then
follows the query parameters by an EMA. One step, in the JAX order
(`:339-363`):

  1. EMA of the key parameters, k = m * k + (1 - m) * q, with
     m = `contrast_momentum(step)` at the step count before the increment
     (`PixPro_swin_v5.py:258-263, 366-367`). It covers parameters only:
     BatchNorm scales and biases are parameters and are included; the
     running statistics are buffers, and each model's come from its own
     forwards;
  2. the key pass: the six views one after another, in train mode under
     `torch.no_grad()`, in view order, so each BatchNorm's running
     statistics move in the reference's order (`make_key_pass_sequential`,
     `:125-139`, is the semantics; the JAX package's vmap and fold are its
     TPU form). Views are never batched into one forward: that would change
     every BatchNorm's batch statistics;
  3. the two query views, one after another with grad, the labels
     nearest-downsampled to the feature map (`:219-222`), the class-sum
     loss of each view against its five key sets (`_KIDX`, `:274`),
     symmetrised, and one backward of the summed loss;
  4. the optimizer step (LARS on its own schedule);
  5. with `ins_loss_weight > 0`, the instance term
     2 - 2 cos(pred_q(view a), proj_k(view b)), symmetrised, is added to
     the loss before the backward.

The TPU workarounds of the JAX step (`query_mode="scan"`, `remat_queries`,
the vmapped key pass) are not ported: the plain joint backward is the
function they compute.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn

from stswincl_tpu_torch.ops.contrastive import class_sum_contrastive_loss
from stswincl_tpu_torch.ops.resize import resize_nearest

# view v's key set: the other of the first two views and views 2..5
# (the reference's symmetrisation, PixPro_swin_v5.py:558-571)
_KIDX = ((1, 2, 3, 4, 5), (0, 2, 3, 4, 5))


def contrast_momentum(step: int, total_steps: int,
                      base_momentum: float = 0.99) -> float:
    """`1 - (1 - m) * (cos(pi * k / K) + 1) / 2` (`PixPro_swin_v5.py:263`),
    in fp32 as the JAX package computes it."""
    f32 = np.float32
    k = f32(step)
    c = np.cos(f32(np.pi) * k / f32(max(total_steps, 1)))
    return float(f32(1.0) - f32(1.0 - base_momentum) * (c + f32(1.0))
                 / f32(2.0))


class ContrastTrainState:
    """query / key `ContrastEncoder`s, the optimizer over the query
    parameters, and the step count. `create` makes the key an exact copy
    of the query (`ContrastTrainState.create`, `:59-70`) whose parameters
    take no gradient."""

    def __init__(self, query: nn.Module, key: nn.Module,
                 opt: torch.optim.Optimizer, step: int = 0):
        self.query, self.key, self.opt, self.step = query, key, opt, step

    @classmethod
    def create(cls, query: nn.Module, make_opt) -> "ContrastTrainState":
        """`make_opt(params)` -> the optimizer over the query parameters."""
        key = copy.deepcopy(query)
        key.requires_grad_(False)
        return cls(query, key, make_opt(query.parameters()))

    def state_dict(self) -> Dict:
        return {"query": self.query.state_dict(),
                "key": self.key.state_dict(),
                "opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        self.query.load_state_dict(sd["query"])
        self.key.load_state_dict(sd["key"])
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])


def _flat(feat: torch.Tensor) -> torch.Tensor:
    B, h, w, C = feat.shape
    return feat.reshape(B, h * w, C)


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def downsample_labels(labels: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 6, Hc, Wc) -> (B, 6, h * w) with torch 'nearest' indexing
    (`PixPro_swin_v5.py:584-590`)."""
    lab = resize_nearest(labels[..., None], h, w)[..., 0]
    return lab.reshape(labels.shape[0], labels.shape[1], h * w)


@torch.no_grad()
def ema_update(key: nn.Module, query: nn.Module, m: float) -> None:
    """k = k * m + q * (1 - m) over the parameters, m and 1 - m in fp32 as
    the JAX tree_map takes them."""
    m32 = np.float32(m)
    one_minus = float(np.float32(1.0) - m32)
    for pk, pq in zip(key.parameters(), query.parameters()):
        pk.mul_(float(m32)).add_(pq.detach() * one_minus)


@torch.no_grad()
def key_pass(key: nn.Module, clips: torch.Tensor) -> List:
    """The six views of clips (B, 6, T, H, W, 3) through the key model in
    train mode, one forward a view in view order; returns each view's
    output."""
    key.train()
    return [key(clips[:, v]) for v in range(clips.shape[1])]


class ContrastTrainStep:
    """(clips (B, 6, T, H, W, 3), labels (B, 6, Hc, Wc)) -> {"loss",
    "momentum", "grad_norm"} (and "ins_loss" with the instance branch),
    each a 0-d fp32 tensor on the model's device; updates the state."""

    def __init__(self, state: ContrastTrainState, class_num: int,
                 total_steps: int, base_momentum: float = 0.99,
                 ins_loss_weight: float = 0.0):
        self.state, self.class_num = state, class_num
        self.total_steps, self.base_momentum = total_steps, base_momentum
        self.ins_loss_weight = ins_loss_weight
        self.with_instance = ins_loss_weight > 0.0

    def loss(self, clips: torch.Tensor, labels: torch.Tensor,
             keys: List) -> tuple:
        """The summed loss of the two query views against `keys` (the key
        pass's outputs), with grad, and the instance term."""
        query = self.state.query
        query.train()
        outs = [query(clips[:, v]) for v in (0, 1)]
        kproj = None
        if self.with_instance:
            kproj = [k[1] for k in keys]
            keys = [k[0] for k in keys]
            ipred = [o[2] for o in outs]
            outs = [o[0] for o in outs]
        _, h, w, _ = outs[0].shape
        lab = downsample_labels(labels, h, w)
        loss = sum(class_sum_contrastive_loss(
            _flat(outs[v]), lab[:, v],
            [(_flat(keys[i]), lab[:, i]) for i in _KIDX[v]], self.class_num)
            for v in (0, 1))
        ins_loss = torch.zeros((), device=loss.device)
        if self.with_instance:
            cos12 = (_l2n(ipred[0]) * _l2n(kproj[1])).sum(-1)
            cos21 = (_l2n(ipred[1]) * _l2n(kproj[0])).sum(-1)
            ins_loss = (2.0 - 2.0 * cos12.mean()) + (2.0 - 2.0 * cos21.mean())
            loss = loss + self.ins_loss_weight * ins_loss
        return loss, ins_loss

    def __call__(self, clips: torch.Tensor,
                 labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self.state
        m = contrast_momentum(st.step, self.total_steps, self.base_momentum)
        ema_update(st.key, st.query, m)
        keys = key_pass(st.key, clips)
        st.opt.zero_grad(set_to_none=True)
        loss, ins_loss = self.loss(clips, labels, keys)
        loss.backward()
        grads = [p.grad for p in st.query.parameters() if p.grad is not None]
        grad_norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        st.opt.step()
        st.step += 1
        out = {"loss": loss.detach(),
               "momentum": torch.tensor(m, dtype=torch.float32,
                                        device=loss.device),
               "grad_norm": grad_norm}
        if self.with_instance:
            out["ins_loss"] = ins_loss.detach()
        return out


def make_contrast_train_step(state: ContrastTrainState, class_num: int,
                             total_steps: int, base_momentum: float = 0.99,
                             ins_loss_weight: float = 0.0
                             ) -> ContrastTrainStep:
    """The train step (port of `make_contrast_train_step` with its plain
    joint backward, the JAX `query_mode="unrolled"`)."""
    if ins_loss_weight > 0.0 and not getattr(state.query, "with_instance",
                                             True):
        raise ValueError("ins_loss_weight > 0 needs a ContrastEncoder built "
                         "with with_instance=True")
    return ContrastTrainStep(state, class_num, total_steps, base_momentum,
                             ins_loss_weight)
