"""Pixel-wise supervised-contrastive loss of the inter-video stage.

Counterpart of `stswincl_tpu/ops/contrastive.py` (`:35-130`), in fp32
PyTorch (`one_hot`, `bmm`): the JAX package computes it with XLA, not a
Pallas kernel, so it stays plain library calls here. For each query pixel
i, its positive score P_i is the mean cosine similarity to same-class
pixels pooled over the key sets, and its negative score N_i the sum over
key sets of the per-set mean similarity to other-class pixels; the loss is
-mean log(e^P / (e^P + e^N) + 1e-6) (`PixPro_swin_v5.py:48-129`). The
masked sums factor through per-class feature sums,

    sum_j 1[l_q(i) == l_s(j)] (q_i . k_j) = q_i . S_s[l_q(i)],
    S_s[c] = sum_j 1[l_s(j) == c] k_j,

so each key set costs two (HW x D x C) products instead of an (HW x HW)
similarity matrix. Labels outside [0, class_num) (the 255 fill) are
dropped from the key counts and from the query mean.

Every sum here is per sample (`bjc,bjd->bcd`): no sample sees another's
keys, on one rank or many. Under a process group (`group`) the only
global part is the normaliser, the valid query pixels of the global
batch, as the JAX step over a sharded batch computes it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from stswincl_tpu_torch.parallel.collectives import sum_over


def _one_hot(labels: torch.Tensor, class_num: int) -> torch.Tensor:
    """fp32 one-hot; a label outside [0, class_num) gives a zero row, as
    `jax.nn.one_hot` does."""
    classes = torch.arange(class_num, device=labels.device)
    return (labels[..., None] == classes).float()


def _per_set_stats(q: torch.Tensor, q_labels: torch.Tensor, k: torch.Tensor,
                   k_labels: torch.Tensor, class_num: int
                   ) -> Tuple[torch.Tensor, ...]:
    """Positive / negative masked-sum statistics for one key set.

    q (B, HW, D) and k (B, HWk, D) L2-normalised features, q_labels (B, HW)
    and k_labels (B, HWk) int labels. Returns pos_sum, pos_cnt, neg_sum,
    neg_cnt, each (B, HW) fp32."""
    onehot_k = _one_hot(k_labels, class_num)                   # (B, HWk, C)
    class_sums = torch.bmm(onehot_k.transpose(1, 2), k.float())  # (B, C, D)
    class_cnts = onehot_k.sum(dim=1)                           # (B, C)
    sims = torch.bmm(q.float(), class_sums.transpose(1, 2))    # (B, HW, C)
    # take_along_axis clamps an out-of-range index to the last class; the
    # caller masks those query pixels out of the mean
    idx = q_labels.long().clamp(0, class_num - 1)[..., None]
    pos_sum = torch.gather(sims, -1, idx)[..., 0]
    pos_cnt = torch.gather(class_cnts[:, None, :].expand_as(sims), -1,
                           idx)[..., 0]
    total_sum = sims.sum(dim=-1)
    # key pixels with out-of-range labels have a zero one-hot row: out of
    # the class sums, so out of the count too
    valid_k_cnt = class_cnts.sum(dim=-1)[:, None]
    return pos_sum, pos_cnt, total_sum - pos_sum, valid_k_cnt - pos_cnt


def pixel_pair_stats(q: torch.Tensor, q_labels: torch.Tensor,
                     keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     class_num: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel pooled positive mean P and summed negative means N
    (`PixPro_swin_v5.py:119-123`): P pools numerators and denominators
    across the key sets, N sums the per-set means."""
    pos_num = pos_den = neg = 0.0
    for k, k_labels in keys:
        ps, pc, ns, nc = _per_set_stats(q, q_labels, k, k_labels, class_num)
        pos_num = pos_num + ps
        pos_den = pos_den + pc
        neg = neg + ns / (nc + 1e-6)
    return pos_num / (pos_den + 1e-6), neg


def class_sum_contrastive_loss(q: torch.Tensor, q_labels: torch.Tensor,
                               keys: Sequence[Tuple[torch.Tensor,
                                                    torch.Tensor]],
                               class_num: int, group=None) -> torch.Tensor:
    """One direction of the reference consistency loss,
    -mean log(e^P / (e^P + e^N) + 1e-6) over the query pixels whose label
    lies in [0, class_num) (`PixPro_swin_v5.py:124-128`), over the ranks'
    batches together with `group`; the caller symmetrises over the two
    query views. 0-d fp32."""
    P, N = pixel_pair_stats(q, q_labels, keys, class_num)
    ratio = torch.exp(P) / (torch.exp(P) + torch.exp(N))
    valid = ((q_labels >= 0) & (q_labels < class_num)).float()
    terms = torch.log(ratio + 1e-6) * valid
    total, count = sum_over(torch.stack([terms.sum(), valid.sum()]), group)
    return -total / count.clamp(min=1.0)
