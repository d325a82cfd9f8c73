"""`run_seg_training` over two gloo ranks on the CPU
(`torch_parallel_ranks`) against the same entry point in one process
(stage 1 with SGD at a constant LR, so that a run of one epoch resumed to
two follows the two-epoch run's schedule; an evaluation each epoch). Two
ranks that each take half of every global batch reach the one-process
run's weights; rank 0 alone evaluates and writes the checkpoints, which
both ranks read on `resume`. (`run_contrast_pretraining` over two ranks:
`tests/test_torch_parallel.py`.)"""

import json

import numpy as np
import pytest
import torch

from stswincl_tpu_torch.ckpt import latest_step, load_checkpoint
from stswincl_tpu_torch.configs import DataConfig, ModelConfig, SegTrainConfig
from stswincl_tpu_torch.pipelines.common import (build_model,
                                                 init_model_variables)
from stswincl_tpu_torch.pipelines.seg import run_seg_training
from tests import torch_parallel_ranks as ranks

torch.set_num_threads(2)
HW, NC = (64, 128), 5
MODEL = dict(num_classes=NC, swin_dim=64, swin_depths=(1, 1),
             dtype="float32")
# Stated bound. After 16 SGD steps at LR 1e-4: the synthetic
# frames are i.i.d. noise, so the ASPP image-pool BatchNorm (one value an
# image and channel) normalises a near-zero variance and the gradients
# are rounding-sensitive: one process parts from itself across 1 and 2
# threads by up to 3.6 % of a tensor's update, two ranks from one process
# by up to 3.2 % (at LR 1e-2 both part by 100 %, chaotically). Each
# tensor's difference from the one-process run is held within UPDATE_TOL
# of its update (and of its running statistics' move); a planted fault,
# the pipeline's BatchNorms unsynced, must break it (measured: 149 %).
UPDATE_TOL = 0.1


def _seg_kwargs(root, name, **kw):
    fields = dict(
        data=dict(dataset="synthetic", crop_hw=HW, batch_size=8,
                  num_classes=NC, num_workers=2),
        model=MODEL, optimizer="sgd", lr=1e-4, lr_scheduler="constant",
        num_epochs=2, eval_hw=HW, ckpt_dir=f"{root}/{name}",
        log_dir=f"{root}/{name}_log")
    fields.update(kw)
    return fields


def _seg_cfg(kw):
    kw = dict(kw)
    return SegTrainConfig(data=DataConfig(**kw.pop("data")),
                          model=ModelConfig(**kw.pop("model")), **kw)


def _update_misses(one, got):
    """The tensors whose difference from the one-process run `one`'s
    final weights exceeds UPDATE_TOL of their update from the seeded
    init."""
    m0, _ = build_model(one.model, one.data, "cpu")
    w0 = init_model_variables(m0, one.data).state_dict()
    w1 = load_checkpoint(one.ckpt_dir)["model"]
    return [k for k, v in got.items()
            if np.linalg.norm(v - w1[k].numpy()) > UPDATE_TOL
            * np.linalg.norm((w1[k] - w0[k]).numpy()) + 1e-9]


def test_run_seg_training_over_two_ranks(tmp_path):
    """One epoch on two ranks, then `resume` to the second: both ranks'
    weights at every checkpoint are equal, and the last ones those of the
    uninterrupted one-process run (the bound above); only rank 0
    evaluated; both ranks acted on rank 0's IoUs."""
    one = _seg_cfg(_seg_kwargs(tmp_path, "one"))
    best_one = run_seg_training(one, device="cpu")
    first = _seg_kwargs(tmp_path, "two", num_epochs=1)
    resumed = _seg_kwargs(tmp_path, "two", resume=True)
    outs = ranks.run_world(ranks.seg_pipeline, [first, resumed])
    assert [o["evaluated"] for o in outs] == [2, 0]
    assert outs[0]["best"] == outs[1]["best"]
    # the first epoch's IoU, before the runs part, is one process's
    with open(f"{one.log_dir}/metrics.jsonl") as f:
        ious = [json.loads(line)["val/iou"] for line in f
                if "val/iou" in line]
    assert best_one == max(ious)
    assert outs[0]["best"][0] == pytest.approx(ious[0], rel=1e-9)
    assert latest_step(f"{tmp_path}/two") == 16
    for (d0, s0, m0), (d1, s1, m1) in zip(outs[0]["saved"],
                                         outs[1]["saved"]):
        assert (d0, s0) == (d1, s1)
        for k in m0:
            np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)
    final = outs[0]["saved"][-1]
    assert final[1] == 16
    assert _update_misses(one, final[2]) == []
    # what rank 0 wrote is what every rank held
    saved = load_checkpoint(f"{tmp_path}/two")["model"]
    for k, v in final[2].items():
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)


def test_unsynced_batchnorms_break_the_bound(tmp_path):
    """Planted fault: the same two-rank run with each rank's BatchNorms on
    its own shard's statistics parts from the one-process run."""
    one = _seg_cfg(_seg_kwargs(tmp_path, "one", num_epochs=1))
    run_seg_training(one, device="cpu")
    outs = ranks.run_world(ranks.seg_pipeline, [
        _seg_kwargs(tmp_path, "two", num_epochs=1)], True)
    assert _update_misses(one, outs[0]["saved"][-1][2]) != []
