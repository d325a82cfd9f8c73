"""Stages 1 and 3 through the port's entry point on the CPU, at a small
size (swin_dim 64, depths (1, 1), 64x128 clips, fp32) on the synthetic
set: `run_seg_training` writes the latest and `best/` checkpoints and
stops early exactly where the rule says; `resume` restarts at the right
epoch with SGD's momentum buffers and the schedule's step restored, and
ends on the same weights as the run it resumes; the stage-2 -> stage-3
warm start from a `run_contrast_pretraining` checkpoint loads the query
encoder and keeps the classifier's init; `init_checkpoint`'s tolerant
merge keeps and drops the same entries as the JAX `_merge`; and
`run_seg_training` / `run_test` need the card unless asked for the CPU."""

import json
import logging
import os

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from stswincl_tpu.ckpt import checkpoint as jckpt  # noqa: E402
from stswincl_tpu_torch.ckpt import (SEG_ENCODER_SUBTREES,  # noqa: E402
                                     latest_step, load_checkpoint,
                                     save_checkpoint, state_dict_from_jax)
from stswincl_tpu_torch.ckpt.checkpoint import _merge  # noqa: E402
from stswincl_tpu_torch.configs import (ContrastTrainConfig, DataConfig,  # noqa: E402
                                        ModelConfig, SegTrainConfig)
from stswincl_tpu_torch.models import TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.pipelines import seg as seg_pipeline  # noqa: E402
from stswincl_tpu_torch.pipelines.common import (build_model,  # noqa: E402
                                                 init_model_variables)
from stswincl_tpu_torch.pipelines.contrast import run_contrast_pretraining  # noqa: E402
from stswincl_tpu_torch.pipelines.evaluate import run_test  # noqa: E402
from stswincl_tpu_torch.train import train_seg  # noqa: E402
from tests.test_torch_stage_handoff import _jax_name, _trees  # noqa: E402

torch.set_num_threads(2)
HW, NC = (64, 128), 5
STEPS_PER_EPOCH = 8  # 64 synthetic clips at batch 8
LOG = logging.getLogger("stswincl.test")


def _cfg(tmp_path, name="run", **kw):
    model = ModelConfig(num_classes=NC, swin_dim=64, swin_depths=(1, 1),
                        dtype="float32")
    data = DataConfig(dataset="synthetic", crop_hw=HW, batch_size=8,
                      num_classes=NC, num_workers=2)
    fields = dict(optimizer="sgd", lr=1e-2, lr_scheduler="poly",
                  num_epochs=2, eval_hw=HW, ckpt_dir=str(tmp_path / name),
                  log_dir=str(tmp_path / f"{name}_log"))
    fields.update(kw)
    return SegTrainConfig(data=data, model=model, **fields)


def _val_ious(cfg):
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["val/iou"] for r in recs if "val/iou" in r]


def test_run_seg_training_checkpoints_and_early_stop(tmp_path):
    """Four epochs at most, early stop after one stale epoch: the loop
    stops at the first epoch that is not a new best one epoch or more
    after the best; a checkpoint after each evaluation, `best/` holding
    the best epoch's step; the metrics log has train/loss and val/*."""
    cfg = _cfg(tmp_path, num_epochs=4, early_stop_epochs=1)
    best = seg_pipeline.run_seg_training(cfg, device="cpu")
    ious = _val_ious(cfg)
    best_iou, best_epoch, stop = 0.0, 0, len(ious) - 1
    for epoch, iou in enumerate(ious):
        if iou > best_iou:
            best_iou, best_epoch = iou, epoch
        elif epoch - best_epoch >= 1:
            stop = epoch
            break
    assert len(ious) == stop + 1 and best == best_iou
    assert latest_step(cfg.ckpt_dir) == (stop + 1) * STEPS_PER_EPOCH
    assert latest_step(os.path.join(cfg.ckpt_dir, "best")) == \
        (best_epoch + 1) * STEPS_PER_EPOCH
    state = load_checkpoint(cfg.ckpt_dir)
    assert sorted(state) == ["model", "opt", "step"]
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        keys = set().union(*(json.loads(line) for line in f))
    assert {"train/loss", "val/iou", "val/dice", "val/frames"} <= keys


def test_resume_restores_momentum_and_schedule(tmp_path, monkeypatch):
    """A two-epoch run cut after its first epoch's checkpoint, then
    `resume`d: it starts at epoch 1 with the checkpoint's SGD momentum
    buffers and schedule step, and ends on the weights of an uninterrupted
    two-epoch run (within 1e-6)."""
    full = _cfg(tmp_path, "full")
    seg_pipeline.run_seg_training(full, device="cpu")

    class Cut(Exception):
        pass

    real_steps = seg_pipeline.train_steps
    epochs = []

    def cut_after_one_epoch(*args):
        epochs.append(len(epochs))
        if len(epochs) == 2:
            raise Cut
        return real_steps(*args)

    part = _cfg(tmp_path, "part")
    monkeypatch.setattr(seg_pipeline, "train_steps", cut_after_one_epoch)
    with pytest.raises(Cut):
        seg_pipeline.run_seg_training(part, device="cpu")
    monkeypatch.setattr(seg_pipeline, "train_steps", real_steps)
    saved = load_checkpoint(part.ckpt_dir)
    assert saved["step"] == STEPS_PER_EPOCH

    first = {}
    real_call = train_seg.SegTrainStep.__call__

    def spy(self, images, labels):
        if not first:
            first["step"] = self.step
            first["bufs"] = [s["momentum_buffer"].clone()
                             for s in self.opt.state_dict()["state"].values()]
        return real_call(self, images, labels)

    monkeypatch.setattr(train_seg.SegTrainStep, "__call__", spy)
    seg_pipeline.run_seg_training(_cfg(tmp_path, "part", resume=True),
                                  device="cpu")
    assert first["step"] == STEPS_PER_EPOCH
    want = [s["momentum_buffer"] for s in saved["opt"]["state"].values()]
    assert len(first["bufs"]) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(first["bufs"], want))
    assert latest_step(part.ckpt_dir) == 2 * STEPS_PER_EPOCH
    got = load_checkpoint(part.ckpt_dir)["model"]
    ref = load_checkpoint(full.ckpt_dir)["model"]
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   msg=k)


def test_stage2_to_stage3_warm_start(tmp_path):
    """`pretrain_checkpoint`: the query encoder's subtrees of a
    `run_contrast_pretraining` checkpoint load into the segmentation
    model; the classifier keeps the seeded init."""
    ccfg = ContrastTrainConfig(
        data=DataConfig(dataset="synthetic", crop_hw=HW, batch_size=16,
                        num_classes=NC, num_workers=2),
        model=ModelConfig(num_classes=NC, swin_dim=64, swin_depths=(1, 1),
                          dtype="float32"),
        num_epochs=1, ckpt_dir=str(tmp_path / "contrast"),
        log_dir=str(tmp_path / "contrast_log"))
    run_contrast_pretraining(ccfg, device="cpu")
    query = load_checkpoint(ccfg.ckpt_dir)["query"]

    cfg = _cfg(tmp_path, pretrain_checkpoint=ccfg.ckpt_dir)
    model, _ = build_model(cfg.model, cfg.data, device="cpu")
    init = {k: v.clone() for k, v in
            init_model_variables(model, cfg.data).state_dict().items()}
    seg_pipeline._warm_start(cfg, model, LOG)
    sd = model.state_dict()
    for name, t in sd.items():
        if name.split(".")[0] in SEG_ENCODER_SUBTREES:
            assert torch.equal(t, query["segmentor." + name]), name
        else:
            assert name.startswith("classifier.")
            assert torch.equal(t, init[name]), name


def test_imagenet_warm_start(tmp_path):
    """`imagenet_checkpoint`: a torchvision resnet18 `.pth` (the replica's
    stem, layer1 and layer2 under torchvision's names, plus layer3 and fc
    that the OS8 backbone does not use) loads into the ResNet's stem,
    layer1 and layer2; the dilated layers and the rest keep the init."""
    from tests.torch_ref import TResNetOS8
    torch.manual_seed(2)
    sd = {}
    for k, v in TResNetOS8().state_dict().items():
        for src, dst in (("resnet.0.", "conv1."), ("resnet.1.", "bn1."),
                         ("resnet.4.", "layer1."), ("resnet.5.", "layer2.")):
            if k.startswith(src):
                sd[dst + k[len(src):]] = v
    sd["fc.weight"] = torch.zeros(1000, 512)
    torch.save(sd, tmp_path / "resnet18.pth")
    cfg = _cfg(tmp_path, imagenet_checkpoint=str(tmp_path / "resnet18.pth"))
    cfg.model.swin_dim = 512  # the ResNet at its full width, 64 channels
    model, _ = build_model(cfg.model, cfg.data, device="cpu")
    init = {k: v.clone() for k, v in
            init_model_variables(model, cfg.data).state_dict().items()}
    got = seg_pipeline._warm_start(cfg, model, LOG).state_dict()
    assert torch.equal(got["resnet.stem.conv.weight"], sd["conv1.weight"])
    assert torch.equal(got["resnet.layer2_1.cb2.bn.running_var"],
                       sd["layer2.1.bn2.running_var"])
    changed = {k for k in got if not torch.equal(got[k], init[k])}
    assert changed and all(k.startswith(("resnet.stem", "resnet.layer1",
                                         "resnet.layer2")) for k in changed)


def test_init_checkpoint_merge_matches_jax(tmp_path):
    """`init_checkpoint` from a run of another shape (a third stage-2
    layer, 2 heads at stage 1, 3 classes): the entries present with the
    same shape load, the rest keep the init, the extra layer is dropped;
    the values equal the JAX `_merge` of the same trees, and the dropped
    names are the same."""
    prev = init_weights(TswinPlus(3, swin_dim=64, swin_depths=(1, 2),
                                  num_heads=2, input_hw=HW),
                        torch.Generator().manual_seed(8))
    save_checkpoint(str(tmp_path / "prev"), 5, {"model": prev.state_dict()})
    cfg = _cfg(tmp_path, init_checkpoint=str(tmp_path / "prev"))
    model, _ = build_model(cfg.model, cfg.data, device="cpu")
    init = init_model_variables(model, cfg.data).state_dict()
    init = {k: v.clone() for k, v in init.items()}
    got = seg_pipeline._warm_start(cfg, model, LOG).state_dict()

    jtrees, jprev = _trees(init), _trees(prev.state_dict())
    jskipped = []
    merged = {c: jckpt._merge(jtrees[c], jprev[c], (), jskipped)
              for c in ("params", "batch_stats")}
    want, left = state_dict_from_jax(merged, model)
    assert left == []
    assert sorted(want) == sorted(got)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    skipped = []
    _merge(init, prev.state_dict(), skipped)
    ranks = {k: v.dim() for k, v in {**init, **prev.state_dict()}.items()}
    assert sorted(_jax_name(e, ranks) for e in skipped) == sorted(jskipped)
    assert any("classifier" in e for e in skipped)
    assert torch.equal(got["resnet.stem.conv.weight"],
                       prev.state_dict()["resnet.stem.conv.weight"])


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = _cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seg_pipeline.run_seg_training(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_test(cfg)
    assert not os.path.exists(cfg.ckpt_dir)


def test_run_test_refuses_a_checkpoint_without_the_model(tmp_path):
    """A checkpoint directory that holds no "model" raises rather than
    evaluating fresh weights."""
    save_checkpoint(str(tmp_path / "other"), 1, {"query": {}, "step": 1})
    cfg = _cfg(tmp_path, test_checkpoint=str(tmp_path / "other"))
    with pytest.raises(KeyError, match="model"):
        run_test(cfg, device="cpu")
