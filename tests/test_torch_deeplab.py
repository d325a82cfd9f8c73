"""The DeepLabV3+ pre-stage of the port against the JAX package on the
CPU, fp32: `DeepLabV3Plus` with ResNet18-OS8 (narrow width) and with
ResNet50-OS16 (64x64 input) forward in both output modes on the JAX
module's own variables, loaded through `state_dict_from_jax` with no leaf
left over; one train step (NHWC logits, OHEM) against the JAX
`make_seg_train_step`; `build_model("puredeeplab18")` against the JAX
one; the cross-arch warm start of a swinPlus run from a DeepLab
checkpoint against the JAX `_merge`; and the pipeline through its entry
points: `run_seg_training(device="cpu")` pre-stage -> stage 1, and
`run_test` on a DeepLab checkpoint (streaming falls back to full clips)."""

import copy
import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.ckpt import checkpoint as jckpt  # noqa: E402
from stswincl_tpu.configs import DataConfig as JDataConfig  # noqa: E402
from stswincl_tpu.configs import ModelConfig as JModelConfig  # noqa: E402
from stswincl_tpu.models import DeepLabV3Plus as JDeepLab  # noqa: E402
from stswincl_tpu.pipelines import common as jcommon  # noqa: E402
from stswincl_tpu.train import optim as joptim  # noqa: E402
from stswincl_tpu.train import train_seg as jtrain  # noqa: E402
from stswincl_tpu_torch.ckpt import (jax_path, latest_step,  # noqa: E402
                                     load_checkpoint, load_from_jax,
                                     save_checkpoint, state_dict_from_jax,
                                     to_jax_layout)
from stswincl_tpu_torch.ckpt.checkpoint import _merge  # noqa: E402
from stswincl_tpu_torch.configs import DataConfig, ModelConfig  # noqa: E402
from stswincl_tpu_torch.models import DeepLabV3Plus, TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.models.norm import BatchNorm  # noqa: E402
from stswincl_tpu_torch.pipelines import seg as seg_pipeline  # noqa: E402
from stswincl_tpu_torch.pipelines.common import (build_model,  # noqa: E402
                                                 init_model_variables)
from stswincl_tpu_torch.pipelines.evaluate import run_test  # noqa: E402
from stswincl_tpu_torch.pipelines.seg import make_tx, train_steps  # noqa: E402
from stswincl_tpu_torch.train import train_seg  # noqa: E402
from stswincl_tpu_torch.train.train_seg import make_seg_eval_step  # noqa: E402
from tests.test_torch_seg_pipeline import _cfg  # noqa: E402
from tests.test_torch_stage_handoff import _jax_name, _trees  # noqa: E402
from tests.test_torch_train import (GRAD_ATOL, GRAD_TOL, LOSS_TOL,  # noqa: E402
                                    STATS_TOL, _jax_variables, _leaf, _rel,
                                    _recording)

torch.set_num_threads(2)
NC = 5
LOG = logging.getLogger("stswincl.test")
# (layers, width, input): ResNet18-OS8 at width 8 on 64x96, ResNet50-OS16
# (its width is fixed) on 64x64
CASES = [(18, 8, (64, 96)), (50, 64, (64, 64))]
# fp32 on both sides, the same convolutions in another order: relative
# error of the logits (4.4e-7 measured at most)
FWD_TOL = 1e-5


def _clip(hw, t=1, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, t, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("layers,width,hw", CASES)
def test_forward_matches_jax(layers, width, hw):
    """Both output modes, the clip cut to its last frame: logits at input
    resolution (NHWC) and channels-first logits at head resolution."""
    x = _clip(hw, t=2)
    jm = JDeepLab(num_classes=NC, layers=layers, width=width)
    variables = jm.init(jax.random.key(layers), jnp.asarray(x), train=False)
    port = DeepLabV3Plus(NC, layers=layers, width=width)
    sd, unmatched = state_dict_from_jax(variables, port)
    assert unmatched == [] and sorted(sd) == sorted(port.state_dict())
    load_from_jax(port, variables)
    port.eval()
    os_ = 16 if layers == 50 else 8
    for head_res in (False, True):
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False,
                                   head_res_logits=head_res))
        with torch.no_grad():
            got = port(torch.from_numpy(x), head_res_logits=head_res)
        shape = ((2, NC, hw[0] // os_, hw[1] // os_) if head_res
                 else (2, *hw, NC))
        assert tuple(got.shape) == want.shape == shape
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= FWD_TOL, head_res
    # a frame batch goes in as it is
    with torch.no_grad():
        frames = port(torch.from_numpy(x[:, -1]))
        clip = port(torch.from_numpy(x))
    assert torch.equal(frames, clip)


def _train_batch():
    """(2, 1, 64, 96) clips whose two images differ in colour, and labels.
    The ASPP image-pool BatchNorm normalises one pooled value per image;
    on noise alone the pooled features of the two images nearly agree,
    and flax's variance E[x^2] - E[x]^2 cancels catastrophically there: on
    plain normal noise the JAX step's stem gradient is then 1.2 % from a
    float64 evaluation of the same step, the port's 6e-6
    (`test_gradients_match_float64`)."""
    x = _clip((64, 96))
    x += np.random.default_rng(2).uniform(
        -1, 1, (2, 1, 1, 1, 3)).astype(np.float32)
    labels = np.random.default_rng(1).integers(
        -1, NC, (2, 64, 96)).astype(np.int32)
    return x, labels


def test_train_step_matches_jax():
    """One step at batch 2, OHEM on the NHWC logits (the JAX step takes
    NHWC logits from a model without `trunk`), Adam 3e-4: loss, every
    gradient, the BatchNorm statistics and the parameters after the step,
    to the bounds of `test_torch_train.py`."""
    x, labels = _train_batch()
    port = init_weights(DeepLabV3Plus(NC, width=8),
                        torch.Generator().manual_seed(0))
    assert port.channels_first_loss is False
    variables = _jax_variables(port)
    jm = JDeepLab(num_classes=NC, width=8)
    assert not hasattr(jm, "trunk")
    tx = _recording(joptim.make_adam(3e-4))
    jstate = jtrain.SegTrainState.create(variables, tx)
    jstep = jtrain.make_seg_train_step(jm, tx, loss_type="ohem")
    jstate, jmetrics = jstep(jstate, jnp.asarray(x), jnp.asarray(labels))
    jgrads = jstate.opt_state[1]

    cfg = seg_pipeline.SegTrainConfig()
    opt, schedule = make_tx(cfg, 10, port)
    step = train_seg.make_seg_train_step(port, opt, schedule, "ohem")
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.numpy().copy() for n, p in port.named_parameters()}))
    old = {n: t.clone() for n, t in port.state_dict().items()}
    metrics = train_steps(step, [{"image": x, "label": labels}], 1,
                          torch.device("cpu"))
    assert metrics[0]["loss"] == pytest.approx(float(jmetrics["loss"]),
                                               rel=LOSS_TOL)
    new_vars = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    for name, t in port.state_dict().items():
        coll, path = jax_path(name, t.dim())
        want = _leaf(new_vars[coll], path)
        got = to_jax_layout(name, t.numpy())
        if coll == "batch_stats":
            assert _rel(got, want) <= STATS_TOL, name
            continue
        pg, jg = to_jax_layout(name, grads[name]), _leaf(jgrads, path)
        assert (np.linalg.norm(pg - jg)
                <= GRAD_TOL * np.linalg.norm(jg) + GRAD_ATOL), name
        start = to_jax_layout(name, old[name].numpy())
        assert np.abs(got - start).max() <= 1.001 * cfg.lr, name


def _grads(model, x, labels, dtype):
    model.train()
    loss = train_seg.SegTrainStep(model, opt=None).loss(
        torch.from_numpy(x).to(dtype), torch.from_numpy(labels).long())
    loss.backward()
    return {n: p.grad.double() for n, p in model.named_parameters()}


def test_gradients_match_float64(monkeypatch):
    """The port's fp32 step against the same step in float64 (parameters,
    convolutions and BatchNorm, the variance centred; the loss head stays
    fp32), on plain normal noise: every gradient within 1e-3 relative
    (2.2e-4 measured at most, the image-pool conv behind its BatchNorm of
    2 values a channel; 1.5e-4 elsewhere), + GRAD_ATOL for the conv biases
    that feed a train-mode BatchNorm (zero in exact arithmetic)."""
    x = _clip((64, 96))
    labels = np.random.default_rng(1).integers(
        -1, NC, (2, 64, 96)).astype(np.int32)
    port = init_weights(DeepLabV3Plus(NC, width=8),
                        torch.Generator().manual_seed(0))
    g32 = _grads(copy.deepcopy(port), x, labels, torch.float32)
    m64 = copy.deepcopy(port).double()
    for mod in m64.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64

    def bn64(self, t):
        t = t.double()
        dims = tuple(range(t.dim() - 1))
        mean = t.mean(dims)
        var = ((t - mean) ** 2).mean(dims)
        return (t - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
    monkeypatch.setattr(BatchNorm, "forward", bn64)
    g64 = _grads(m64, x, labels, torch.float64)
    for n, g in g64.items():
        assert (g32[n] - g).norm() <= 1e-3 * g.norm() + GRAD_ATOL, n


def test_train_step_takes_nhwc_logits():
    """The loss asks DeepLabV3Plus for its plain logits (it has no
    channels-first keyword) and TswinPlus for channels-first ones; plain
    CE on the NHWC logits equals CE on the same logits channels first."""
    model = init_weights(DeepLabV3Plus(NC, width=8),
                         torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(_clip((64, 96)))
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        -1, NC, (2, 64, 96))).long()
    step = train_seg.SegTrainStep(model, opt=None, loss_type="ce")
    loss = step.loss(x, labels)
    logits = model(x).permute(0, 3, 1, 2)
    ce = train_seg.per_pixel_ce_channels_first(logits, labels, -1)
    want = ce.sum() / (labels != -1).sum()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    assert TswinPlus.channels_first_loss is True


def _configs():
    model_cfg = ModelConfig(arch="puredeeplab18", num_classes=NC,
                            swin_dim=64, dtype="float32")
    data_cfg = DataConfig(dataset="synthetic", crop_hw=(64, 96), t=1)
    return model_cfg, data_cfg


def test_build_model_matches_jax():
    """`arch='puredeeplab18'`: DeepLabV3Plus at width swin_dim // 8, the
    class count, the JAX init's variables loading with nothing left over,
    and the same logits on them."""
    model_cfg, data_cfg = _configs()
    port, nc = build_model(model_cfg, data_cfg, device="cpu")
    jm, jnc = jcommon.build_model(JModelConfig(**vars(model_cfg)),
                                  JDataConfig(**vars(data_cfg)))
    assert isinstance(port, DeepLabV3Plus) and type(jm).__name__ == \
        "DeepLabV3Plus"
    assert nc == jnc == NC and jm.width == 8 and port.layers == 18
    variables = jcommon.init_model_variables(jm, JDataConfig(
        **vars(data_cfg)), clip=False)
    load_from_jax(port, variables)
    x = _clip((64, 96), t=1)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    assert _rel(got, want) <= FWD_TOL


def test_warm_start_from_deeplab_matches_jax(tmp_path):
    """A swinPlus run with `init_checkpoint` = a DeepLab checkpoint: the
    entries of the same name and shape load (the whole resnet, and the
    few head entries whose shapes agree), the rest keep their init; the
    values and the skipped names equal the JAX `_merge`'s."""
    prev = init_weights(DeepLabV3Plus(NC, width=8),
                        torch.Generator().manual_seed(8))
    save_checkpoint(str(tmp_path / "deeplab"), 3,
                    {"model": prev.state_dict()})
    cfg = _cfg(tmp_path, init_checkpoint=str(tmp_path / "deeplab"))
    model, _ = build_model(cfg.model, cfg.data, device="cpu")
    init = {k: v.clone() for k, v in
            init_model_variables(model, cfg.data).state_dict().items()}
    got = seg_pipeline._warm_start(cfg, model, LOG).state_dict()

    jtrees, jprev = _trees(init), _trees(prev.state_dict())
    jskipped = []
    merged = {c: jckpt._merge(jtrees[c], jprev[c], (), jskipped)
              for c in ("params", "batch_stats")}
    want, left = state_dict_from_jax(merged, model)
    assert left == [] and sorted(want) == sorted(got)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    skipped = []
    _merge(init, prev.state_dict(), skipped)
    ranks = {k: v.dim() for k, v in {**init, **prev.state_dict()}.items()}
    # the JAX merge runs once per collection, so it names the missing
    # `project` module twice (params and batch_stats), the port once
    assert sorted(_jax_name(e, ranks) for e in skipped) == sorted(
        set(jskipped))
    assert len(jskipped) == len(skipped) + 1
    src = prev.state_dict()
    resnet = [k for k in got if k.startswith("resnet.")]
    assert len(resnet) > 0 and all(torch.equal(got[k], src[k])
                                   for k in resnet)
    assert "project (missing in target)" in skipped
    for k in got:
        if k.startswith(("swin.", "project1.", "project2.", "project3.")):
            assert torch.equal(got[k], init[k]), k
    assert torch.equal(got["classifier.conv1.weight"],
                       init["classifier.conv1.weight"])
    assert torch.equal(got["aspp.fuse.conv.weight"],
                       init["aspp.fuse.conv.weight"])


def test_pre_stage_then_stage1_and_test(tmp_path, caplog):
    """The pipeline's first two commands on the synthetic set: the DeepLab
    pre-stage (`model.arch=puredeeplab18 data.t=1`) writes `best/`, stage 1
    warm-starts from it (the resnet entries equal the pre-stage's), and
    `test` on the DeepLab checkpoint falls back from streaming to full
    clips with a warning and scores every frame."""
    pre = _cfg(tmp_path, "deeplab", num_epochs=1)
    pre.model.arch, pre.data.t = "puredeeplab18", 1
    best = seg_pipeline.run_seg_training(pre, device="cpu")
    assert best > 0 and latest_step(str(tmp_path / "deeplab" / "best")) == 8
    deeplab = load_checkpoint(str(tmp_path / "deeplab" / "best"))["model"]

    warm = {}
    real = seg_pipeline._warm_start

    def spy(cfg, model, logger):
        out = real(cfg, model, logger)
        warm.update({k: v.clone() for k, v in model.state_dict().items()})
        return out
    stage1 = _cfg(tmp_path, "stage1", num_epochs=1,
                  init_checkpoint=str(tmp_path / "deeplab" / "best"))
    seg_pipeline._warm_start = spy
    try:
        seg_pipeline.run_seg_training(stage1, device="cpu")
    finally:
        seg_pipeline._warm_start = real
    resnet = [k for k in deeplab if k.startswith("resnet.")]
    assert len(resnet) > 0 and all(torch.equal(warm[k], deeplab[k])
                                   for k in resnet)
    assert latest_step(stage1.ckpt_dir) == 8

    test = _cfg(tmp_path, "deeplab", streaming_eval=True,
                test_checkpoint=str(tmp_path / "deeplab" / "best"))
    test.model.arch, test.data.t = "puredeeplab18", 1
    logger = logging.getLogger("stswincl")
    logger.addHandler(caplog.handler)
    try:
        summary = run_test(test, device="cpu")
    finally:
        logger.removeHandler(caplog.handler)
    assert "streaming_eval: unsupported for DeepLabV3Plus" in caplog.text
    assert summary["frames"] == 8 and "streamed_frames" not in summary


def test_eval_step_on_deeplab_logits():
    """`make_seg_eval_step` takes DeepLab's head-resolution logits through
    the composed upsample and argmax, as the argmax of its full-resolution
    logits resized by the eval protocol."""
    model = init_weights(DeepLabV3Plus(NC, width=8),
                         torch.Generator().manual_seed(3)).eval()
    x = _clip((64, 96), t=1, batch=1)
    fast = make_seg_eval_step(model, out_hw=(128, 192))(x)
    slow = make_seg_eval_step(model, out_hw=(128, 192),
                              head_res_logits=False)(x)
    assert fast.shape == (1, 128, 192) and fast.dtype == torch.int32
    assert (fast == slow).float().mean() >= 0.999
