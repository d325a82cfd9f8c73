"""The port's evaluation path against the JAX package on the CPU, fp32, on
shared weights (the port's seeded weights, BatchNorm statistics drawn away
from identity, handed to the JAX TswinPlus through `ckpt.jax_path` /
`to_jax_layout`): `make_seg_eval_step` at the EndoVis protocol
(align_corners, out twice the input) and the CaDIS one (half-pixel
centres), and `evaluate_split` full-clip and streaming, with a sequence
boundary whose frame must fall back to a full-clip forward, on both
protocols.

Tolerances. The port computes the exact GELU with the erf polynomial of
the kernels (max error 2.6e-5), the JAX CPU route with the exact erf: the
logits differ by about 1e-6 (`tests/test_torch_model.py`), and a pixel
whose top-2 margin is below that may flip. The eval step runs that model
and holds predictions equal on >= 99.9 % of pixels. A flipped pixel moves
a class's IoU on a 128x192 frame by about 1e-5, so `evaluate_split`, whose
summaries are held within 1e-6 (and equal where every prediction is),
runs both models with the tanh GELU, which both packages compute by the
same formula: logits within 3e-7. Its predictions are held equal on
>= 99.9 % of pixels too, and the port's streamed and full-clip summaries
equal (the same arithmetic on the same weights)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from stswincl_tpu.configs import DataConfig as JDataConfig  # noqa: E402
from stswincl_tpu.configs import SegTrainConfig as JSegTrainConfig  # noqa: E402
from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.pipelines import evaluate as jevaluate  # noqa: E402
from stswincl_tpu.train import train_seg as jtrain  # noqa: E402
from stswincl_tpu_torch.ckpt import jax_path, to_jax_layout  # noqa: E402
from stswincl_tpu_torch.configs import DataConfig, SegTrainConfig  # noqa: E402
from stswincl_tpu_torch.data.loader import SyntheticSegDataset  # noqa: E402
from stswincl_tpu_torch.models import TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.pipelines.evaluate import evaluate_split  # noqa: E402
from stswincl_tpu_torch.train.train_seg import make_seg_eval_step  # noqa: E402

torch.set_num_threads(2)

# 128x192: 16x24 / 8x12 feature maps keep every SW block shifting
HW, NC = (128, 192), 9   # 9 = CADIS_CLASS_NUM["1"]
PRED_SHARE = 0.999
METRIC_TOL = 1e-6
PROTOCOLS = {"endovis": dict(out=(256, 384), align=True),
             "cadis": dict(out=(135, 240), align=False)}


class TwoSeq(SyntheticSegDataset):
    """The synthetic stream cut into two sequences at sample 4: sample 4
    restarts the frame numbers, so its clip is not the previous clip
    advanced by one (`tests/test_pipelines.py:118`)."""

    def get(self, index, rng=None):
        s = super().get(index, rng)
        f = s["path"][1]
        s["path"] = (1, f) if index < 4 else (2, f - 4)
        return s


def _jax_variables(model):
    tree = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        coll, path = jax_path(name, t.dim())
        node = tree[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.array(to_jax_layout(name, t.numpy()), copy=True)
    return tree


def _case(gelu_exact):
    port = TswinPlus(NC, swin_dim=64, swin_depths=(2, 2), input_hw=HW,
                     gelu_exact=gelu_exact)
    init_weights(port, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=g) * 0.4 - 0.2)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) * 0.6 + 0.7)
    port.eval()
    jm = JTswinPlus(num_classes=NC, swin_dim=64, swin_depths=(2, 2),
                    gelu_exact=gelu_exact)
    return port, jm, _jax_variables(port)


@pytest.fixture(scope="module")
def case():
    return _case(gelu_exact=True)


@pytest.fixture(scope="module")
def tanh_case():
    return _case(gelu_exact=False)


@pytest.mark.parametrize("head_res_logits", [True, False])
@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_eval_step_matches_jax(case, protocol, head_res_logits):
    """With `head_res_logits` the composed upsample from head resolution;
    without it (the path of a model that lacks the keyword) the resize of
    the model's finished NHWC logits from the input resolution."""
    port, jm, variables = case
    p = PROTOCOLS[protocol]
    clip = np.random.default_rng(1).random((2, 4, *HW, 3), dtype=np.float32)
    kw = dict(out_hw=p["out"], align_corners=p["align"],
              head_res_logits=head_res_logits)
    got = make_seg_eval_step(port, **kw)(clip)
    want = jtrain.make_seg_eval_step(jm, **kw)(
        variables["params"], variables["batch_stats"], jnp.asarray(clip))
    assert got.shape == (2, *p["out"]) and got.dtype == torch.int32
    share = (got.numpy() == np.asarray(want)).mean()
    assert share >= PRED_SHARE, share
    assert len(np.unique(got.numpy())) >= 3  # not collapsed to one class


def _cfg(pkg, protocol, viz_dir):
    data_cls, cfg_cls = ((JDataConfig, JSegTrainConfig) if pkg == "jax"
                         else (DataConfig, SegTrainConfig))
    is_cadis = protocol == "cadis"
    data = data_cls(dataset="cadis" if is_cadis else "synthetic",
                    num_classes=NC, crop_hw=HW, tag="1")
    # CaDIS: the default eval_hw (1024, 1280) becomes the (540, 960)
    # protocol; both protocols then score at the label's 128x192 through
    # the nearest resize
    return cfg_cls(data=data, viz_dir=viz_dir,
                   eval_hw=(1024, 1280) if is_cadis else (256, 384))


def _viz(d):
    import glob
    import os
    return {os.path.basename(p): np.asarray(Image.open(p))
            for p in sorted(glob.glob(os.path.join(d, "*.png")))}


def _hold(got, want, same_predictions):
    assert list(got) == list(want)
    for k in got:
        if k == "sec_per_frame":
            continue
        if same_predictions:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_evaluate_split_matches_jax(tanh_case, protocol, tmp_path):
    """Full clip and streaming, port against JAX, through the sequence
    boundary: 6 of 8 frames stream (sample 0 seeds, sample 4 falls back)."""
    port, jm, variables = tanh_case
    ds = TwoSeq(length=8, t=4, hw=HW, num_classes=NC - 1)
    summaries = {}
    for streaming in (False, True):
        got = evaluate_split(port, ds, _cfg("port", protocol,
                                            str(tmp_path / f"p{streaming}")),
                             streaming=streaming)
        want = jevaluate.evaluate_split(
            jm, variables["params"], variables["batch_stats"], ds,
            _cfg("jax", protocol, str(tmp_path / f"j{streaming}")),
            streaming=streaming)
        pv, jv = _viz(tmp_path / f"p{streaming}"), _viz(
            tmp_path / f"j{streaming}")
        assert list(pv) == list(jv) and len(pv) == 8
        share = np.mean([(pv[k] == jv[k]).all(-1).mean() for k in pv])
        assert share >= PRED_SHARE, share
        _hold(got, want, all((pv[k] == jv[k]).all() for k in pv))
        assert got["frames"] == 8
        if streaming:
            assert got["streamed_frames"] == 6  # 0 seeds, 4 re-seeds
        summaries[streaming] = got
    s = dict(summaries[True])
    del s["streamed_frames"]
    _hold(s, summaries[False], True)
