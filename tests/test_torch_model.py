"""The whole slice on the CPU, fp32: JAX TswinPlus weights -> the port
(`ckpt.from_jax`) -> head-resolution logits and composed upsample+argmax
predictions, against JAX TswinPlus(head_res_logits=True) +
composed_upsample_argmax_cf; and the port's StreamingSegmenter against the
port's full clip and against the JAX StreamingSegmenter."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import traverse_util  # noqa: E402

from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.ops import resize as jresize  # noqa: E402
from stswincl_tpu.pipelines.streaming import (  # noqa: E402
    StreamingSegmenter as JStreamingSegmenter)
from stswincl_tpu_torch.ckpt import load_from_jax, state_dict_from_jax  # noqa: E402
from stswincl_tpu_torch.models import TswinPlus  # noqa: E402
from stswincl_tpu_torch.ops.resize import (  # noqa: E402
    composed_matrices, composed_upsample_argmax_cf)
from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter  # noqa: E402

torch.set_num_threads(1)

# 128x192 input: 16x24 / 8x12 feature maps keep every SW block shifting
HW, OUT, NC = (128, 192), (256, 384), 5
# The JAX CPU route computes GELU with the exact erf; the port (like the
# JAX kernels and their refs) with the erf polynomial (max error 2.6e-5).
# So the two cannot agree bit for bit. Carried through 8 blocks, the
# difference stays at 1.2e-6 on logits of magnitude 0.14; the stated
# bound is 1e-5, and predictions must agree wherever the top-2 margin of
# the upsampled logits exceeds it.
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def model_case():
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((1, 6, *HW, 3)).astype(np.float32)
    jm = JTswinPlus(num_classes=NC, swin_dim=64, swin_depths=(2, 2))
    variables = jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), jnp.asarray(frames[:, :4]))
    # non-trivial BatchNorm statistics, so eval-mode BN is really tested
    flat = traverse_util.flatten_dict(variables["batch_stats"])
    for k, v in flat.items():
        lo, hi = (-0.2, 0.2) if k[-1] == "mean" else (0.7, 1.3)
        flat[k] = jnp.asarray(rng.uniform(lo, hi, v.shape).astype(np.float32))
    variables = {"params": variables["params"],
                 "batch_stats": traverse_util.unflatten_dict(flat)}
    port = TswinPlus(NC, swin_dim=64, swin_depths=(2, 2), input_hw=HW)
    load_from_jax(port, variables)
    jlogits = jax.jit(functools.partial(jm.apply, train=False,
                                        head_res_logits=True))
    return frames, jm, variables, port.eval(), jlogits


def _top2_margin(lcf: np.ndarray) -> np.ndarray:
    """Top-2 class margin of the composed-upsampled logits."""
    mh, mw = (m.numpy() for m in composed_matrices(*lcf.shape[2:], HW, OUT))
    y = np.einsum("pw,bcow->bcop", mw, np.einsum("oh,bchw->bcow", mh, lcf))
    top = np.sort(y, axis=1)
    return top[:, -1] - top[:, -2]


def test_from_jax_consumes_every_leaf(model_case):
    _, _, variables, port, _ = model_case
    sd, unmatched = state_dict_from_jax(variables, port)
    assert unmatched == []
    assert set(sd) == set(port.state_dict())
    n_jax = sum(len(traverse_util.flatten_dict(t)) for t in variables.values())
    assert len(sd) == n_jax


def test_slice_matches_jax(model_case):
    frames, _, variables, port, jlogits = model_case
    clip = frames[:, :4]
    lcf_j = np.asarray(jlogits(variables, jnp.asarray(clip)))
    with torch.no_grad():
        lcf = port(torch.from_numpy(clip), head_res_logits=True)
    assert lcf.shape == (1, NC, HW[0] // 8, HW[1] // 8)
    np.testing.assert_allclose(lcf.numpy(), lcf_j, rtol=0, atol=LOGIT_TOL)

    pred = composed_upsample_argmax_cf(lcf, HW, OUT, exact=True).numpy()
    pred_j = np.asarray(jresize.composed_upsample_argmax_cf(
        jnp.asarray(lcf_j), HW, OUT, exact=True))
    assert pred.shape == (1, *OUT) and pred.dtype == np.int32
    live = _top2_margin(lcf_j) > LOGIT_TOL
    assert live.mean() > 0.9
    np.testing.assert_array_equal(pred[live], pred_j[live])


def test_streaming_matches_full_clip_and_jax(model_case):
    """Port streaming == port full clip on every pixel (fp32, CPU); and ==
    the JAX StreamingSegmenter wherever the JAX top-2 margin exceeds the
    logit tolerance, with the logits of every clip within it."""
    frames, jm, variables, port, jlogits = model_case
    seg = StreamingSegmenter(port, out_hw=OUT)
    jseg = JStreamingSegmenter(jm, variables, out_hw=OUT)
    cache, pred = seg.init_and_predict(torch.from_numpy(frames[:, :4]))
    jcache, jpred = jseg.init_and_predict(jnp.asarray(frames[:, :4]))
    preds, jpreds = [pred], [jpred]
    for i in (4, 5):
        cache, pred = seg.predict_next(cache, torch.from_numpy(frames[:, i]))
        jcache, jpred = jseg.predict_next(jcache, jnp.asarray(frames[:, i]))
        preds.append(pred)
        jpreds.append(jpred)
    for k, (p, jp) in enumerate(zip(preds, jpreds)):
        clip = frames[:, k:k + 4]
        with torch.no_grad():
            lcf = port(torch.from_numpy(clip), head_res_logits=True)
        full = composed_upsample_argmax_cf(lcf, HW, OUT, exact=True)
        np.testing.assert_array_equal(p.numpy(), full.numpy())
        lcf_j = np.asarray(jlogits(variables, jnp.asarray(clip)))
        np.testing.assert_allclose(lcf.numpy(), lcf_j, rtol=0, atol=LOGIT_TOL)
        live = _top2_margin(lcf_j) > LOGIT_TOL
        assert live.mean() > 0.9
        np.testing.assert_array_equal(p.numpy()[live], np.asarray(jp)[live])
