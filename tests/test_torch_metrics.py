"""The port's metrics and prediction dumps against the JAX package's on
seeded label maps and predictions: Dice, Jaccard and their per-class
forms, `EndovisEvaluator.summary` over several sequences, the CaDIS
confusion matrix with the ignore label (and predictions) outside the
scored classes, PA / PAC / mIoU, all within 1e-12; the colour tables
equal; `save_prediction`'s PNG equal pixel for pixel."""

import numpy as np
import pytest
from PIL import Image

from stswincl_tpu import eval as jeval
from stswincl_tpu.eval import metrics_cadis as jcadis
from stswincl_tpu.eval import visualization as jviz
from stswincl_tpu_torch import eval as peval
from stswincl_tpu_torch.eval import metrics_cadis as pcadis
from stswincl_tpu_torch.eval import visualization as pviz

TOL = 1e-12


def _maps(rng, n, classes, hw=(24, 40), agree=0.6, low=0):
    """n (label, prediction) pairs: blocky labels, predictions equal to
    them on about `agree` of the pixels."""
    out = []
    for _ in range(n):
        lab = np.kron(rng.integers(low, classes, (hw[0] // 4, hw[1] // 4)),
                      np.ones((4, 4), dtype=np.int64)).astype(np.int32)
        noise = rng.integers(low, classes, hw).astype(np.int32)
        out.append((lab, np.where(rng.random(hw) < agree, lab, noise)))
    return out


def _close(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_exports_match():
    assert sorted(peval.__all__) == sorted(
        n for n in dir(jeval) if not n.startswith("_")
        and n not in ("metrics_cadis", "metrics_endovis", "visualization"))


@pytest.mark.parametrize("fn", ["dice_score", "jaccard_score",
                                "per_class_dice", "per_class_jaccard"])
def test_endovis_metric_functions_match(rng, fn):
    for lab, pred in _maps(rng, 6, 12):
        if fn.endswith("score"):
            for c in (1, 5, 11):
                _close(getattr(peval, fn)(lab == c, pred == c),
                       getattr(jeval, fn)(lab == c, pred == c))
        else:
            _close(getattr(peval, fn)(lab, pred), getattr(jeval, fn)(lab, pred))


@pytest.mark.parametrize("num_classes", [12, 11])
def test_endovis_evaluator_summary_matches(rng, num_classes):
    port = peval.EndovisEvaluator(num_classes=num_classes)
    ref = jeval.EndovisEvaluator(num_classes=num_classes)
    for k, (lab, pred) in enumerate(_maps(rng, 9, num_classes)):
        if k == 4:  # a frame of background only: its score is NaN
            lab = np.zeros_like(lab)
        port.update(lab, pred, k % 3 + 1)
        ref.update(lab, pred, k % 3 + 1)
    got, want = port.summary(), ref.summary()
    assert list(got) == list(want) and got["frames"] == 9
    _close(got, want)


def test_confusion_matrix_with_ignore_matches(rng):
    """Labels hold the ignore class (9 of tag 1's 9 + ignore after the
    train remap, 255 raw) and predictions one past the scored classes:
    both are left out of the matrix."""
    n = 8
    pairs = _maps(rng, 5, n + 1)
    pairs = [(np.where(lab == 3, 255, lab), pred) for lab, pred in pairs]
    port, ref = pcadis.ConfusionMatrix(n), jcadis.ConfusionMatrix(n)
    for lab, pred in pairs:
        port.update(lab, pred)
        ref.update(lab, pred)
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    assert port.matrix.sum() < sum(lab.size for lab, _ in pairs)
    for fn in ("pixel_accuracy", "pixel_accuracy_per_class", "mean_iou"):
        _close(getattr(pcadis, fn)(port.matrix),
               getattr(jcadis, fn)(ref.matrix))
    labs, preds = zip(*pairs)
    _close(pcadis.segmentation_metrics(list(labs), list(preds), n),
           jcadis.segmentation_metrics(list(labs), list(preds), n))
    port.reset()
    assert port.matrix.sum() == 0
    with pytest.raises(ValueError):
        port.update(labs[0], preds[0][:-1])


@pytest.mark.parametrize("tag", ["1", "2", "3"])
def test_colour_maps_match(tag):
    np.testing.assert_array_equal(pviz.CADIS_COLORMAP, jviz.CADIS_COLORMAP)
    np.testing.assert_array_equal(pviz.ENDOVIS_COLORMAP,
                                  jviz.ENDOVIS_COLORMAP)
    got, want = pviz.remapped_cadis_colormap(tag), \
        jviz.remapped_cadis_colormap(tag)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["endovis", "cadis"])
def test_save_prediction_matches(rng, tmp_path, kind):
    mask = rng.integers(-1, 14, (30, 50)).astype(np.int32)
    kw = (dict(colormap=pviz.ENDOVIS_COLORMAP) if kind == "endovis"
          else dict(cadis_tag="2"))
    pviz.save_prediction(str(tmp_path / "port.png"), mask, **kw)
    jviz.save_prediction(str(tmp_path / "jax.png"), mask, **kw)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.shape == (30, 50, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pviz.label_to_rgb(mask, pviz.ENDOVIS_COLORMAP),
        jviz.label_to_rgb(mask, jviz.ENDOVIS_COLORMAP))
    np.testing.assert_array_equal(pviz.cadis_mask_to_rgb(mask, "3"),
                                  jviz.cadis_mask_to_rgb(mask, "3"))
