"""The port's segmentation datasets against the JAX package on the CPU:
`clip_frame_indices`, `EndovisDataset` train samples (augmented from the
same `_seeded_rng` stream) and test samples (labels decoded from RGB maps
through `labels.json`, the 11-class variant), and `CadisDataset` on every
split and experiment tag, each equal to the JAX class's bit for bit on
small PNG trees written under tmp_path; `sliding_from` equal on every
consecutive pair of samples."""

import json

import numpy as np
import pytest
from PIL import Image

from stswincl_tpu.data import cadis as jcadis
from stswincl_tpu.data import endovis18 as jendovis
from stswincl_tpu.data import loader as jloader
from stswincl_tpu_torch.data import cadis, endovis18, loader
from tests.test_torch_data import (EV_FRAMES, EV_SEQS,  # noqa: F401
                                   _equal_samples, endovis_tree)

SIZES = dict(crop_hw=(32, 48), base_hw=(36, 52))
TEST_SEQS, TEST_FRAMES, LABEL_HW = (1, 2), 7, (40, 56)
# the EndoVis18 challenge colours (a `labels.json` as the dataset ships it)
COLORS = [[0, 0, 0], [0, 255, 0], [0, 255, 255], [125, 255, 12],
          [255, 55, 0], [24, 55, 125], [187, 155, 25], [0, 255, 125],
          [255, 255, 125], [123, 15, 175], [124, 155, 5], [12, 255, 141]]


CADIS_VIDEOS, CADIS_FRAMES = (1, 5), 12


@pytest.fixture
def cadis_tree(tmp_path):
    """Two videos of 12 frames (clips two frames apart reach 7 back) with
    raw 36-class label maps."""
    root = tmp_path / "cadis"
    rng = np.random.default_rng(5)
    for vid in CADIS_VIDEOS:
        for sub in ("Images", "Labels"):
            (root / f"Video{vid:02d}" / sub).mkdir(parents=True)
        for i in range(CADIS_FRAMES):
            img = rng.integers(0, 255, (54, 96, 3), dtype=np.uint8)
            Image.fromarray(img).save(
                root / f"Video{vid:02d}" / "Images" / f"frame{i:04d}.png")
            lab = rng.integers(0, 36, (54, 96), dtype=np.uint8)
            Image.fromarray(lab).save(
                root / f"Video{vid:02d}" / "Labels" / f"frame{i:04d}.png")
    return str(root)


@pytest.fixture
def endovis_test_tree(endovis_tree):
    """The train tree plus a test split: frames under `Processed_test/`,
    RGB label maps at their own size under `test/seq_N/labels/` (blocks of
    every class colour) and `train/labels.json`."""
    import pathlib
    root = pathlib.Path(endovis_tree)
    rng = np.random.default_rng(11)
    (root / "train").mkdir()
    (root / "train" / "labels.json").write_text(json.dumps(
        [{"name": f"class{i}", "color": c, "classid": i}
         for i, c in enumerate(COLORS)]))
    for s in TEST_SEQS:
        imdir = root / "Processed_test" / f"seq_{s}" / "left_frames"
        lbdir = root / "test" / f"seq_{s}" / "labels"
        imdir.mkdir(parents=True)
        lbdir.mkdir(parents=True)
        for i in range(TEST_FRAMES):
            img = rng.integers(0, 255, (72, 96, 3), dtype=np.uint8)
            Image.fromarray(img).save(imdir / f"frame{i:03d}.png")
            ids = rng.integers(0, 12, (LABEL_HW[0] // 8, LABEL_HW[1] // 8))
            ids = np.kron(ids, np.ones((8, 8), dtype=np.int64))
            Image.fromarray(np.asarray(COLORS, np.uint8)[ids]).save(
                lbdir / f"frame{i:03d}.png")
    return endovis_tree


@pytest.mark.parametrize("t", [3, 4])
def test_clip_frame_indices_match_jax(t):
    for frame in range(13):
        assert endovis18.clip_frame_indices(frame, t) == \
            jendovis.clip_frame_indices(frame, t)


def _sliding_pairs_equal(port, ref):
    pairs = list(zip(port.samples, port.samples[1:]))
    assert pairs
    got = [port.sliding_from(a, b) for a, b in pairs]
    assert got == [ref.sliding_from(a, b) for a, b in pairs]
    return got


@pytest.mark.parametrize("augment", [True, False])
def test_endovis_train_matches_jax_bitwise(endovis_tree, augment):
    kw = dict(SIZES, sequences=EV_SEQS, augment=augment,
              frames_per_seq={s: EV_FRAMES for s in EV_SEQS})
    port = endovis18.EndovisDataset(endovis_tree, "train", **kw)
    ref = jendovis.EndovisDataset(endovis_tree, "train", **kw)
    assert port.samples == ref.samples
    for i in (0, 1, 6, 13, 22, 39):
        got = port.get(i, loader._seeded_rng(3, 2, i))
        want = ref.get(i, jloader._seeded_rng(3, 2, i))
        assert got["image"].shape == (4, 32, 48, 3)
        _equal_samples(got, want)
    _sliding_pairs_equal(port, ref)


@pytest.mark.parametrize("num_classes", [12, 11])
def test_endovis_test_split_matches_jax_bitwise(endovis_test_tree,
                                                num_classes):
    kw = dict(SIZES, sequences=TEST_SEQS, num_classes=num_classes,
              frames_per_seq={s: TEST_FRAMES for s in TEST_SEQS})
    port = endovis18.EndovisDataset(endovis_test_tree, "test", **kw)
    ref = jendovis.EndovisDataset(endovis_test_tree, "test", **kw)
    np.testing.assert_array_equal(port.color_table, ref.color_table)
    assert port.samples == ref.samples
    top = 0
    for i in range(len(port)):
        got, want = port.get(i), ref.get(i)
        assert got["label"].shape == LABEL_HW
        top = max(top, got["label"].max())
        _equal_samples(got, want)
    # 11 classes: the table stops at class 10, which becomes 9
    assert top == (11 if num_classes == 12 else 9)
    # frames below t take the reversed fallback and never slide
    slides = _sliding_pairs_equal(port, ref)
    assert slides.count(True) == len(TEST_SEQS) * (TEST_FRAMES - 4 - 1)


@pytest.mark.parametrize("tag", ["1", "2", "3"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_cadis_matches_jax_bitwise(cadis_tree, tag, split):
    kw = dict(SIZES, tag=tag, videos=CADIS_VIDEOS, step=2 if tag == "2"
              else 1)
    port = cadis.CadisDataset(cadis_tree, split, **kw)
    ref = jcadis.CadisDataset(cadis_tree, split, **kw)
    assert port.samples == ref.samples and port.paths == ref.paths
    for i in (0, 1, 4, 5, 6, 11, 13, 23):
        got = port.get(i, loader._seeded_rng(1, 0, i))
        want = ref.get(i, jloader._seeded_rng(1, 0, i))
        _equal_samples(got, want)
        if split == "train":  # ignore -> the last class at train time
            assert got["label"].max() <= port.class_num - 1
        else:
            assert got["image"].shape == (4, 32, 48, 3)
    _sliding_pairs_equal(port, ref)


def test_cadis_refuses_unknown_split(cadis_tree):
    with pytest.raises(ValueError, match="split"):
        cadis.CadisDataset(cadis_tree, "dev")
    with pytest.raises(ValueError, match="tag"):
        cadis.CadisDataset(cadis_tree, "train", tag="4")
