"""The port's RandAugment (`stswincl_tpu_torch/data/rand_augment.py`)
against the JAX package's copy on the CPU, bit for bit: every op of `OPS`
on seeded images and label maps (the geometric ops warp the label with the
same affine), the config grammar and its errors, `RandAugment` and both
`ClipRandAugment` modes from the same generator; then the six-view sampler
with `rand_augment` on a PNG tree under `tmp_path` against the JAX
`ContrastiveClipDataset`, and the loader's spawned processes against its
threads on that dataset (the dataset and its augment pickle)."""

import pickle

import numpy as np
import pytest

from stswincl_tpu.data import contrastive as jcontrastive
from stswincl_tpu.data import loader as jloader
from stswincl_tpu.data import rand_augment as jra
from stswincl_tpu_torch.data import contrastive, loader
from stswincl_tpu_torch.data import rand_augment as ra
from tests.test_torch_data import (EV_FRAMES, EV_SEQS, SMALL,  # noqa: F401
                                   _equal_samples, endovis_tree)

CONFIG = "rand-m9-mstd0.5"


def _image(seed, hw=(37, 53)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    # a smooth ramp under the noise, so that the stretches and
    # histograms have a shape to work on
    ramp = np.linspace(40, 200, hw[1]).astype(np.uint8)
    return np.where(rng.random(hw)[..., None] < 0.5, img,
                    ramp[None, :, None]).astype(np.uint8)


def _label(seed, hw=(37, 53)):
    return np.random.default_rng(seed + 1).integers(
        0, 12, hw).astype(np.int32)


@pytest.mark.parametrize("name", sorted(jra.OPS))
def test_every_op_matches_jax(name):
    """prob 1, magnitude 9 with std 0.5 (the sampler's config), three
    seeds: the image and the warped label equal the JAX op's."""
    for seed in range(3):
        img, lab = _image(seed), _label(seed)
        op = ra.RandAugmentOp(name, prob=1.0, magnitude=9.0,
                              magnitude_std=0.5)
        jop = jra.RandAugmentOp(name, prob=1.0, magnitude=9.0,
                                magnitude_std=0.5)
        got = op(np.random.default_rng(seed), img, lab)
        want = jop(np.random.default_rng(seed), img, lab)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(op(np.random.default_rng(seed), img),
                                      jop(np.random.default_rng(seed), img))
        if name not in ra.GEOMETRIC_COEFFS:
            np.testing.assert_array_equal(got[1], lab)


def test_geometric_ops_fill_the_label():
    """A 20 % translation warps label pixels in from outside the frame:
    they become LABEL_FILL (255), in both packages."""
    lab = _label(0, (40, 50))
    op = ra.RandAugmentOp("TranslateXRel", prob=1.0, magnitude=10.0)
    _, out = op(np.random.default_rng(0), _image(0, (40, 50)), lab)
    assert ra.LABEL_FILL == jra.LABEL_FILL == 255
    # a 45 % shift: 22 or 23 whole columns, by the nearest rounding
    filled_cols = (out == 255).all(axis=0).sum()
    assert 22 <= filled_cols <= 23 and (out == 255).sum() == 40 * filled_cols
    assert set(np.unique(out)) <= set(range(12)) | {255}


@pytest.mark.parametrize("config,use_cmc", [
    (c, cmc) for c in ("rand-m9-mstd0.5", "rand-m9-n3-mstd0.5", "rand-m7-n1",
                       "rand-m9-mstd0.5-w0", "rand")
    for cmc in (False, True) if not (cmc and c.endswith("-w0"))])
def test_config_grammar_matches_jax(config, use_cmc):
    got = ra.rand_augment_transform(config, use_cmc=use_cmc)
    want = jra.rand_augment_transform(config, use_cmc=use_cmc)
    assert got.num_layers == want.num_layers
    assert [vars(o) for o in got.ops] == [vars(o) for o in want.ops]
    if want.choice_weights is None:
        assert got.choice_weights is None
    else:
        np.testing.assert_array_equal(got.choice_weights,
                                      want.choice_weights)
    for seed in range(4):
        img = _image(seed)
        np.testing.assert_array_equal(
            got(np.random.default_rng(seed), img),
            want(np.random.default_rng(seed), img))


@pytest.mark.parametrize("config,use_cmc,error", [
    ("auto-m9", False, ValueError), ("rand-x3", False, ValueError),
    ("rand-m9-w1", False, ValueError),
    # weight set 0 has no weight for the CMC menu's 'Identity'
    ("rand-m9-w0", True, KeyError)])
def test_config_errors_match_jax(config, use_cmc, error):
    for mod in (ra, jra):
        with pytest.raises(error):
            mod.rand_augment_transform(config, use_cmc=use_cmc)


def test_clip_augment_matches_jax_in_both_modes():
    clip = np.stack([_image(s) for s in range(4)])
    lab = _label(0)
    aug = ra.ClipRandAugment(ra.rand_augment_transform("rand-m9-n3-mstd0.5"))
    jaug = jra.ClipRandAugment(jra.rand_augment_transform(
        "rand-m9-n3-mstd0.5"))
    for seed in range(4):
        got = aug(np.random.default_rng(seed), clip, label=lab)
        want = jaug(np.random.default_rng(seed), clip, label=lab)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(
            aug(np.random.default_rng(seed), clip),
            jaug(np.random.default_rng(seed), clip))
    per_frame = ra.ClipRandAugment(aug.augment, per_frame=True)
    jper_frame = jra.ClipRandAugment(jaug.augment, per_frame=True)
    for seed in range(4):
        np.testing.assert_array_equal(
            per_frame(np.random.default_rng(seed), clip),
            jper_frame(np.random.default_rng(seed), clip))
    with pytest.raises(ValueError, match="per_frame"):
        per_frame(np.random.default_rng(0), clip, label=lab)


def test_augment_pickles_by_name():
    """`RandAugmentOp` holds the op's name, so the augment round-trips
    through pickle (the spawned loader workers) and augments alike."""
    aug = ra.ClipRandAugment(ra.rand_augment_transform(CONFIG))
    back = pickle.loads(pickle.dumps(aug))
    assert all(isinstance(o.name, str) for o in back.augment.ops)
    clip = np.stack([_image(s) for s in range(4)])
    np.testing.assert_array_equal(aug(np.random.default_rng(3), clip),
                                  back(np.random.default_rng(3), clip))


def _datasets(root):
    kw = dict(SMALL, sequences=EV_SEQS, rand_augment=CONFIG,
              frames_per_seq={s: EV_FRAMES for s in EV_SEQS})
    return (contrastive.ContrastiveClipDataset(root, "endovis18", **kw),
            jcontrastive.ContrastiveClipDataset(root, "endovis18", **kw))


def test_contrastive_sampler_with_rand_augment_matches_jax(endovis_tree):
    """The six augmented views, their warped labels and the crop boxes
    from the same `_seeded_rng` stream equal the JAX sampler's bit for
    bit; the augment changes the sample and fills some label pixels."""
    port, ref = _datasets(endovis_tree)
    plain = contrastive.ContrastiveClipDataset(
        endovis_tree, "endovis18", sequences=EV_SEQS,
        frames_per_seq={s: EV_FRAMES for s in EV_SEQS}, **SMALL)
    filled = 0
    for i in (0, 3, 12, 23, 39):
        got = port.get(i, loader._seeded_rng(5, 1, i))
        want = ref.get(i, jloader._seeded_rng(5, 1, i))
        _equal_samples(got, want)
        base = plain.get(i, loader._seeded_rng(5, 1, i))
        assert not np.array_equal(got["clips"], base["clips"])
        filled += int((got["labels"] == 255).sum())
    assert filled > 0


def test_loader_processes_match_threads(endovis_tree):
    """The loader pickles the augmenting dataset into spawned processes:
    their batches equal the threads' batches."""
    ds, _ = _datasets(endovis_tree)
    kw = dict(batch_size=4, seed=2, num_workers=2)
    threads = list(loader.Loader(ds, use_processes=False, **kw).epoch(0))[:2]
    procs = list(loader.Loader(ds, use_processes=True, **kw).epoch(0))[:2]
    assert len(threads) == len(procs) == 2
    for a, b in zip(threads, procs):
        _equal_samples(a, b)
