"""The port's data slice against the JAX package on the CPU: the clip
transforms, the CaDIS remapping, the six-view contrastive sampler (bit
for bit from the same seeded generator, on small EndoVis and CaDIS trees
of PNG frames written under tmp_path), the loader's order and batches
across shards, threads and processes, and the synthetic datasets."""

import numpy as np
import pytest
from PIL import Image

from stswincl_tpu.data import cadis as jcadis
from stswincl_tpu.data import contrastive as jcontrastive
from stswincl_tpu.data import loader as jloader
from stswincl_tpu.data import transforms as jT
from stswincl_tpu_torch.data import cadis, contrastive, loader
from stswincl_tpu_torch.data import transforms as T

EV_SEQS, EV_FRAMES = (1, 2, 3, 4, 5), 8
CADIS_VIDEOS = (1, 3, 4, 6)  # training videos
SMALL = dict(crop_hw=(32, 48), src_wh=(80, 64))


@pytest.fixture
def endovis_tree(tmp_path):
    root = tmp_path / "endovis"
    rng = np.random.default_rng(7)
    for s in EV_SEQS:
        imdir = root / "Processed_train" / f"seq_{s}" / "left_frames"
        lbdir = root / "Processed_train" / f"seq_{s}" / "labels"
        imdir.mkdir(parents=True)
        lbdir.mkdir(parents=True)
        for i in range(EV_FRAMES):
            img = rng.integers(0, 255, (72, 96, 3), dtype=np.uint8)
            Image.fromarray(img).save(imdir / f"frame{i:03d}.png")
            lab = rng.integers(0, 12, (72, 96), dtype=np.uint8)
            Image.fromarray(lab).save(lbdir / f"grayframe{i:03d}.png")
    return str(root)


@pytest.fixture
def cadis_tree(tmp_path):
    root = tmp_path / "cadis"
    rng = np.random.default_rng(3)
    for vid in CADIS_VIDEOS:
        imdir = root / f"Video{vid:02d}" / "Images"
        lbdir = root / f"Video{vid:02d}" / "Labels"
        imdir.mkdir(parents=True)
        lbdir.mkdir(parents=True)
        for i in range(6):
            img = rng.integers(0, 255, (54, 96, 3), dtype=np.uint8)
            Image.fromarray(img).save(imdir / f"frame{i:04d}.png")
            lab = rng.integers(0, 36, (54, 96), dtype=np.uint8)
            Image.fromarray(lab).save(lbdir / f"frame{i:04d}.png")
    return str(root)


def _equal_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("frame", [0, 1, 2, 3, 4, 7, 12])
def test_clip_indices_match_jax(frame):
    for t in (3, 4):
        assert contrastive.anchor_clip_indices(frame, t) == \
            jcontrastive.anchor_clip_indices(frame, t)
        assert contrastive.neg_clip_indices(frame, t) == \
            jcontrastive.neg_clip_indices(frame, t)


def test_contrastive_endovis_matches_jax_bitwise(endovis_tree):
    """Every sample (early frames' fallbacks included) from the same
    `_seeded_rng` stream equals the JAX package's, bit for bit."""
    kw = dict(SMALL, sequences=EV_SEQS,
              frames_per_seq={s: EV_FRAMES for s in EV_SEQS})
    port = contrastive.ContrastiveClipDataset(endovis_tree, "endovis18", **kw)
    ref = jcontrastive.ContrastiveClipDataset(endovis_tree, "endovis18",
                                              **kw)
    assert len(port) == len(ref) == len(EV_SEQS) * EV_FRAMES
    assert port.samples == ref.samples
    for i in (0, 1, 7, 12, 23, 39):
        got = port.get(i, loader._seeded_rng(5, 1, i))
        want = ref.get(i, jloader._seeded_rng(5, 1, i))
        assert got["clips"].shape == (6, 4, 32, 48, 3)
        _equal_samples(got, want)


@pytest.mark.parametrize("tag", ["1", "2", "3"])
def test_contrastive_cadis_matches_jax_bitwise(cadis_tree, tag):
    """CaDIS: frame counts found on disk, the labels remapped by the
    experiment's table, CenterNet normalisation."""
    port = contrastive.ContrastiveClipDataset(cadis_tree, "cadis", tag=tag,
                                              **SMALL)
    ref = jcontrastive.ContrastiveClipDataset(cadis_tree, "cadis", tag=tag,
                                              **SMALL)
    assert port.sequences == ref.sequences == CADIS_VIDEOS
    assert port.frames == ref.frames
    for i in (0, 5, 17):
        _equal_samples(port.get(i, np.random.default_rng(i)),
                       ref.get(i, np.random.default_rng(i)))


@pytest.mark.parametrize("tag", ["1", "2", "3"])
def test_remap_experiment_matches_jax(rng, tag):
    mask = rng.integers(0, 40, (37, 53)).astype(np.uint8)
    np.testing.assert_array_equal(cadis._remap_lut(tag),
                                  jcadis._remap_lut(tag))
    got = cadis.remap_experiment(mask, tag)
    np.testing.assert_array_equal(got, jcadis.remap_experiment(mask, tag))
    assert got.dtype == np.uint8


def _pil_clip(rng, n=3, hw=(45, 70)):
    imgs = [Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8))
            for _ in range(n)]
    mask = Image.fromarray(rng.integers(0, 12, hw, dtype=np.uint8))
    return imgs, mask


def _both(fn_port, fn_ref, seed, *args, **kw):
    """Call the port's and the JAX function on the same arguments, each
    with its own generator from `seed`."""
    return (fn_port(*args, rng=np.random.default_rng(seed), **kw),
            fn_ref(*args, rng=np.random.default_rng(seed), **kw))


def _assert_tree_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", range(4))
def test_transforms_match_jax(rng, seed):
    """Each transform (both branches of its coin over the seeds) draws and
    computes as the JAX one does."""
    imgs, mask = _pil_clip(rng)
    _assert_tree_equal(*_both(T.random_scale_pad_crop,
                              jT.random_scale_pad_crop, seed, imgs, mask,
                              48, 40, 56))
    _assert_tree_equal(*_both(T.resized_crop_clip, jT.resized_crop_clip,
                              seed, imgs, mask, 24, 40))
    _assert_tree_equal(*_both(T.random_resized_crop_params,
                              jT.random_resized_crop_params, seed, 70, 45))
    clip = np.stack([np.asarray(im) for im in imgs])
    m = np.asarray(mask)
    for name in ("vertical_flip", "horizontal_flip", "rotate"):
        _assert_tree_equal(*_both(getattr(T, name), getattr(jT, name), seed,
                                  clip, m))
    for name in ("brightness_contrast", "gaussian_noise"):
        _assert_tree_equal(*_both(getattr(T, name), getattr(jT, name), seed,
                                  clip))


def test_random_resized_crop_fallback_matches_jax():
    """The centre-crop fallback once the ten draws miss (an extreme
    aspect ratio)."""
    for seed in range(3):
        _assert_tree_equal(*_both(T.random_resized_crop_params,
                                  jT.random_resized_crop_params, seed, 400,
                                  3))


def _batches(mod, ds, **kw):
    return list(mod.Loader(ds, **kw).epoch(2))


@pytest.mark.parametrize("use_processes", [False, True])
def test_loader_matches_jax(use_processes):
    """The same batches in the same order as the JAX loader, whole and
    split over 2 shards, on threads or processes."""
    kw = dict(length=10, t=2, hw=(32, 32), num_classes=5)
    ds, jds = loader.SyntheticSegDataset(**kw), jloader.SyntheticSegDataset(**kw)
    for shards in (1, 2):
        for shard in range(shards):
            common = dict(batch_size=4, seed=1, num_workers=2,
                          shard_index=shard, num_shards=shards)
            got = _batches(loader, ds, use_processes=use_processes, **common)
            want = _batches(jloader, jds, **common)
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                _equal_samples(a, b)
                assert a["image"].shape[0] == 4 // shards


def test_loader_shards_partition_the_batch():
    ds = loader.SyntheticSegDataset(length=16, t=2, hw=(32, 32),
                                    num_classes=5)
    whole = _batches(loader, ds, batch_size=4, seed=1)
    parts = [_batches(loader, ds, batch_size=4, seed=1, shard_index=i,
                      num_shards=2) for i in range(2)]
    for k, b in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][k]["image"], parts[1][k]["image"]]),
            b["image"])
    with pytest.raises(ValueError):
        loader.Loader(ds, batch_size=3, num_shards=2)
    assert loader.Loader(ds, batch_size=3, drop_last=False).steps_per_epoch() \
        == jloader.Loader(ds, batch_size=3, drop_last=False).steps_per_epoch()


def test_loader_surfaces_worker_errors():
    class Broken(loader.SyntheticSegDataset):
        def get(self, index, rng=None):
            raise RuntimeError(f"sample {index}")
    with pytest.raises(RuntimeError, match="sample"):
        _batches(loader, Broken(length=8, hw=(16, 16)), batch_size=4)


@pytest.mark.parametrize("kind", ["SyntheticSegDataset",
                                  "SyntheticContrastDataset"])
def test_synthetic_datasets_match_jax(kind):
    kw = dict(length=6, t=4, hw=(48, 64), num_classes=5)
    port, ref = getattr(loader, kind)(**kw), getattr(jloader, kind)(**kw)
    assert len(port) == len(ref)
    for i in (0, 5):
        _equal_samples(port.get(i), ref.get(i))
