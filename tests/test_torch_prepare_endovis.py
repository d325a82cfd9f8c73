"""The port's raw EndoVis18 converter
(`python -m stswincl_tpu_torch.data.prepare_endovis`) against the JAX
package's on a small raw tree under `tmp_path` (2 train sequences of
2 frames and a test sequence, 256x320 RGB frames and colour labels with a
`labels.json`, plus files the converter skips): the processed trees equal
byte for byte through `main()`, for the train and the test split, and
`decode_color_label` / `prepare_sequence` equal the JAX functions. The
processed train tree is what `EndovisDataset` reads."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from stswincl_tpu.data import prepare_endovis as jprep
from stswincl_tpu_torch.data import prepare_endovis as prep
from stswincl_tpu_torch.data.endovis18 import EndovisDataset

COLORS = [[i * 20, 255 - i * 10, i * 5] for i in range(12)]
HW = (256, 320)


@pytest.fixture
def raw(tmp_path):
    src = tmp_path / "raw"
    (src / "train").mkdir(parents=True)
    with open(src / "train" / "labels.json", "w") as f:
        json.dump([{"name": f"c{i}", "color": c, "classid": i}
                   for i, c in enumerate(COLORS)], f)
    rng = np.random.default_rng(0)
    for split, seqs in (("train", (1, 2)), ("test", (3,))):
        for s in seqs:
            seq = src / split / f"seq_{s}"
            (seq / "left_frames").mkdir(parents=True)
            (seq / "labels").mkdir(parents=True)
            for i in range(2):
                img = rng.integers(0, 256, (*HW, 3), dtype=np.uint8)
                Image.fromarray(img).save(
                    seq / "left_frames" / f"frame{i:03d}.png")
                ids = np.kron(rng.integers(0, 12, (HW[0] // 16, HW[1] // 16)),
                              np.ones((16, 16), np.int64))
                rgb = np.array(COLORS, np.uint8)[ids]
                rgb[:3, :3] = 7  # colours outside the table decode to 0
                Image.fromarray(rgb).save(seq / "labels" / f"frame{i:03d}.png")
            # skipped: not a frame, not a sequence
            Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
                seq / "left_frames" / "thumb.png")
        (src / split / "notes").mkdir()
    return src


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("split", ["train", "test"])
def test_main_matches_jax_byte_for_byte(raw, tmp_path, split, capsys):
    port_dst, jax_dst = tmp_path / "port", tmp_path / "jax"
    prep.main(["--src", str(raw), "--dst", str(port_dst), "--split", split])
    port_out = capsys.readouterr().out
    jprep.main(["--src", str(raw), "--dst", str(jax_dst), "--split", split])
    assert capsys.readouterr().out == port_out
    got, want = _tree(port_dst), _tree(jax_dst)
    assert sorted(got) == sorted(want) and len(got) > 0
    for k in want:
        assert got[k] == want[k], k
    sub = "Processed_train" if split == "train" else "Processed_test"
    img = Image.open(port_dst / sub / f"seq_{1 if split == 'train' else 3}"
                     / "left_frames" / "frame000.png")
    assert img.size == (640, 512)
    labels = [k for k in got if "/labels/" in k]
    assert len(labels) == (4 if split == "train" else 0)


def test_functions_match_jax(raw, tmp_path):
    rgb = np.asarray(Image.open(raw / "train" / "seq_1" / "labels"
                                / "frame000.png"))
    table = np.array(COLORS)
    got = prep.decode_color_label(rgb, table)
    np.testing.assert_array_equal(got, jprep.decode_color_label(rgb, table))
    assert got.dtype == np.uint8 and got[:3, :3].max() == 0
    assert got.max() <= 11
    prep.prepare_sequence(str(raw / "train" / "seq_2"), str(tmp_path / "p"),
                          table, make_gray_labels=False)
    jprep.prepare_sequence(str(raw / "train" / "seq_2"), str(tmp_path / "j"),
                           table, make_gray_labels=False)
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


def test_endovis_dataset_reads_the_processed_tree(raw, tmp_path):
    dst = tmp_path / "processed"
    prep.main(["--src", str(raw), "--dst", str(dst), "--split", "train"])
    ds = EndovisDataset(str(dst), "train", t=1, crop_hw=(128, 160),
                        sequences=(1, 2), frames_per_seq={1: 2, 2: 2})
    assert len(ds) == 4
    sample = ds.get(0, np.random.default_rng(0))
    assert sample["image"].shape == (1, 128, 160, 3)
    assert sample["label"].shape == (128, 160)
    assert sample["label"].max() < 12
