"""Stage hand-offs, checkpoints and the stage-2 entry point of the port on
the CPU: `translate_seg_to_pretrain` / `translate_pretrain_to_seg` on port
`state_dict`s against the JAX functions on the same trees (the merged
values and the skipped entries), the checkpoint round trip, and
`run_contrast_pretraining` on the synthetic contrast set at a small size:
two steps, a checkpoint, `resume` picking it up, the warm start, and the
card required unless the CPU is asked for."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from stswincl_tpu.ckpt import checkpoint as jckpt  # noqa: E402
from stswincl_tpu_torch.ckpt import (SEG_ENCODER_SUBTREES, jax_path,  # noqa: E402
                                     latest_step, load_checkpoint,
                                     save_checkpoint, to_jax_layout,
                                     translate_pretrain_to_seg,
                                     translate_seg_to_pretrain)
from stswincl_tpu_torch.configs import (ContrastTrainConfig, DataConfig,  # noqa: E402
                                        ModelConfig, to_json)
from stswincl_tpu_torch.models import ContrastEncoder, TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.pipelines.contrast import run_contrast_pretraining  # noqa: E402

torch.set_num_threads(2)
HW, NC = (128, 128), 5


def _seg(depths=(2, 3), seed=0, heads=4):
    return init_weights(TswinPlus(NC, swin_dim=64, swin_depths=depths,
                                  num_heads=heads, input_hw=HW),
                        torch.Generator().manual_seed(seed))


def _enc(seed=1, heads=4):
    return init_weights(ContrastEncoder(NC, swin_dim=64, swin_depths=(2, 2),
                                        num_heads=heads, input_hw=HW),
                        torch.Generator().manual_seed(seed))


def _trees(sd):
    """A port state_dict as JAX collections {"params", "batch_stats"}."""
    tree = {"params": {}, "batch_stats": {}}
    for name, t in sd.items():
        coll, path = jax_path(name, t.dim())
        node = tree[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = to_jax_layout(name, t.numpy())
    return tree


def _jax_name(entry, ranks):
    """'a.b.weight (why)' -> 'a/b/kernel (why)' through the reverse map; a
    module 'a.b (why)' -> 'a/b (why)'."""
    name, why = entry.split(" ", 1)
    if name not in ranks:
        return name.replace(".", "/") + " " + why
    return "/".join(jax_path(name, ranks[name])[1]) + " " + why


@pytest.mark.parametrize("direction", ["seg_to_pretrain", "pretrain_to_seg"])
def test_translation_matches_jax(direction):
    """The segmentation model has a third stage-2 layer (missing in the
    encoder) and, at stage 1, 2 heads where the encoder has 4 (relative
    tables of another shape): both are skipped, the rest copied, the
    classifier left out, exactly as the JAX functions do collection by
    collection."""
    seg = _seg().state_dict()
    seg.update({k: v for k, v in _seg(heads=2).state_dict().items()
                if ".layers_0_" in k and "relative_position" in k})
    enc = _enc().state_dict()
    if direction == "seg_to_pretrain":
        got, skipped = translate_seg_to_pretrain(seg, enc)
        src, dst, fn = seg, enc, jckpt.translate_seg_to_pretrain
    else:
        got, skipped = translate_pretrain_to_seg(enc, seg)
        src, dst, fn = enc, seg, jckpt.translate_pretrain_to_seg
    assert set(got) == set(dst)
    jsrc, jdst = _trees(src), _trees(dst)
    want_skipped = []
    for coll in ("params", "batch_stats"):
        merged, sk = fn(jsrc[coll], jdst[coll])
        want_skipped += sk
        for name, t in got.items():
            c, path = jax_path(name, t.dim())
            if c != coll:
                continue
            leaf = merged
            for k in path:
                leaf = leaf[k]
            np.testing.assert_array_equal(to_jax_layout(name, t.numpy()),
                                          np.asarray(leaf), err_msg=name)
    ranks = {k: v.dim() for k, v in list(src.items()) + [
        (("segmentor." + k) if direction == "seg_to_pretrain" else
         k.split(".", 1)[1], v) for k, v in src.items()]}
    assert sorted(_jax_name(s, ranks) for s in skipped) == sorted(
        want_skipped)
    assert any("missing in target" in s for s in skipped) == (
        direction == "seg_to_pretrain")
    assert any("shape mismatch" in s for s in skipped)
    assert not any("classifier" in s for s in skipped)
    assert {k.split(".")[1] for k in got if k.startswith("segmentor.")} <= \
        set(SEG_ENCODER_SUBTREES)


def test_checkpoint_round_trip(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d)
    state = {"model": _enc().state_dict(), "step": 3,
             "opt": {"count": 3, "lrs": [0.1, 0.2]}}
    save_checkpoint(d, 3, state)
    save_checkpoint(d, 12, dict(state, step=12))
    assert latest_step(d) == 12
    assert sorted(os.listdir(d)) == ["step_12.pt", "step_3.pt"]
    back = load_checkpoint(d, step=3)
    assert back["step"] == 3 and back["opt"] == state["opt"]
    for k, v in state["model"].items():
        assert torch.equal(back["model"][k], v), k
    assert load_checkpoint(d)["step"] == 12


def _cfg(tmp_path, **kw):
    return ContrastTrainConfig(
        data=DataConfig(dataset="synthetic", crop_hw=HW, batch_size=16,
                        num_classes=NC, num_workers=2),
        model=ModelConfig(num_classes=NC, swin_dim=64, swin_depths=(2, 2),
                          dtype="float32"),
        num_epochs=1, ckpt_dir=str(tmp_path / "ckpt"),
        log_dir=str(tmp_path / "log"), **kw)


def test_run_contrast_pretraining_and_resume(tmp_path):
    """One epoch of the synthetic set (32 samples, batch 16: 2 steps) on
    the CPU: finite losses logged, a checkpoint equal to the state, then
    `resume` with one more epoch continues from it (steps 3-4)."""
    cfg = _cfg(tmp_path)
    state = run_contrast_pretraining(cfg, device="cpu")
    assert state.step == 2 and state.opt.count == 2
    assert latest_step(cfg.ckpt_dir) == 2
    saved = load_checkpoint(cfg.ckpt_dir)
    for k, v in state.query.state_dict().items():
        assert torch.equal(saved["query"][k], v), k
    for k, v in state.key.state_dict().items():
        assert torch.equal(saved["key"][k], v), k
    with open(os.path.join(cfg.log_dir, "config.json")) as f:
        assert f.read() == to_json(cfg)
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        rec = json.loads(f.readlines()[-1])
    assert rec["step"] == 2 and np.isfinite(rec["pretrain/loss"])
    q = dict(state.query.named_parameters())
    k = dict(state.key.named_parameters())
    assert any(not torch.equal(q[n], k[n]) for n in q)

    cfg2 = _cfg(tmp_path, resume=True)
    cfg2.num_epochs = 2
    resumed = run_contrast_pretraining(cfg2, device="cpu")
    assert resumed.step == 4 and resumed.opt.count == 4
    assert latest_step(cfg.ckpt_dir) == 4


def test_warm_start_from_a_segmentation_checkpoint(tmp_path):
    """`init_checkpoint`: the encoder subtrees of a stage-1 model's state
    initialise both branches' segmentor; no step runs at 0 epochs."""
    seg = _seg(depths=(2, 2))
    save_checkpoint(str(tmp_path / "seg"), 7, {"model": seg.state_dict()})
    cfg = _cfg(tmp_path, init_checkpoint=str(tmp_path / "seg"))
    cfg.num_epochs = 0
    state = run_contrast_pretraining(cfg, device="cpu")
    assert state.step == 0
    for branch in (state.query, state.key):
        sd = branch.state_dict()
        for name, t in seg.state_dict().items():
            if name.split(".")[0] in SEG_ENCODER_SUBTREES:
                assert torch.equal(sd["segmentor." + name], t), name


def test_run_contrast_pretraining_needs_the_card_unless_asked_for_the_cpu(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_contrast_pretraining(_cfg(tmp_path))
