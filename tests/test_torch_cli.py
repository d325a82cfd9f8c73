"""The port's CLI (`python -m stswincl_tpu_torch.cli`) against the JAX
package's: for the same argv both print the same config JSON, the
`finetune-cl` stage-3 defaults rule and its override cases
(`tests/test_prepare_and_cli.py:42-80`) included; then `train-seg`,
`finetune-cl` (warm-started from the first run) and `test` run on the
synthetic set with `--device cpu` at a small size, and without a card
`--device cuda` (the default) raises."""

import json

import pytest

from stswincl_tpu import cli as jcli
from stswincl_tpu.pipelines import contrast as jcontrast
from stswincl_tpu.pipelines import evaluate as jevaluate
from stswincl_tpu.pipelines import seg as jseg
from stswincl_tpu_torch import cli
from stswincl_tpu_torch.ckpt import latest_step, load_checkpoint
from stswincl_tpu_torch.pipelines import contrast, evaluate, seg

CASES = [
    ["train-seg", "data.dataset=synthetic", "lr=0.01"],
    ["finetune-cl", "data.dataset=synthetic"],
    ["finetune-cl", "lr=0.005"],
    ["finetune-cl", "lr_scheduler=cos"],  # 'lr' prefix: no defaults
    ["finetune-cl", "optimizer=adam"],
    ["finetune-cl", "num_epochs=3", "data.batch_size=4"],
    ["finetune-cl", "momentum=0.5"],
    ["pretrain-contrast", "base_lr=0.5", "data.crop_hw=(128,192)"],
    ["test", "streaming_eval=true", "model.swin_depths=(2,2)"],
    # the options of examples/endovis18_full_pipeline.sh
    ["train-seg", "model.arch=puredeeplab18", "data.t=1"],
    ["train-seg", "model.remat=true", "init_checkpoint=/ckpt/deeplab/best"],
    ["finetune-cl", "model.remat=true"],
    ["pretrain-contrast", "data.dataset=endovis18",
     "data.rand_augment=rand-m9-mstd0.5"],
]
SMALL = ["data.dataset=synthetic", "model.swin_dim=64",
         "model.swin_depths=(1,1)", "data.crop_hw=(64,128)",
         "eval_hw=(64,128)", "data.num_classes=5", "model.num_classes=5",
         "model.dtype=float32", "data.batch_size=8", "num_epochs=1"]


def _printed_config(capsys, main, argv):
    main(argv)
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


def _no_runs(monkeypatch):
    """Every pipeline of both packages replaced by one that records its
    config."""
    ran = []
    for mod, name in ((jseg, "run_seg_training"), (seg, "run_seg_training"),
                      (jcontrast, "run_contrast_pretraining"),
                      (contrast, "run_contrast_pretraining"),
                      (jevaluate, "run_test"), (evaluate, "run_test")):
        monkeypatch.setattr(mod, name,
                            lambda cfg, *a, **k: ran.append((cfg, k)))
    return ran


@pytest.mark.parametrize("argv", CASES, ids=[" ".join(c) for c in CASES])
def test_cli_prints_the_jax_config(capsys, monkeypatch, argv):
    ran = _no_runs(monkeypatch)
    want = _printed_config(capsys, jcli.main, argv)
    got = _printed_config(capsys, cli.main, argv + ["--device", "cpu"])
    assert got == want
    assert len(ran) == 2 and ran[1][1] == {"device": "cpu"}
    if argv[:2] == ["finetune-cl", "data.dataset=synthetic"]:
        assert (got["optimizer"], got["lr"], got["lr_scheduler"],
                got["num_epochs"]) == ("sgd", 1e-3, "poly", 200)


def test_cli_config_file_turns_the_defaults_off(capsys, monkeypatch,
                                                tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"lr": 0.02, "data": {"t": 3}}))
    _no_runs(monkeypatch)
    argv = ["finetune-cl", "--config", str(path), "model.num_heads=2"]
    got = _printed_config(capsys, cli.main, argv)
    assert got == _printed_config(capsys, jcli.main, argv)
    assert got["optimizer"] == "adam" and got["lr"] == 0.02


def test_cli_runs_the_three_seg_commands_on_the_cpu(capsys, tmp_path):
    stage1, stage3 = str(tmp_path / "s1"), str(tmp_path / "s3")
    cli.main(["train-seg", "--device", "cpu", *SMALL, f"ckpt_dir={stage1}",
              f"log_dir={tmp_path}/l1"])
    assert latest_step(stage1) == 8
    cli.main(["finetune-cl", "--device", "cpu", *SMALL, "optimizer=sgd",
              "lr=0.001", "lr_scheduler=poly", f"init_checkpoint={stage1}",
              f"ckpt_dir={stage3}", f"log_dir={tmp_path}/l3"])
    opt = load_checkpoint(stage3)["opt"]
    assert [g["lr_mult"] for g in opt["param_groups"]] == [1.0, 1.0]
    assert "momentum_buffer" in next(iter(opt["state"].values()))
    capsys.readouterr()
    summary = cli.main(["test", "--device", "cpu", *SMALL,
                        f"test_checkpoint={stage3}", "streaming_eval=true",
                        f"log_dir={tmp_path}/lt"])
    assert summary["frames"] == 8 and summary["streamed_frames"] == 7
    assert "'dice'" in capsys.readouterr().out


def test_cli_defaults_to_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["test", *SMALL, f"log_dir={tmp_path}/l"])
