"""Command-line entry points of the port, the twin of `stswincl_tpu/cli.py`.

  python -m stswincl_tpu_torch.cli train-seg         (stage 1: train_swin.py
                                                      / train_cata_swin.py)
  python -m stswincl_tpu_torch.cli pretrain-contrast (stage 2:
                                                      main_pretrain_swinv5.py)
  python -m stswincl_tpu_torch.cli finetune-cl       (stage 3:
                                                      train_CL_ft_mswin_sgd_minput.py)
  python -m stswincl_tpu_torch.cli test              (test.py / cata_test.py)

The config comes from an optional JSON file (`--config`) and `key=value`
overrides, as in the JAX package. `--device` (default `cuda`) picks where
the command runs: without a card, `cuda` raises; `--device cpu` runs on
the CPU (the kernels' plain twins). It is an argument, not a config
field, so the configs stay equal to the JAX package's.

Data parallel: `torchrun --nproc_per_node=W -m stswincl_tpu_torch.cli
train-seg ...` (or `finetune-cl`, `pretrain-contrast`) starts W ranks
that join one process group (NCCL with `--device cuda`, each rank on
`cuda:LOCAL_RANK`; gloo with `--device cpu`), take the global-batch step
and leave the group on exit. `test` runs in one process: under a launcher
with `WORLD_SIZE > 1` it raises.
"""

from __future__ import annotations

import argparse
import os

from stswincl_tpu_torch.configs import (ContrastTrainConfig, SegTrainConfig,
                                        apply_overrides, load_config, to_json)
from stswincl_tpu_torch.parallel import distributed as pdist


def main(argv=None):
    parser = argparse.ArgumentParser(prog="stswincl_tpu_torch")
    parser.add_argument("command", choices=[
        "train-seg", "pretrain-contrast", "finetune-cl", "test"])
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda or cpu)")
    parser.add_argument("overrides", nargs="*",
                        help="key=value config overrides (e.g. data.root=/x)")
    args = parser.parse_intermixed_args(argv)

    if args.command in ("train-seg", "finetune-cl", "test"):
        cfg = (load_config(SegTrainConfig, args.config)
               if args.config else SegTrainConfig())
    else:
        cfg = (load_config(ContrastTrainConfig, args.config)
               if args.config else ContrastTrainConfig())
    cfg = apply_overrides(cfg, args.overrides)

    if args.command == "finetune-cl":
        # stage-3 defaults where not overridden: SGD, poly 1e-3, 200 epochs
        if not args.config and not any(
                o.startswith(("optimizer", "lr", "num_epochs"))
                for o in args.overrides):
            cfg.optimizer, cfg.lr = "sgd", 1e-3
            cfg.lr_scheduler, cfg.num_epochs = "poly", 200

    print(to_json(cfg))  # on every rank, as the JAX CLI on every process
    if args.command == "test":
        if pdist.launched() and int(os.environ["WORLD_SIZE"]) > 1:
            raise SystemExit("stswincl_tpu_torch test runs in one process; "
                             f"it was started as {os.environ['WORLD_SIZE']} "
                             "ranks (run it without torchrun)")
        from stswincl_tpu_torch.pipelines.evaluate import run_test
        return run_test(cfg, device=args.device)

    # the pipelines join torchrun's group; leave it on the way out
    try:
        if args.command in ("train-seg", "finetune-cl"):
            from stswincl_tpu_torch.pipelines.seg import run_seg_training
            return run_seg_training(cfg, device=args.device)
        from stswincl_tpu_torch.pipelines.contrast import \
            run_contrast_pretraining
        return run_contrast_pretraining(cfg, device=args.device)
    finally:
        if pdist.launched():
            pdist.shutdown()

if __name__ == "__main__":
    main()
