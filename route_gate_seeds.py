#!/usr/bin/env python3
"""Phases 4, 4d and 4e of `chip_smoke.py` with the batch of phases 4d and
4e drawn from each seed given, or with `--contrast` phase 8 (a) (the
stage-2 step's gates) on the batch of each seed: where the train-route
gates (the absolute gradient-cosine floor and the 1 - cosine against a
control route) sit, batch by batch, so that a gate reading can be told
from the noise of its batch. Each failed check is printed and counted,
not raised.

    python3 route_gate_seeds.py 4 1 2 5
    python3 route_gate_seeds.py --contrast 1 2 3

Seed 3 stays phase 4's batch; `chip_smoke.ROUTE_TRAIN_SEED` (4) is the
batch phases 4d and 4e use. It runs the `stswincl_tpu_torch` package and
`chip_smoke.py` that lie beside it: to read another checkout, run a copy
of both files placed there. Needs a CUDA card; prints the card's name and
power limit first. Exits 1 if any check failed.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    contrast = "--contrast" in args
    seeds = [int(s) for s in args if s != "--contrast"]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("route_gate_seeds: needs a CUDA card")
    from stswincl_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    kernels.build()
    kernels.load()
    failed = {}
    dev = torch.device("cuda", 0)
    for seed in seeds:
        before = len(chip_smoke.FAILED)
        if contrast:
            print(f"==== seed {seed} (phase 8 (a))", flush=True)
            chip_smoke.contrast_gates(dev, torch.bfloat16, seed)
        else:
            print(f"==== seed {seed} (phases 4d and 4e)", flush=True)
            chip_smoke.phase_train(dev, torch.bfloat16, "",
                                   chip_smoke.kernel_wrappers(),
                                   chip_smoke.ROUTE_KERNEL, {},
                                   route_seed=seed)
        failed[seed] = chip_smoke.FAILED[before:]
    print(f"failed checks by seed: {failed}", flush=True)
    return 1 if chip_smoke.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
