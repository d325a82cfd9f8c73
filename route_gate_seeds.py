#!/usr/bin/env python3
"""Phases 4, 4d and 4e of `chip_smoke.py` with the batch of phases 4d and
4e drawn from each seed given, or with `--contrast` phase 8 (a) (the
stage-2 step's gates) on the batch of each seed, or with
`--fp32-parallel` phase 11 (e)'s sound step (two fp32 gloo ranks on the
card against the one-process fp32 step, its bounds set by the controls
of `chip_smoke.p11_one_process`: the input perturbed at 2^-20 and 2^-23
and the batch in reverse order) on the batch `p11_seg_batch(seed)`:
where the gates sit, batch by batch, so that a gate reading can be told
from the noise of its batch. Each failed check is printed and counted,
not raised; `--fp32-parallel` ends with a line a seed: the worst gate
and the gradient it reads, the worst norm gate, whether the ranks part.

    python3 route_gate_seeds.py 4 1 2 5
    python3 route_gate_seeds.py --contrast 1 2 3
    python3 route_gate_seeds.py --fp32-parallel 1 2 3 4 5 6 7 8 9 10

Seed 3 stays phase 4's batch (and phase 11's: `chip_smoke.P11_SEG_SEED`);
`chip_smoke.ROUTE_TRAIN_SEED` (4) is the batch phases 4d and 4e use. It
runs the `stswincl_tpu_torch` package and
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
    parallel = "--fp32-parallel" in args
    seeds = [int(s) for s in args if not s.startswith("--")]
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
    failed, read = {}, {}
    dev = torch.device("cuda", 0)
    for seed in seeds:
        before = len(chip_smoke.FAILED)
        if parallel:
            print(f"==== seed {seed} (phase 11 (e), the sound step)",
                  flush=True)
            read[seed] = fp32_parallel(dev, seed)
        elif contrast:
            print(f"==== seed {seed} (phase 8 (a))", flush=True)
            chip_smoke.contrast_gates(dev, torch.bfloat16, seed)
        else:
            print(f"==== seed {seed} (phases 4d and 4e)", flush=True)
            chip_smoke.phase_train(dev, torch.bfloat16, "",
                                   chip_smoke.kernel_wrappers(),
                                   chip_smoke.ROUTE_KERNEL, {},
                                   route_seed=seed)
        failed[seed] = chip_smoke.FAILED[before:]
    for seed, r in read.items():
        print(f"(11e) seed {seed}: worst gate {r['worst'][1]:.4f} "
              f"({r['worst'][0]}), worst norm gate {r['worst_norm'][1]:.4f} "
              f"({r['worst_norm'][0]}), ranks part by {r['parted']}, "
              f"{'passes' if not failed[seed] else 'fails'}", flush=True)
    print(f"failed checks by seed: {failed}", flush=True)
    return 1 if chip_smoke.FAILED else 0


def fp32_parallel(dev, seed: int) -> dict:
    """Phase 11 (e)'s sound step on the batch of `seed`: the one-process
    fp32 step and its controls, then two gloo ranks on the card, held by
    `chip_smoke.p11_hold` as phase 11 holds them. Returns its reading."""
    import tempfile

    import torch
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        runs, zero_grad = chip_smoke.p11_one_process(
            "seg_fp32", dev, torch.float32, seed=seed)
        torch.cuda.empty_cache()
        outs = chip_smoke.p11_spawn("seg_fp32", tmp, seed=seed,
                                    only=("sound",))
        read = chip_smoke.p11_hold("seg_fp32", outs, tmp, runs, zero_grad,
                                   ("sound",), label=f" seed {seed}")
    del runs
    torch.cuda.empty_cache()
    return read["sound"]


if __name__ == "__main__":
    sys.exit(main())
