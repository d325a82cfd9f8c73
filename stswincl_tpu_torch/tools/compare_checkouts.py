"""One phase of `chip_smoke.py` on two checkouts in one call, in turns
(other / this / this / other), so that two versions of the kernels are
compared on one card.

    python3 -m stswincl_tpu_torch.tools.compare_checkouts runs/parent \
        [--phase phase_fp32_attn_bwd | --script <path>] \
        [--out runs/compare.json]

`other` is the root of another checkout (for a parent commit: `git
archive <commit> | tar -x -C runs/parent`, a directory `.gitignore`
lists). Each turn runs in a process of its own rooted there: it builds
that checkout's kernels (its own `_build`) and calls its
`chip_smoke.<phase>(dev, results, median_ms)`, a phase 7 (a) function
(`phase_fp32_attn_bwd`, `phase_fp32_train_kernels`, `phase_fp32_kernels`,
...), with `median_ms` the CUDA-event median of single calls after two
warm-up calls, as `chip_smoke.main`'s. With `--script`, each turn instead runs that
script of this checkout (`python3 <path> --out <json>`) in a process
rooted at the turn's checkout, with it first on PYTHONPATH, so that one
script times both versions (`tools/profile_bwd_bf16.py`, whose output
has the same shape). Prints each turn's output, then each row's `ms`
(and `device_ms` and `k5_ms`, where the rows carry them) by turn and,
where a row carries `sha` (a digest of its outputs:
`tools/kernel_bits.py`), whether every turn's is the same (a row whose
digests differ fails the run); writes every turn's rows to `--out`. Prints the card's name and
power limit first. Needs a CUDA card; exits 1 if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

TURN = r"""
import json, os, statistics, sys
root, phase, out = sys.argv[1:4]
sys.path.insert(0, root)
os.chdir(root)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from stswincl_tpu_torch import kernels
import chip_smoke
kernels.build()
kernels.load()


def median_ms(fn, reps=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


results = {}
getattr(chip_smoke, phase)(torch.device("cuda", 0), results, median_ms)
with open(out, "w") as f:
    json.dump({"results": results, "failed": chip_smoke.FAILED}, f,
              default=str)
sys.exit(1 if chip_smoke.FAILED else 0)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the root of the other checkout")
    ap.add_argument("--phase", default="phase_fp32_attn_bwd")
    ap.add_argument("--script", default=None,
                    help="a script of this checkout to run in each turn "
                    "in place of a chip_smoke phase")
    ap.add_argument("--out", default="runs/compare_checkouts.json")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(args.other)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    turns, failed = [], False
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, root) in enumerate((("other", other), ("this", here),
                                         ("this", here), ("other", other))):
            path = os.path.join(tmp, f"turn{i}.json")
            print(f"==== turn {i}: {tag} ({root})", flush=True)
            if args.script:
                env = dict(os.environ, PYTHONPATH=root)
                rc = subprocess.run([sys.executable,
                                     os.path.abspath(args.script), "--out",
                                     path], cwd=root, env=env).returncode
            else:
                rc = subprocess.run([sys.executable, "-c", TURN, root,
                                     args.phase, path]).returncode
            failed |= rc != 0
            if not os.path.exists(path):
                turns.append((tag, {"results": {}, "failed": [
                    f"the turn exited {rc} without its results"]}))
                continue
            with open(path) as f:
                turns.append((tag, json.load(f)))
    print("ms by turn (" + " / ".join(t for t, _ in turns) + "):", flush=True)
    for kname, rows in turns[1][1]["results"].items():
        for j, row in enumerate(rows):
            for key in ("ms", "device_ms", "k5_ms"):
                if key not in row:
                    continue
                vals = []
                for _, t in turns:
                    r = t["results"].get(kname, [])
                    vals.append(r[j].get(key) if j < len(r) else None)
                print(f"  {kname} {row['case']} {key}: " + " / ".join(
                    "-" if v is None else f"{v:.4f}" for v in vals),
                    flush=True)
            if "sha" in row:
                shas = {(t["results"].get(kname, [])[j:j + 1] or [{}])[0]
                        .get("sha") for _, t in turns}
                failed |= len(shas) != 1
                print(f"  {kname} {row['case']} outputs bit-equal in every "
                      f"turn: {len(shas) == 1}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump([{"turn": tag, **t} for tag, t in turns], f, default=str)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
