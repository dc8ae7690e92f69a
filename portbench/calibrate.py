"""The readings each correctness limit is set from: the compared numbers of
sound runs of the program over many seeds, or of the control, all in one
process (the set-up's imports and first CUDA calls paid once).

    python3 -m portbench.calibrate --workload <name> --seconds <s> --seeds <n> [<n> ...] [--control]

The control is the plain reference put in the program's place (the frozen
step at the cell's own B) with TF32 matrix products, the nearest precision
below the float32 the configuration states; the numbers then say how far
that lower precision lies from the float32 reference. One JSON line per
seed on standard output: the numbers, `correct` under the committed limits,
steps and lanes. A control whose step raises (TF32 can break the window's
factorisation) is read over the steps before it. Runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        r = run.run_cell(run.ROOT, args.workload, seed, args.seconds, 0, t_start=t, control=args.control)
        line = {"workload": args.workload, "seed": seed, "control": args.control, "numbers": r["numbers"],
                "correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
                "frames_per_s": r["metrics"]["frames_per_s"]["value"], "run_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
