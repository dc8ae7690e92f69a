"""The sweep that chose each cell's lane count B: at each B, the cell's
step warmed up and then timed over a few steps, with its device busy
share and peak memory.

    python3 -m portbench.sweep --workload <name> --lanes 16 32 64 128 256 [--steps 6] [--frames 24]

Per B: host ms per step over `--steps` steps (one synchronize at the
end); then, over a second pass of as many steps under torch.profiler's
device tracing, its wall ms per step, the device busy ms per step (the raw
device events) and the busy share of that same pass; and
`torch.cuda.max_memory_allocated` over the warm-up and both passes, with
the scene bank's own bytes beside it. The scenes are the cell's traffic
cut to `--frames` frames, enough for the warm-up and both passes.
Runs on a CUDA card only; one JSON line per B on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from portbench import programs, scenes, spec
from portbench import trace as tr
from portbench.drivers import lockstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(cell, B: int, bank, warmup: int, steps: int, seed: int) -> dict:
    dev = bank.device
    api = programs.load("port")
    cfg, intr = programs.build(api, cell.config)
    step, init_fn = api.batched.make_batched_pipeline(cfg, intr, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.reset_peak_memory_stats(dev)
    states = init_fn(B, dev)
    t = time.perf_counter()
    for i in range(warmup):
        states, _ = step(states, lockstep.frame_inputs(api, bank, B, i))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(warmup, warmup + steps):
        states, _ = step(states, lockstep.frame_inputs(api, bank, B, i))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / steps
    prof = {}
    with tr.profiled(prof, tr.Spans()):
        for i in range(warmup + steps, warmup + 2 * steps):
            states, _ = step(states, lockstep.frame_inputs(api, bank, B, i))
    busy_ms = prof["busy_s"] * 1e3 / steps
    profiled_ms = prof["window_s"] * 1e3 / steps
    return {"lanes": B, "step_ms": step_ms, "frames_per_s": B * 1e3 / step_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / profiled_ms, "profiled_step_ms": profiled_ms,
            "warmup_s": warm_s, "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--lanes", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    t = time.perf_counter()
    bank = scenes.SceneBank(args.seed, cell.traffic, cell.config, "cuda", frames=args.frames)
    torch.cuda.synchronize()
    bank_bytes = torch.cuda.memory_allocated()
    print(f"{args.workload}: bank of {bank.S} x {bank.K} frames, {bank_bytes} B, {time.perf_counter() - t:.2f} s",
          file=sys.stderr, flush=True)
    for B in args.lanes:
        try:
            r = measure(cell, B, bank, args.warmup, args.steps, args.seed)
        except torch.cuda.OutOfMemoryError as e:
            r = {"lanes": B, "error": str(e).splitlines()[0]}
        r.update(workload=args.workload, bank_bytes=bank_bytes, device=torch.cuda.get_device_name(0))
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
