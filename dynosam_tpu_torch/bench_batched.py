"""Multi-sequence batched throughput on one card (the port of
scripts/bench_batched.py).

B sequences step as one program (`parallel/batched.py::
make_batched_pipeline`: every operation once for the whole batch, K1 once
per frame for all B images through its `blockIdx.z`), the same program
`multichip.py` splits over ranks. Each batched frame broadcasts one of the
8 bench frames to all B sequences. Measured at B in {1, 4, 8}: aggregate
and per-sequence frames/s over `-n` steps after `--warmup` (the first
timed apart), one synchronize at the end of the timed loop. There is no
MFU column: the reference's peak is a TPU's, and the system runs no model.

Splices its section into `--out` (default dynosam_tpu_torch/BENCH_TABLE.md)
between the batched markers.

Usage: python -m dynosam_tpu_torch.bench_batched [--out PATH]
       [--batches 1 4 8] [--warmup 5] [-n 20] [--device cuda|cpu] [--small]
       [--seed 0]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from dynosam_tpu_torch import bench as B
from dynosam_tpu_torch import timing
from dynosam_tpu_torch.bench_table import BB_BEGIN, BB_END, DEFAULT_OUT, splice

WARMUP = 5
MEASURE = 20


def batch_frames(frames, batch: int):
    """Each frame's tensors broadcast to a leading batch axis of `batch`
    (materialised, as the reference's device_put of np.broadcast_to)."""
    return [dataclasses.replace(f, **{k: v.expand((batch,) + v.shape).contiguous() for k, v in f.tensors().items()})
            for f in frames]


def measure(batch, warmup=WARMUP, n=MEASURE, device="cuda", small=False, seed=0) -> dict:
    """-> {fps (aggregate), fps_per_seq, first_s, ms, launches} of the
    batched step at B = `batch`."""
    from dynosam_tpu_torch.parallel.batched import make_batched_pipeline

    cfg, intr, frames = B.bench_setup(device, small)
    step, init_fn = make_batched_pipeline(cfg, intr, torch.Generator(device=device).manual_seed(seed))
    states = init_fn(batch, device)
    bf = batch_frames(frames, batch)
    before = timing.counts()
    _, out, first_s, dt = timing.time_steps(step, states, bf, warmup, n, device=device)
    if not bool(torch.isfinite(out["X_world_cam"]).all()):
        raise RuntimeError(f"B={batch}: a timed frame's camera pose is not finite")
    return {"fps": batch / dt, "fps_per_seq": 1.0 / dt, "first_s": first_s, "ms": dt * 1e3,
            "launches": timing.since(before)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 4, 8])
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("-n", type=int, default=MEASURE, help="measured steps per batch size")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="the graft's quick configuration, 128 x 96")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    card = timing.prepare(args.device)
    lines = [
        "## Multi-sequence batched throughput (one card)\n\n",
        "B sequences step in one program (make_batched_pipeline, the program multichip.py splits over\n"
        f"ranks), each frame one bench frame broadcast to all B. Device: {card}. Generated by\n"
        f"`python -m dynosam_tpu_torch.bench_batched` (warm-up {args.warmup}, {args.n} measured steps"
        + (", --small" if args.small else "") + ").\n\n",
        "| B | aggregate frames/s | frames/s per seq | ms per step | first step (s) | K1b launches |\n",
        "|---|---|---|---|---|---|\n",
    ]
    results = {}
    for batch in args.batches:
        r = measure(batch, args.warmup, args.n, args.device, args.small, args.seed)
        results[batch] = r
        lines.append(f"| {batch} | {r['fps']:.4f} | {r['fps_per_seq']:.4f} | {r['ms']:.3f} | {r['first_s']:.3f} | "
                     f"{r['launches']['K1']} |\n")
        print(f"B={batch}: {r['fps']:.4f} frames/s aggregate ({r['fps_per_seq']:.4f}/seq), {r['ms']:.3f} ms per "
              f"step, first step {r['first_s']:.3f} s, launches {r['launches']}", flush=True)
    lines.append("\n")
    splice(args.out, BB_BEGIN, BB_END, "".join(lines))
    print(f"wrote batched section -> {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
