"""End-to-end benchmark of the port: the fused SLAM step at KITTI scale (the
port of bench.py).

Runs the full per-frame pipeline (provided dense flow and instance masks ->
tracking -> RANSAC motion solves -> windowed LM backend, hybrid incremental
mode) at `bench_config()` (384 x 1280, 800 static + 1024 dynamic track
slots, 8 object slots) on the 8 distinct frames of the bench scene, and
reports the steady-state frames per second on the card.

As in bench.py: the first frame is timed apart, `WARMUP - 1` more frames
warm up, then `MEASURE` frames are timed on frames[(WARMUP + i) % 8] (the
camera jumps back 5.6 m at every wrap) with one `torch.cuda.synchronize()`
at the end of the measured loop and none inside it. The host syncs that the
step makes itself (the window advance's host read and its eigh branch,
which depend on the data) are counted in the measured loop with torch's
sync debug mode, which adds no sync. `--steps N` adds a separate pass of N
steps after the timed loop, each ended by a synchronize, for the per-step
host ms at p10 / p50 / p90.

Prints exactly one JSON line on stdout,
`{"metric": "e2e_fps_kitti_scale_synth", "value": ..., "unit": "frames/s"}`;
the card (name and power limit), the first frame's seconds, ms per frame,
K1's launches and host syncs per frame go to stderr.

Without `--worker` the command is a parent that runs the worker (`--worker`)
in a fresh process, up to MAX_ATTEMPTS times RETRY_DELAY_S apart: a sticky
CUDA error (an illegal address, a launch failure) poisons the context for
the life of the process, and only a new process recovers. Every failed
attempt's exit code and the tail of its stderr are printed; the parent
prints the successful worker's JSON line, or exits non-zero with none.

Usage: python -m dynosam_tpu_torch.bench [--worker] [--device cuda|cpu]
       [--small] [--warmup 5] [--measure 30] [--steps 0] [--seed 0]
`--small` runs __graft_entry__.py's quick configuration on its one random
128 x 96 frame (bench_config.small_config), for a CPU run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from dynosam_tpu_torch import timing

WARMUP = 5
MEASURE = 30
METRIC = "e2e_fps_kitti_scale_synth"
SMALL_METRIC = "e2e_fps_small_synth"
MAX_ATTEMPTS = 3
RETRY_DELAY_S = 20.0
WORKER_TIMEOUT_S = 1800
STDERR_TAIL = 4000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_setup(device="cuda", small=False):
    """(cfg, intr, frames) of the benchmark: bench_config() on the 8 bench
    frames, or with `small` the graft's configuration on its one frame."""
    from dynosam_tpu_torch import bench_config as bc

    if small:
        return bc.small_config(), bc.small_intr(), [bc.small_frame_inputs(device=device)]
    cfg, intr = bc.bench_config()
    return cfg, intr, bc.bench_frames(intr, device=device)


def build(cfg, intr, device="cuda", seed=0):
    """(step, state): the fused step (RANSAC drawing from a generator on
    `device` seeded with `seed`) and an empty state without an image shape,
    as bench.py builds them (mask propagation off)."""
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step

    gen = torch.Generator(device=device).manual_seed(seed)
    return make_fused_step(cfg, intr, gen), init_pipeline_state(cfg, device)


def run(device="cuda", small=False, warmup=WARMUP, measure=MEASURE, steps=0, seed=0) -> dict:
    """The benchmark -> {fps, first_s, ms_per_frame, launches (over the first
    frame, warm-up and measured loop), syncs (in the measured loop; None
    off the card), sync_top (their most frequent sites), step_ms (the
    synchronised pass; None without one)}."""
    cfg, intr, frames = bench_setup(device, small)
    step, state = build(cfg, intr, device, seed)
    n = len(frames)
    before = timing.counts()
    sc = timing.SyncCounter(device)
    state, out, first_s, dt = timing.time_steps(step, state, frames, warmup, measure, device=device, measured=sc)
    launches = timing.since(before)
    finite = bool(torch.isfinite(out["X_world_cam"]).all())
    times = []
    for i in range(steps):
        timing.sync(device)
        t0 = time.perf_counter()
        state, out = step(state, frames[(warmup + measure + i) % n])
        timing.sync(device)
        times.append(time.perf_counter() - t0)
    return {"fps": 1.0 / dt, "first_s": first_s, "ms_per_frame": dt * 1e3, "launches": launches,
            "syncs": sc.count, "syncs_per_frame": sc.per_frame(measure), "sync_top": sc.top(4),
            "finite": finite, "step_ms": timing.percentiles_ms(times) if times else None,
            "metric": SMALL_METRIC if small else METRIC}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true", help="run the benchmark in this process")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="the graft's quick configuration, 128 x 96")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--measure", type=int, default=MEASURE)
    ap.add_argument("--steps", type=int, default=0, help="steps of the synchronised pass after the timed loop")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    """The worker: the benchmark in this process; one JSON line on stdout."""
    args = parser().parse_args(argv)
    card = timing.prepare(args.device)
    r = run(args.device, args.small, args.warmup, args.measure, args.steps, args.seed)
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"[bench] device={kind} ({card}) first-frame={r['first_s']:.3f}s per-frame={r['ms_per_frame']:.3f}ms "
          f"K1 launches={r['launches']['K1']} (map entry {r['launches']['K1 map']}) host syncs per frame="
          f"{r['syncs_per_frame']}" + (f" ({r['sync_top']})" if r["sync_top"] else ""), file=sys.stderr, flush=True)
    if r["step_ms"]:
        p = r["step_ms"]
        print(f"[bench] synchronised pass, {args.steps} steps: host ms per step p10 {p['p10']:.3f} p50 "
              f"{p['p50']:.3f} p90 {p['p90']:.3f}", file=sys.stderr, flush=True)
    if not r["finite"]:
        raise RuntimeError("the last measured frame's camera pose is not finite")
    print(json.dumps({"metric": r["metric"], "value": r["fps"], "unit": "frames/s"}), flush=True)
    return r


def _json_line(stdout: str):
    """The last JSON line with a metric and a value in `stdout`, or None."""
    found = None
    for line in (stdout or "").splitlines():
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "metric" in parsed and "value" in parsed:
                found = line
    return found


def supervise(argv=None, attempts=MAX_ATTEMPTS, delay_s=RETRY_DELAY_S) -> int:
    """Run the worker in fresh processes until one succeeds -> exit code.
    Prints exactly one JSON line on stdout (the successful worker's) or
    none; every failed attempt's exit code and stderr tail go to stderr."""
    argv = list(sys.argv[1:] if argv is None else argv)
    last_rc = 1
    for attempt in range(1, attempts + 1):
        try:
            proc = subprocess.run([sys.executable, "-m", "dynosam_tpu_torch.bench", "--worker", *argv],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=ROOT, text=True,
                                  timeout=WORKER_TIMEOUT_S)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", f"timed out after {WORKER_TIMEOUT_S} s\n{e.stderr or ''}"
            out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
        line = _json_line(out)
        if rc == 0 and line is not None:
            sys.stderr.write(err or "")
            print(line, flush=True)
            return 0
        last_rc = rc
        print(f"[bench] attempt {attempt}/{attempts} failed (rc={rc}, json={'yes' if line else 'no'})"
              + (f"; retrying in {delay_s:.0f}s" if attempt < attempts else "")
              + f"; its stderr ends:\n{(err or '')[-STDERR_TAIL:]}", file=sys.stderr, flush=True)
        if attempt < attempts:
            time.sleep(delay_s)
    return last_rc or 1


if __name__ == "__main__":
    if "--worker" in sys.argv[1:]:
        main()
    else:
        sys.exit(supervise())
