"""Per-layer time of the port's fused step at bench_config on a CUDA card.

Runs the 10 bench frames (one filled window) twice on fresh states: the
first pass warms up (kernel build, cuBLAS/cuSOLVER handles, allocator), the
second is measured. Layers are timed on the host clock with a
torch.cuda.synchronize() at each boundary: tracker (track_frame), the rest
of the frontend (RANSAC, GN, joint refinement), graph update and hybrid
optimize. A third pass runs under torch.profiler for device busy time,
kernel count and the top kernels by device time.

Usage: python scripts/profile_torch_step.py [--out PATH.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the full result, with the top kernels, as JSON here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    from dynosam_tpu_torch.backend import graph as graph_mod
    from dynosam_tpu_torch.backend import hybrid as hybrid_mod
    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.frontend import frontend as fe_mod
    from dynosam_tpu_torch.parallel import batched as batched_mod
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg, intr = bench_config()
    frames = bench_scene(intr, 10, device="cuda").frames()

    layers = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            layers.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return wrapper

    def run_pass():
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        step = make_fused_step(cfg, intr, gen)
        state = init_pipeline_state(cfg, "cuda")
        times = []
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, f)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    run_pass()                                      # warm-up
    # wrap each layer's entry point, as the step looks it up, for the
    # measured pass
    hooks = [
        (fe_mod, "track_frame", "tracker"),
        (batched_mod, "frontend_step", "frontend_total"),
        (graph_mod, "update_from_packet_hybrid", "graph_update"),
        (hybrid_mod, "optimize", "hybrid_optimize"),
    ]
    orig = [getattr(mod, attr) for mod, attr, _ in hooks]
    try:
        for (mod, attr, name), fn in zip(hooks, orig):
            setattr(mod, attr, timed(name, fn))
        step_times = run_pass()
    finally:
        for (mod, attr, _), fn in zip(hooks, orig):
            setattr(mod, attr, fn)
    layers["motion_and_refine"] = [
        a - b for a, b in zip(layers["frontend_total"], layers["tracker"])
    ]

    # device busy time over frames 2-10 under the profiler
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    step = make_fused_step(cfg, intr, gen)
    state = init_pipeline_state(cfg, "cuda")
    state, _ = step(state, frames[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[1:]:
            state, _ = step(state, f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]

    result = {
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "step_ms": [t * 1e3 for t in step_times],
        "step_ms_median_2_10": statistics.median(step_times[1:]) * 1e3,
        "layer_ms_median_2_10": {
            k: statistics.median(v[1:]) * 1e3 for k, v in layers.items()
        },
        "profiled_frames": len(frames) - 1,
        "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        # the profiler slows the host, so the idle share of its own wall
        # time overstates idling; the second share uses the unprofiled step
        "device_idle_share_profiled": 1.0 - (busy_us / 1e6) / wall,
        "device_idle_share_of_step": 1.0 - (busy_us / 1e3 / (len(frames) - 1))
        / (statistics.median(step_times[1:]) * 1e3),
        "device_ops": len(kernels),             # kernels, copies and fills
        "top_kernels_ms": [[n, t / 1e3] for n, t in top],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "top_kernels_ms"}))
    for n, t in top:
        print(f"{t / 1e3:10.3f} ms  {n[:100]}")


if __name__ == "__main__":
    main()
