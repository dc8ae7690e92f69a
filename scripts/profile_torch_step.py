"""Per-layer time of the port's two main paths on a CUDA card.

  * bench: the fused step at bench_config over 20 bench frames (the
    10-frame window fills, then advances every frame);
  * detector: detector_scene() at detector_config over 24 frames, each
    frame labelled by YOLOv8-seg before the fused step (ByteTrack relabels
    the masks inside the tracker).

Each path runs twice on fresh states: the first pass warms up (kernel build,
cuBLAS/cuSOLVER/cuDNN handles, allocator), the second is measured. Layers
are timed on the host clock with a torch.cuda.synchronize() at each
boundary (so the layer times add up to more than an unhooked step):
tracker, the rest of the frontend (RANSAC, GN, joint refinement), window
advance, graph update and hybrid optimize; on the detector path also the
network, decode + NMS, mask combination (with K2 alone inside it), label
image and ByteTrack. A third pass runs under torch.profiler for device busy
time, device op count and the top kernels by device time.

Usage: python scripts/profile_torch_step.py [--out PATH.json] [--seed N]
"""

from __future__ import annotations

import argparse
import dataclasses
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
    from dynosam_tpu_torch import bench_config as bc
    from dynosam_tpu_torch.backend import graph as graph_mod
    from dynosam_tpu_torch.backend import hybrid as hybrid_mod
    from dynosam_tpu_torch.backend import window as window_mod
    from dynosam_tpu_torch.frontend import frontend as fe_mod
    from dynosam_tpu_torch.frontend import tracker as tracker_mod
    from dynosam_tpu_torch.nn import detector as det_mod
    from dynosam_tpu_torch.nn import postprocess as pp_mod
    from dynosam_tpu_torch.parallel import batched as batched_mod
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

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

    step_hooks = [
        (fe_mod, "track_frame", "tracker"),
        (batched_mod, "frontend_step", "frontend_total"),
        (window_mod, "advance_hybrid", "window_advance"),
        (graph_mod, "update_from_packet_hybrid", "graph_update"),
        (hybrid_mod, "optimize", "hybrid_optimize"),
    ]
    det_hooks = [
        (det_mod.YoloV8DetectorEngine, "detect", "detector_total"),
        (pp_mod, "decode_all", "decode"),
        (pp_mod, "nms", "nms"),
        (pp_mod, "combine_masks", "mask_combination"),
        (pp_mod, "mask_combine", "K2"),
        (pp_mod, "masks_to_label_image", "label_image"),
        (tracker_mod.bt, "masks_to_detections", "bytetrack_boxes"),
        (tracker_mod.bt, "bytetrack_step", "bytetrack_step"),
    ]

    def make_path(name):
        if name == "bench":
            cfg, intr = bc.bench_config()
            frames = bc.bench_scene(intr, 20, device="cuda").frames()
            engine = None
        else:
            cfg, intr = bc.detector_config()
            frames = bc.detector_scene(intr, 24, device="cuda").frames()
            engine = det_mod.YoloV8DetectorEngine(device="cuda")
        return cfg, intr, frames, engine

    def run_pass(cfg, intr, frames, engine):
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        step = make_fused_step(cfg, intr, gen)
        state = init_pipeline_state(cfg, "cuda")
        times = []
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if engine is not None:
                f = dataclasses.replace(f, mask=engine.process(f.rgb))
            state, _ = step(state, f)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    def hooked(hooks, fn):
        orig = [getattr(owner, attr) for owner, attr, _ in hooks]
        try:
            for (owner, attr, name), f in zip(hooks, orig):
                setattr(owner, attr, timed(name, f))
            return fn()
        finally:
            for (owner, attr, _), f in zip(hooks, orig):
                setattr(owner, attr, f)

    def profile_pass(cfg, intr, frames, engine):
        from torch.profiler import ProfilerActivity, profile

        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        step = make_fused_step(cfg, intr, gen)
        state = init_pipeline_state(cfg, "cuda")

        def one(state, f):
            if engine is not None:
                f = dataclasses.replace(f, mask=engine.process(f.rgb))
            return step(state, f)

        state, _ = one(state, frames[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in frames[1:]:
                state, _ = one(state, f)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        return wall, kernels, by_name

    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "paths": {}}
    for name in ("bench", "detector"):
        cfg, intr, frames, engine = make_path(name)
        run_pass(cfg, intr, frames, engine)                       # warm-up
        layers.clear()
        hooks = step_hooks
        if engine is not None:
            # the network's own time: its forward, as the engine calls it
            hooks = hooks + det_hooks + [(engine.model, "forward", "network")]
        step_times = hooked(hooks, lambda: run_pass(cfg, intr, frames, engine))
        layers["motion_and_refine"] = [a - b for a, b in zip(layers["frontend_total"], layers["tracker"])]
        wall, kernels, by_name = profile_pass(cfg, intr, frames, engine)
        busy_us = sum(by_name.values())
        n_prof = len(frames) - 1
        steady = step_times[10:] if name == "bench" else step_times[1:]
        r = {
            "frames": len(frames),
            "step_ms": [t * 1e3 for t in step_times],
            # bench: frames 11-20, where every step advances the window
            "step_ms_median_steady": statistics.median(steady) * 1e3,
            "layer_ms_median": {k: statistics.median(v[1:] if len(v) > 1 else v) * 1e3
                                for k, v in layers.items()},
            "layer_calls": {k: len(v) for k, v in layers.items()},
            "profiled_frames": n_prof,
            "profiled_wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            # the profiler slows the host, so the idle share of its own wall
            # time overstates idling; the second share uses the unprofiled step
            "device_idle_share_profiled": 1.0 - (busy_us / 1e6) / wall,
            "device_idle_share_of_step": 1.0 - (busy_us / 1e3 / n_prof)
            / (statistics.median(step_times[1:]) * 1e3),
            "device_ops_per_frame": len(kernels) / n_prof,     # kernels, copies and fills
            "top_kernels_ms": [[n, t / 1e3] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]],
        }
        result["paths"][name] = r
        print(json.dumps({"path": name, "card": card,
                          **{k: v for k, v in r.items() if k not in ("top_kernels_ms", "step_ms")}}),
              flush=True)
        for n, t in r["top_kernels_ms"]:
            print(f"{t:10.3f} ms  {n[:100]}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
