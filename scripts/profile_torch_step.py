"""Per-layer time of the port's main paths on a CUDA card.

  * bench: the fused step at bench_config over 20 bench frames (the
    10-frame window fills, then advances every frame);
  * klt: bench_klt_config over 20 frames of the world-textured bench scene:
    CLAHE (once per frame), then inside the tracker LK forward and back
    (ops/lk.py::lk_flow, each with its pyramids) and the rest of the tracker
    as their own layers;
  * stereo_imu: stereo_imu_config over 12 such frames, each with a right
    image, a corrupted depth and an IMU window (bench_config.stereo_imu_frame);
    stereo matching (twice per frame) and IMU preintegration are layers too;
  * detector: detector_scene() at detector_config over 24 frames, each
    frame labelled by YOLOv8-seg before the fused step (ByteTrack relabels
    the masks inside the tracker);
  * wcme, wcpe, joint: the bench path with the WCME (backend_updater_enum
    0) or WCPE (1) backend, or the joint hybrid solve (decoupled_object_solve
    off); their backend layers are the window advance, the graph update, the
    optimizer, inside it the LM loop (lm_accept_reject) and each
    linearisation, and for WCME and WCPE inside that the chain elimination's
    block-Thomas factorisation and dense chain inverse;
  * batched_b8 (or batched_b<B>): make_batched_pipeline at bench_config over
    8 sequences of one 27-frame bench scene, sequence b on frames b..b+19,
    each frame one program for the batch; its layers are the bench path's,
    the optimizer being the decoupled hybrid LM it calls.

Each path runs twice on fresh states: the first pass warms up (kernel build,
cuBLAS/cuSOLVER/cuDNN handles, allocator), the second is measured. Layers
are timed on the host clock with a torch.cuda.synchronize() at each
boundary (so the layer times add up to more than an unhooked step):
tracker, the rest of the frontend (RANSAC, GN, joint refinement; stereo,
IMU and CLAHE taken out), window advance, graph update and hybrid optimize; on the detector path also the
network, decode + NMS, the label image from the prototypes
(nn/postprocess.py::mask_label_image, one launch of K2's entry B) and
ByteTrack. A third pass runs under torch.profiler for device busy
time, device op count and the top kernels by device time.

Usage: python scripts/profile_torch_step.py [--out PATH.json] [--seed N]
    [--paths bench,klt,stereo_imu,detector,wcme,wcpe,joint,batched_b8]
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
    ap.add_argument("--paths", default="bench,klt,stereo_imu,detector",
                    help="comma-separated paths to profile, in order")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    from dynosam_tpu_torch import bench_config as bc
    from dynosam_tpu_torch.backend import graph as graph_mod
    from dynosam_tpu_torch.backend import hybrid as hybrid_mod
    from dynosam_tpu_torch.backend import solver as solver_mod
    from dynosam_tpu_torch.backend import wcpe as wcpe_mod
    from dynosam_tpu_torch.backend import window as window_mod
    from dynosam_tpu_torch.ops import block_tridiag as bt_mod
    from dynosam_tpu_torch.cv import stereo as stereo_mod
    from dynosam_tpu_torch.frontend import frontend as fe_mod
    from dynosam_tpu_torch.frontend import imu as imu_mod
    from dynosam_tpu_torch.frontend import tracker as tracker_mod
    from dynosam_tpu_torch.ops import lk as lk_mod
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
        # the label image in one launch of K2's entry B
        (pp_mod, "mask_label_image", "mask_label"),
        (tracker_mod.bt, "masks_to_detections", "bytetrack_boxes"),
        (tracker_mod.bt, "bytetrack_step", "bytetrack_step"),
    ]

    lk_calls = [0]

    def lk_flow_named(fn):
        # lk_track calls lk_flow forward, then back
        def wrapper(*a, **kw):
            name = "lk_forward" if lk_calls[0] % 2 == 0 else "lk_back"
            lk_calls[0] += 1
            return timed(name, fn)(*a, **kw)
        return wrapper

    klt_hooks = [
        (tracker_mod, "_clahe_padded", "clahe"),
        (lk_mod, "lk_track", "lk_track"),
    ]
    stereo_imu_hooks = [
        (stereo_mod, "stereo_track", "stereo_track"),
        (imu_mod, "preintegrate", "imu_preintegrate"),
    ]

    chain_hooks = [(bt_mod, "factorize", "chain_factorize"), (bt_mod, "full_inverse", "chain_inverse")]
    form_hooks = {
        "wcme": [(window_mod, "advance", "window_advance"), (graph_mod, "update_from_packet", "graph_update"),
                 (solver_mod, "optimize", "optimize"), (solver_mod, "lm_accept_reject", "lm"),
                 (solver_mod, "linearize", "linearize")] + chain_hooks,
        "wcpe": [(window_mod, "advance_wcpe", "window_advance"),
                 (wcpe_mod, "update_from_packet_wcpe", "graph_update"), (wcpe_mod, "optimize", "optimize"),
                 (wcpe_mod, "lm_accept_reject", "lm"), (wcpe_mod, "linearize", "linearize")] + chain_hooks,
        "joint": [(hybrid_mod, "lm_accept_reject", "lm"), (hybrid_mod, "linearize", "linearize")],
    }
    form_overrides = {"wcme": {"backend.backend_updater_enum": 0}, "wcpe": {"backend.backend_updater_enum": 1},
                      "joint": {"backend.decoupled_object_solve": False}}

    def make_path(name):
        engine, batch = None, None
        if name.startswith("batched_b"):
            batch = int(name[len("batched_b"):])
            cfg, intr = bc.bench_config()
            scene_frames = bc.bench_scene(intr, 20 + batch - 1, device="cuda").frames()
            frames = [dataclasses.replace(scene_frames[k], **{
                f: torch.stack([getattr(fr, f) for fr in scene_frames[k:k + batch]])
                for f in scene_frames[k].tensors()}) for k in range(20)]
        elif name in form_overrides:
            cfg, intr = bc.bench_config()
            cfg = cfg.with_overrides(form_overrides[name])
            frames = bc.bench_scene(intr, 20, device="cuda").frames()
        elif name == "bench":
            cfg, intr = bc.bench_config()
            frames = bc.bench_scene(intr, 20, device="cuda").frames()
        elif name == "klt":
            cfg, intr = bc.bench_klt_config()
            frames = bc.bench_scene(intr, 20, device="cuda", world_texture=True).frames()
        elif name == "stereo_imu":
            cfg, intr = bc.stereo_imu_config()
            scene = bc.bench_scene(intr, 12, device="cuda", world_texture=True)
            frames = [bc.stereo_imu_frame(scene, k) for k in range(12)]
        else:
            cfg, intr = bc.detector_config()
            frames = bc.detector_scene(intr, 24, device="cuda").frames()
            engine = det_mod.YoloV8DetectorEngine(device="cuda")
        return cfg, intr, frames, engine, batch

    def make_step(cfg, intr, batch):
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        if batch:
            step, init = batched_mod.make_batched_pipeline(cfg, intr, gen)
            return step, init(batch, "cuda")
        return make_fused_step(cfg, intr, gen), init_pipeline_state(
            cfg, "cuda", image_shape=(intr.height, intr.width))

    def run_pass(cfg, intr, frames, engine, batch):
        step, state = make_step(cfg, intr, batch)
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

    def profile_pass(cfg, intr, frames, engine, batch):
        from torch.profiler import ProfilerActivity, profile

        step, state = make_step(cfg, intr, batch)

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
    for name in args.paths.split(","):
        cfg, intr, frames, engine, batch = make_path(name)
        run_pass(cfg, intr, frames, engine, batch)                # warm-up
        layers.clear()
        hooks = step_hooks
        if batch:
            hooks = [h for h in step_hooks if h[1] != "optimize"] + [
                (hybrid_mod, "optimize_decoupled", "hybrid_optimize")]
        elif name in ("wcme", "wcpe"):
            hooks = [h for h in step_hooks if h[0] is not window_mod and h[0] is not graph_mod
                     and h[0] is not hybrid_mod] + form_hooks[name]
        elif name == "joint":
            hooks = step_hooks + form_hooks[name]
        if engine is not None:
            # the network's own time: its forward, as the engine calls it
            hooks = hooks + det_hooks + [(engine.model, "forward", "network")]
        if name in ("klt", "stereo_imu"):
            hooks = hooks + klt_hooks
        if name == "stereo_imu":
            hooks = hooks + stereo_imu_hooks
        orig_flow = lk_mod.lk_flow
        lk_mod.lk_flow = lk_flow_named(orig_flow)
        lk_calls[0] = 0
        try:
            step_times = hooked(hooks, lambda: run_pass(cfg, intr, frames, engine, batch))
        finally:
            lk_mod.lk_flow = orig_flow
        n = len(frames)

        def per_frame(key):
            # a layer's calls summed within each frame (stereo runs twice)
            v = layers.get(key, [])
            k = len(v) // n if v else 0
            return [sum(v[i * k:(i + 1) * k]) for i in range(n)] if k else [0.0] * n

        # frontend minus the tracker and minus what ran outside it this frame
        layers["motion_and_refine"] = [
            f - t - c - st - im for f, t, c, st, im in zip(
                layers["frontend_total"], layers["tracker"], per_frame("clahe"),
                per_frame("stereo_track"), per_frame("imu_preintegrate"))]
        if "lk_track" in layers:
            # lk_flow also runs inside stereo matching: the tracker's LK is
            # the first lk_track call of each frame
            trk_lk = layers["lk_track"][:: len(layers["lk_track"]) // n]
            layers["tracker_rest"] = [t - lkt for t, lkt in zip(layers["tracker"], trk_lk)]
        wall, kernels, by_name = profile_pass(cfg, intr, frames, engine, batch)
        busy_us = sum(by_name.values())
        n_prof = len(frames) - 1
        steady = (step_times[10:] if batch or name in ("bench", "klt", "wcme", "wcpe", "joint")
                  else step_times[1:])
        r = {
            "frames": len(frames),
            "sequences": batch or 1,
            "step_ms": [t * 1e3 for t in step_times],
            # bench, klt: frames 11-20, where every step advances the window
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
