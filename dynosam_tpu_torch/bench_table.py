"""The port's end-to-end table (the port of scripts/bench_table.py): the
rows that put bench.py's number beside what a user of the system pays.

  fused-synth        bench.py's configuration on the 8 bench frames
                     (384 x 1280, provided flow and masks), the state built
                     with the image shape, so mask propagation runs
  fused-synth-gated  the same with per-variable-type update gating on
                     (the four update thresholds at 1e-5)
  fused-synth-klt    the same tracking by pyramidal KLT + CLAHE
                     (prefer_provided_optical_flow=False) on the
                     world-textured bench frames, the reference's row as it
                     has it (on this scene the reference loses the camera)
  detector-on        fused-synth (no image shape, as the reference's row)
                     with the YOLOv8-seg engine (the committed checkpoint,
                     384 x 640 input) labelling each frame before the step
  real-io            the committed tests/fixtures/kitti_fixture (320 x 96)
                     through DynoPipeline.run with deferred host outputs:
                     disk decode, prefetch, logging and finish() included,
                     after max_frames + 2 warm frames and a drain (its
                     first-frame column holds that warm-up's seconds)

Each synthetic row times `--measure` steps after `--warmup` (the first
apart), with one synchronize at the end of the timed loop, on frames
[(warmup + i) % 8] (the detector row on [(5 + i) % 8], as the reference's).
A separate pass under torch.profiler over the first `--profile-frames` of
those frames gives the device busy ms per frame and the idle share (1 -
busy / the timed ms per frame). There are no GFLOP or MFU columns: the
reference's peaks are a TPU's, XLA's cost model has no torch counterpart
that counts the solver and elementwise work of a SLAM step, and the system
runs no model, so there is no share of a peak to report.

Writes `--out` (default dynosam_tpu_torch/BENCH_TABLE.md, beside SCALE.md
and ACCURACY.md; never the repository's root BENCH_TABLE.md, which is the
reference's), keeping the sections that bench_batched and
bench_mesh_scaling splice between their markers.

Usage: python -m dynosam_tpu_torch.bench_table [--out PATH] [--skip ROW ...]
       [--warmup 10] [--measure 120] [--profile-frames 16]
       [--device cuda|cpu] [--small] [--seed 0]
`--small` runs the synthetic rows at the graft's quick configuration on its
one 128 x 96 frame (the detector's input at 96 x 128); real-io is the
fixture's either way.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import tempfile
import time

import torch

from dynosam_tpu_torch import timing

PKG = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(PKG, "BENCH_TABLE.md")
KITTI_FIXTURE = os.path.join(os.path.dirname(PKG), "tests", "fixtures", "kitti_fixture")
WARMUP = 10
MEASURE = 120
PROFILE_FRAMES = 16
DETECTOR_HW = (384, 640)
DETECTOR_OFFSET = 5
REAL_IO_FRAMES = 60
GATE = 1e-5

BB_BEGIN = "<!-- batched-section-begin -->"
BB_END = "<!-- batched-section-end -->"
MESH_BEGIN = "<!-- mesh-section-begin -->"
MESH_END = "<!-- mesh-section-end -->"


def preserved_section(path: str, begin: str, end: str) -> str:
    """What lies between the markers in the table at `path` ("\\n" if none)."""
    if not os.path.exists(path):
        return "\n"
    with open(path) as fh:
        text = fh.read()
    if begin in text and end in text:
        return text.split(begin)[1].split(end)[0]
    return "\n"


def splice(path: str, begin: str, end: str, content: str):
    """Put `content` between the markers of the table at `path` (appended
    with its markers where they are missing; a new file otherwise)."""
    base = open(path).read() if os.path.exists(path) else "# Benchmark table of the port\n"
    block = f"{begin}\n{content}{end}\n"
    if begin in base and end in base:
        out = base.split(begin)[0] + block + base.split(end, 1)[1]
    else:
        out = base.rstrip() + "\n\n" + block
    with open(path, "w") as fh:
        fh.write(out)


def _idle(busy_ms, ms):
    return None if busy_ms is None else 1.0 - busy_ms / ms


def time_fused(cfg, intr, frames, warmup=WARMUP, measure=MEASURE, device="cuda", seed=0, image_shape=True,
               engine=None, offset=None, profile_frames=PROFILE_FRAMES) -> dict:
    """The fused step under `cfg` timed over `measure` steps on frames
    [(offset + i) % n] (offset defaults to `warmup`) after the first and
    `warmup - 1` more; with `engine`, each frame's mask comes from it first.
    Then the profiled pass over the first `profile_frames` of those frames.
    -> {fps, ms, first_s, busy_ms, ops, idle, profiled_frames, launches}."""
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step

    gen = torch.Generator(device=device).manual_seed(seed)
    step = make_fused_step(cfg, intr, gen)
    shape = tuple(frames[0].rgb.shape[:2]) if image_shape else None
    state = init_pipeline_state(cfg, device, image_shape=shape)
    offset = warmup if offset is None else offset

    def one(state, f):
        if engine is not None:
            f = dataclasses.replace(f, mask=engine.process(f.rgb))
        return step(state, f)

    before = timing.counts()
    state, out, first_s, dt = timing.time_steps(one, state, frames, warmup, measure, offset, device)
    p = min(profile_frames, measure)
    holder = [state]

    def profiled():
        for i in range(p):
            holder[0], _ = one(holder[0], frames[(offset + i) % len(frames)])

    prof = timing.device_busy(device, profiled, p)
    if not bool(torch.isfinite(out["X_world_cam"]).all()):
        raise RuntimeError("a timed frame's camera pose is not finite")
    return {"fps": 1.0 / dt, "ms": dt * 1e3, "first_s": first_s, "busy_ms": prof["busy_ms"], "ops": prof["ops"],
            "idle": _idle(prof["busy_ms"], dt * 1e3), "profiled_frames": p, "launches": timing.since(before)}


def _synth(device, small, world_texture=False):
    """(cfg, intr, frames): bench_config() on the 8 bench frames, or the
    graft's configuration on its one frame."""
    from dynosam_tpu_torch import bench_config as bc

    if small:
        return bc.small_config(), bc.small_intr(), [bc.small_frame_inputs(device=device)]
    cfg, intr = bc.bench_config()
    return cfg, intr, bc.bench_frames(intr, world_texture=world_texture, device=device)


def row_fused_synth(klt=False, device="cuda", small=False, **kw):
    cfg, intr, frames = _synth(device, small, world_texture=klt)
    if klt:
        cfg = cfg.with_overrides({"frontend.tracker.prefer_provided_optical_flow": False})
    return time_fused(cfg, intr, frames, device=device, **kw)


def row_fused_gated(device="cuda", small=False, **kw):
    """fused-synth with the per-variable-type update gating on, at
    thresholds below the noise floor."""
    cfg, intr, frames = _synth(device, small)
    cfg = cfg.with_overrides({f"backend.optimizer.{k}": GATE for k in (
        "x_update_threshold_rot", "x_update_threshold_trans", "h_update_threshold_rot",
        "h_update_threshold_trans")})
    return time_fused(cfg, intr, frames, device=device, **kw)


def row_detector_on(device="cuda", small=False, warmup=WARMUP, **kw):
    """fused-synth (no image shape) with the YOLOv8-seg engine's masks."""
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine

    cfg, intr, frames = _synth(device, small)
    engine = YoloV8DetectorEngine(input_hw=tuple(frames[0].rgb.shape[:2]) if small else DETECTOR_HW, device=device)
    return time_fused(cfg, intr, frames, device=device, image_shape=False, engine=engine, warmup=warmup,
                      offset=DETECTOR_OFFSET, **kw)


def row_real_io(device="cuda", small=False, measure=MEASURE, profile_frames=PROFILE_FRAMES, seed=0,
                fixture=KITTI_FIXTURE, frames=REAL_IO_FRAMES):
    """The committed fixture through DynoPipeline.run (deferred outputs):
    frames warm..warm+measure (at most the fixture's 60) after
    max_frames + 2 warm frames and a drain; then the same warm-up in a
    second pipeline and its first `profile_frames` measured frames under
    the profiler."""
    from dynosam_tpu_torch.bench_config import kitti_real_io_config
    from dynosam_tpu_torch.dataproviders.base import create_dataset
    from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline

    cfg = kitti_real_io_config()
    ds = create_dataset(0, fixture, device=device)
    warm = cfg.backend.max_frames + 2
    n = min(frames, len(ds), warm + measure)
    out_dir = tempfile.mkdtemp(prefix="benchreal_")

    def warmed():
        pipe = DynoPipeline(cfg, ds.intrinsics(), output_path=out_dir, device=device, seed=seed)
        for k in range(warm):
            pipe.process_frame(ds.frame(k), ds.ground_truth(k))
        pipe._drain_outputs()
        timing.sync(device)
        return pipe

    def run_frames(pipe, stop):
        pipe.run((ds.frame_host(k) for k in range(warm, stop)), (ds.ground_truth(k) for k in range(warm, stop)))

    try:
        before = timing.counts()
        t0 = time.perf_counter()
        pipe = warmed()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_frames(pipe, n)
        timing.sync(device)
        dt = time.perf_counter() - t0
        p = min(profile_frames, n - warm)
        pipe2 = warmed()
        prof = timing.device_busy(device, lambda: run_frames(pipe2, warm + p), p)
        launches = timing.since(before)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ms = dt * 1e3 / (n - warm)
    return {"fps": (n - warm) / dt, "ms": ms, "first_s": first_s, "busy_ms": prof["busy_ms"], "ops": prof["ops"],
            "idle": _idle(prof["busy_ms"], ms), "profiled_frames": p, "launches": launches,
            "frames": n - warm, "first_of": f"{warm} warm frames + drain"}


ROWS = {
    "fused-synth": ("bench.py's path, 384x1280, provided flow/mask, mask propagation on (image-shaped state)",
                    lambda **kw: row_fused_synth(False, **kw)),
    "fused-synth-gated": ("per-variable-type update gating on (solver.gate_dx_by_type A/B; the four update "
                          "thresholds at 1e-5)", row_fused_gated),
    "fused-synth-klt": ("in-loop pyramidal KLT + CLAHE (no provided flow) on the world-textured bench frames",
                        lambda **kw: row_fused_synth(True, **kw)),
    "detector-on": ("YOLOv8-seg engine per frame (384x640 input, the committed checkpoint)", row_detector_on),
    "real-io": ("60-frame fixture (320x96), disk decode + prefetch + logging, deferred outputs", row_real_io),
}


def _fmt(x, spec):
    return "n/a" if x is None or (isinstance(x, float) and not math.isfinite(x)) else format(x, spec)


def _first(r):
    """The row's first-frame seconds, with what they cover where that is
    more than one frame (real-io: its warm-up and drain)."""
    return f"{r['first_s']:.3f}" + (f" ({r['first_of']})" if "first_of" in r else "")


def write_table(path, card, rows, args):
    batched = preserved_section(path, BB_BEGIN, BB_END)
    meshsec = preserved_section(path, MESH_BEGIN, MESH_END)
    with open(path, "w") as fh:
        fh.write(f"# Benchmark table of the port — device: {card}\n\n")
        fh.write(
            "All rows measured at one code state by `python -m dynosam_tpu_torch.bench_table` "
            f"(warm-up {args.warmup}, measure {args.measure}, profiled frames {args.profile_frames}"
            + (", --small" if args.small else "") + "). frames/s: the timed steps over the host wall time "
            "with one synchronize at the end (real-io: frames over the wall time of DynoPipeline.run, "
            "finish() included). Device busy ms per frame: torch.profiler's kernel, copy and fill time "
            "summed over the profiled frames of a separate pass over the same frames; idle share: 1 - busy / "
            "ms per frame of the timed pass.\n\n"
            "No GFLOP or MFU columns: the reference's peaks are a TPU's, XLA's cost model has no torch "
            "counterpart that counts the solver and elementwise work of a SLAM step, and the system runs "
            "no model, so there is no share of a peak to report.\n\n")
        fh.write("| config | frames/s | ms/frame | first frame (s) | device busy ms/frame | device idle share "
                 "| device ops/frame | K1 launches | notes |\n|---|---|---|---|---|---|---|---|---|\n")
        for name, note, r in rows:
            fh.write(f"| {name} | {r['fps']:.4f} | {r['ms']:.3f} | {_first(r)} | {_fmt(r['busy_ms'], '.3f')} "
                     f"| {_fmt(r['idle'], '.4f')} | {_fmt(r['ops'], '.1f')} | {r['launches']['K1']} | {note} |\n")
        fh.write(f"\n{BB_BEGIN}{batched}{BB_END}\n")
        fh.write(f"\n{MESH_BEGIN}{meshsec}{MESH_END}\n")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip", nargs="*", default=[], choices=list(ROWS))
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--measure", type=int, default=MEASURE)
    ap.add_argument("--profile-frames", type=int, default=PROFILE_FRAMES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="the synthetic rows at the graft's quick configuration")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    card = timing.prepare(args.device, detector="detector-on" not in args.skip)
    print(f"device: {card}", flush=True)
    rows = []
    for name, (note, fn) in ROWS.items():
        if name in args.skip:
            continue
        kw = {"device": args.device, "small": args.small, "measure": args.measure,
              "profile_frames": args.profile_frames, "seed": args.seed}
        if name != "real-io":
            kw["warmup"] = args.warmup
        t0 = time.perf_counter()
        r = fn(**kw)
        r["row_s"] = time.perf_counter() - t0
        rows.append((name, note, r))
        print(f"{name:18s} {r['fps']:10.4f} frames/s  {r['ms']:9.3f} ms/frame  first (s) {_first(r)}  "
              f"busy {_fmt(r['busy_ms'], '.3f')} ms/frame  idle {_fmt(r['idle'], '.4f')}  "
              f"launches {r['launches']}  (row {r['row_s']:.1f} s)", flush=True)
    write_table(args.out, card, rows, args)
    print(f"wrote {args.out}", flush=True)
    result = {name: r for name, _, r in rows}
    print(json.dumps({"rows": [(name, r["fps"]) for name, _, r in rows]}), flush=True)
    return result


if __name__ == "__main__":
    main()
