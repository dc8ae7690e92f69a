"""Per-stage time of the fused SLAM step at bench scale (the port of
scripts/profile_breakdown.py).

Fills the state to steady state (`max_frames + 2` fused steps: the window
full and advancing), then times each stage alone on that state and bench
frame 0, with a synchronize around each call: the fused step, the
frontend step, the graph update, the window advance and the optimizer of
the formulation `--updater` picks (3 hybrid, 1 WCPE, 0 WCME), under the
fused step's incremental-mode optimizer settings
(`parallel/batched.py::_incremental`). The graph update ingests frame 0's
packet into the window advanced once, outside the timed region: the port
refuses to ingest into a full window (the reference's scatter into the
slot past the end drops the write), and in the fused step an advance
always comes first. Stage times measured apart add the synchronizes the
fused step does not pay: use the ratios.

The stages run again and again on one state, as the reference's do on an
undonated state, so none may change its inputs: a digest of the state, the
advanced window, the frontend's packet and the frame is taken before and
after the timed calls and must not move. `--trace DIR` adds a
torch.profiler Chrome trace of 5 fused steps, the counterpart of
`jax.profiler.trace`.

Usage: python -m dynosam_tpu_torch.profile_breakdown [--updater 3] [-n 30]
       [--trace DIR] [--device cuda|cpu] [--small] [--seed 0]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import statistics
import time

import torch

from dynosam_tpu_torch import bench as B
from dynosam_tpu_torch import timing

UPDATERS = {3: "hybrid", 1: "wcpe", 0: "wcme"}
STAGE_WARMUP = 3
TRACE_STEPS = 5


def digest(obj) -> str:
    """sha256 over every tensor (and host number) in `obj` (nested
    dataclasses, dicts, lists), in field order."""
    h = hashlib.sha256()

    def walk(x):
        if torch.is_tensor(x):
            h.update(str((x.dtype, tuple(x.shape))).encode())
            h.update(x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(repr(x).encode())

    walk(obj)
    return h.hexdigest()


def stages(cfg, intr, generator):
    """(fused step, advance, {stage: fn(ctx)}): the fused step and each of
    its stages under `cfg`'s formulation, on ctx = {"state": the filled
    PipelineState, "packet": the frame's frontend packet, "frame": its
    FrameInputs, "advanced": the state's window advanced once}."""
    from dynosam_tpu_torch.frontend.frontend import frontend_step
    from dynosam_tpu_torch.parallel.batched import _formulation, _incremental, make_fused_step

    fused = make_fused_step(cfg, intr, generator)
    icfg = _incremental(cfg)
    bcfg = icfg.backend
    advance_fn, update_fn, optimize_fn = _formulation(bcfg)

    def advance(g):
        return advance_fn(g, bcfg)

    return fused, advance, {
        "fused step": lambda c: fused(c["state"], c["frame"]),
        "frontend_step": lambda c: frontend_step(c["state"].frontend, c["frame"], intr, icfg.frontend, generator),
        "graph update": lambda c: update_fn(c["advanced"], c["packet"], intr, bcfg),
        "window advance": lambda c: advance(c["state"].graph),
        "optimize": lambda c: optimize_fn(c["state"].graph, bcfg),
    }


def timeit(fn, device, n=30, warmup=STAGE_WARMUP):
    """-> (mean ms, median ms) of `n` calls of fn(), each between two
    synchronizes, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        timing.sync(device)
        t0 = time.perf_counter()
        fn()
        timing.sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.fmean(times) * 1e3, statistics.median(times) * 1e3


def fill(step, state, frames, n_steps, device):
    """The state after `n_steps` fused steps on frames[i % len(frames)]."""
    for i in range(n_steps):
        state, _ = step(state, frames[i % len(frames)])
    timing.sync(device)
    return state


def run(updater=3, n=30, device="cuda", small=False, seed=0, trace=None) -> dict:
    """The breakdown -> {updater, stages: {stage: (mean ms, median ms)},
    digest_before, digest_after, launches (over the timed calls), trace}."""
    from dynosam_tpu_torch.frontend.frontend import frontend_step
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state

    cfg, intr, frames = B.bench_setup(device, small)
    cfg = cfg.with_overrides({"backend.backend_updater_enum": updater}).normalized()
    gen = torch.Generator(device=device).manual_seed(seed)
    fused, advance, fns = stages(cfg, intr, gen)
    state = fill(fused, init_pipeline_state(cfg, device), frames, cfg.backend.max_frames + 2, device)
    _, packet = frontend_step(state.frontend, frames[0], intr, cfg.frontend, gen)
    ctx = {"state": state, "packet": packet, "frame": frames[0], "advanced": advance(state.graph)}
    timing.sync(device)
    before = digest(ctx)
    counted = timing.counts()
    times = {name: timeit(lambda fn=fn: fn(ctx), device, n) for name, fn in fns.items()}
    launches = timing.since(counted)
    after = digest(ctx)
    out = {"updater": updater, "formulation": UPDATERS[updater], "stages": times, "digest_before": before,
           "digest_after": after, "launches": launches, "calls": n + STAGE_WARMUP, "trace": None}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(trace, exist_ok=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
        with profile(activities=acts) as prof:
            for i in range(TRACE_STEPS):
                state, _ = fused(state, frames[i % len(frames)])
            timing.sync(device)
        out["trace"] = os.path.join(trace, f"profile_breakdown_updater{updater}.json")
        prof.export_chrome_trace(out["trace"])
    return out


def report(r) -> list:
    fused_mean = r["stages"]["fused step"][0]
    lines = [f"== stage breakdown (updater={r['updater']}, {r['formulation']}) =="]
    for name, (mean, med) in r["stages"].items():
        extra = f"   ({1e3 / fused_mean:.1f} FPS)" if name == "fused step" else ""
        lines.append(f"{name + ':':20s}{mean:10.3f} ms   median {med:10.3f} ms{extra}")
    lines.append(f"state digest before {r['digest_before'][:16]} after {r['digest_after'][:16]} "
                 f"({'unchanged' if r['digest_before'] == r['digest_after'] else 'CHANGED'}); launches over "
                 f"{r['calls']} calls of each stage: {r['launches']}")
    if r["trace"]:
        lines.append(f"trace written to {r['trace']}")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--updater", type=int, default=3, choices=sorted(UPDATERS))
    ap.add_argument("-n", type=int, default=30, help="timed calls of each stage")
    ap.add_argument("--trace", default=None, help="directory for a torch.profiler Chrome trace")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="the graft's quick configuration, 128 x 96")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    card = timing.prepare(args.device)
    print(f"device: {card}", flush=True)
    r = run(args.updater, args.n, args.device, args.small, args.seed, args.trace)
    for line in report(r):
        print(line, flush=True)
    if r["digest_before"] != r["digest_after"]:
        raise SystemExit("profile_breakdown: a stage changed the state it was given")
    return r


if __name__ == "__main__":
    main()
