"""The closed-loop sweep: B lanes step in lockstep through the batched SLAM
step, each step feeding every lane its next frame.

Lane b plays scene (b + q) mod S in the sweep's q-th round of sequences;
when the lanes reach frame K they all start fresh states on their next
sequences (the window fill is one host integer, so they restart together).
Set-up renders the scene bank, builds the step and warms it on the cell's
own B over the frames that reach every shape (the window filling, the
first advance, steady advances); the window then starts fresh states at
frame 0 with the RANSAC generator re-seeded, so the reference can replay it.

A step completes when its lanes' outputs are in host memory: each step's
packed outputs go to a pinned host row by one copy on the step's stream,
followed by an event; the rate counts every lane-frame submitted in the
window over the wall time until the last of them is on the host.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import check, programs, scenes
from portbench import trace as tr


@dataclass
class Run:
    setup_s: float
    window_s: float
    steps: int
    lanes: int
    outputs: np.ndarray            # (steps, B, P) float32
    step_ms: list
    memory_peak_bytes: int
    window_seed: int
    bank: scenes.SceneBank
    trace: tr.Trace | None = None
    error: str | None = None       # the step error that ended the control's window early


def window_seed(seed: int) -> int:
    return (int(seed) * 2654435761 + 97) % 2**63


def schedule(i: int, K: int):
    """(round of sequences, frame) of window step i."""
    return divmod(i, K)


def frame_inputs(api, bank: scenes.SceneBank, B: int, i: int, rows=None):
    q, k = schedule(i, bank.K)
    lanes = scenes.lane_scenes(B, bank.S, q, bank.device)
    return api.FrameInputs(**bank.gather(lanes if rows is None else lanes[rows], k))


@contextlib.contextmanager
def wrapped_layers(api, spans: tr.Spans):
    """Span wrappers around the attributes the batched step looks up, while
    the block runs: the frontend and the backend (the step has to be built
    inside the block), and the stereo match and the IMU preintegration that
    the frontend calls."""
    b = api.batched
    saved = [(b, "frontend_step"), (b, "_backend_step"), (api.stereo, "stereo_track"), (api.imu, "preintegrate")]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    make_backend = b._backend_step
    b.frontend_step = spans.wrap("frontend", b.frontend_step)
    b._backend_step = lambda cfg, pipelined: spans.wrap("backend", make_backend(cfg, pipelined))
    api.stereo.stereo_track = spans.wrap("frontend.stereo", api.stereo.stereo_track)
    api.imu.preintegrate = spans.wrap("frontend.imu", api.imu.preintegrate)
    try:
        yield
    finally:
        for m, a, f in saved:
            setattr(m, a, f)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, control: bool = False,
        wrap_step=None, log=print) -> Run:
    """One run of the cell: set-up, warm-up, the measured window. The
    program steps, or with `control` the benchmark's frozen copy of its step
    with TF32 matrix products, whose window ends at a step that raises and
    keeps the steps before it (the control's readings); `wrap_step` wraps
    the built step (the tests' planted faults)."""
    api = programs.load("frozen" if control else "port")
    spans = tr.Spans()
    with wrapped_layers(api, spans) if trace else contextlib.nullcontext():
        return _run(api, spans, cell, seed, seconds, trace, device, t_start, control, wrap_step, log)


def _run(api, spans, cell, seed, seconds, trace, device, t_start, control, wrap_step, log) -> Run:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    traffic = cell.traffic
    B, S = traffic["lanes"], traffic["scenes"]
    if B % S:
        raise ValueError(f"{B} lanes do not divide over {S} scenes")
    torch.backends.cuda.matmul.allow_tf32 = control

    t = time.perf_counter()
    bank = scenes.SceneBank(seed, traffic, cell.config, dev)
    for line in bank.check_visible(traffic["objects"]["min_visible_px"]):
        log(line)
    if cuda:
        torch.cuda.synchronize()
    log(f"scene bank: {bank.S} scenes x {bank.K} frames, objects {bank.object_counts}, "
        f"{time.perf_counter() - t:.3f} s")

    cfg, intr = programs.build(api, cell.config)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2**63)
    step, init_fn = api.batched.make_batched_pipeline(cfg, intr, gen)
    if wrap_step is not None:
        step = wrap_step(step)
    P = check.width(cfg.backend.max_objects)

    def one(states, i, row, ev=None):
        if i > 0 and schedule(i, bank.K)[1] == 0:    # the lanes' next sequences
            states = init_fn(B, dev)
        states, out = step(states, frame_inputs(api, bank, B, i))
        row.copy_(check.pack(out), non_blocking=cuda)
        if ev is not None:
            ev.record()
        return states

    step_span = spans.wrap("outside the program's step", one) if trace else one

    # warm-up: every shape the window reaches, on the cell's B
    if cuda:
        torch.linalg.eigh(torch.eye(8, device=dev).expand(2, 8, 8).contiguous())
        if trace:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=dev).add_(1)
    scratch = torch.empty((B, P), dtype=torch.float32, pin_memory=cuda)
    states = init_fn(B, dev)
    warm_s = []
    for i in range(traffic["warmup_frames"]):
        t = time.perf_counter()
        states = one(states, i, scratch)
        if cuda:
            torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t)
    log("warm-up s per step: " + " ".join(f"{x:.3f}" for x in warm_s))

    # the window: fresh states at frame 0, the generator re-seeded
    wseed = window_seed(seed)
    gen.manual_seed(wseed)
    states = init_fn(B, dev)
    cap = int(seconds / max(0.5 * min(warm_s[-3:]), 1e-3)) + 8
    rows = [torch.empty((cap, B, P), dtype=torch.float32, pin_memory=cuda)]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(cap)] if cuda else None
    before = programs.launches(api)
    submit, done_host = [], []
    syncs = tr.SyncCounter(cell.root) if trace and cuda else None
    prof = {}
    error = None
    if cuda:
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda.synchronize()
    spans.reset(keep=trace)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with tr.profiled(prof, spans) if trace and cuda else contextlib.nullcontext():
        with syncs or contextlib.nullcontext():
            i = 0
            while i < traffic.get("min_window_steps", 1) or time.perf_counter() - t0 < seconds:
                if i == len(rows) * cap:
                    rows.append(torch.empty((cap, B, P), dtype=torch.float32, pin_memory=cuda))
                    if cuda:
                        events += [torch.cuda.Event(enable_timing=True) for _ in range(cap)]
                submit.append(time.perf_counter() - t0)
                try:
                    states = step_span(states, i, rows[i // cap][i % cap], events[i] if cuda else None)
                except Exception as e:      # noqa: BLE001 - the control's own failure, kept as its reading
                    if not control:
                        raise
                    error = f"step {i}: {type(e).__name__}: {str(e).splitlines()[0]}"
                    submit.pop()
                    break
                if not cuda:
                    done_host.append(time.perf_counter() - t0)
                i += 1
        # the last outputs reach the host (a sync of the harness, not counted)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    n = i
    if cuda:
        done = [e0.elapsed_time(events[j]) / 1e3 for j in range(n)]
    else:
        done = done_host
    step_ms = [(d - s) * 1e3 for s, d in zip(submit, done)]
    outputs = np.concatenate([r.numpy() for r in rows])[:n].copy()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    after = programs.launches(api)
    del states, rows
    torch.backends.cuda.matmul.allow_tf32 = False

    t_rec = None
    if trace:
        t_rec = tr.Trace(lanes=B, steps=n, step_ms=step_ms, spans=dict(spans.total), config=cell.config)
        if syncs is not None:
            t_rec.syncs, t_rec.sync_sites = syncs.count, syncs.sites
        if prof:
            t_rec.busy_s, t_rec.window_s = prof["busy_s"], prof["window_s"]
            t_rec.device_ops, t_rec.kernels, t_rec.idle_gaps = prof["device_ops"], prof["kernels"], prof["idle_gaps"]
        if before is not None:
            t_rec.counters["k1_launches"] = after - before
    return Run(setup_s=setup_s, window_s=window_s, steps=n, lanes=B, outputs=outputs, step_ms=step_ms,
               memory_peak_bytes=int(peak), window_seed=wseed, bank=bank, trace=t_rec, error=error)


def truth_index(bank: scenes.SceneBank, B: int, steps: int):
    """(scene (steps, B), frame (steps,)) that each lane played at window
    steps [0, steps)."""
    qk = [schedule(i, bank.K) for i in range(steps)]
    scene = np.stack([scenes.lane_scenes(B, bank.S, q, "cpu").numpy() for q, _ in qk]) if qk else np.zeros((0, B), int)
    return scene, np.array([k for _, k in qk], dtype=np.int64)


def steps_for(traffic_check: dict, steps: int) -> int:
    """How many of the window's first steps the reference replays: a share
    of them, at most `max_steps`, so that the replay stays shorter than the
    window however fast the program steps."""
    share, most = traffic_check["share_of_window"], traffic_check["max_steps"]
    return max(1, min(steps, most, math.floor(share * steps)))
