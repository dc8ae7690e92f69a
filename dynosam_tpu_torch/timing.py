"""What the timing programs, multichip.py and chip_smoke.py share: the card's
line, the kernel build, the kernels' launch counts, host-sync counting,
device busy time from torch.profiler and bench.py's timing of a step.

Every program times a step the one way `time_steps` does, so the programs'
numbers stay comparable.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def prepare(device, detector=False) -> str:
    """Refuse a missing card, build the kernels the programs launch (K1;
    with `detector` K2 too) and return `card_line(device)`."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass --device cpu to run on the CPU)")
        from dynosam_tpu_torch.ops.cuda import _build
        from dynosam_tpu_torch.ops.cuda import mask_combine as mc
        from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

        for src in (st.SOURCE, mc.SOURCE) if detector else (st.SOURCE,):
            _build.build(src)
    return card_line(device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _wrappers():
    """{kernel: its wrapper, which counts its launches}: K1 (fused; K1b on
    a batch), K1's map entry, K2's entries A and B."""
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    return {"K1": st.shi_tomasi_cell_max, "K1 map": st.shi_tomasi_response, "K2": mc.mask_combine,
            "K2 label": mc.mask_label}


def counts() -> dict:
    """{kernel: launches counted by its wrapper}."""
    return {k: fn.launches for k, fn in _wrappers().items()}


def zero_counts():
    """Every wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def since(before: dict) -> dict:
    """Each kernel's launches since `before` (an earlier `counts()`); the
    programs never reset the counts, which belong to whoever runs them."""
    return {k: v - before[k] for k, v in counts().items()}


class SyncCounter:
    """Counts the host-device synchronizations inside a `with` block (on a
    CUDA device; elsewhere `count` stays None): torch's sync debug mode
    warns on each one and the warnings are recorded, by their Python site."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"
        self.count = None
        self.sites = {}

    def __enter__(self):
        if self.on:
            self._catch = warnings.catch_warnings(record=True)
            self._seen = self._catch.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode("default")
            self._catch.__exit__(*exc)
            syncs = [w for w in self._seen if "synchroniz" in str(w.message)]
            self.count = len(syncs)
            for w in syncs:
                site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                self.sites[site] = self.sites.get(site, 0) + 1
        return False

    def per_frame(self, n) -> str:
        return "n/a" if self.count is None else f"{self.count / n:.2f}"

    def top(self, n=6) -> str:
        """The `n` most frequent sites, "file:line xcount", comma-separated."""
        return ", ".join(f"{k} x{v}" for k, v in sorted(self.sites.items(), key=lambda kv: -kv[1])[:n])


def time_steps(step, state, frames, warmup, measure, offset=None, device="cuda", measured=None):
    """bench.py's timing of `step(state, frame) -> (state, out)`: the first
    step, on frames[0], timed apart and synchronised; `warmup - 1` more on
    frames[i % n]; then `measure` steps on frames[(offset + i) % n] (offset
    defaults to `warmup`) with one synchronize at the end of the loop and
    none inside it. `measured`, a context manager, wraps the measured loop.
    -> (state, out of the last step, first step s, s per measured step)."""
    n = len(frames)
    offset = warmup if offset is None else offset
    sync(device)
    t0 = time.perf_counter()
    state, out = step(state, frames[0])
    sync(device)
    first_s = time.perf_counter() - t0
    for i in range(1, warmup):
        state, out = step(state, frames[i % n])
    sync(device)
    t0 = time.perf_counter()
    with measured or contextlib.nullcontext():
        for i in range(measure):
            state, out = step(state, frames[(offset + i) % n])
    sync(device)
    return state, out, first_s, (time.perf_counter() - t0) / measure


def device_busy(device, run, frames: int) -> dict:
    """`run()` (which steps `frames` frames) under torch.profiler's device
    tracing -> device busy ms per frame (the kernels, copies and fills
    summed), device ops per frame and the profiled wall ms per frame. The
    raw trace events are read, without building the profiler's event tree
    (seconds per frame at ~17k device ops). On the CPU, no device time:
    None for each."""
    if torch.device(device).type != "cuda":
        run()
        return {"busy_ms": None, "ops": None, "profiled_ms": None}
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(device)
        wall = time.perf_counter() - t0
    ops = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy_ns = sum(e.duration_ns() for e in ops)
    return {"busy_ms": busy_ns / 1e6 / frames, "ops": len(ops) / frames, "profiled_ms": wall * 1e3 / frames}


def percentiles_ms(times_s) -> dict:
    """{"p10", "p50", "p90"} of per-step seconds, in ms."""
    ms = np.asarray(times_s, dtype=np.float64) * 1e3
    return {f"p{q}": float(np.percentile(ms, q)) for q in (10, 50, 90)}
