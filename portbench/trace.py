"""What a `--trace 1` run records, and the arithmetic that turns it into
the readers' inputs.

- Spans: host-clock ranges that the benchmark's own wrappers put around
  the program's layer entries (the program is not edited), each also a
  `torch.profiler.record_function` range of the same name.
- Host syncs: torch's sync debug mode warns at each host-device
  synchronisation; the warnings are counted by their Python site (the
  arithmetic of the port's `timing.py::SyncCounter`).
- Device time: the profiler's raw device events (kernels, copies, fills),
  summed without building its event tree (the port's
  `timing.py::device_busy`), traced with the device activity alone (the
  host's ops are not recorded, which would slow the host-bound step
  further), and the idle gaps between them, each named by the innermost
  span open on the host at its middle.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    """Everything a per-layer reader may read; a reader that finds its
    input missing returns None."""

    lanes: int
    steps: int                                  # window steps
    step_ms: list                               # per window step, submit -> outputs on the host
    spans: dict = field(default_factory=dict)   # {name: total host s over the window}
    syncs: int | None = None
    sync_sites: dict = field(default_factory=dict)
    busy_s: float | None = None                 # device busy time in the traced window
    window_s: float | None = None               # the traced window's wall time
    device_ops: int | None = None
    kernels: dict = field(default_factory=dict)  # {device op name: [seconds per event]}
    idle_gaps: list = field(default_factory=list)  # [(host activity, seconds)], longest first
    counters: dict = field(default_factory=dict)   # the program's own counts over the window
    config: dict = field(default_factory=dict)


class Spans:
    """Host-clock spans around wrapped callables: totalled by name, and
    kept as (start ns, end ns, name) intervals while `keep` is set."""

    def __init__(self):
        self.total = {}
        self.intervals = []
        self.keep = False

    def reset(self, keep: bool):
        self.total.clear()
        self.intervals.clear()
        self.keep = keep

    def wrap(self, name: str, fn):
        label = SPAN_PREFIX + name

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter_ns()
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            t1 = time.perf_counter_ns()
            self.total[name] = self.total.get(name, 0.0) + (t1 - t0) * 1e-9
            if self.keep:
                self.intervals.append((t0, t1, name))
            return out

        return wrapped


class SyncCounter:
    """Counts host-device synchronisations inside a `with` block, by site."""

    def __init__(self, root: str):
        self.root = root
        self.count = 0
        self.sites = {}

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        syncs = [w for w in self._seen if "synchroniz" in str(w.message)]
        self.count = len(syncs)
        for w in syncs:
            site = f"{os.path.relpath(w.filename, self.root)}:{w.lineno}"
            self.sites[site] = self.sites.get(site, 0) + 1
        return False


@contextlib.contextmanager
def profiled(result: dict, spans: Spans):
    """torch.profiler's device tracing over the block; on exit `result`
    gets the raw events' summary (`summarize`). The block starts with the
    device idle and one short anchor kernel launched at a known host time,
    which puts the host's spans on the device's clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        anchor_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    result.update(summarize(prof.profiler.kineto_results.events(), wall, spans.intervals, anchor_ns))


def summarize(events, wall_s: float, spans=(), anchor_ns=None) -> dict:
    """Raw profiler events -> {busy_s, window_s, device_ops, kernels,
    idle_gaps}. The earliest device event is the anchor and is left out;
    busy time is the sum of the other device events' durations; the idle
    gaps are the holes in their union, each named by the innermost span
    open on the host at the gap's middle (host ns + the anchor's offset)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.start_ns(), e.duration_ns(), e.name()) for e in events
                 if e.device_type() == cuda and not e.is_user_annotation())
    offset = dev[0][0] - anchor_ns if dev and anchor_ns is not None else 0
    dev = dev[1:] if anchor_ns is not None else dev
    kernels = {}
    for _, d, name in dev:
        kernels.setdefault(name, []).append(d * 1e-9)
    gaps = []
    end = None
    for s, d, _ in dev:
        if end is not None and s > end:
            gaps.append((end, s))
        end = s + d if end is None else max(end, s + d)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2 - offset
        open_ = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = min(open_, key=lambda sp: sp[1] - sp[0])[2] if open_ else "outside the program's step"
        named.append((label, (b - a) * 1e-9))
    return {"busy_s": sum(d for _, d, _ in dev) * 1e-9, "window_s": wall_s, "device_ops": len(dev),
            "kernels": kernels, "idle_gaps": named}


def top_device_ops(kernels: dict, n: int = 10) -> list:
    """[[name, total s]] of the `n` device ops that took most time."""
    tot = sorted(((k, sum(v)) for k, v in kernels.items()), key=lambda kv: -kv[1])
    return [[k, v] for k, v in tot[:n]]
