"""Global statistics registry + timers (port of dynosam_tpu/utils/stats.py),
and the program's own trace.

A process-global tag -> sample collector with mean/min/max/stddev and the
reference's `statistics_samples.csv` layout (one column per tag, rows are
samples). Times are host milliseconds. A timer told to block on a CUDA
tensor synchronizes that tensor's device before it stops the clock, so the
sample covers the device work queued inside it; otherwise it takes no host
sync.

The trace: inside a `tracing()` block, `span(name)` records host-clock
ranges (`time.perf_counter_ns`, each with its parent span and the step it
belongs to; while a torch profiler runs, also a
`torch.profiler.record_function` range, which a profiler alone reads) and
`count` / `count_tensor` add to named counters; `timed` and `Timer` record
a span of their tag too. Outside the block each of them costs one test of
the current recorder. Recording adds no torch operation and no host sync:
`count_tensor` keeps a reference to a tensor the program already computed,
and the references are summed when the block exits.
"""

from __future__ import annotations

import csv
import itertools
import math
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List

import torch


class _Collector:
    __slots__ = ("samples",)

    def __init__(self):
        self.samples: List[float] = []

    def add(self, v: float):
        self.samples.append(float(v))

    @property
    def count(self):
        return len(self.samples)

    @property
    def mean(self):
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def minimum(self):
        return min(self.samples) if self.samples else 0.0

    @property
    def maximum(self):
        return max(self.samples) if self.samples else 0.0

    @property
    def stddev(self):
        n = len(self.samples)
        if n < 2:
            return 0.0
        m = self.mean
        return math.sqrt(sum((x - m) ** 2 for x in self.samples) / (n - 1))


class Statistics:
    """Process-global tag -> sample registry."""

    _collectors: Dict[str, _Collector] = {}

    @classmethod
    def get(cls, tag: str) -> _Collector:
        if tag not in cls._collectors:
            cls._collectors[tag] = _Collector()
        return cls._collectors[tag]

    @classmethod
    def add_sample(cls, tag: str, value: float):
        cls.get(tag).add(value)

    @classmethod
    def reset(cls):
        cls._collectors = {}

    @classmethod
    def tags(cls):
        return sorted(cls._collectors)

    @classmethod
    def summary(cls) -> str:
        lines = [f"{'tag':<48} {'n':>6} {'mean':>12} {'min':>12} {'max':>12} {'std':>12}"]
        for tag in cls.tags():
            c = cls._collectors[tag]
            lines.append(
                f"{tag:<48} {c.count:>6} {c.mean:>12.6f} {c.minimum:>12.6f}"
                f" {c.maximum:>12.6f} {c.stddev:>12.6f}"
            )
        return "\n".join(lines)

    @classmethod
    def write_all_samples_to_csv(cls, path: str):
        """One column per tag, rows are samples."""
        tags = cls.tags()
        if not tags:
            return
        rows = max(cls._collectors[t].count for t in tags)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(tags)
            for i in range(rows):
                w.writerow(
                    [
                        cls._collectors[t].samples[i]
                        if i < cls._collectors[t].count
                        else ""
                        for t in tags
                    ]
                )


class Recorder:
    """What one `tracing()` block recorded.

    `spans`: (start ns, end ns, name, span id, parent id, step id) in the
    order the spans ended; the parent is the span open on the same thread
    when the span started (None at the top), the step id the call index of
    the enclosing span opened with `new_step` (None outside one).
    `counters`: {name: int}, the `count_tensor` sums included once the
    block has exited."""

    def __init__(self):
        self.spans: list = []
        self.counters: Dict[str, int] = {}
        self._tensors: list = []
        self._ids = itertools.count()
        self._steps = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _reduce_tensors(self):
        for name, t in self._tensors:
            self.counters[name] = self.counters.get(name, 0) + int(t.sum())
        self._tensors.clear()


def host_times(spans) -> Dict[str, tuple]:
    """{name: (total s, self s)} over a Recorder's spans (or a selection of
    them with their children): a span's self time is its duration less its
    children's."""
    child_ns: Dict[int, int] = {}
    for s0, s1, _, _, parent, _ in spans:
        if parent is not None:
            child_ns[parent] = child_ns.get(parent, 0) + s1 - s0
    out: Dict[str, list] = {}
    for s0, s1, name, sid, _, _ in spans:
        acc = out.setdefault(name, [0, 0])
        acc[0] += s1 - s0
        acc[1] += s1 - s0 - child_ns.get(sid, 0)
    return {k: (v[0] * 1e-9, v[1] * 1e-9) for k, v in out.items()}


class _Span:
    """One range of a recorder: entered and exited by `with`, or by a
    Timer's start and stop. Exiting it also ends the spans opened inside it
    and left open."""

    __slots__ = ("rec", "name", "new_step", "sid", "parent", "step", "start", "rf")

    def __init__(self, rec: Recorder, name: str, new_step: bool = False):
        self.rec, self.name, self.new_step = rec, name, new_step

    def __enter__(self):
        stack = self.rec._stack()
        up = stack[-1] if stack else None
        self.sid = next(self.rec._ids)
        self.parent = up.sid if up is not None else None
        self.step = next(self.rec._steps) if self.new_step else (up.step if up is not None else None)
        self.rf = torch.profiler.record_function(self.name) if torch.autograd._profiler_enabled() else None
        if self.rf is not None:
            self.rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = self.rec._stack()
        if self in stack:
            del stack[stack.index(self):]
        self.rec.spans.append((self.start, end, self.name, self.sid, self.parent, self.step))
        return False


_recorder = None            # the Recorder of the innermost open tracing() block
_OFF = nullcontext()


@contextmanager
def tracing():
    """Record spans and counters while the block runs; yields the Recorder.
    The `count_tensor` references are summed on exit, so a caller on a
    device synchronizes before leaving the block."""
    global _recorder
    rec, outer = Recorder(), _recorder
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer
        rec._reduce_tensors()


def span(name: str, new_step: bool = False):
    """A context manager recording the block as span `name` while tracing
    is on; `new_step` makes it a step: the spans inside it take its call
    index as their step id."""
    rec = _recorder
    return _OFF if rec is None else _Span(rec, name, new_step)


def count(name: str, n: int):
    """Add the host number `n` to counter `name` while tracing is on."""
    rec = _recorder
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def count_tensor(name: str, t: torch.Tensor):
    """Add the sum of `t` to counter `name` while tracing is on: a reference
    is kept, and summed when the tracing block exits. `t` must not be
    written in place afterwards."""
    rec = _recorder
    if rec is not None:
        rec._tensors.append((name, t))


def _block(t):
    """Wait for the device work producing tensor `t` (a CUDA tensor only)."""
    if torch.is_tensor(t) and t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextmanager
def timed(tag: str, block_on=None):
    """Timer feeding Statistics in milliseconds; `block_on`: a tensor whose
    device is synchronized before the clock stops. A span of `tag` while
    tracing is on."""
    start = time.perf_counter()
    with span(tag):
        try:
            yield
        finally:
            _block(block_on)
            Statistics.add_sample(tag, (time.perf_counter() - start) * 1e3)


class Timer:
    """Imperative start/stop variant for loops that rebind the blocked value.
    A span of its tag while tracing is on."""

    def __init__(self, tag: str):
        self.tag = tag
        self._start = None
        self._span = None

    def start(self):
        rec = _recorder
        if rec is not None:
            self._span = _Span(rec, self.tag).__enter__()
        self._start = time.perf_counter()
        return self

    def stop(self, block_on=None):
        _block(block_on)
        Statistics.add_sample(self.tag, (time.perf_counter() - self._start) * 1e3)
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
