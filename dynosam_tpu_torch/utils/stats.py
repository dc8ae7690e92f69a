"""Global statistics registry + timers (port of dynosam_tpu/utils/stats.py).

A process-global tag -> sample collector with mean/min/max/stddev and the
reference's `statistics_samples.csv` layout (one column per tag, rows are
samples). Times are host milliseconds. A timer told to block on a CUDA
tensor synchronizes that tensor's device before it stops the clock, so the
sample covers the device work queued inside it; otherwise it takes no host
sync.
"""

from __future__ import annotations

import csv
import math
import time
from contextlib import contextmanager
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


def _block(t):
    """Wait for the device work producing tensor `t` (a CUDA tensor only)."""
    if torch.is_tensor(t) and t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextmanager
def timed(tag: str, block_on=None):
    """Timer feeding Statistics in milliseconds; `block_on`: a tensor whose
    device is synchronized before the clock stops."""
    start = time.perf_counter()
    try:
        yield
    finally:
        _block(block_on)
        Statistics.add_sample(tag, (time.perf_counter() - start) * 1e3)


class Timer:
    """Imperative start/stop variant for loops that rebind the blocked value."""

    def __init__(self, tag: str):
        self.tag = tag
        self._start = None

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self, block_on=None):
        _block(block_on)
        Statistics.add_sample(self.tag, (time.perf_counter() - self._start) * 1e3)
