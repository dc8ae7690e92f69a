"""A benchmark cell of `portbench` run with the port's own trace on
(`dynosam_tpu_torch/utils/stats.py::tracing`): per window step, the host
ms and the device ms of each span of the batched step, the program's
counters, and the idle gaps named by the innermost span of either set, the
benchmark's or the program's.

    python scripts/trace_torch_cells.py --workload kitti-hybrid.sweep --seed 7 --seconds 51 --profile 1

--profile 1 is the run `python -m portbench.run --trace 1` makes (the
benchmark's spans, its sync counter and its device-only profiler), with the
program's tracing entered in the profiler's scope: it adds the cell's
per-layer metrics as portbench reads them, and the device time put down to
the span that launched it (`timing.py::device_by_span`). --profile 0 is
the untraced run with recording on: frames_per_s and setup_s as
`--trace 0` measures them, the cost of recording. Neither replays the
reference: `python -m portbench.run` judges correctness. One JSON line on
standard output (and in --out); it needs a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# shares of two counters: the advanced lanes that took the eigh route, and
# the LM lane-iterations that ran on a lane already converged
SHARES = {"eigh_lane_pct": ("advance.eigh_lanes", "advance.lanes"),
          "lm_idle_iter_pct": ("lm.idle_lane_iterations", "lm.lane_iterations")}


def trace_cell(root, workload, seed, seconds, profile) -> dict:
    from portbench import spec
    from portbench import trace as tr
    from portbench.drivers import lockstep

    from dynosam_tpu_torch import timing
    from dynosam_tpu_torch.utils import stats

    cell = spec.load_cell(root, workload)
    seen = {}
    profiled, summarize = tr.profiled, tr.summarize

    @contextlib.contextmanager
    def profiled_and_recorded(result, spans):
        with stats.tracing() as rec:
            seen["rec"] = rec
            with profiled(result, spans):
                yield

    def summarize_kept(events, wall_s, spans=(), anchor_ns=None):
        seen.update(events=events, anchor_ns=anchor_ns, bench=list(spans))
        return summarize(events, wall_s, spans, anchor_ns)

    tr.profiled, tr.summarize = profiled_and_recorded, summarize_kept
    try:
        if profile:
            run = lockstep.run(cell, seed, seconds, True, "cuda", T_START, log=_log)
            rec, first = seen["rec"], 0
        else:
            with stats.tracing() as rec:
                run = lockstep.run(cell, seed, seconds, False, "cuda", T_START, log=_log)
            first = cell.traffic["warmup_frames"]
    finally:
        tr.profiled, tr.summarize = profiled, summarize

    n = run.steps
    window = [sp for sp in rec.spans if sp[5] is not None and sp[5] >= first]
    out = {"workload": workload, "seed": seed, "profile": profile, "card": timing.card_line("cuda"),
           "frames_per_s": run.lanes * n / run.window_s, "setup_s": run.setup_s, "steps": n, "lanes": run.lanes,
           "host_ms": {k: [v[0] * 1e3 / n, v[1] * 1e3 / n] for k, v in sorted(stats.host_times(window).items())}}
    if not profile:
        return out
    counters = rec.counters
    out["counters"] = {k: v / n for k, v in sorted(counters.items())}
    out.update({k: 100.0 * counters[a] / counters[b] for k, (a, b) in SHARES.items() if counters.get(b)})
    out["metrics"] = {}
    for m in cell.per_layer:
        value = spec.metric_reader(root, m["name"])(run.trace)
        if value is not None:
            out["metrics"][m["name"]] = value
    if "events" in seen:
        bench = [(s0, s1, tr.SPAN_PREFIX + name) for s0, s1, name in seen["bench"]]
        dev = timing.device_by_span(seen["events"], seen["anchor_ns"], rec.spans, other=bench)
        out["device_busy_ms"] = dev["busy_s"] * 1e3 / n
        out["device_ms"] = {k: [v * 1e3 / n, dev["self_s"].get(k, 0.0) * 1e3 / n]
                            for k, v in sorted(dev["span_s"].items())}
        out["unattributed_device_pct"] = 100.0 * dev["unattributed_s"] / dev["busy_s"]
        out["unmatched_device_events"] = dev["unmatched"]
        out["idle_gaps"] = dev["idle_gaps"]
    return out


def _log(line):
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None, help="also append the line to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_torch_cells: no CUDA card; the cells do not run on the CPU", file=sys.stderr)
        return 2
    out = trace_cell(ROOT, args.workload, args.seed, args.seconds, args.profile)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
