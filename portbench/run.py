"""One run of one benchmark cell of the port, `dynosam_tpu_torch`, on the
card it is started on.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in BENCHMARK.json and its configuration, traffic and
limits files by name, renders the cell's scenes on the card from the seed,
warms the program up on the cell's own shapes, measures for `--seconds`,
then replays a sample of the window's lanes through the plain reference and
compares, and holds every lane to the scenes' ground truth. With `--trace 0` the last line of standard output carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics read from
the same kind of run under the profiler. The compared numbers and their
limits are the last lines of standard error and the result's last key.

It exits non-zero and prints no result without a CUDA card (it never falls
back to the CPU), when the cell or the program cannot be loaded, or when
JAX or the JAX package was loaded in the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# every kernel cache a library might keep goes to a fixed place in the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, reference, spec  # noqa: E402
from portbench import trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dynosam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (the port's name begins with the package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def end_to_end(name: str, run, attempted: int):
    if name == "frames_per_s":
        return attempted / run.window_s
    if name == "setup_s":
        return run.setup_s
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def run_cell(root, workload, seed, seconds, trace, device="cuda", t_start=None, control=False,
             wrap_step=None, log=None) -> dict:
    """One run -> the result's dict (without printing it), with every
    compared number, limited or not, under `numbers`. `control` puts the
    control in the program's place (`drivers.lockstep.run`)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = spec.load_cell(root, workload)
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    run = driver.run(cell, seed, seconds, bool(trace), device, T_START if t_start is None else t_start,
                     control=control, wrap_step=wrap_step, log=log)
    J = cell.config["settings"]["backend"]["max_objects"]
    attempted = run.lanes * run.steps
    failed = int((~check.finite_lanes(run.outputs, J)).sum())
    log(f"window: {run.steps} steps x {run.lanes} lanes in {run.window_s:.4f} s, set-up {run.setup_s:.4f} s, "
        f"memory peak {run.memory_peak_bytes} B" + (f", stopped at {run.error}" if run.error else ""))

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(root, m["name"])(run.trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(end_to_end(m["name"], run, attempted)), "unit": m["unit"]}
                   for m in cell.end_to_end}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        t = run.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(t.kernels), "idle_gaps": [list(g) for g in t.idle_gaps]}
        log(f"host syncs {t.syncs} at {t.sync_sites}; spans {t.spans}; counters {t.counters}")

    # the comparison, once the program's state is freed
    if cuda:
        torch.cuda.empty_cache()
    chk = cell.traffic["check"]
    rows = check.sample_lanes(seed, run.lanes, cell.traffic["scenes"], chk["lanes"])
    # a tolerated error (the control's) ends the window early: all its steps
    steps = run.steps if run.error else driver.steps_for(chk, run.steps)
    t0 = time.perf_counter()
    ref = reference.replay(cell, run.bank, rows, steps, run.window_seed, device)
    numbers = check.numbers(run.outputs[:steps, rows], ref, J)
    g = check.gaps(run.outputs[:steps, rows], ref, J)
    for k in ("cam_t_m", "frontend_t_m", "motion_t_m"):
        log(f"{k} widest per step: " + " ".join(f"{x:.3g}" for x in g[k].max(1)))
        log(f"{k} widest per lane: " + " ".join(f"{x:.3g}" for x in g[k].max(0)))
    log(f"reference: lanes {rows}, {steps} of {run.steps} steps, {time.perf_counter() - t0:.3f} s")
    # every lane against the scenes' ground truth, over a fixed count of steps
    n_truth = run.steps if run.error else min(run.steps, chk["truth_steps"])
    scene_of, frame_of = driver.truth_index(run.bank, run.lanes, n_truth)
    numbers.update(check.truth_numbers(run.outputs[:n_truth], scene_of, frame_of, run.bank, J,
                                       chk["truth_from_frame"]))
    log("numbers: " + json.dumps(numbers))
    result["numbers"] = numbers
    checks = {"nonfinite_lane_frames": {"value": failed + (run.lanes if run.error else 0), "limit": 0}}
    checks.update({k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()})
    result["correct"] = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = spec.load_cell(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); the benchmark does not run on the CPU",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
