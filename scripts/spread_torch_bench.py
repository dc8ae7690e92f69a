"""Spread of repeated runs of the port's timing programs on one card.

Runs `python -m dynosam_tpu_torch.bench --steps STEPS` (the command as a
user runs it: the supervising parent and its worker) `--bench-runs` times
and bench_table's fused-synth row (`python -m dynosam_tpu_torch.bench_table
--skip` every other row) `--table-runs` times, each in a fresh process, one
after another. For each run: the frames/s, the ms per frame of the timed
loop, the first frame's seconds, the host syncs per frame and (bench) the
per-step host ms at p10 / p50 / p90 of the synchronised pass after the
timed loop; the card's SM clock, power draw and temperature before each
run. Then each metric's median and (max - min) / median over the runs.
Compare two machines' files with `--compare A.json B.json`.

Usage: python scripts/spread_torch_bench.py [--bench-runs 5] [--table-runs 3]
       [--steps 30] [--out results/torch/spread.json]
       python scripts/spread_torch_bench.py --compare A.json B.json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _num(pattern, text):
    m = re.search(pattern, text)
    return float(m.group(1)) if m else None


def run_bench(steps):
    p = subprocess.run([sys.executable, "-m", "dynosam_tpu_torch.bench", "--steps", str(steps)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1800)
    if p.returncode != 0:
        raise RuntimeError(f"bench rc={p.returncode}\n{p.stderr[-4000:]}")
    (line,) = p.stdout.splitlines()
    return {"fps": json.loads(line)["value"], "ms_per_frame": _num(r"per-frame=([\d.]+)ms", p.stderr),
            "first_s": _num(r"first-frame=([\d.]+)s", p.stderr),
            "syncs_per_frame": _num(r"host syncs per frame=([\d.]+)", p.stderr),
            "p10_ms": _num(r"p10 ([\d.]+)", p.stderr), "p50_ms": _num(r"p50 ([\d.]+)", p.stderr),
            "p90_ms": _num(r"p90 ([\d.]+)", p.stderr)}


def run_table_row(row="fused-synth"):
    from dynosam_tpu_torch.bench_table import ROWS

    with tempfile.TemporaryDirectory() as tmp:
        p = subprocess.run([sys.executable, "-m", "dynosam_tpu_torch.bench_table", "--out",
                            os.path.join(tmp, "t.md"), "--skip", *[r for r in ROWS if r != row]], cwd=ROOT,
                           capture_output=True, text=True, timeout=1800)
    if p.returncode != 0:
        raise RuntimeError(f"bench_table rc={p.returncode}\n{p.stderr[-4000:]}")
    rows = dict(json.loads(p.stdout.strip().splitlines()[-1])["rows"])
    return {"fps": rows[row], "ms_per_frame": _num(r"([\d.]+) ms/frame", p.stdout),
            "first_s": _num(r"first ([\d.]+) s", p.stdout), "busy_ms": _num(r"busy ([\d.]+) ms/frame", p.stdout),
            "idle": _num(r"idle ([\d.]+)", p.stdout)}


def summary(runs, keys=("fps", "ms_per_frame", "p50_ms")):
    out = {}
    for k in keys:
        v = [r[k] for r in runs if r.get(k) is not None]
        if v:
            med = statistics.median(v)
            out[k] = {"values": v, "median": med, "spread": (max(v) - min(v)) / med}
    return out


def compare(paths):
    """Each machine's medians and spreads, and the spread of all runs
    pooled and of the machines' medians."""
    data = [json.load(open(p)) for p in paths]
    for name in ("bench", "fused_synth"):
        pooled = [r for d in data for r in d[name]]
        meds = [statistics.median(r["fps"] for r in d[name]) for d in data]
        print(f"{name}: " + "; ".join(f"{d['card']} {d['summary'][name]['fps']['median']:.4f} frames/s "
                                      f"(spread {d['summary'][name]['fps']['spread']:.2%})" for d in data)
              + f"; pooled {summary(pooled)['fps']['spread']:.2%}, between medians "
              f"{(max(meds) - min(meds)) / statistics.median(meds):.2%}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bench-runs", type=int, default=5)
    ap.add_argument("--table-runs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=30, help="bench's synchronised pass, steps")
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "torch", "spread.json"))
    ap.add_argument("--compare", nargs="+", default=None, help="spread files of several machines")
    args = ap.parse_args()
    if args.compare:
        compare(args.compare)
        return
    card = smi("name,power.limit")
    state = "clocks.sm,power.draw,temperature.gpu"
    bench_runs, table_runs = [], []
    for k in range(args.bench_runs):
        before = smi(state)
        r = dict(run_bench(args.steps), card_before=before)
        bench_runs.append(r)
        print(f"bench run {k}: {json.dumps(r)}", flush=True)
    for k in range(args.table_runs):
        before = smi(state)
        r = dict(run_table_row(), card_before=before)
        table_runs.append(r)
        print(f"fused-synth run {k}: {json.dumps(r)}", flush=True)
    res = {"card": card, "bench": bench_runs, "fused_synth": table_runs,
           "summary": {"bench": summary(bench_runs), "fused_synth": summary(table_runs)}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    for name, s in res["summary"].items():
        for k, v in s.items():
            print(f"{card} | {name} {k}: median {v['median']:.4f}, (max - min) / median {v['spread']:.2%}, "
                  f"values {[round(x, 4) for x in v['values']]}", flush=True)


if __name__ == "__main__":
    main()
