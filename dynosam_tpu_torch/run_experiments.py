"""Multi-sequence, multi-configuration experiment runner: the port of
scripts/run_experiments.py.

Every (formulation x optimization mode) cell runs on every sequence through
the port's DynoPipeline and evaluator, and writes per-run CSV logs, the
statistics registry's samples (statistics_samples.csv) and the evaluation
report under <out>/<sequence>/<cell>/; then an aggregate summary.json and
SUMMARY.md with the reference's columns and, where matplotlib is
importable, timing.png. A cell that raises records {"error": ...} and the
sweep goes on, as the reference's does.

  python -m dynosam_tpu_torch.run_experiments --out results/torch/exp1 \\
      --sequence kitti:tests/fixtures/kitti_fixture [--sequence synthetic:] \\
      [--frames 40] [--forms 0,1,3] [--modes 0,1,2] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from dynosam_tpu_torch.config import BackendParams, DynoConfig, FrontendParams, OptimizerParams, TrackerParams

FORMS = {0: "wcme", 1: "wcpe", 3: "hybrid"}
MODES = {0: "batch", 1: "sliding", 2: "incremental"}
DATASET_TYPES = {
    "kitti": 0, "vkitti": 1, "cluster": 2, "omd": 3, "aria": 4,
    "tartanair": 5, "viode": 6, "synthetic": 100,
}
DEFAULT_OUT = os.path.join("results", "torch", "experiments")


def make_config(form: int, mode: int, frames: int) -> DynoConfig:
    """The reference's sweep configuration: 8 object slots, 512 static and
    768 dynamic features, cell 8; a window of all the frames in batch mode,
    else 8; 10 optimizer iterations."""
    return DynoConfig(
        frontend=FrontendParams(
            max_objects=8,
            tracker=TrackerParams(
                max_features_per_frame=512,
                min_features_per_frame=200,
                max_dynamic_features_per_frame=768,
                detection_cell_size=8,
                min_corner_response=1e-6,
            ),
        ),
        backend=BackendParams(
            optimization_mode=mode,
            backend_updater_enum=form,
            max_frames=frames if mode == 0 else 8,
            optimizer=OptimizerParams(max_iterations=10),
        ),
    )


def run_cell(ds, form: int, mode: int, frames: int, out_dir: str, device="cuda", seed: int = 0) -> dict:
    """One cell over the first `frames` frames of `ds` -> the camera's ATE,
    rotation and RPE, the objects' AME rms (over objects) and mean median,
    the per-object report, and the mean milliseconds of each timing tag."""
    from dynosam_tpu_torch.eval.evaluator import DatasetEvaluator
    from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline
    from dynosam_tpu_torch.utils.stats import Statistics

    Statistics.reset()
    os.makedirs(out_dir, exist_ok=True)
    cfg = make_config(form, mode, frames)
    pipe = DynoPipeline(cfg, ds.intrinsics(), output_path=out_dir, device=device, seed=seed)
    for k in range(frames):
        pipe.process_frame(ds.frame(k), ds.ground_truth(k))
    pipe.finish()
    stats_csv = os.path.join(out_dir, "statistics_samples.csv")
    Statistics.write_all_samples_to_csv(stats_csv)
    with open(DatasetEvaluator(out_dir).write_report()) as fh:
        rep = json.load(fh)
    mod = next(iter(rep.values()))
    cam = mod["camera"]
    objs = mod.get("objects", {})
    ame_rms = [o["ame_trans_rmse"] for o in objs.values()]
    ame_med = [o.get("ame_trans_median", float("nan")) for o in objs.values()]
    return {
        "ate_trans_rmse": cam["ate_unaligned_trans_rmse"],
        "ate_rot_rmse": cam["ate_rot_rmse"],
        "rpe_trans_rmse": cam["rpe_trans_rmse"],
        "ame_trans_rmse": float(np.sqrt(np.mean(np.square(ame_rms)))) if ame_rms else float("nan"),
        "ame_trans_median": float(np.mean(ame_med)) if ame_med else float("nan"),
        "objects": objs,
        "timing_ms": timing_summary(stats_csv),
    }


def timing_summary(stats_csv: str) -> dict:
    """Mean per-tag milliseconds from a statistics_samples.csv (columns of
    unequal length padded with empty cells)."""
    if not os.path.exists(stats_csv):
        return {}
    with open(stats_csv) as fh:
        rows = list(csv.reader(fh))
    if not rows:
        return {}
    header = rows[0]
    out = {}
    cols = list(zip(*[r + [""] * (len(header) - len(r)) for r in rows[1:]]))
    for name, col in zip(header, cols):
        vals = [float(v) for v in col if v not in ("", None)]
        if vals:
            out[name] = float(np.mean(vals))
    return out


def plot_timing(summary: dict, out_png: str) -> bool:
    """Stacked per-cell timing bars -> whether the figure was written (only
    where matplotlib is importable, as in the reference)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    cells = [(f"{seq}/{cell}", r["timing_ms"]) for seq, cs in summary.items() for cell, r in cs.items()
             if r.get("timing_ms")]
    if not cells:
        return False
    tags = sorted({t for _, tm in cells for t in tm})
    fig, ax = plt.subplots(figsize=(max(6, len(cells) * 0.9), 4))
    bottom = np.zeros(len(cells))
    for tag in tags:
        vals = np.array([tm.get(tag, 0.0) for _, tm in cells])
        ax.bar([c for c, _ in cells], vals, bottom=bottom, label=tag)
        bottom += vals
    ax.set_ylabel("mean per-frame time [ms]")
    ax.legend(fontsize=6)
    plt.xticks(rotation=45, ha="right", fontsize=6)
    plt.tight_layout()
    plt.savefig(out_png, dpi=120)
    plt.close(fig)
    return True


class SyntheticDataset:
    """A DenseScenario behind the dataset interface the runner reads."""

    def __init__(self, dense):
        self.d = dense

    def __len__(self):
        return self.d.scn.spec.num_frames

    def intrinsics(self):
        return self.d.intr

    def frame(self, k):
        return self.d.frame(k)

    def ground_truth(self, k):
        return self.d.scn.ground_truth(k)


def open_sequence(seq: str, frames: int, device="cuda"):
    """"type:path" -> (name, dataset); `synthetic:` is the reference's
    default dense scenario over `frames` frames."""
    kind, _, path = seq.partition(":")
    if kind not in DATASET_TYPES:
        raise ValueError(f"unknown sequence type {kind!r}: one of {sorted(DATASET_TYPES)}")
    name = f"{kind}_{os.path.basename(path.rstrip('/')) or kind}"
    if kind == "synthetic":
        from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario

        return name, SyntheticDataset(default_dense_scenario(num_frames=frames, device=device))
    from dynosam_tpu_torch.dataproviders.base import create_dataset

    return name, create_dataset(DATASET_TYPES[kind], path, device=device)


def write_summary_md(summary: dict, path: str) -> None:
    """SUMMARY.md: per sequence, each cell's ATE, AME rms and median (cm)
    and mean frontend / backend ms."""
    with open(path, "w") as f:
        f.write("# Experiment summary\n\n")
        for name, cells in summary.items():
            f.write(f"## {name}\n\n| config | ATE (cm) | AME rms (cm) | AME med (cm) | frontend ms | backend ms |\n"
                    "|---|---|---|---|---|---|\n")
            for cell, r in cells.items():
                if "error" in r:
                    f.write(f"| {cell} | ERROR | | | | |\n")
                    continue
                tm = r.get("timing_ms", {})
                fe = tm.get("pipeline.frontend", float("nan"))
                be = tm.get("pipeline.backend", float("nan"))
                f.write(f"| {cell} | {r['ate_trans_rmse']*100:.3f} | {r['ame_trans_rmse']*100:.3f} | "
                        f"{r['ame_trans_median']*100:.3f} | {fe:.2f} | {be:.2f} |\n")
            f.write("\n")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sequence", action="append", default=[],
                    help="type:path, e.g. kitti:tests/fixtures/kitti_fixture (repeatable)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--forms", default="0,1,3")
    ap.add_argument("--modes", default="0,1,2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sequences = args.sequence or ["kitti:tests/fixtures/kitti_fixture"]
    forms = [int(v) for v in args.forms.split(",")]
    modes = [int(v) for v in args.modes.split(",")]

    summary = {}
    for seq in sequences:
        name, ds = open_sequence(seq, args.frames, args.device)
        n = min(args.frames, len(ds))
        summary[name] = {}
        for form in forms:
            for mode in modes:
                cell = f"{FORMS[form]}_{MODES[mode]}"
                out_dir = os.path.join(args.out, name, cell)
                print(f"== {name} / {cell} ({n} frames)", flush=True)
                try:
                    r = run_cell(ds, form, mode, n, out_dir, device=args.device)
                except Exception as e:  # noqa: BLE001 - a failed cell is recorded and the sweep goes on
                    print(f"   FAILED: {type(e).__name__}: {e}", flush=True)
                    r = {"error": f"{type(e).__name__}: {e}"}
                summary[name][cell] = r
                if "ate_trans_rmse" in r:
                    print(f"   ATE {r['ate_trans_rmse']*100:.3f} cm  AME rms {r['ame_trans_rmse']*100:.3f} cm  "
                          f"med {r['ame_trans_median']*100:.3f} cm", flush=True)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    write_summary_md(summary, os.path.join(args.out, "SUMMARY.md"))
    written = ["summary.json", "SUMMARY.md"]
    if plot_timing(summary, os.path.join(args.out, "timing.png")):
        written.append("timing.png")
    print(f"wrote {', '.join(os.path.join(args.out, w) for w in written)}")
    return summary


if __name__ == "__main__":
    main()
