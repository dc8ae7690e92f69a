"""Accuracy matrices of the port: every formulation (WCME, WCPE, hybrid)
in every optimization mode, as ATE / AME against ground truth (port of
run_config, run_config_dataset and _matrix of scripts/accuracy_report.py).

Two matrices:
  * synthetic: the dense test scene (default_dense_scenario, analytic
    ground truth) at bench_config.synthetic_accuracy_config, 12 frames;
    camera ATE (unaligned) of the backend and of the frontend, and AME over
    the frames where the backend reports a motion (motion_at);
  * kitti: the committed dyno-KITTI fixture, 60 frames, from disk through
    the CSV logs and DatasetEvaluator (the run_dynosam contract), at
    bench_config.kitti_accuracy_config.

A row that fails fails the run (the reference prints FAILED and goes on).
The table goes to --out, never to ACCURACY.md, which holds the reference's
rows.

Usage: python -m dynosam_tpu_torch.eval.accuracy [--only synthetic|kitti]
    [--frames 12] [--dataset_frames 60] [--out accuracy_port.md]
    [--device cuda] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

FORMS = {0: "WCME", 1: "WCPE", 3: "Hybrid"}
MODES = {0: "full-batch", 1: "sliding-window", 2: "incremental"}
MODE_KEYS = {0: "full_batch", 1: "sliding_window", 2: "incremental"}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "kitti_fixture")


def run_config(dense, formulation: int, mode: int, num_frames: int, device, seed: int = 0) -> dict:
    """One cell on the synthetic dense scene."""
    from dynosam_tpu_torch.bench_config import synthetic_accuracy_config
    from dynosam_tpu_torch.eval import metrics
    from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline

    cfg = synthetic_accuracy_config(MODE_KEYS[mode], num_frames, formulation)
    pipe = DynoPipeline(cfg, dense.intr, device=device, seed=seed)
    pipe.run([dense.frame(k) for k in range(num_frames)])

    gt = dense.scn.X_gt[:num_frames].cpu().numpy()
    ate = metrics.ate(np.stack(pipe.trajectory), gt, align=False)
    ate_fe = metrics.ate(np.stack(pipe.frontend_trajectory), gt, align=False)
    # object motion AME over the frames where the backend reports a motion
    H_est, H_gt = [], []
    for k in range(2, num_frames):
        for j, oid in enumerate(dense.scn.object_ids):
            H = pipe.backend.motion_at(k, object_id=oid)
            if H is None:
                continue
            H_est.append(np.asarray(H))
            H_gt.append(dense.scn.H_gt[j][k].cpu().numpy())
    ame = (metrics.ame(np.stack(H_est), np.stack(H_gt)) if H_est
           else metrics.MetricResult(float("nan"), float("nan"), np.array([]), np.array([])))
    return dict(ate_t=ate.trans_rmse, ate_r=ate.rot_rmse, ate_fe_t=ate_fe.trans_rmse,
                ame_t=ame.trans_rmse, ame_r=ame.rot_rmse, n_motions=len(H_est))


def _summarize(mod: dict) -> dict:
    cam = mod["camera"]
    objs = list(mod.get("objects", {}).values())

    def rms(key):
        v = [o[key] for o in objs]
        return float(np.sqrt(np.mean(np.square(v)))) if v else float("nan")

    def mean(key):
        v = [o.get(key, float("nan")) for o in objs]
        return float(np.mean(v)) if v else float("nan")

    return dict(ate_t=cam["ate_unaligned_trans_rmse"], ate_r=cam["ate_rot_rmse"], rpe_t=cam["rpe_trans_rmse"],
                ame_t=rms("ame_trans_rmse"), ame_r=rms("ame_rot_rmse"),
                # median over frames, averaged over objects: the typical
                # frame (the RMS is ruled by a few information-poor frames)
                ame_t_med=mean("ame_trans_median"), ame_r_med=mean("ame_rot_median"),
                n_motions=sum(o["n_frames"] for o in objs))


def run_config_dataset(ds, formulation: int, mode: int, num_frames: int, device, seed: int = 0) -> dict:
    """One cell on an on-disk dataset, through the CSV logs and
    DatasetEvaluator."""
    from dynosam_tpu_torch.bench_config import kitti_accuracy_config
    from dynosam_tpu_torch.eval.evaluator import DatasetEvaluator
    from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline

    cfg = kitti_accuracy_config(MODE_KEYS[mode], num_frames, formulation)
    out_dir = tempfile.mkdtemp(prefix="acc_")
    try:
        pipe = DynoPipeline(cfg, ds.intrinsics(), output_path=out_dir, device=device, seed=seed)
        for k in range(num_frames):
            pipe.process_frame(ds.frame(k), ds.ground_truth(k))
        pipe.finish()
        rep = DatasetEvaluator(out_dir).run_analysis()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    res = _summarize(rep["dynosam_tpu"])
    # the frontend's own (pre-optimization) estimates, for contrast
    if "frontend" in rep and "camera" in rep["frontend"]:
        fe = _summarize(rep["frontend"])
        res.update(fe_ate_t=fe["ate_t"], fe_ame_t=fe["ame_t"], fe_ame_t_med=fe["ame_t_med"])
    return res


def _matrix(run_one) -> list:
    """Every formulation x mode -> [(formulation, mode, result, seconds)]."""
    rows = []
    for form, fname in FORMS.items():
        for mode, mname in MODES.items():
            t0 = time.perf_counter()
            r = run_one(form, mode)
            dt = time.perf_counter() - t0
            rows.append((fname, mname, r, dt))
            med = f" med {r['ame_t_med'] * 100:6.3f} cm" if "ame_t_med" in r else ""
            print(f"{fname:8s} {mname:16s} ATE {r['ate_t'] * 100:7.3f} cm AME {r['ame_t'] * 100:7.3f} cm{med} "
                  f"rot {r['ame_r']:.5f} rad [{r['n_motions']} motions] {dt:.1f} s", flush=True)
    return rows


def _device_line(device) -> str:
    import torch

    if torch.device(device).type != "cuda":
        return f"device {device}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return f"device {torch.cuda.get_device_name(0)} ({smi[0] if smi else 'nvidia-smi gave nothing'})"


def write_table(path, device_line, frames, rows=None, dataset_frames=None, ds_rows=None):
    with open(path, "w") as f:
        f.write(f"# Accuracy of dynosam_tpu_torch ({device_line})\n\n"
                "Written by `python -m dynosam_tpu_torch.eval.accuracy`. Camera ATE is the\n"
                "unaligned translation RMSE; AME the world-frame object-motion error.\n")
        if rows is not None:
            f.write(f"\n## Synthetic dense scene, {frames} frames\n\n"
                    "| Formulation | Mode | camera ATE (cm) | frontend ATE (cm) | object AME (cm) | "
                    "AME rot (rad) | #motions | seconds |\n|---|---|---|---|---|---|---|---|\n")
            for fname, mname, r, dt in rows:
                f.write(f"| {fname} | {mname} | {r['ate_t'] * 100:.3f} | {r['ate_fe_t'] * 100:.3f} | "
                        f"{r['ame_t'] * 100:.3f} | {r['ame_r']:.5f} | {r['n_motions']} | {dt:.1f} |\n")
        if ds_rows is not None:
            f.write(f"\n## dyno-KITTI fixture, {dataset_frames} frames\n\n"
                    "| Formulation | Mode | camera ATE (cm) | ATE rot (rad) | AME rms (cm) | AME median (cm) | "
                    "AME rot (rad) | #motions | seconds |\n|---|---|---|---|---|---|---|---|---|\n")
            for fname, mname, r, dt in ds_rows:
                f.write(f"| {fname} | {mname} | {r['ate_t'] * 100:.3f} | {r['ate_r']:.5f} | "
                        f"{r['ame_t'] * 100:.3f} | {r['ame_t_med'] * 100:.3f} | {r['ame_r']:.5f} | "
                        f"{r['n_motions']} | {dt:.1f} |\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["synthetic", "kitti"], action="append",
                    help="run only these matrices (default: both)")
    ap.add_argument("--frames", type=int, default=12, help="frames of the synthetic scene")
    ap.add_argument("--dataset_frames", type=int, default=60, help="frames of the fixture")
    ap.add_argument("--out", default="accuracy_port.md", help="where the table goes (never ACCURACY.md)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the RANSAC generator")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == "ACCURACY.md":
        raise ValueError("ACCURACY.md holds the reference's rows; give another --out")
    todo = args.only or ["synthetic", "kitti"]
    device_line = _device_line(args.device)
    print(device_line, flush=True)

    rows = ds_rows = None
    if "synthetic" in todo:
        from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario

        dense = default_dense_scenario(num_frames=args.frames, device=args.device)
        print(f"== synthetic dense scene ({args.frames} frames) ==", flush=True)
        rows = _matrix(lambda f, m: run_config(dense, f, m, args.frames, args.device, args.seed))
    if "kitti" in todo:
        from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider

        ds = KittiDataProvider(FIXTURE, device=args.device)
        n = min(args.dataset_frames, len(ds))
        print(f"== dataset section: {FIXTURE} ({n} frames) ==", flush=True)
        ds_rows = _matrix(lambda f, m: run_config_dataset(ds, f, m, n, args.device, args.seed))
        args.dataset_frames = n
    write_table(args.out, device_line, args.frames, rows, args.dataset_frames, ds_rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
