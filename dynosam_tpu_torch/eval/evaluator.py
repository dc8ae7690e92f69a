"""Dataset evaluation: CSV logs -> metric tables (port of
dynosam_tpu/eval/evaluator.py).

Walks a results folder, loads the per-module CSV logs written by
utils/logger.EstimationModuleLogger and computes:

  * camera: ATE (aligned and unaligned) and RPE,
  * per object: AME (world frame) and RME (body frame, needs GT object
    poses in the object-pose log).

Results are plain dicts, written as JSON. Quaternions become rotations in
float32 arithmetic, as the reference computes them.
"""

from __future__ import annotations

import csv
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from dynosam_tpu_torch.eval import metrics


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(N, 4) xyzw -> (N, 3, 3), in float32."""
    q = np.asarray(q, np.float32)
    q = q / np.sqrt(np.sum(q * q, axis=-1, keepdims=True))
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    one, two = np.float32(1), np.float32(2)
    rows = [
        [one - two * (y * y + z * z), two * (x * y - z * w), two * (x * z + y * w)],
        [two * (x * y + z * w), one - two * (x * x + z * z), two * (y * z - x * w)],
        [two * (x * z - y * w), two * (y * z + x * w), one - two * (x * x + y * y)],
    ]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def _row_vals(row, offset) -> Optional[List[float]]:
    try:
        return [float(row[offset + i]) for i in range(7)]
    except (ValueError, IndexError):
        return None


def _poses(vals: List[List[float]]) -> np.ndarray:
    """(N, 7) [t, q xyzw] rows -> (N, 4, 4) float64 poses."""
    if not vals:
        return np.zeros((0, 4, 4))
    v = np.asarray(vals, np.float64)
    T = np.tile(np.eye(4), (len(v), 1, 1))
    T[:, :3, :3] = _quat_to_rot(v[:, 3:])
    T[:, :3, 3] = v[:, :3]
    return T


def load_camera_pose_log(path: str):
    """-> (frame_ids, est (K,4,4), gt (K,4,4) or None)."""
    frames, est, gt = [], [], []
    has_gt = True
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            T = _row_vals(row, 1)
            if T is None:
                continue
            frames.append(int(row[0]))
            est.append(T)
            G = _row_vals(row, 8)
            if G is None:
                has_gt = False
            else:
                gt.append(G)
    return np.array(frames), _poses(est), _poses(gt) if (has_gt and gt) else None


def load_object_log(path: str):
    """-> {object_id: (frame_ids, est (K,4,4), gt (K,4,4) or None)}."""
    per_obj = defaultdict(lambda: ([], [], []))
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            T = _row_vals(row, 2)
            if T is None:
                continue
            frames, est, gt = per_obj[int(row[1])]
            frames.append(int(row[0]))
            est.append(T)
            gt.append(_row_vals(row, 9))
    out = {}
    for oid, (frames, est, gt) in per_obj.items():
        gt_ok = all(g is not None for g in gt) and len(gt) == len(est)
        out[oid] = (np.array(frames), _poses(est), _poses(gt) if gt_ok else None)
    return out


class DatasetEvaluator:
    """Evaluate one results folder (one or more logged modules)."""

    def __init__(self, results_path: str):
        self.path = results_path

    def modules(self):
        mods = set()
        for f in os.listdir(self.path):
            if f.endswith("_camera_pose_log.csv"):
                mods.add(f[: -len("_camera_pose_log.csv")])
        return sorted(mods)

    def evaluate_module(self, module: str) -> Dict:
        out: Dict = {"module": module}

        cam_log = os.path.join(self.path, f"{module}_camera_pose_log.csv")
        if os.path.exists(cam_log):
            _, est, gt = load_camera_pose_log(cam_log)
            if gt is not None and len(est) >= 2:
                ate = metrics.ate(est, gt, align=True)
                ate_ua = metrics.ate(est, gt, align=False)
                rpe = metrics.rpe(est, gt)
                out["camera"] = {
                    "n_frames": int(len(est)),
                    "ate_trans_rmse": ate.trans_rmse,
                    "ate_rot_rmse": ate.rot_rmse,
                    "ate_unaligned_trans_rmse": ate_ua.trans_rmse,
                    "rpe_trans_rmse": rpe.trans_rmse,
                    "rpe_rot_rmse": rpe.rot_rmse,
                }

        motion_log = os.path.join(self.path, f"{module}_object_motion_log.csv")
        pose_log = os.path.join(self.path, f"{module}_object_pose_log.csv")
        if os.path.exists(motion_log):
            motions = load_object_log(motion_log)
            poses = load_object_log(pose_log) if os.path.exists(pose_log) else {}
            objects = {}
            for oid, (frames, H_est, H_gt) in motions.items():
                if H_gt is None or len(H_est) < 1:
                    continue
                entry = {"n_frames": int(len(H_est))}
                ame = metrics.ame(H_est, H_gt)
                entry["ame_trans_rmse"] = ame.trans_rmse
                entry["ame_rot_rmse"] = ame.rot_rmse
                # medians beside the RMSE: a few information-poor frames
                # rule an RMS, the median is the typical frame
                entry["ame_trans_median"] = float(np.median(ame.trans_errors))
                entry["ame_rot_median"] = float(np.median(ame.rot_errors))
                # the per-frame error trace and the frames ruling the RMS
                entry["ame_trace"] = [
                    [int(f), round(float(e), 4)] for f, e in zip(frames, ame.trans_errors)
                ]
                worst = np.argsort(ame.trans_errors)[::-1][:5]
                entry["worst_frames"] = [
                    [int(frames[i]), round(float(ame.trans_errors[i]), 4)] for i in worst
                ]
                # RME needs GT object poses at k-1 and k
                if oid in poses and poses[oid][2] is not None:
                    pf, _, L_gt = poses[oid]
                    fmap = {f: i for i, f in enumerate(pf)}
                    idx_pairs = [
                        (fmap[f - 1], fmap[f], i)
                        for i, f in enumerate(frames)
                        if f in fmap and (f - 1) in fmap
                    ]
                    if idx_pairs:
                        prev = np.stack([L_gt[a] for a, _, _ in idx_pairs])
                        curr = np.stack([L_gt[b] for _, b, _ in idx_pairs])
                        Hs = np.stack([H_est[i] for _, _, i in idx_pairs])
                        rme = metrics.rme(Hs, prev, curr)
                        entry["rme_trans_rmse"] = rme.trans_rmse
                        entry["rme_rot_rmse"] = rme.rot_rmse
                objects[int(oid)] = entry
            out["objects"] = objects
        return out

    def run_analysis(self) -> Dict:
        return {m: self.evaluate_module(m) for m in self.modules()}

    def write_report(self, out_path: Optional[str] = None) -> str:
        text = json.dumps(self.run_analysis(), indent=2, sort_keys=True)
        if out_path is None:
            out_path = os.path.join(self.path, "evaluation_results.json")
        with open(out_path, "w") as f:
            f.write(text)
        return out_path

    def write_plots(self, out_dir: Optional[str] = None) -> Optional[str]:
        """Per module, a top-down camera trajectory (estimate vs GT) and
        per-object motion error over frames, as PNGs next to the logs;
        returns the directory, or None when matplotlib is unavailable."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        out_dir = out_dir or os.path.join(self.path, "plots")
        os.makedirs(out_dir, exist_ok=True)
        for module in self.modules():
            cam_log = os.path.join(self.path, f"{module}_camera_pose_log.csv")
            if os.path.exists(cam_log):
                _, est, gt = load_camera_pose_log(cam_log)
                if len(est):
                    fig, ax = plt.subplots(figsize=(5, 5))
                    ax.plot(est[:, 0, 3], est[:, 2, 3], label="estimate")
                    if gt is not None:
                        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "--", label="ground truth")
                    ax.set_xlabel("x [m]")
                    ax.set_ylabel("z [m]")
                    ax.set_aspect("equal", adjustable="datalim")
                    ax.legend()
                    ax.set_title(f"{module}: camera trajectory (top-down)")
                    fig.tight_layout()
                    fig.savefig(os.path.join(out_dir, f"{module}_trajectory.png"), dpi=120)
                    plt.close(fig)

            mot_log = os.path.join(self.path, f"{module}_object_motion_log.csv")
            if os.path.exists(mot_log):
                per_obj = load_object_log(mot_log)
                if per_obj:
                    fig, ax = plt.subplots(figsize=(6, 3.5))
                    for oid, (frames, est, gt) in sorted(per_obj.items()):
                        if gt is None:
                            continue
                        err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
                        ax.plot(frames, err * 100.0, label=f"object {oid}")
                    ax.set_xlabel("frame")
                    ax.set_ylabel("motion error [cm]")
                    ax.set_yscale("log")
                    ax.legend(fontsize=7)
                    ax.set_title(f"{module}: object motion error")
                    fig.tight_layout()
                    fig.savefig(os.path.join(out_dir, f"{module}_motion_error.png"), dpi=120)
                    plt.close(fig)
        return out_dir


def summarize(module_report: Dict) -> Dict[str, float]:
    """One module's report -> the on-disk accuracy row: camera ATE
    (unaligned, m), ATE rot (aligned, rad), AME RMS over objects (m), AME
    median averaged over objects (m) and the number of motions."""
    cam = module_report["camera"]
    objs = list(module_report.get("objects", {}).values())
    ame_t = [o["ame_trans_rmse"] for o in objs]
    med_t = [o["ame_trans_median"] for o in objs]
    return {
        "ate_unaligned_m": cam["ate_unaligned_trans_rmse"],
        "ate_rot_rad": cam["ate_rot_rmse"],
        "ame_rms_m": float(np.sqrt(np.mean(np.square(ame_t)))) if ame_t else float("nan"),
        "ame_median_m": float(np.mean(med_t)) if med_t else float("nan"),
        "n_motions": float(sum(o["n_frames"] for o in objs)),
    }
