"""Accuracy runs of the port (scripts/accuracy_report.py,
scripts/accuracy_rich.py and scripts/accuracy_detector.py): ATE / AME
against ground truth.

Sections (--only, repeatable; default synthetic and kitti):
  * synthetic: every formulation x mode on the dense test scene
    (default_dense_scenario, analytic ground truth) at
    bench_config.synthetic_accuracy_config, 12 frames; camera ATE
    (unaligned) of the backend and of the frontend, and AME over the frames
    where the backend reports a motion (motion_at);
  * kitti: every formulation x mode over the committed dyno-KITTI fixture,
    60 frames, from disk through the CSV logs and DatasetEvaluator (the
    run_dynosam contract), at bench_config.kitti_accuracy_config;
  * rich: the rich fixture (bench_config.fixture_scenario at 1242x375,
    rich=True: four cars, the fourth occluded behind the lead car and
    re-entering), 100 frames rendered on the host and written by the
    port's dyno-KITTI writer to a temporary directory (removed after), read
    back onto the device and run in scripts/accuracy_rich.py's nine cells
    and order at the observability floor RICH_MIN_AREA;
  * sweep: hybrid sliding-window at windows 8, 12 and 16 over the 60
    fixture frames;
  * detector: scripts/accuracy_detector.py run_cell over the 60 fixture
    frames with the provided masks and with the committed YOLOv8-seg
    checkpoint + ByteTrack supplying them, estimated object ids associated
    to ground-truth ids by object-pose trajectory.

The rich, sweep and detector rows stand beside the JAX package's rows in
testdata/{rich_matrix_ref_100f,sweep_ref_60f,det_acc_ref_60f}.npz
(scripts/make_torch_smoke_reference.py), with their difference and the
bounds of ROW_BOUNDS (the rich WCME and WCPE rows against the JAX seeds of
testdata/rich_seeds_ref_100f/). The table is rewritten after every
section. A row that raises fails the run (the reference
prints FAILED and goes on); a row outside its bounds fails it once the
table is written. The table goes to --out, never to ACCURACY.md, which
holds the reference's rows.

Usage: python -m dynosam_tpu_torch.eval.accuracy
    [--only synthetic|kitti|rich|sweep|detector] [--frames 12]
    [--dataset_frames 60] [--rich_frames 100] [--out accuracy_port.md]
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


def run_config_dataset(ds, formulation: int, mode: int, num_frames: int, device, seed: int = 0,
                       min_observable_mask_area: float = 0.0, window=None) -> dict:
    """One cell on an on-disk dataset, through the CSV logs and
    DatasetEvaluator; the floor and the window as kitti_accuracy_config
    takes them."""
    from dynosam_tpu_torch.bench_config import kitti_accuracy_config
    from dynosam_tpu_torch.eval.evaluator import DatasetEvaluator
    from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline

    cfg = kitti_accuracy_config(MODE_KEYS[mode], num_frames, formulation, min_observable_mask_area, window)
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


def associate(backend, gts) -> dict:
    """Estimated object id -> ground-truth id by object-pose trajectory
    (scripts/accuracy_detector.py run_cell): the ground-truth object whose
    positions lie nearest on average over at least 3 shared frames, if
    nearer than 3 m. Detected ids are ByteTrack's and never equal the
    dataset's, so id-keyed evaluation is impossible."""
    est_pos = {}
    for (fid, oid), L in backend.matured_objpose.items():
        est_pos.setdefault(int(oid), {})[fid] = np.asarray(L)[:3, 3]
    gt_pos = {}
    for k, g in enumerate(gts):
        for i, goid in enumerate(np.asarray(g.object_ids)):
            if int(goid) > 0:
                gt_pos.setdefault(int(goid), {})[k] = np.asarray(g.object_poses[i])[:3, 3]
    assoc = {}
    for eid, traj in est_pos.items():
        best, best_d = None, np.inf
        for goid, gtraj in gt_pos.items():
            common = sorted(set(traj) & set(gtraj))
            if len(common) < 3:
                continue
            d = float(np.mean([np.linalg.norm(traj[f] - gtraj[f]) for f in common]))
            if d < best_d:
                best, best_d = goid, d
        if best is not None and best_d < 3.0:
            assoc[eid] = best
    return assoc


def run_cell(ds, n: int, detector, device, seed: int = 0, on_frame=None):
    """scripts/accuracy_detector.py run_cell: hybrid sliding-window over
    the first `n` frames of `ds` with the provided masks (detector None)
    or the detector's, relabelled by ByteTrack -> (result, pipeline, the
    association). `on_frame(inputs, packet)` as DynoPipeline.run takes it."""
    from dynosam_tpu_torch.bench_config import detector_accuracy_config
    from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline

    pipe = DynoPipeline(detector_accuracy_config(detector is not None), ds.intrinsics(), detector=detector,
                        device=device, seed=seed)
    gts = [ds.ground_truth(k) for k in range(n)]
    pipe.run((ds.frame_host(k) for k in range(n)), gts, on_frame=on_frame)
    est = np.stack(pipe.trajectory)
    gt_X = np.stack([np.asarray(g.X_world_cam) for g in gts])
    ate_t = float(np.sqrt(np.mean(np.sum((est[:, :3, 3] - gt_X[:, :3, 3]) ** 2, axis=-1))))
    assoc = associate(pipe.backend, gts)
    gt_mot = {}
    for k, g in enumerate(gts):
        for i, goid in enumerate(np.asarray(g.object_ids)):
            if int(goid) > 0:
                gt_mot.setdefault(int(goid), {})[k] = np.asarray(g.object_motions[i])
    errs = []
    for (fid, eid), H in pipe.backend.matured_motion.items():
        goid = assoc.get(int(eid))
        if goid is None or fid not in gt_mot.get(goid, {}):
            continue
        E = np.linalg.inv(gt_mot[goid][fid]) @ np.asarray(H)
        errs.append(np.linalg.norm(E[:3, 3]))
    errs = np.asarray(errs)
    est_ids = {int(oid) for _, oid in pipe.backend.matured_objpose}
    result = dict(ate_t=ate_t,
                  ame_t=float(np.sqrt(np.mean(errs ** 2))) if len(errs) else float("nan"),
                  ame_t_med=float(np.median(errs)) if len(errs) else float("nan"),
                  n_motions=int(len(errs)), n_tracks=len(est_ids), n_assoc=len(assoc))
    return result, pipe, assoc


def write_rich(root: str, frames: int, device) -> None:
    """Render the rich fixture's first `frames` frames on `device` and write
    them to `root` in dyno-KITTI layout as scripts/accuracy_rich.py does
    (uint16 disparity at fx * KITTI_BASELINE_M, depth scale 256, .flo flow,
    txt masks, the world offset): make_fixture_sequence's --rich preset."""
    from dynosam_tpu_torch.make_fixture_sequence import write_fixture

    write_fixture(root, frames, 1242, 375, rich=True, device=device)


def write_detector_scene(root: str, frames: int) -> None:
    """Render bench_config.detector_scene (the scene the committed detector
    checkpoint was trained on, at detector_config's 640x384 camera) on the
    host over `frames` frames and write it to `root` in dyno-KITTI layout
    (uint16 disparity at fx * baseline, depth scale 256)."""
    from dynosam_tpu_torch.bench_config import detector_config, detector_scene
    from dynosam_tpu_torch.dataproviders.kitti_writer import write_kitti_sequence

    _, intr = detector_config()
    dense = detector_scene(intr, frames, device="cpu")
    write_kitti_sequence(dense, root, base_line=float(intr.fx * intr.baseline), depth_scale_factor=256.0)


# Bounds of the rich, sweep and detector rows against the JAX rows (the
# same files on both sides): |port - JAX seed 0| <= abs + rel * |JAX| for
# camera ATE, AME rms / median (m), AME rotation (rad) and #motions.
# Hybrid rows (the sweep's and the detector's are hybrid too): on an H100
# the rich cells read within 1e-5 m ATE and 0.05% AME rms of JAX, the
# sweep within 6e-5 m (H100 80GB HBM3, 700 W). WCME and WCPE on the rich fixture
# follow the frontend's motion in one or two deep-occlusion frames, where
# the RANSAC draws decide between centimetres and metres, and the port
# draws from its own generator: so each of their fields, and the
# frontend's AME rms in every rich row, is held to the range of the JAX
# seeds (seed 0 of the matrix file and the seeds of
# testdata/rich_seeds_ref_100f/, make_torch_smoke_reference.py --only
# rich_seeds) widened by the same abs + rel * |end|. Given JAX seed 0's
# draws the port still parts from it there (camera ATE 1.16 against 0.29
# mm in WCME incremental on the CPU; --only rich_draws). The frontend alone
# on identical files and draws agrees with JAX's until frame 32, where
# object 4 re-enters as 19 collinear points: the yaw about that line is
# unobservable, and a one-ulp change of one sample point moves JAX itself
# to the port's branch (a 49 m motion; frame 51 again):
# tests/test_torch_rich_frontend.py, ROADMAP.md queue 3.
ROW_BOUNDS = {"ate_t": (2e-4, 0.05), "ame_t": (2e-3, 0.10), "ame_t_med": (1e-3, 0.10), "ame_r": (1e-4, 0.10),
              "n_motions": (2, 0.05)}
RICH_SEEDS_DIR = os.path.join(ROOT, "dynosam_tpu_torch", "testdata", "rich_seeds_ref_100f")
RICH_PARTING_NOTE = (
    'Where the frontends part (tests/test_torch_rich_frontend.py): run alone on the same files\n'
    "with JAX seed 0's draws, the port's frontend equals JAX's until frame 32, where object 4\n"
    're-enters after its first deep occlusion as 19 collinear points. The yaw about that line is\n'
    "unobservable: RANSAC's three-point Kabsch and Horn's refit take one of two yaws 180 degrees\n"
    'apart (a 49 m motion), and a one-ulp change of one sample point moves JAX itself to the\n'
    "port's branch; frame 51 (the second re-entry) again. A near-tie both sides decide, not a\n"
    'different function; what to hold the WCME and WCPE rows to is open (ROADMAP.md queue 3).\n'
)


def _agrees(port: float, lo: float, hi: float, a: float, r: float) -> bool:
    """port within [lo, hi] widened by a + r * |end|; a field undefined on
    both sides (an AME over no motion) agrees."""
    if np.isnan(port) or np.isnan(lo) or np.isnan(hi):
        return bool(np.isnan(port) and np.isnan(lo) and np.isnan(hi))
    return lo - (a + r * abs(lo)) <= port <= hi + (a + r * abs(hi))


def _against(port: dict, ref: dict, spread: dict | None = None) -> list:
    """The fields of `port` outside ROW_BOUNDS against the JAX row `ref`,
    or, for the fields of `spread` ({field: (lo, hi)}), against that range
    of JAX seeds."""
    outside = []
    for k, (a, r) in ROW_BOUNDS.items():
        if k not in port:
            continue
        lo, hi = (spread or {}).get(k, (ref[k], ref[k]))
        if not _agrees(port[k], lo, hi, a, r):
            outside.append(k)
    if spread and "fe_ame_t" in spread and not _agrees(port["fe_ame_t"], *spread["fe_ame_t"],
                                                       *ROW_BOUNDS["ame_t"]):
        outside.append("fe_ame_t")
    return outside


def _seed_spread(ref: dict) -> dict:
    """{cell: {field: (lo, hi)}} over the JAX seeds of each WCME / WCPE
    cell (seed 0 from `ref`, the matrix file's rows), and "frontend": the
    frontend's AME rms over every seed run (the frontend does not depend
    on the backend: one value per seed in every cell)."""
    spread, fe = {}, {float(row["fe_ame_t"]) for row in ref.values()}
    for name in sorted(os.listdir(RICH_SEEDS_DIR)):
        f = np.load(os.path.join(RICH_SEEDS_DIR, name))
        cell = str(f["cell"])
        fields = [str(x) for x in f["summary_fields"]]
        runs = [ref[cell]] + [dict(zip(fields, map(float, v))) for v in f["summary"]]
        spread[cell] = {k: (min(r[k] for r in runs), max(r[k] for r in runs)) for k in ROW_BOUNDS}
        spread[cell]["seeds"] = [0] + [int(x) for x in f["seeds"]]
        fe |= {r["fe_ame_t"] for r in runs}
    spread["frontend"] = (min(fe), max(fe))
    return spread


def _ref_rows(path, names, fields_key="summary_fields", values_key="summary"):
    ref = np.load(path)
    fields = [str(f) for f in ref[fields_key]]
    rows = [str(c) for c in ref[names]]
    return {row: dict(zip(fields, map(float, ref[values_key][i]))) for i, row in enumerate(rows)}


def _matrix(run_one) -> list:
    """Every formulation x mode -> [(formulation, mode, result, seconds)]."""
    rows = []
    for form, fname in FORMS.items():
        for mode, mname in MODES.items():
            t0 = time.perf_counter()
            r = run_one(form, mode)
            dt = time.perf_counter() - t0
            rows.append((fname, mname, r, dt))
            _say_row(*rows[-1])
    return rows


def _device_line(device) -> str:
    import torch

    if torch.device(device).type != "cuda":
        return f"device {device}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return f"device {torch.cuda.get_device_name(0)} ({smi[0] if smi else 'nvidia-smi gave nothing'})"


RICH_CELLS = tuple((mode, form) for mode in (1, 2, 0) for form in (3, 1, 0))   # accuracy_rich.py's order
TESTDATA = os.path.join(ROOT, "dynosam_tpu_torch", "testdata")


def rich_rows(frames: int, device, seed: int = 0) -> list:
    """The nine cells over the rich fixture -> [(formulation, mode, result,
    seconds)]. The fixture is rendered on the host, as the JAX rows' files
    were (make_torch_smoke_reference.py): the scene's f32 trajectory is ill-conditioned at its 0.002 rad yaw, so
    a render on the card would be another disparity-quantisation draw of
    the scene (on an H100 the hybrid cells' camera ATE moved up to 1.4 mm
    that way on an H100 80GB HBM3), and the table would compare renders, not
    pipelines. The files are removed afterwards."""
    from dynosam_tpu_torch.bench_config import RICH_MIN_AREA
    from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider

    tmp = tempfile.mkdtemp(prefix="rich_")
    try:
        t0 = time.perf_counter()
        write_rich(tmp, frames, "cpu")
        ds = KittiDataProvider(tmp, device=device)
        print(f"rendered and wrote the rich fixture ({frames} frames, 1242x375) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        n = min(frames, len(ds))
        rows = []
        for mode, form in RICH_CELLS:
            t0 = time.perf_counter()
            r = run_config_dataset(ds, form, mode, n, device, seed, min_observable_mask_area=RICH_MIN_AREA)
            rows.append((FORMS[form], MODES[mode], r, time.perf_counter() - t0))
            _say_row(*rows[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def sweep_rows(frames: int, device, seed: int = 0) -> list:
    """Hybrid sliding-window at each of SWEEP_WINDOWS over the fixture ->
    [(window, result, seconds)]."""
    from dynosam_tpu_torch.bench_config import SWEEP_WINDOWS
    from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider

    ds = KittiDataProvider(FIXTURE, device=device)
    n = min(frames, len(ds))
    rows = []
    for w in SWEEP_WINDOWS:
        t0 = time.perf_counter()
        r = run_config_dataset(ds, 3, 1, n, device, seed, window=w)
        rows.append((w, r, time.perf_counter() - t0))
        _say_row(f"window {w}", MODES[1], r, rows[-1][2])
    return rows


def detector_rows(frames: int, device, seed: int = 0) -> list:
    """run_cell with the provided and the detected masks over the fixture
    -> [(row, result, association, seconds)]."""
    from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine

    ds = KittiDataProvider(FIXTURE, device=device)
    n = min(frames, len(ds))
    hw = (int(ds.intrinsics().height), int(ds.intrinsics().width))
    rows = []
    for name, det in (("provided", None),
                      ("detected", YoloV8DetectorEngine(input_hw=hw, score_threshold=0.35, device=device))):
        t0 = time.perf_counter()
        r, _, assoc = run_cell(ds, n, det, device, seed)
        rows.append((name, r, assoc, time.perf_counter() - t0))
        print(f"{name:9s} masks ATE {r['ate_t'] * 100:7.3f} cm AME {r['ame_t'] * 100:7.3f} cm med "
              f"{r['ame_t_med'] * 100:6.3f} cm [{r['n_motions']} motions, {r['n_assoc']}/{r['n_tracks']} tracks "
              f"associated {assoc}] {rows[-1][3]:.1f} s", flush=True)
    return rows


def _say_row(fname, mname, r, dt):
    med = f" med {r['ame_t_med'] * 100:6.3f} cm" if "ame_t_med" in r else ""
    print(f"{fname:8s} {mname:16s} ATE {r['ate_t'] * 100:7.3f} cm AME {r['ame_t'] * 100:7.3f} cm{med} "
          f"rot {r['ame_r']:.5f} rad [{r['n_motions']} motions] {dt:.1f} s", flush=True)


def _vs(port, ref, key, scale=100.0, fmt="{:.3f}"):
    """'port / JAX / difference' of one field (cm by default)."""
    return " / ".join(fmt.format(v * scale) for v in (port[key], ref[key], port[key] - ref[key]))


def write_table(path, device_line, frames=None, rows=None, dataset_frames=None, ds_rows=None, rich=None, sweep=None,
                detector=None) -> list:
    """Write the sections run -> the rows outside their bounds against the
    JAX rows."""
    outside = []
    said = ", ".join(f"{k} {a:g} + {r:g} x |JAX|" for k, (a, r) in ROW_BOUNDS.items())

    def verdict(out):
        return "yes" if not out else "no: " + ", ".join(out)

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
        if rich is not None:
            rich_rows_, rich_frames = rich
            ref = _ref_rows(os.path.join(TESTDATA, "rich_matrix_ref_100f.npz"), "cells")
            spread = _seed_spread(ref)
            f.write(f"\n## Rich fixture, 1242x375, {rich_frames} frames, floor 0.0065 of the image\n\n"
                    "scripts/accuracy_rich.py's nine cells: four cars, the fourth occluded behind the lead car\n"
                    "and re-entering. The fixture is rendered on the host and written by the port's writer: the\n"
                    "JAX rows read the same files. Each cell: the port / the JAX package (seed 0,\n"
                    "testdata/rich_matrix_ref_100f.npz) / their difference. Bounds (m, rad, counts): hybrid "
                    f"rows {said}.\nWCME and WCPE rows follow the frontend's motion in one or two deep-occlusion "
                    "frames, where the\nRANSAC draws decide between centimetres and metres, so each of their "
                    "fields is held to the\nrange of the JAX seeds below widened by the same abs + rel x |end|; "
                    "the frontend's AME rms of\nevery row to the range over all those seed runs "
                    f"({spread['frontend'][0] * 100:.3f}-{spread['frontend'][1] * 100:.3f} cm).\n"
                    + RICH_PARTING_NOTE + "\n"
                    "| Formulation | Mode | camera ATE (cm) | frontend ATE (cm) | AME rms (cm) | "
                    "frontend AME rms (cm) | AME median (cm) | AME rot (rad) | #motions | seconds | within |\n"
                    "|---|---|---|---|---|---|---|---|---|---|---|\n")
            for (fname, mname, r, dt), (mode, form) in zip(rich_rows_, RICH_CELLS):
                cell = f"{MODE_KEYS[mode]}_{form}"
                jr = ref[cell]
                held = dict(spread.get(cell, {}), fe_ame_t=spread["frontend"]) if form != 3 else \
                    {"fe_ame_t": spread["frontend"]}
                out = _against(r, jr, held)
                outside += [f"rich {fname} {mname} {k}" for k in out]
                f.write(f"| {fname} | {mname} | {_vs(r, jr, 'ate_t')} | {_vs(r, jr, 'fe_ate_t')} | "
                        f"{_vs(r, jr, 'ame_t')} | {_vs(r, jr, 'fe_ame_t')} | {_vs(r, jr, 'ame_t_med')} | "
                        f"{_vs(r, jr, 'ame_r', 1.0, '{:.5f}')} | {_vs(r, jr, 'n_motions', 1.0, '{:.0f}')} | "
                        f"{dt:.1f} | {verdict(out)} |\n")
            f.write("\nThe JAX seeds of the WCME and WCPE cells (low-high over the seeds; "
                    "testdata/rich_seeds_ref_100f/):\n\n| Formulation | Mode | seeds | camera ATE (cm) | "
                    "AME rms (cm) | AME median (cm) | AME rot (rad) | #motions |\n|---|---|---|---|---|---|---|---|\n")
            for mode, form in RICH_CELLS:
                sp = spread.get(f"{MODE_KEYS[mode]}_{form}")
                if form == 3 or sp is None:
                    continue

                def rng(k, scale=100.0, fmt="{:.3f}"):
                    return "-".join(fmt.format(v * scale) for v in sp[k])

                f.write(f"| {FORMS[form]} | {MODES[mode]} | {', '.join(map(str, sp['seeds']))} | {rng('ate_t')} | "
                        f"{rng('ame_t')} | {rng('ame_t_med')} | {rng('ame_r', 1.0, '{:.5f}')} | "
                        f"{rng('n_motions', 1.0, '{:.0f}')} |\n")
        if sweep is not None:
            sweep_rows_, sweep_frames = sweep
            ref = _ref_rows(os.path.join(TESTDATA, "sweep_ref_60f.npz"), "cells")
            f.write(f"\n## Hybrid sliding-window sweep, dyno-KITTI fixture, {sweep_frames} frames\n\n"
                    "Each cell: the port / the JAX package (seed 0, testdata/sweep_ref_60f.npz) / their\n"
                    f"difference. Bounds: {said}.\n\n"
                    "| window | camera ATE (cm) | AME rms (cm) | AME median (cm) | AME rot (rad) | #motions | "
                    "seconds | within |\n|---|---|---|---|---|---|---|---|\n")
            for w, r, dt in sweep_rows_:
                jr = ref[f"window_{w}"]
                out = _against(r, jr)
                outside += [f"sweep window {w} {k}" for k in out]
                f.write(f"| {w} | {_vs(r, jr, 'ate_t')} | {_vs(r, jr, 'ame_t')} | {_vs(r, jr, 'ame_t_med')} | "
                        f"{_vs(r, jr, 'ame_r', 1.0, '{:.5f}')} | {_vs(r, jr, 'n_motions', 1.0, '{:.0f}')} | "
                        f"{dt:.1f} | {verdict(out)} |\n")
        if detector is not None:
            det_rows_, det_frames = detector
            ref_file = np.load(os.path.join(TESTDATA, "det_acc_ref_60f.npz"))
            ref = _ref_rows(os.path.join(TESTDATA, "det_acc_ref_60f.npz"), "rows", "result_fields", "results")
            f.write(f"\n## Detected vs provided masks, dyno-KITTI fixture, {det_frames} frames, hybrid "
                    "sliding-window\n\n"
                    "scripts/accuracy_detector.py run_cell: the detected row takes its masks from the committed\n"
                    "YOLOv8-seg checkpoint (score 0.35, at the fixture's 96x320) relabelled by ByteTrack; the\n"
                    "checkpoint finds no car on this fixture, on either side. Each cell: the port / the JAX\n"
                    "package (seed 0, testdata/det_acc_ref_60f.npz) / their difference. Bounds: "
                    f"{said}; the association equal.\n\n"
                    "| masks | camera ATE (cm) | AME rms (cm) | AME median (cm) | #motions | tracks (assoc/total) | "
                    "association (estimated id: ground-truth id), port / JAX | seconds | within |\n"
                    "|---|---|---|---|---|---|---|---|---|\n")
            for name, r, assoc, dt in det_rows_:
                jr = ref[name]
                jassoc = {int(a): int(b) for a, b in ref_file[f"{name}_assoc"]}
                out = _against(r, jr) + ([] if assoc == jassoc else ["association"])
                outside += [f"detector {name} {k}" for k in out]
                f.write(f"| {name} | {_vs(r, jr, 'ate_t')} | {_vs(r, jr, 'ame_t')} | {_vs(r, jr, 'ame_t_med')} | "
                        f"{_vs(r, jr, 'n_motions', 1.0, '{:.0f}')} | {r['n_assoc']}/{r['n_tracks']} / "
                        f"{int(jr['n_assoc'])}/{int(jr['n_tracks'])} | {assoc} / {jassoc} | {dt:.1f} | "
                        f"{verdict(out)} |\n")
    return outside


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["synthetic", "kitti", "rich", "sweep", "detector"], action="append",
                    help="run only these sections (default: synthetic and kitti)")
    ap.add_argument("--frames", type=int, default=12, help="frames of the synthetic scene")
    ap.add_argument("--dataset_frames", type=int, default=60, help="frames of the fixture")
    ap.add_argument("--rich_frames", type=int, default=100, help="frames of the rich fixture")
    ap.add_argument("--out", default="accuracy_port.md", help="where the table goes (never ACCURACY.md)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the RANSAC generator")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == "ACCURACY.md" and os.path.dirname(os.path.abspath(args.out)) == ROOT:
        raise ValueError("ACCURACY.md holds the reference's rows; give another --out")
    todo = args.only or ["synthetic", "kitti"]
    device_line = _device_line(args.device)
    print(device_line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    done = {}

    def table(**section):
        """The table of the sections run so far (a cut run keeps them)."""
        done.update(section)
        outside = write_table(args.out, device_line, **done)
        print(f"wrote {args.out}", flush=True)
        return outside

    if "synthetic" in todo:
        from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario

        dense = default_dense_scenario(num_frames=args.frames, device=args.device)
        print(f"== synthetic dense scene ({args.frames} frames) ==", flush=True)
        table(rows=_matrix(lambda f, m: run_config(dense, f, m, args.frames, args.device, args.seed)),
              frames=args.frames)
    if "kitti" in todo:
        from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider

        ds = KittiDataProvider(FIXTURE, device=args.device)
        n = min(args.dataset_frames, len(ds))
        print(f"== dataset section: {FIXTURE} ({n} frames) ==", flush=True)
        table(ds_rows=_matrix(lambda f, m: run_config_dataset(ds, f, m, n, args.device, args.seed)),
              dataset_frames=n)
    # the short sections first
    if "sweep" in todo:
        print(f"== window sweep ({args.dataset_frames} fixture frames) ==", flush=True)
        table(sweep=(sweep_rows(args.dataset_frames, args.device, args.seed), args.dataset_frames))
    if "detector" in todo:
        print(f"== detected vs provided masks ({args.dataset_frames} fixture frames) ==", flush=True)
        table(detector=(detector_rows(args.dataset_frames, args.device, args.seed), args.dataset_frames))
    if "rich" in todo:
        print(f"== rich fixture ({args.rich_frames} frames, 1242x375) ==", flush=True)
        table(rich=(rich_rows(args.rich_frames, args.device, args.seed), args.rich_frames))
    outside = table()
    if outside:
        raise SystemExit(f"rows outside their bounds against the JAX rows: {outside}")





if __name__ == "__main__":
    main()
