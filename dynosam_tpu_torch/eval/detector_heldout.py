"""Held-out quality of the committed detector checkpoint on the port (port of
`random_scene`, `_cls_of_oid` and `eval_iou` of scripts/train_detector.py).

48 randomized driving scenes are rendered by the port's `DenseScenario` from
`np.random.default_rng(10_000)`, drawn in the reference's order: per scene
its objects, classes, extents and motions, then the frame to score. Each
frame goes through `YoloV8DetectorEngine` at 384x640 (the committed
checkpoint, at most 8 detections, score threshold 0.25, no class filter);
on the card its label image comes from K2's entry B. Every ground-truth
instance of at least 40 pixels scores the best mask IoU any label reaches,
and a class hit when the detection of that label has the instance's class.

The checkpoint's own numbers (its .json beside it) are mean IoU 0.712,
class accuracy 0.956 over 114 instances.

Usage: python -m dynosam_tpu_torch.eval.detector_heldout [--device cuda]
(prints the totals as JSON)
"""

from __future__ import annotations

import argparse
import json

import numpy as np

IMG_H, IMG_W = 384, 640
NUM_CLASSES = 2
MAX_OBJ = 5
NUM_SCENES = 48
SEED = 10_000
MIN_PIXELS = 40


def random_scene(rng: np.random.Generator, num_frames: int = 4, device="cuda"):
    """A randomized driving scene of 1..MAX_OBJ objects of 2 classes (class
    0 wide with a check texture, class 1 tall with stripes), the
    reference's draws in the reference's order."""
    from dynosam_tpu_torch.cv import camera as cam
    from dynosam_tpu_torch.dataproviders.simulator import ObjectSpec, ScenarioSpec
    from dynosam_tpu_torch.dataproviders.synthetic_dense import DenseScenario

    intr = cam.CameraIntrinsics.create(fx=360.0, fy=360.0, cx=IMG_W / 2, cy=IMG_H / 2,
                                       width=IMG_W, height=IMG_H, baseline=0.54)
    n_obj = int(rng.integers(1, MAX_OBJ + 1))
    objects, classes, extents = [], [], []
    for j in range(n_obj):
        z = float(rng.uniform(7.0, 28.0))
        x = float(rng.uniform(-0.32, 0.32)) * z
        y = float(rng.uniform(-0.2, 0.6))
        yaw = float(rng.uniform(-0.5, 0.5))
        cls = int(rng.integers(0, NUM_CLASSES))
        if cls == 0:
            ex, ey = float(rng.uniform(1.4, 2.1)), float(rng.uniform(0.6, 0.95))
        else:
            ex, ey = float(rng.uniform(0.9, 1.3)), float(rng.uniform(1.25, 1.9))
        classes.append(cls)
        extents.append((ex, ey))
        objects.append(ObjectSpec(
            object_id=j + 1,
            initial_pose_xi=np.array([0.0, yaw, 0.0, x, y, z]),
            motion_xi=np.array([0.0, rng.uniform(-0.02, 0.02), 0.0,
                                rng.uniform(-0.3, 0.3), 0.0, rng.uniform(-0.2, 0.5)]),
            num_points=0,
        ))
    spec = ScenarioSpec(
        num_frames=num_frames, num_static=0,
        camera_motion_xi=np.array([0.0, rng.uniform(-0.01, 0.01), 0.0, 0.0, 0.0, rng.uniform(0.2, 0.9)]),
        objects=objects,
    )
    return DenseScenario(spec, intr, ground_y=float(rng.uniform(1.3, 1.8)),
                         far_depth=float(rng.uniform(40.0, 70.0)), world_texture=True,
                         object_texture=True, object_half_extents=extents, object_classes=classes,
                         device=device)


def cls_of_oid(scene) -> np.ndarray:
    """(MAX_OBJ + 1,) object id -> class of one scene (id = j + 1)."""
    m = np.zeros((MAX_OBJ + 1,), np.int32)
    for j, c in enumerate(scene.object_classes):
        m[j + 1] = c
    return m


def score_frame(gt: np.ndarray, label: np.ndarray, det_classes: np.ndarray, cls_map: np.ndarray):
    """Per ground-truth instance of >= MIN_PIXELS pixels: (best IoU over the
    labels, whether the best label's detection has its class)."""
    ious, hits = [], []
    labs = [int(v) for v in np.unique(label) if v > 0]
    for oid in np.unique(gt):
        if oid <= 0:
            continue
        g = gt == oid
        if g.sum() < MIN_PIXELS:
            continue
        best, best_lab = 0.0, -1
        for lab in labs:
            p = label == lab
            iou = np.logical_and(g, p).sum() / max(np.logical_or(g, p).sum(), 1)
            if iou > best:
                best, best_lab = iou, lab
        ious.append(best)
        # label value = detection index + 1 (masks_to_label_image)
        hits.append(best_lab > 0 and int(det_classes[best_lab - 1]) == int(cls_map[int(oid)]))
    return ious, hits


def make_engine(device="cuda"):
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine

    return YoloV8DetectorEngine(input_hw=(IMG_H, IMG_W), max_detections=8, score_threshold=0.25,
                                class_ids=None, device=device)


def evaluate(num_scenes: int = NUM_SCENES, seed: int = SEED, device="cuda", engine=None):
    """-> dict: per-instance `iou` (N,) and `class_hit` (N,), the `scene`
    and `frame` of each instance, and the totals mean_mask_iou,
    class_accuracy, instances, mean_detected_iou, missed_rate."""
    import torch

    engine = engine or make_engine(device)
    rng = np.random.default_rng(seed)
    ious, hits, scenes, frames = [], [], [], []
    for s in range(num_scenes):
        scene = random_scene(rng, device=device)
        cm = cls_of_oid(scene)
        k = int(rng.integers(0, scene.scn.spec.num_frames))
        fr = scene.frame(k)
        with torch.no_grad():
            label, det = engine.detect(fr.rgb)
        i, h = score_frame(fr.mask.cpu().numpy(), label.cpu().numpy(), det.classes.cpu().numpy(), cm)
        ious += i
        hits += h
        scenes += [s] * len(i)
        frames += [k] * len(i)
    ious, hits = np.asarray(ious, np.float64), np.asarray(hits, bool)
    det_only = ious[ious > 0.1]
    return {
        "iou": ious, "class_hit": hits,
        "scene": np.asarray(scenes, np.int32), "frame": np.asarray(frames, np.int32),
        "mean_mask_iou": float(ious.mean()) if ious.size else 0.0,
        "class_accuracy": float(hits.mean()) if hits.size else 0.0,
        "instances": int(ious.size),
        # the mean conflates segmentation quality with recall: both parts
        "mean_detected_iou": float(det_only.mean()) if det_only.size else 0.0,
        "missed_rate": float(np.mean(ious <= 0.1)) if ious.size else 1.0,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = evaluate(device=args.device)
    print(json.dumps({k: v for k, v in res.items() if not isinstance(v, np.ndarray)}))


if __name__ == "__main__":
    main()
