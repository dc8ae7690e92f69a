"""A checkout-shaped copy of the benchmark at a size the CPU runs in
seconds: one cell per configuration, each the repository's own
configuration and traffic with the sizes cut (the settings of the port's
quick configuration, `bench_config.small_config`, a 160 x 96 camera, 2
lanes over 2 scenes of 10 frames, a window of at least 3 steps)."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(PORTBENCH)

SMALL = {
    "frontend": {"max_objects": 4,
                 "tracker": {"max_features_per_frame": 128, "min_features_per_frame": 48,
                             "max_dynamic_features_per_frame": 128, "detection_cell_size": 8},
                 "motion_solver": {"refinement_iterations": 4, "camera": {"ransac_iterations": 64},
                                   "object": {"ransac_iterations": 64}}},
    "backend": {"max_frames": 6, "max_objects": 4, "max_static_landmarks": 128, "max_dynamic_landmarks": 128},
}
CAMERA = {"fx": 96.0, "fy": 96.0, "cx": 80.0, "cy": 48.0, "width": 160, "height": 96, "baseline": 0.537}
# limits on the ground-truth numbers at this cut, where the backend's
# 6-frame window over 128 landmarks lies ~0.2-0.5 m from the truth (the
# cell's own limits are set at the cell's size)
TRUTH = {"gt_cam_t_m.lane_q75": 1.5, "gt_cam_r_rad.lane_q75": 0.05, "gt_frontend_t_m.lane_q75": 0.5,
         "gt_motion_t_m.lane_q75": 1.0, "gt_motion_none": 0.3}


def tiny_limits(limits: dict) -> dict:
    """A cell's limits with those on the ground truth set for this cut."""
    out = {k: v for k, v in limits.items() if not k.startswith("gt_")}
    out.update({k: v for k, v in TRUTH.items() if k in limits})
    return out


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def load(*parts):
    with open(os.path.join(PORTBENCH, *parts)) as f:
        return json.load(f)


def make_root(tmp: str, limits: dict | None = None, lanes: int = 2) -> str:
    """A directory holding BENCHMARK.json and portbench's data files and
    readers, with the cells `tiny-hybrid.sweep` and `tiny-stereo-imu.sweep`."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(PORTBENCH, "metrics"), os.path.join(root, "portbench", "metrics"))
    bench = load("..", "BENCHMARK.json")
    cells = []
    for cell in bench["workloads"]:
        config, traffic = cell["config"], cell["traffic"]
        name = "tiny-" + config.split("-", 1)[1]
        c = load("configs", config + ".json")
        c["settings"] = _merge(c["settings"], SMALL)
        c["camera"] = CAMERA
        t = load("traffic", traffic + ".json")
        t.update(lanes=lanes, scenes=2, frames=10, warmup_frames=7, render_chunk=5, min_window_steps=3)
        t["objects"] = dict(t["objects"], per_scene=[2, 3], min_visible_px=20, margin_px=2)
        t["check"] = dict(t["check"], lanes=lanes, share_of_window=1.0, max_steps=4)
        for kind, fname, data in (("configs", name, c), ("traffic", name, t),
                                  ("limits", name + ".sweep", {"limits": limits or {"cam_t_m": 1e-3}})):
            os.makedirs(os.path.join(root, "portbench", kind), exist_ok=True)
            with open(os.path.join(root, "portbench", kind, fname + ".json"), "w") as f:
                json.dump(data, f)
        cells.append(dict(cell, name=name + ".sweep", config=name, traffic=name))
    bench["workloads"] = cells
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-stereo-imu.sweep"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
