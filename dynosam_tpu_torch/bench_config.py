"""The benchmark configuration and scene of bench.py, for the port.

`bench_config()` returns the same `DynoConfig` as `bench.bench_config()` and
the port's intrinsics; `bench_scene()` builds the same KITTI-scale synthetic
scene as `bench.make_frames()` (384 x 1280, three moving objects), rendered
with torch on the given device. bench.py itself cannot be imported here: it
reaches the JAX package.
"""

from __future__ import annotations

import numpy as np

from dynosam_tpu.config import (
    BackendParams,
    DynoConfig,
    FrontendParams,
    MotionSolverParams,
    OptimizerParams,
    RansacParams,
    TrackerParams,
)
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.simulator import ObjectSpec, ScenarioSpec
from dynosam_tpu_torch.dataproviders.synthetic_dense import DenseScenario

HEIGHT, WIDTH = 384, 1280


def bench_config():
    """(cfg, intr): fused step at KITTI scale — 800 static + 1024 dynamic
    track slots, 8 objects, 128 RANSAC hypotheses, incremental hybrid
    backend over a 10-frame window."""
    cfg = DynoConfig(
        frontend=FrontendParams(
            max_objects=8,
            tracker=TrackerParams(
                max_features_per_frame=800,
                min_features_per_frame=300,
                max_dynamic_features_per_frame=1024,
                detection_cell_size=16,
                min_corner_response=1e-6,
            ),
            motion_solver=MotionSolverParams(
                camera=RansacParams(ransac_iterations=128),
                object=RansacParams(ransac_iterations=128, min_inliers=8),
                refinement_iterations=3,
                object_refinement_iterations=2,
                refit_rounds=1,
            ),
        ),
        backend=BackendParams(
            optimization_mode=2,
            backend_updater_enum=3,
            max_frames=10,
            max_objects=8,
            max_static_landmarks=800,
            max_dynamic_landmarks=1024,
            optimizer=OptimizerParams(max_iterations=2),
        ),
    )
    intr = cam.CameraIntrinsics.create(
        fx=720.0, fy=720.0, cx=WIDTH / 2, cy=HEIGHT / 2,
        width=WIDTH, height=HEIGHT, baseline=0.537,
    )
    return cfg, intr


def bench_scene(intr, num_frames=10, device="cpu") -> DenseScenario:
    """The benchmark's synthetic scene: camera driving forward with a slight
    yaw, three objects on the road."""
    spec = ScenarioSpec(
        num_frames=num_frames,
        camera_motion_xi=np.array([0.0, 0.004, 0.0, 0.0, 0.0, 0.8]),
        objects=[
            ObjectSpec(
                object_id=1,
                initial_pose_xi=np.array([0.0, 0.0, 0.0, -4.0, 0.3, 16.0]),
                motion_xi=np.array([0.0, 0.01, 0.0, 0.5, 0.0, 0.1]),
            ),
            ObjectSpec(
                object_id=2,
                initial_pose_xi=np.array([0.0, 0.0, 0.0, 5.0, 0.0, 22.0]),
                motion_xi=np.array([0.0, -0.008, 0.0, -0.4, 0.0, 0.15]),
            ),
            ObjectSpec(
                object_id=3,
                initial_pose_xi=np.array([0.0, 0.0, 0.0, 0.5, 0.2, 28.0]),
                motion_xi=np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.9]),
            ),
        ],
    )
    return DenseScenario(spec, intr, ground_y=1.6, far_depth=60.0,
                         object_half_extent=1.6, device=device)
