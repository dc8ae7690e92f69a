"""The benchmark configuration and scene of bench.py, for the port.

`bench_config()` returns the same `DynoConfig` as `bench.bench_config()` and
the port's intrinsics; `bench_scene()` builds the same KITTI-scale synthetic
scene as `bench.make_frames()` (384 x 1280, three moving objects), rendered
with torch on the given device. bench.py itself cannot be imported here: it
reaches the JAX package.

`bench_klt_config()` is the KLT path: the same settings tracking by
pyramidal KLT on CLAHE-equalized frames instead of the provided flow, on the
bench scene rendered with the world-anchored texture (`world_texture=True`,
as `bench.make_frames(world_texture=True)`), which moves with the geometry
as LK needs. `stereo_imu_config()` adds the IMU with its rotation prior,
and `stereo_imu_frame()` gives each frame a right image rendered at
+baseline, the 1.15x corrupted provided depth that only stereo repairs, and
the exact IMU window of the interval before it.

`batched_stereo_imu_config()` and `batched_bytetrack_config()` are the
batched step's two frontend modes at the bench's width: stereo + IMU on the
provided flow, and ByteTrack's relabelling of masks whose labels
`label_permutations` permutes per frame and per sequence.

`detector_config()` and `detector_scene()` are the detector path: the same
settings with the masks coming from YOLOv8-seg (relabelled by ByteTrack)
instead of the renderer, at the committed checkpoint's own camera (384 x
640, fx = fy = 360, as scripts/train_detector.py renders its training
frames), on textured frames the detector can see objects in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynosam_tpu_torch.config import (
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
from dynosam_tpu_torch.frontend.types import FrameInputs
from dynosam_tpu_torch.utils import lie

HEIGHT, WIDTH = 384, 1280
DET_HEIGHT, DET_WIDTH = 384, 640
# the bench's distinct frames, stepped through in turn (bench.py)
DISTINCT_FRAMES = 8


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


# the bench camera's forward step, m per frame (bench.py::make_frames)
BENCH_FORWARD_M = 0.8


def _bench_spec(num_frames, forward_m=BENCH_FORWARD_M):
    return ScenarioSpec(
        num_frames=num_frames,
        camera_motion_xi=np.array([0.0, 0.004, 0.0, 0.0, 0.0, forward_m]),
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


# the bench camera's height over the ground plane, m (bench.py::make_frames)
BENCH_GROUND_Y = 1.6


def bench_scene(intr, num_frames=10, device="cuda", world_texture=False,
                forward_m=BENCH_FORWARD_M, ground_y=BENCH_GROUND_Y) -> DenseScenario:
    """The benchmark's synthetic scene: camera driving forward `forward_m`
    per frame with a slight yaw, `ground_y` above the ground plane, three
    objects on the road; `world_texture` anchors the texture to the surfaces
    (the KLT path's frames)."""
    return DenseScenario(_bench_spec(num_frames, forward_m), intr, ground_y=ground_y, far_depth=60.0,
                         object_half_extents=[(1.6, 1.6)] * 3, world_texture=world_texture,
                         device=device)


def bench_frames(intr, num_frames=DISTINCT_FRAMES, world_texture=False, device="cuda"):
    """bench.py::make_frames: the first `num_frames` frames of the bench
    scene, rendered on `device`."""
    return bench_scene(intr, num_frames, device=device, world_texture=world_texture).frames()


def small_config():
    """__graft_entry__.py::_small_config: 128 static + 128 dynamic track
    slots, cell 8, 4 objects, 64 hypotheses, hybrid incremental over a
    6-frame window, 2 LM iterations."""
    return DynoConfig(
        frontend=FrontendParams(
            max_objects=4,
            tracker=TrackerParams(
                max_features_per_frame=128,
                min_features_per_frame=48,
                max_dynamic_features_per_frame=128,
                detection_cell_size=8,
                min_corner_response=1e-6,
            ),
            motion_solver=MotionSolverParams(
                camera=RansacParams(ransac_iterations=64),
                object=RansacParams(ransac_iterations=64, min_inliers=8),
                refinement_iterations=4,
            ),
        ),
        backend=BackendParams(
            optimization_mode=2,
            backend_updater_enum=3,
            max_frames=6,
            max_objects=4,
            max_static_landmarks=128,
            max_dynamic_landmarks=128,
            optimizer=OptimizerParams(max_iterations=2),
        ),
    )


def small_intr(width=128, height=96):
    """__graft_entry__.py::_intr: fx = fy = 0.55 width, centred."""
    return cam.CameraIntrinsics.create(
        fx=width * 0.55, fy=width * 0.55, cx=width / 2, cy=height / 2, width=width, height=height,
    )


def small_frame_inputs(width=128, height=96, batch=None, device="cuda") -> FrameInputs:
    """__graft_entry__.py::_frame_inputs: one random frame (uniform RGB,
    depth 5-15 m, standard normal flow, one object box) from
    `numpy.random.default_rng(0)`, with a leading axis of `batch` copies'
    shape (each drawn anew, as the reference draws the whole array) when
    given."""
    shape = (height, width) if batch is None else (batch, height, width)
    rng = np.random.default_rng(0)
    mask = torch.zeros(shape, dtype=torch.int32)
    mask[..., 30:60, 40:80] = 1
    return FrameInputs(
        frame_id=torch.ones(shape[:-2], dtype=torch.int32),
        rgb=torch.from_numpy(rng.random(shape + (3,), np.float32)),
        depth=torch.from_numpy(5.0 + 10.0 * rng.random(shape, np.float32)),
        flow=torch.from_numpy(rng.standard_normal(shape + (2,)).astype(np.float32)),
        mask=mask,
    ).to(device)


# The tracked scene: the bench scene with the camera raised to
# TRACKED_GROUND_Y and its forward step cut to TRACKED_FORWARD_M, where the
# JAX reference keeps the camera on the KLT and stereo + IMU paths (on the
# bench scene itself it loses it). Raising the camera moves the band of
# ground whose texture aliases under the renderer's isotropic band limit
# (a grazing pixel spans ~depth^2 / (fx * height) m along the view) out of
# the tracked depths; the shorter step keeps LK off the far wall's
# one-period locks.
TRACKED_GROUND_Y = 6.4
TRACKED_FORWARD_M = 0.4


def tracked_scene(intr, num_frames=20, device="cuda") -> DenseScenario:
    """The world-textured bench scene at TRACKED_GROUND_Y and
    TRACKED_FORWARD_M: objects, texture and intrinsics as the bench's."""
    return bench_scene(intr, num_frames, device=device, world_texture=True, forward_m=TRACKED_FORWARD_M,
                       ground_y=TRACKED_GROUND_Y)


def bench_klt_config():
    """(cfg, intr): bench_config() tracking by KLT (3 levels, 7x7 window,
    8 iterations, forward-backward check at 1 px) on CLAHE-equalized frames
    (grid 8, clip 2.0), the defaults of TrackerParams."""
    cfg, intr = bench_config()
    return cfg.with_overrides({"frontend.tracker.prefer_provided_optical_flow": False}), intr


def stereo_imu_config():
    """(cfg, intr): bench_klt_config() with the IMU and its rotation prior
    (known-rotation RANSAC); in-loop stereo stays at its default (on) and
    runs on frames that carry a right image."""
    cfg, intr = bench_klt_config()
    return cfg.with_overrides({"frontend.use_imu": True, "frontend.imu.use_rotation_prior": True}), intr


def render_right(scene: DenseScenario, k: int):
    """The rectified right image of frame k (H, W, 3): the scene rendered
    from X_gt[k] @ T_lr, T_lr translating by the baseline along camera x."""
    scn = scene.scn
    T_lr = torch.eye(4, dtype=torch.float32, device=scene.device)
    T_lr[0, 3] = float(scene.intr.baseline)
    X_r = lie.compose(scn.X_gt[k], T_lr)
    L_k = [L[k] for L in scn.L_gt]
    depth_r, mask_r = scene._depth_mask(X_r, L_k)
    return scene._world_rgb(X_r, L_k, depth_r, mask_r)


def stereo_imu_frame(scene: DenseScenario, k: int, imu_samples: int = 32) -> FrameInputs:
    """Frame k with its right image, its provided depth corrupted by 1.15x
    (triangulated stereo depth is the only route back to the geometry) and
    the IMU window of (k-1, k]."""
    fr = scene.frame(k)
    imu, imu_valid = scene.scn.imu_window(k, imu_samples)
    return dataclasses.replace(fr, depth=fr.depth * 1.15, right=render_right(scene, k),
                               imu_samples=imu, imu_valid=imu_valid)


def batched_stereo_imu_config():
    """(cfg, intr): stereo_imu_config() tracking by the provided flow, the
    batched step's stereo + IMU mode (KLT does not run batched): frames from
    `stereo_imu_frame` on the world-textured bench scene."""
    cfg, intr = stereo_imu_config()
    return cfg.with_overrides({"frontend.tracker.prefer_provided_optical_flow": True}), intr


def batched_bytetrack_config():
    """(cfg, intr): bench_config() with ByteTrack giving the masks their
    persistent ids (prefer_provided_object_detection=False), the batched
    step's detector-label mode: masks relabelled by `label_permutations`."""
    cfg, intr = bench_config()
    return cfg.with_overrides({"frontend.tracker.prefer_provided_object_detection": False}), intr


def label_permutations(seed: int, num_frames: int, batch: int, num_labels: int) -> np.ndarray:
    """(num_frames, batch, num_labels + 1) int32 lookup tables, one per frame
    and sequence, from `numpy.random.default_rng(seed)`: entry 0 keeps the
    background, labels 1..num_labels go through a random permutation. A
    mask relabelled by them carries per-frame detector labels with no
    identity, which ByteTrack has to restore."""
    rng = np.random.default_rng(seed)
    lut = np.zeros((num_frames, batch, num_labels + 1), np.int32)
    for k in range(num_frames):
        for b in range(batch):
            lut[k, b, 1:] = rng.permutation(num_labels) + 1
    return lut


def detector_config():
    """(cfg, intr): bench_config()'s settings with the instance masks taken
    from the detector (prefer_provided_object_detection=False, so ByteTrack
    gives them persistent ids), at 384 x 640 with fx = fy = 360."""
    cfg, _ = bench_config()
    cfg = cfg.with_overrides({"frontend.tracker.prefer_provided_object_detection": False})
    intr = cam.CameraIntrinsics.create(
        fx=360.0, fy=360.0, cx=DET_WIDTH / 2, cy=DET_HEIGHT / 2,
        width=DET_WIDTH, height=DET_HEIGHT, baseline=0.537,
    )
    return cfg, intr


KITTI_MODES = {"full_batch": 0, "sliding_window": 1, "incremental": 2}
# backend_updater_enum of each formulation of the accuracy matrices
FORMULATIONS = {"wcme": 0, "wcpe": 1, "hybrid": 3}


def kitti_accuracy_config(mode: str, num_frames: int = 60, formulation: int = 3,
                          min_observable_mask_area: float = 0.0, window=None) -> DynoConfig:
    """ACCURACY.md's on-disk configuration (scripts/accuracy_report.py
    run_config_dataset) in mode `mode` ("incremental", "sliding_window" or
    "full_batch") and formulation `formulation` (backend_updater_enum: 0
    WCME, 1 WCPE, 3 hybrid): 512 static + 768 dynamic track slots, cell 8,
    8 objects, an 8-frame window (the whole sequence for full-batch), 10 LM
    iterations. `min_observable_mask_area` is the tracker's observability
    floor (the rich matrix runs at RICH_MIN_AREA); `window` replaces the
    8-frame window of the windowed modes (the sweep of
    scripts/accuracy_rich.py)."""
    opt_mode = KITTI_MODES[mode]
    return DynoConfig(
        frontend=FrontendParams(
            max_objects=8,
            tracker=TrackerParams(
                max_features_per_frame=512,
                min_features_per_frame=200,
                max_dynamic_features_per_frame=768,
                detection_cell_size=8,
                min_corner_response=1e-6,
                min_observable_mask_area=min_observable_mask_area,
            ),
        ),
        backend=BackendParams(
            optimization_mode=opt_mode,
            backend_updater_enum=formulation,
            max_frames=num_frames if opt_mode == 0 else (window or 8),
            optimizer=OptimizerParams(max_iterations=10),
        ),
    )


SWEEP_WINDOWS = (8, 12, 16)


def detector_accuracy_config(detected: bool) -> DynoConfig:
    """scripts/accuracy_detector.py run_cell's configuration: hybrid
    sliding-window over an 8-frame window at kitti_accuracy_config's widths;
    with `detected` the instance masks come from the detector, relabelled
    by ByteTrack (prefer_provided_object_detection=False)."""
    cfg = kitti_accuracy_config("sliding_window")
    if detected:
        cfg = cfg.with_overrides({"frontend.tracker.prefer_provided_object_detection": False})
    return cfg


# KITTI tracking's camera (scripts/make_fixture_sequence.py): 1242x375, and
# the disparity base line 387.5744 px = fx * 0.537 m of virtual stereo
KITTI_W, KITTI_H = 1242.0, 375.0
KITTI_FX, KITTI_CX, KITTI_CY = 721.5377, 609.5593, 172.854
KITTI_BASELINE_M = 387.5744 / KITTI_FX
# the rich matrix's observability floor, a share of the image area
# (scripts/accuracy_rich.py RICH_MIN_AREA)
RICH_MIN_AREA = 0.0065
# the world offset the fixture files carry (scripts/accuracy_rich.py
# ensure_fixture): the reader's align-to-identity path has work to do
FIXTURE_WORLD_OFFSET_XI = (0.0, 0.3, 0.0, 5.0, -1.0, 2.0)


def fixture_world_offset() -> np.ndarray:
    """(4, 4) float64: se3_exp of FIXTURE_WORLD_OFFSET_XI in f32, as the
    reference's writer scripts compute it."""
    xi = torch.tensor(FIXTURE_WORLD_OFFSET_XI, dtype=torch.float32)
    return lie.se3_exp(xi).numpy().astype(np.float64)


def fixture_scenario(num_frames: int = 60, width: int = 320, height: int = 96, rich: bool = False,
                     device="cuda") -> DenseScenario:
    """The committed dyno-KITTI fixture's scene
    (scripts/make_fixture_sequence.py fixture_scenario): KITTI's camera
    scaled to width x height, the camera driving forward 0.25 m per frame
    with a slow yaw, three cars with yaw-only motions. `rich` (the
    1242x375, 100-frame preset of scripts/accuracy_rich.py) adds a fourth
    car crossing behind the lead car: its mask drops out under the
    occlusion and re-enters."""
    s = width / KITTI_W
    intr = cam.CameraIntrinsics.create(
        fx=KITTI_FX * s, fy=KITTI_FX * (height / KITTI_H), cx=KITTI_CX * s, cy=KITTI_CY * (height / KITTI_H),
        width=width, height=height, baseline=KITTI_BASELINE_M,
    )
    objects = [
        # lead car slightly left, pulling away with a slow left yaw
        ObjectSpec(object_id=1, initial_pose_xi=np.array([0.0, 0.0, 0.0, -2.0, 0.3, 8.0]),
                   motion_xi=np.array([0.0, 0.005, 0.0, 0.0, 0.0, 0.30]), num_points=0),
        # car in the right lane, near-constant heading
        ObjectSpec(object_id=2, initial_pose_xi=np.array([0.0, 0.0, 0.0, 2.5, 0.0, 14.0]),
                   motion_xi=np.array([0.0, -0.004, 0.0, 0.0, 0.0, 0.28]), num_points=0),
        # distant car drifting across the lane, slowly caught up
        ObjectSpec(object_id=3, initial_pose_xi=np.array([0.0, 0.0, 0.0, 0.5, -0.4, 20.0]),
                   motion_xi=np.array([0.0, 0.006, 0.0, -0.04, 0.0, 0.21]), num_points=0),
    ]
    if rich:
        # crossing car: cuts right to left behind the lead car
        objects.append(ObjectSpec(object_id=4, initial_pose_xi=np.array([0.0, 0.0, 0.0, 6.5, 0.1, 16.0]),
                                  motion_xi=np.array([0.0, 0.0, 0.0, -0.17, 0.0, 0.27]), num_points=0))
    spec = ScenarioSpec(num_frames=num_frames, num_static=0,
                        camera_motion_xi=np.array([0.0, 0.002, 0.0, 0.0, 0.0, 0.25]), objects=objects)
    return DenseScenario(spec, intr, ground_y=1.5, far_depth=55.0, object_half_extent=1.2, device=device)


def synthetic_accuracy_config(mode: str, num_frames: int = 12, formulation: int = 3) -> DynoConfig:
    """ACCURACY.md's synthetic configuration (scripts/accuracy_report.py
    run_config) on the dense test scene: 256 static + 256 dynamic track
    slots, cell 8, 4 objects, an 8-frame window (the whole sequence for
    full-batch), 10 LM iterations; mode and formulation as in
    kitti_accuracy_config."""
    opt_mode = KITTI_MODES[mode]
    return DynoConfig(
        frontend=FrontendParams(
            max_objects=4,
            tracker=TrackerParams(
                max_features_per_frame=256,
                min_features_per_frame=100,
                max_dynamic_features_per_frame=256,
                detection_cell_size=8,
                min_corner_response=1e-6,
            ),
        ),
        backend=BackendParams(
            optimization_mode=opt_mode,
            backend_updater_enum=formulation,
            max_frames=num_frames if opt_mode == 0 else 8,
            max_objects=4,
            max_static_landmarks=256,
            max_dynamic_landmarks=256,
            optimizer=OptimizerParams(max_iterations=10),
        ),
    )


def kitti_real_io_config() -> DynoConfig:
    """The real-io row of scripts/bench_table.py (row_real_io): the
    incremental accuracy configuration with 2 LM iterations and deferred
    host outputs."""
    cfg = kitti_accuracy_config("incremental")
    return cfg.with_overrides({"backend.optimizer.max_iterations": 2,
                               "pipeline.defer_host_outputs": True})


def detector_scene(intr, num_frames=24, device="cuda") -> DenseScenario:
    """The bench scene's camera motion and objects, rendered with the
    world-anchored texture and the per-class object appearance the
    checkpoint was trained on: two class-0 objects (1.8 x 0.8 m half
    extents) and one class-1 object (1.1 x 1.5 m)."""
    return DenseScenario(
        _bench_spec(num_frames), intr, ground_y=1.6, far_depth=60.0,
        world_texture=True, object_texture=True,
        object_half_extents=[(1.8, 0.8), (1.1, 1.5), (1.8, 0.8)],
        object_classes=[0, 1, 0], device=device,
    )


# The dataset runs of chip_smoke.py phase 12: each on-disk format at its
# dataset's frame size and with the camera its reader expects. name ->
# (DatasetType, width, height, (fx, fy, cx, cy), baseline m, writer arguments,
# reader arguments). KITTI / Virtual KITTI 2 take KITTI tracking's camera;
# OMD the reader's default camera; TartanAir-Shibuya, VIODE and Aria the
# cameras their readers hard-code; ClusterSlam reads its camera from the
# projection files, so its 640x480, fx 500 camera is this table's choice.
# VIODE and ClusterSlam are written at a 0.5 m stereo baseline (VIODE's rig
# has 0.05 m) so that their stereo depth has 10-80 px of disparity.
DATASET_FORMATS = {
    "kitti_png": (0, 1242, 375, (721.5377, 721.5377, 609.5593, 172.854), 0.54,
                  {"mask_format": "png"}, {"mask_format": "png"}),
    "vkitti": (1, 1242, 375, (721.5377, 721.5377, 609.5593, 172.854), 0.532725, {}, {}),
    "omd": (3, 640, 480, (430.0, 430.0, 320.0, 240.0), 0.119, {"imu": True}, {}),
    "tartanair": (5, 640, 360, (772.5483399593904, 772.5483399593904, 320.0, 180.0), 0.1, {},
                  {"depth_scale": 256.0}),
    "viode": (6, 752, 480, (376.0, 376.0, 376.0, 240.0), 0.5, {"baseline": 0.5}, {"baseline": 0.5}),
    "clusterslam": (2, 640, 480, (500.0, 500.0, 320.0, 240.0), 0.5, {"baseline": 0.5}, {}),
    "aria": (4, 640, 360, (267.644012, 311.656128, 267.644012, 174.2612), 0.1, {}, {"depth_scale": 256.0}),
}


def dataset_frames(name: str) -> int:
    """Frames of format `name`'s run: 12, but 10 for VIODE and Aria, whose
    writers name frames by unpadded nanosecond stamps (k * 0.1 s) that their
    readers sort as strings, as the reference's do: past 10 frames the
    stamps gain a digit and sort out of order."""
    return 10 if name in ("viode", "aria") else 12


def dataset_spec(num_frames: int) -> ScenarioSpec:
    """The reference's dense test scene (dataproviders/synthetic_dense.py
    default_dense_scenario): the camera driving forward 0.25 m per frame,
    two objects at 10 and 14 m."""
    return ScenarioSpec(
        num_frames=num_frames,
        camera_motion_xi=np.array([0.0, 0.004, 0.0, 0.0, 0.0, 0.25]),
        objects=[
            ObjectSpec(object_id=1, initial_pose_xi=np.array([0.0, 0.0, 0.0, -2.5, 0.2, 10.0]),
                       motion_xi=np.array([0.0, 0.01, 0.0, 0.3, 0.0, 0.05])),
            ObjectSpec(object_id=2, initial_pose_xi=np.array([0.0, 0.0, 0.0, 3.0, 0.0, 14.0]),
                       motion_xi=np.array([0.0, -0.008, 0.0, -0.25, 0.0, 0.1])),
        ],
    )


def dataset_intrinsics(name: str) -> cam.CameraIntrinsics:
    _, w, h, (fx, fy, cx, cy), baseline, _, _ = DATASET_FORMATS[name]
    return cam.CameraIntrinsics.create(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h, baseline=baseline)


def dataset_scene(name: str, num_frames: int = 12, device="cuda") -> DenseScenario:
    """The two-object scene at format `name`'s frame size and camera,
    world-textured."""
    return DenseScenario(dataset_spec(num_frames), dataset_intrinsics(name), world_texture=True, device=device)
