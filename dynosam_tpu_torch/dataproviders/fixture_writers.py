"""Serialize rendered scenes into the OMD, native Virtual KITTI 2,
TartanAir-Shibuya, VIODE, ClusterSlam and Project Aria on-disk formats
(port of dynosam_tpu/dataproviders/fixture_writers.py).

Each writer produces the files the reference's writer produces: the same
names, layouts, text formats and pixel encodings, PNGs through
`native.write_png`, Virtual KITTI's JPEG through `jpeg.write_jpeg` at
quality 98 (the bytes `cv2.imwrite` writes), the indexed instance PNG with
the reference's palette, and grey conversions with OpenCV's fixed-point
weights (`native.gray_from_bgr`). A written sequence is a fixture for the
matching reader (see each reader's module for the field map).
"""

from __future__ import annotations

import os

import numpy as np

from dynosam_tpu_torch import jpeg, native
from dynosam_tpu_torch.dataproviders.kitti_writer import (
    _yaw_from_rotation,
    host,
    host_frames,
    rgb8,
    write_flo,
)

# X_cv = y_NED, Y_cv = z_NED, Z_cv = x_NED (tartanair.py)
R_NED_CV = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
# object rotations: carla -> opencv (clusterslam.py)
R_CARLA_CV_OBJ = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]])


def _axis_angle_from_R(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (2 * np.sin(theta))
    return w * theta


def _imu_rows(scn, n: int, timestep: float):
    """[t ax ay az gx gy gz] rows of the scenario's exact IMU samples, each
    stamped with the START of the interval it covers."""
    rows = []
    for k in range(1, n):
        samples, valid = scn.imu_window(k, n_samples=32)
        s = host(samples).astype(np.float64)
        valid = host(valid)
        t0 = (k - 1) * timestep
        ts = t0 + np.cumsum(s[:, 0]) - s[:, 0]
        for i in range(s.shape[0]):
            if valid[i]:
                rows.append([float(ts[i])] + s[i, 1:7].tolist())
    return rows


def write_omd_sequence(dense, out_dir: str, timestep: float = 0.1, imu: bool = False) -> None:
    """DenseScenario -> OMD (old dyno) layout."""
    for sub in ("image_0", "flow", "depth", "semantic"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    scn = dense.scn
    intr = dense.intr
    n = scn.spec.num_frames
    fx = float(intr.fx)
    baseline = float(intr.baseline)
    X_gt = [host(x).astype(np.float64) for x in scn.X_gt]
    frames = host_frames(dense)

    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        for k in range(n):
            f.write(f"{k * timestep:.6f}\n")

    with open(os.path.join(out_dir, "oxford.yaml"), "w") as f:
        f.write(
            f"Camera.fx: {fx}\nCamera.fy: {float(intr.fy)}\n"
            f"Camera.cx: {float(intr.cx)}\nCamera.cy: {float(intr.cy)}\n"
            f"Camera.baseline: {baseline}\n"
        )

    with open(os.path.join(out_dir, "pose_gt.txt"), "w") as f:
        for k in range(n):
            vals = " ".join(f"{v:.9f}" for v in X_gt[k].reshape(-1))
            f.write(f"{k} {vals}\n")

    obj_lines = []
    for k in range(n):
        inp = frames[k]
        name = f"{k:06d}"
        native.write_png(os.path.join(out_dir, "image_0", name + ".png"), rgb8(inp["rgb"]))
        # raw = disparity * 256, depth = baseline * fx / disparity
        disp = baseline * fx / np.maximum(inp["depth"].astype(np.float64), 1e-6)
        native.write_png(os.path.join(out_dir, "depth", name + ".png"),
                         np.clip(np.round(disp * 256.0), 0, 65535).astype(np.uint16))
        mask = inp["mask"].astype(np.int32)
        np.savetxt(os.path.join(out_dir, "semantic", name + ".txt"), mask, fmt="%d")
        if k + 1 < n:
            write_flo(os.path.join(out_dir, "flow", name + ".flo"), frames[k + 1]["flow"])

        for j, oid in enumerate(scn.object_ids):
            if not (mask == oid).any():
                continue
            L_w = host(scn.L_gt[j][k]).astype(np.float64)
            r = _axis_angle_from_R(L_w[:3, :3])
            t = L_w[:3, 3]
            obj_lines.append(
                f"{k} {oid} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{r[0]:.9f} {r[1]:.9f} {r[2]:.9f}"
            )
    with open(os.path.join(out_dir, "object_pose.txt"), "w") as f:
        f.write("\n".join(obj_lines) + "\n")

    if imu:
        # exact IMU from the piecewise-constant-twist GT
        with open(os.path.join(out_dir, "imu.csv"), "w") as f:
            for r in _imu_rows(scn, n, timestep):
                f.write(" ".join(f"{v:.9f}" for v in r) + "\n")


def encode_vkitti_flow(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) float flow -> (H, W, 3) uint16 BGR (VKITTI png content)."""
    h, w = flow.shape[:2]
    scale = (2.0**16 - 1.0) / 2.0
    fx16 = np.clip((flow[..., 0] / (w - 1.0) + 1.0) * scale, 0, 65535)
    fy16 = np.clip((flow[..., 1] / (h - 1.0) + 1.0) * scale, 0, 65535)
    b = np.full_like(fx16, 65535.0)           # valid everywhere
    return np.stack([b, fy16, fx16], axis=-1).round().astype(np.uint16)


def _vkitti_palette() -> np.ndarray:
    """The 256-entry palette of the reference writer's instance PNGs."""
    i = np.arange(256)
    return np.stack([(i * 37) % 256, (i * 73) % 256, (i * 151) % 256], axis=-1).astype(np.uint8)


def write_vkitti_sequence(
    dense,
    out_dir: str,
    scene: str = "Scene01",
    scene_type: str = "clone",
    version: str = "vkitti_2.0.3",
) -> None:
    """DenseScenario -> native VKITTI-2 layout."""

    def sub(kind, leaf):
        d = os.path.join(out_dir, f"{version}_{kind}", scene, scene_type, "frames", leaf, "Camera_0")
        os.makedirs(d, exist_ok=True)
        return d

    rgb_dir = sub("rgb", "rgb")
    depth_dir = sub("depth", "depth")
    flow_dir = sub("forwardFlow", "forwardFlow")
    inst_dir = sub("instanceSegmentation", "instanceSegmentation")
    textgt = os.path.join(out_dir, f"{version}_textgt", scene, scene_type)
    os.makedirs(textgt, exist_ok=True)

    scn = dense.scn
    intr = dense.intr
    n = scn.spec.num_frames
    X_gt = [host(x).astype(np.float64) for x in scn.X_gt]
    frames = host_frames(dense)

    with open(os.path.join(textgt, "intrinsic.txt"), "w") as f:
        f.write("frame cameraID K[0,0] K[1,1] K[0,2] K[1,2]\n")
        for k in range(n):
            f.write(f"{k} 0 {float(intr.fx)} {float(intr.fy)} {float(intr.cx)} {float(intr.cy)}\n")

    with open(os.path.join(textgt, "extrinsic.txt"), "w") as f:
        f.write("frame cameraID r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3 t2 "
                "r3,1 r3,2 r3,3 t3 0 0 0 1\n")
        for k in range(n):
            T_cw = np.linalg.inv(X_gt[k])     # world -> camera
            vals = " ".join(f"{v:.9f}" for v in T_cw.reshape(-1))
            f.write(f"{k} 0 {vals}\n")

    pose_lines = [
        "frame cameraID trackID alpha width height length "
        "world_space_X world_space_Y world_space_Z "
        "rotation_world_space_y rotation_world_space_x rotation_world_space_z "
        "camera_space_X camera_space_Y camera_space_Z "
        "rotation_camera_space_y rotation_camera_space_x rotation_camera_space_z"
    ]
    bbox_lines = [
        "frame cameraID trackID left right top bottom number_pixels "
        "truncation_ratio occupancy_ratio isMoving"
    ]
    palette = _vkitti_palette()
    for k in range(n):
        inp = frames[k]
        name = f"{k:05d}"
        jpeg.write_jpeg(os.path.join(rgb_dir, f"rgb_{name}.jpg"), rgb8(inp["rgb"]), quality=98)
        depth_cm = np.clip(np.round(inp["depth"].astype(np.float64) * 100.0), 0, 65535).astype(np.uint16)
        native.write_png(os.path.join(depth_dir, f"depth_{name}.png"), depth_cm)
        if k + 1 < n:
            native.write_png(os.path.join(flow_dir, f"flow_{name}.png"),
                             encode_vkitti_flow(frames[k + 1]["flow"]), order="bgr")
        # indexed png: pixel = trackID + 1 == the mask labels directly
        mask = inp["mask"].astype(np.int32)
        native.write_png(os.path.join(inst_dir, f"instancegt_{name}.png"), mask.astype(np.uint8),
                         palette=palette)

        for j, oid in enumerate(scn.object_ids):
            obj_mask = mask == oid
            if not obj_mask.any():
                continue
            L_w = host(scn.L_gt[j][k]).astype(np.float64)
            L_cam = np.linalg.inv(X_gt[k]) @ L_w
            ry = _yaw_from_rotation(L_cam[:3, :3])
            t = L_cam[:3, 3]
            rows = np.any(obj_mask, axis=1).nonzero()[0]
            cols = np.any(obj_mask, axis=0).nonzero()[0]
            pose_lines.append(
                f"{k} 0 {oid - 1} 0.0 1.0 1.0 1.0 0 0 0 0 0 0 "
                f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} {ry:.9f} 0.0 0.0"
            )
            bbox_lines.append(
                f"{k} 0 {oid - 1} {cols[0]} {cols[-1] + 1} {rows[0]} "
                f"{rows[-1] + 1} {int(obj_mask.sum())} 0.0 1.0 True"
            )
    with open(os.path.join(textgt, "pose.txt"), "w") as f:
        f.write("\n".join(pose_lines) + "\n")
    with open(os.path.join(textgt, "bbox.txt"), "w") as f:
        f.write("\n".join(bbox_lines) + "\n")


# ---------------------------------------------------------------------------
# TartanAir-Shibuya / VIODE / ClusterSlam / Aria

def _R_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (qw, qx, qy, qz), standard Shepperd extraction."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _depth16(depth: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.round(depth.astype(np.float64) * scale), 0, 65535).astype(np.uint16)


def write_tartanair_sequence(dense, out_dir: str, timestep: float = 0.1, depth_scale: float = 256.0) -> None:
    """DenseScenario -> TartanAir-Shibuya layout (see tartanair.py).

    gt_pose.txt stores world_R_cam in NED (the reader re-applies R_NED_CV)
    and an arbitrary global offset (the reader re-aligns to the first pose)."""
    for sub in ("image_0", "depth_0", "flow_0", "mask_0"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    scn = dense.scn
    n = scn.spec.num_frames
    X_gt = [host(x).astype(np.float64) for x in scn.X_gt]
    frames = host_frames(dense)

    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        for k in range(n):
            f.write(f"{k * timestep:.6f}\n")

    T_off = np.eye(4)
    T_off[:3, 3] = (3.0, -1.0, 2.0)
    with open(os.path.join(out_dir, "gt_pose.txt"), "w") as f:
        for k in range(n):
            T = T_off @ X_gt[k]
            q = _R_to_quat_wxyz(T[:3, :3] @ R_NED_CV.T)
            t = T[:3, 3]
            f.write(
                f"{k * timestep:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )

    for k in range(n):
        inp = frames[k]
        name = f"{k:06d}"
        native.write_png(os.path.join(out_dir, "image_0", name + ".png"), rgb8(inp["rgb"]))
        native.write_png(os.path.join(out_dir, "depth_0", name + ".png"), _depth16(inp["depth"], depth_scale))
        native.write_png(os.path.join(out_dir, "mask_0", name + ".png"), inp["mask"].astype(np.int32).astype(np.uint8))
        if k + 1 < n:
            write_flo(os.path.join(out_dir, "flow_0", name + ".flo"), frames[k + 1]["flow"])


def _synth_right_image(gray: np.ndarray, depth: np.ndarray, fx: float, baseline: float) -> np.ndarray:
    """Approximate rectified right view: R(x) = L(x + d(x)) with the left
    disparity as a proxy for the right-frame disparity (exact for
    fronto-parallel patches)."""
    h, w = gray.shape
    d = fx * baseline / np.maximum(depth, 1e-6)
    xs = np.arange(w)[None, :] + d
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    a = np.clip(xs - x0, 0.0, 1.0)
    rows = np.arange(h)[:, None]
    return (1 - a) * gray[rows, x0] + a * gray[rows, x1]


def _stereo_pair(inp, fx: float, baseline: float):
    """-> (left RGB uint8, right grey uint8 synthesised from the left)."""
    rgb = rgb8(inp["rgb"])
    gray = native.gray_from_bgr(rgb[..., ::-1]).astype(np.float64)
    right = _synth_right_image(gray, inp["depth"].astype(np.float64), fx, baseline)
    return rgb, np.clip(right, 0, 255).astype(np.uint8)


def write_viode_sequence(dense, out_dir: str, timestep: float = 0.1, baseline: float = 0.5) -> None:
    """DenseScenario -> VIODE layout (see viode.py): stereo pairs (right
    synthesised from left + GT depth), ns-stamped flow/mask/image files,
    odometry_odom.csv in the NED body convention, imu0_imu.csv.

    `baseline` is larger than VIODE's real 0.05 m so that low-resolution
    renders still carry multi-pixel disparities; the reader under test
    takes the same value."""
    for sub in ("cam0/image_raw", "cam1/image_raw", "cam0/flow_0", "cam0/mask_0"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    scn = dense.scn
    n = scn.spec.num_frames
    fx = float(dense.intr.fx)
    X_gt = [host(x).astype(np.float64) for x in scn.X_gt]
    frames = host_frames(dense)

    with open(os.path.join(out_dir, "odometry_odom.csv"), "w") as f:
        f.write("t tx ty tz qx qy qz qw\n")
        for k in range(n):
            T = X_gt[k]
            q = _R_to_quat_wxyz(T[:3, :3] @ R_NED_CV.T)
            t = T[:3, 3]
            f.write(
                f"{k * timestep:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )

    with open(os.path.join(out_dir, "imu0_imu.csv"), "w") as f:
        f.write("t ax ay az wx wy wz\n")
        for r in _imu_rows(scn, n, timestep):
            f.write(f"{r[0]:.9f} " + " ".join(f"{v:.9f}" for v in r[1:]) + "\n")

    for k in range(n):
        inp = frames[k]
        stem = str(int(round(k * timestep * 1e9)))
        left, right = _stereo_pair(inp, fx, baseline)
        native.write_png(os.path.join(out_dir, "cam0/image_raw", stem + ".png"), left)
        native.write_png(os.path.join(out_dir, "cam1/image_raw", stem + ".png"), right)
        native.write_png(os.path.join(out_dir, "cam0/mask_0", stem + ".png"),
                         inp["mask"].astype(np.int32).astype(np.uint8))
        write_flo(os.path.join(out_dir, "cam0/flow_0", stem + ".flo"),
                  frames[k + 1]["flow"] if k + 1 < n else np.zeros_like(inp["flow"]))


def write_clusterslam_sequence(dense, out_dir: str, landmarks_per_object: int = 12, baseline: float = 2.0) -> None:
    """DenseScenario -> ClusterSlam layout (see clusterslam.py).

    instance_masks get scrambled labels (3 * id + 5) so the reader's
    landmark-vote relabelling is exercised; landmarks are mask-interior
    pixels with per-cluster ids in landmark_mapping.txt."""
    for sub in ("images/left", "images/right", "optical_flow", "instance_masks", "landmarks/left", "pose"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    scn = dense.scn
    intr = dense.intr
    n = scn.spec.num_frames
    fx, fy = float(intr.fx), float(intr.fy)
    cx, cy = float(intr.cx), float(intr.cy)
    X_gt = [host(x).astype(np.float64) for x in scn.X_gt]
    frames = host_frames(dense)

    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([np.eye(3), np.array([[-baseline], [0.0], [0.0]])])
    with open(os.path.join(out_dir, "intrinsic.txt"), "w") as f:
        for row in P1:
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
        f.write("\n")
        for row in P2:
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")

    mapping_lines = []
    next_lid = 0
    cluster_lids: dict = {}

    for k in range(n):
        inp = frames[k]
        name = f"{k:04d}"
        left, right = _stereo_pair(inp, fx, baseline)
        native.write_png(os.path.join(out_dir, "images/left", name + ".png"), left)
        native.write_png(os.path.join(out_dir, "images/right", name + ".png"), right)
        mask = inp["mask"].astype(np.int32)
        scrambled = np.where(mask > 0, 3 * mask + 5, 0)
        native.write_png(os.path.join(out_dir, "instance_masks", name + ".png"), scrambled.astype(np.uint8))
        if k + 1 < n:
            write_flo(os.path.join(out_dir, "optical_flow", name + ".flo"), frames[k + 1]["flow"])

        # landmarks: interior pixels of each object; stable per-cluster ids
        lm_lines = []
        rng = np.random.default_rng(1000 + k)
        for oid in scn.object_ids:
            ys, xs = np.nonzero(mask == oid)
            if len(ys) == 0:
                continue
            if oid not in cluster_lids:
                cluster_lids[oid] = list(range(next_lid, next_lid + landmarks_per_object))
                next_lid += landmarks_per_object
                for lid in cluster_lids[oid]:
                    mapping_lines.append(f"{lid} {oid}")
            sel = rng.choice(len(ys), min(landmarks_per_object, len(ys)), replace=False)
            for lid, i in zip(cluster_lids[oid], sel):
                lm_lines.append(f"{lid} {xs[i]:.1f} {ys[i]:.1f}")
        with open(os.path.join(out_dir, "landmarks/left", name + ".txt"), "w") as f:
            f.write("\n".join(lm_lines) + ("\n" if lm_lines else ""))

        # pose file: camera first, then one line per cluster id (sorted)
        lines = []
        T = X_gt[k]
        q = _R_to_quat_wxyz(T[:3, :3])
        t = T[:3, 3]
        lines.append(f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
        # cluster line i is object id i: identity for ids absent from the scene
        for oid in range(1, max(scn.object_ids) + 1):
            if oid in scn.object_ids:
                L_w = host(scn.L_gt[list(scn.object_ids).index(oid)][k]).astype(np.float64)
                R_file = R_CARLA_CV_OBJ.T @ L_w[:3, :3]
                tt = L_w[:3, 3]
            else:
                R_file, tt = np.eye(3), np.zeros(3)
            q = _R_to_quat_wxyz(R_file)
            lines.append(f"{tt[0]:.9f} {tt[1]:.9f} {tt[2]:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
        with open(os.path.join(out_dir, "pose", name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    with open(os.path.join(out_dir, "landmark_mapping.txt"), "w") as f:
        f.write("\n".join(mapping_lines) + "\n")


def write_aria_sequence(dense, out_dir: str, timestep: float = 0.1, depth_scale: float = 256.0) -> None:
    """DenseScenario -> Project Aria layout (see aria.py). Masks carry
    scrambled ids (7 * id + 3) so the reader's persistent relabelling to
    1..N is exercised; right/ holds one extra raw frame the reader pops."""
    for sub in ("rgb_sync", "right", "depth_sync", "optical_flow", "instance_masks"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    n = dense.scn.spec.num_frames
    frames = host_frames(dense)

    for k in range(n):
        inp = frames[k]
        stem = str(int(round(k * timestep * 1e9)))
        rgb = rgb8(inp["rgb"])
        native.write_png(os.path.join(out_dir, "rgb_sync", stem + ".png"), rgb)
        native.write_png(os.path.join(out_dir, "right", stem + ".png"), native.gray_from_bgr(rgb[..., ::-1]))
        native.write_png(os.path.join(out_dir, "depth_sync", stem + ".png"), _depth16(inp["depth"], depth_scale))
        mask = inp["mask"].astype(np.int32)
        native.write_png(os.path.join(out_dir, "instance_masks", stem + ".png"),
                         np.where(mask > 0, 7 * mask + 3, 0).astype(np.uint8))
        if k + 1 < n:
            write_flo(os.path.join(out_dir, "optical_flow", stem + ".flo"), frames[k + 1]["flow"])
    # one extra raw right frame (the reference pops it)
    h, w = frames[0]["rgb"].shape[:2]
    native.write_png(os.path.join(out_dir, "right", str(int(round(n * timestep * 1e9))) + ".png"),
                     np.zeros((h, w), np.uint8))
