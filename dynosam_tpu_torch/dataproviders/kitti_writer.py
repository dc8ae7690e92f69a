"""Write a rendered scene to disk in the dyno-KITTI dataset format (port of
dynosam_tpu/dataproviders/kitti_writer.py; PNGs through native.write_png):

  image_0/%06d.png   RGB uint8
  flow/%06d.flo      Middlebury .flo, flow k -> k+1 stored at index k
  depth/%06d.png     uint16 disparity, depth = base_line / (raw / scale)
  motion/%06d.txt    instance-id int grid (MaskType::MOTION); with
                     mask_format="png", motion/%06d.png (8-bit grey, 16-bit
                     where an id exceeds 255), the layout the KITTI reader's
                     png branch and the Virtual KITTI repack read
  times.txt          one timestamp per line
  pose_gt.txt        "frame" + 16 row-major 4x4 values (reader aligns to I)
  object_pose.txt    "frame obj b1 b2 b3 b4 t1 t2 t3 ry" — object pose in the
                     CAMERA frame, rotation R_y(ry + pi/2)

The renderer's camera and object rotations are pure world-yaw, so the
camera-frame object rotation is exactly the format's single yaw angle; the
writer checks the round trip.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dynosam_tpu_torch import native


def _yaw_from_rotation(R: np.ndarray, tol: float = 1e-3) -> float:
    """theta with R == R_y(theta); raises where the residual exceeds tol."""
    theta = float(np.arctan2(R[0, 2], R[0, 0]))
    c, s = np.cos(theta), np.sin(theta)
    Ry = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    err = np.abs(Ry - R).max()
    if err > tol:
        raise ValueError(
            f"object rotation is not pure camera-yaw (residual {err:.2e}); "
            "the KITTI GT format cannot represent it"
        )
    return theta


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(202021.25).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)


def host(x) -> np.ndarray:
    """A tensor (on any device) or array -> numpy on the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def host_frames(dense):
    """Every frame of a DenseScenario as {field: numpy array}."""
    return [{k: host(v) for k, v in dense.frame(k).tensors().items()}
            for k in range(dense.scn.spec.num_frames)]


def rgb8(rgb: np.ndarray) -> np.ndarray:
    """float RGB in [0, 1] -> uint8, truncating as the reference's writers do."""
    return (rgb * 255.0).astype(np.uint8)


def write_kitti_sequence(
    dense,
    out_dir: str,
    base_line: float,
    depth_scale_factor: float = 256.0,
    world_offset: np.ndarray | None = None,
    timestep: float = 0.1,
    write_params: bool = True,
    mask_format: str = "txt",
) -> None:
    """Serialize a DenseScenario to `out_dir` in dyno-KITTI layout.

    world_offset: optional 4x4 premultiplied onto all GT camera poses before
    writing, exercising the reader's align-first-pose-to-identity path.
    """
    if mask_format not in ("txt", "png"):
        raise ValueError(f"mask_format must be 'txt' or 'png', not {mask_format!r}")
    for sub in ("image_0", "flow", "depth", "motion"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    scn = dense.scn
    n = scn.spec.num_frames
    X_gt = [host(x).astype(np.float64) for x in scn.X_gt]
    offset = np.eye(4) if world_offset is None else np.asarray(world_offset)

    frames = host_frames(dense)

    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        for k in range(n):
            f.write(f"{k * timestep:.6f}\n")

    with open(os.path.join(out_dir, "pose_gt.txt"), "w") as f:
        for k in range(n):
            T = offset @ X_gt[k]
            vals = " ".join(f"{v:.9f}" for v in T.reshape(-1))
            f.write(f"{k} {vals}\n")

    obj_lines = []
    for k in range(n):
        inp = frames[k]
        name = f"{k:06d}"
        native.write_png(os.path.join(out_dir, "image_0", name + ".png"), rgb8(inp["rgb"]))

        depth = inp["depth"].astype(np.float64)
        if depth.min() <= base_line * depth_scale_factor / 65535.0:
            raise ValueError("depth too small for uint16 disparity encoding")
        raw = np.clip(base_line / depth * depth_scale_factor, 0, 65535)
        native.write_png(os.path.join(out_dir, "depth", name + ".png"), np.round(raw).astype(np.uint16))

        mask = inp["mask"].astype(np.int32)
        if mask_format == "txt":
            np.savetxt(os.path.join(out_dir, "motion", name + ".txt"), mask, fmt="%d")
        else:
            native.write_png(os.path.join(out_dir, "motion", name + ".png"),
                             mask.astype(np.uint8 if mask.max(initial=0) < 256 else np.uint16))

        # file k stores the k -> k+1 flow (the renderer's flow of frame k+1)
        write_flo(
            os.path.join(out_dir, "flow", name + ".flo"),
            frames[k + 1]["flow"] if k + 1 < n else np.zeros(mask.shape + (2,), np.float32),
        )

        # object GT: pose in camera frame, yaw-only rotation
        for j, oid in enumerate(scn.object_ids):
            L_w = host(scn.L_gt[j][k]).astype(np.float64)
            obj_mask = mask == oid
            if not obj_mask.any():
                continue  # not visible this frame -> no GT line (as in KITTI)
            rows = np.any(obj_mask, axis=1).nonzero()[0]
            cols = np.any(obj_mask, axis=0).nonzero()[0]
            b1, b2, b3, b4 = cols[0], rows[0], cols[-1] + 1, rows[-1] + 1
            L_cam = np.linalg.inv(X_gt[k]) @ L_w
            ry = _yaw_from_rotation(L_cam[:3, :3]) - np.pi / 2
            t = L_cam[:3, 3]
            obj_lines.append(
                f"{k} {oid} {b1} {b2} {b3} {b4} "
                f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} {ry:.9f}"
            )

    with open(os.path.join(out_dir, "object_pose.txt"), "w") as f:
        f.write("\n".join(obj_lines) + "\n")

    if write_params:
        intr = dense.intr
        with open(os.path.join(out_dir, "DatasetParams.yaml"), "w") as f:
            f.write(
                "mask_type: MOTION\n"
                f"base_line: {base_line}\n"
                f"depth_scale_factor: {depth_scale_factor}\n"
                f"fx: {float(intr.fx)}\n"
                f"fy: {float(intr.fy)}\n"
                f"cx: {float(intr.cx)}\n"
                f"cy: {float(intr.cy)}\n"
                f"width: {int(intr.width)}\n"
                f"height: {int(intr.height)}\n"
            )
