"""TartanAir-Shibuya reader: dynamic pedestrian crowds, monocular RGB-D
(port of dynosam_tpu/dataproviders/tartanair.py; TartanAirShibuya.cc):

  image_0/*.png       RGB frames (sorted directory listing)
  depth_0/*.png       depth, read unchanged -> float; `depth_scale` divides
                      the raw values of 16-bit-packed fixtures
  flow_0/*.flo        dense flow k -> k+1 at index k; the number of flow
                      files is the dataset's length (one less than the
                      frames). Frame k carries the (k-1 -> k) flow.
  mask_0/*.png        instance masks, read unchanged -> int32
  times.txt           one timestamp per line, sorted (the raw files are not)
  gt_pose.txt         TUM lines `t tx ty tz qx qy qz qw`: world_R_cam in NED,
                      converted with the fixed NED -> CV rotation and aligned
                      so the first pose is the identity. Camera-only.

The reference hard-codes the camera: fx = fy = 772.5483399593904, cx = 320,
cy = 180, 640 x 360, no distortion.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from dynosam_tpu_torch import native
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.base import host_frame, pad_image, padded, sorted_files
from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame

# X_cv(right) = y_NED, Y_cv(down) = z_NED, Z_cv(forward) = x_NED
R_NED_CV = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])

INTRINSICS = dict(fx=772.5483399593904, fy=772.5483399593904, cx=320.0, cy=180.0)


def _quat_to_R(qx, qy, qz, qw) -> np.ndarray:
    q = np.array([qw, qx, qy, qz], np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def camera_only_ground_truth(X: np.ndarray, max_objects: int) -> GroundTruthFrame:
    J = max_objects
    return GroundTruthFrame(
        X_world_cam=np.asarray(X, np.float32),
        object_ids=np.full((J,), -1, np.int32),
        object_poses=np.tile(np.eye(4, dtype=np.float32), (J, 1, 1)),
        object_motions=np.tile(np.eye(4, dtype=np.float32), (J, 1, 1)),
        object_valid=np.zeros((J,), bool),
    )


class TartanAirShibuyaDataProvider:
    """DatasetType 5."""

    def __init__(
        self,
        path: str,
        depth_scale: float = 1.0,
        max_objects: int = 16,
        pad_to_multiple: int = 0,
        device="cuda",
    ):
        self.path = path
        self.device = torch.device(device)
        self.depth_scale = depth_scale
        self.max_objects = max_objects
        self.pad_to_multiple = pad_to_multiple

        self._rgb = sorted_files(os.path.join(path, "image_0"), ".png")
        self._depth = sorted_files(os.path.join(path, "depth_0"), ".png")
        self._mask = sorted_files(os.path.join(path, "mask_0"), ".png")
        self._flow = sorted_files(os.path.join(path, "flow_0"), ".flo")
        # the flow-file count is the dataset's length (TartanAirShibuya.cc:138)
        self._n = len(self._flow)
        if self._n == 0:
            raise FileNotFoundError(f"no flow files under {path}/flow_0")

        self._h, self._w = native.read_png(self._rgb[0], color=True).shape[:2]
        m = pad_to_multiple
        self._intr = cam.CameraIntrinsics.create(width=padded(self._w, m), height=padded(self._h, m),
                                                 **INTRINSICS)
        self._times = self._load_times()
        self._poses = self._load_gt_poses()

    # ------------------------------------------------------------------
    def _load_times(self) -> List[float]:
        fname = os.path.join(self.path, "times.txt")
        times: List[float] = []
        if os.path.exists(fname):
            with open(fname) as f:
                times = sorted(float(v) for v in f.read().split())
        return times

    def _load_gt_poses(self) -> List[np.ndarray]:
        fname = os.path.join(self.path, "gt_pose.txt")
        poses: List[np.ndarray] = []
        if not os.path.exists(fname):
            return poses
        first_inv = None
        with open(fname) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, tx, ty, tz, qx, qy, qz, qw = (float(v) for v in line.split())
                T = np.eye(4)
                T[:3, :3] = _quat_to_R(qx, qy, qz, qw) @ R_NED_CV
                T[:3, 3] = (tx, ty, tz)
                if first_inv is None:
                    first_inv = np.linalg.inv(T)
                poses.append(first_inv @ T)
        return poses

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def timestamp(self, k: int) -> float:
        return self._times[k] if k < len(self._times) else float(k)

    def intrinsics(self) -> cam.CameraIntrinsics:
        return self._intr

    def frame_host(self, k: int) -> FrameInputs:
        """Frame k decoded on the host, as CPU tensors."""
        rgb = native.read_png(self._rgb[k], color=True).astype(np.float32) / np.float32(255.0)
        depth = native.read_png(self._depth[k], order="bgr").astype(np.float32)
        if self.depth_scale != 1.0:
            depth = depth / np.float32(self.depth_scale)
        mask = native.read_png(self._mask[k], order="bgr").astype(np.int32)
        if k > 0:
            flow = native.read_flo(self._flow[k - 1], self._h, self._w)
        else:
            flow = np.zeros((self._h, self._w, 2), np.float32)
        h, w, m = self._h, self._w, self.pad_to_multiple
        return host_frame(k, pad_image(rgb, h, w, m), pad_image(depth, h, w, m), pad_image(flow, h, w, m),
                          pad_image(mask, h, w, m))

    def frame(self, k: int) -> FrameInputs:
        """Frame k on the provider's device."""
        return self.frame_host(k).to(self.device)

    def ground_truth(self, k: int) -> Optional[GroundTruthFrame]:
        if k >= len(self._poses):
            return None
        return camera_only_ground_truth(self._poses[k], self.max_objects)

    def __iter__(self):
        for k in range(len(self)):
            yield self.frame(k), self.ground_truth(k)
