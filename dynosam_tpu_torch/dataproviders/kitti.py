"""KITTI-tracking (dyno-preprocessed) dataset reader (port of
dynosam_tpu/dataproviders/kitti.py). On-disk layout:

  image_0/%06d.png    RGB frames
  flow/%06d.flo       dense optical flow k -> k+1 stored at frame k
  depth/%06d.png      uint16 disparity; depth = base_line / (raw / depth_scale_factor)
  motion/%06d.txt     instance masks as whitespace-separated int grids
  semantic/%06d.txt   (mask_type MOTION vs SEMANTIC_INSTANCE); with
                      mask_format="png", %06d.png read as cv2.IMREAD_UNCHANGED
                      reads it (the Virtual KITTI repack)
  pose_gt.txt         "frame_id" + 16 row-major 4x4 entries per line, aligned
                      so the first pose is the identity
  object_pose.txt     frame obj_id bbox(4) t(3) ry; object pose in the camera
                      frame, R from yaw + pi/2
  DatasetParams.yaml  optional base_line / depth_scale_factor / mask_type /
                      intrinsics

Frame k carries the (k-1 -> k) flow, i.e. flow file k-1 (zeros at k = 0).
Decoding runs on the host (dynosam_tpu_torch/native.py): `frame_host(k)`
returns CPU tensors that share the decoded numpy buffers, `frame(k)` the
same frame on the provider's device. Ground truth stays host numpy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dynosam_tpu_torch import native
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.base import object_ground_truth
from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame

# KITTI tracking camera intrinsics (sequences 0000-0013)
DEFAULT_INTRINSICS = dict(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854)


def _yaw_pose(t: np.ndarray, ry: float) -> np.ndarray:
    """Object pose from KITTI yaw: a rotation about the camera y-axis."""
    y = ry + np.pi / 2
    cy, sy = np.cos(y), np.sin(y)
    R = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class KittiDataProvider:
    def __init__(
        self,
        path: str,
        base_line: float = 387.5744,
        depth_scale_factor: float = 256.0,
        mask_folder: str = "motion",
        mask_format: str = "txt",
        intrinsics: Optional[Dict[str, float]] = None,
        max_objects: int = 16,
        pad_to_multiple: int = 0,
        device="cuda",
    ):
        self.path = path
        self.device = torch.device(device)
        # DatasetParams.yaml overrides the defaults; explicit constructor
        # arguments override both
        dp = self._load_dataset_params()
        self.base_line = dp.get("base_line", base_line) if base_line == 387.5744 else base_line
        self.depth_scale_factor = (
            dp.get("depth_scale_factor", depth_scale_factor)
            if depth_scale_factor == 256.0
            else depth_scale_factor
        )
        if "mask_type" in dp and mask_folder == "motion":
            mask_folder = (
                "motion" if str(dp["mask_type"]).upper() == "MOTION" else "semantic"
            )
        if mask_format not in ("txt", "png"):
            raise ValueError(f"mask_format must be 'txt' or 'png', not {mask_format!r}")
        self.mask_folder = mask_folder
        self.mask_format = mask_format
        self.max_objects = max_objects
        self.pad_to_multiple = pad_to_multiple
        if intrinsics is None and all(k in dp for k in ("fx", "fy", "cx", "cy")):
            intrinsics = {k: float(dp[k]) for k in ("fx", "fy", "cx", "cy")}

        rgb_dir = os.path.join(path, "image_0")
        self._n = len([f for f in os.listdir(rgb_dir) if f.endswith(".png")])
        self._h, self._w = native.read_png(os.path.join(rgb_dir, "000000.png"), color=True).shape[:2]

        ip = dict(DEFAULT_INTRINSICS)
        if intrinsics:
            ip.update(intrinsics)
        # the baseline in metres is the constructor's base_line over fx, as
        # in the reference (the dataset file's base_line sets only the depth)
        self._intr = cam.CameraIntrinsics.create(
            fx=ip["fx"], fy=ip["fy"], cx=ip["cx"], cy=ip["cy"],
            width=self._padded(self._w), height=self._padded(self._h),
            baseline=base_line / ip["fx"],
        )

        self._poses = self._load_camera_poses()
        self._object_gt = self._load_object_poses()

    # ------------------------------------------------------------------
    def _load_dataset_params(self) -> Dict[str, float]:
        fname = os.path.join(self.path, "DatasetParams.yaml")
        out: Dict[str, float] = {}
        if not os.path.exists(fname):
            return out
        with open(fname) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                v = v.strip()
                try:
                    out[k.strip()] = float(v)
                except ValueError:
                    out[k.strip()] = v
        return out

    def _padded(self, x: int) -> int:
        m = self.pad_to_multiple
        return x if m <= 0 else ((x + m - 1) // m) * m

    def _pad(self, img: np.ndarray, value=0.0) -> np.ndarray:
        H, W = self._padded(self._h), self._padded(self._w)
        if img.shape[0] == H and img.shape[1] == W:
            return img
        pad = [(0, H - img.shape[0]), (0, W - img.shape[1])] + [(0, 0)] * (img.ndim - 2)
        return np.pad(img, pad, constant_values=value)

    def _load_camera_poses(self) -> List[np.ndarray]:
        fname = os.path.join(self.path, "pose_gt.txt")
        poses = []
        if not os.path.exists(fname):
            return poses
        first_inv = None
        with open(fname) as f:
            for line in f:
                vals = line.split()
                if len(vals) < 17:
                    continue
                T = np.array([float(v) for v in vals[1:17]]).reshape(4, 4)
                if first_inv is None:
                    first_inv = np.linalg.inv(T)
                poses.append(first_inv @ T)
        return poses

    def _load_object_poses(self) -> Dict[int, Dict[int, np.ndarray]]:
        """frame -> {object_id -> L_camera (4,4)}."""
        fname = os.path.join(self.path, "object_pose.txt")
        out: Dict[int, Dict[int, np.ndarray]] = {}
        if not os.path.exists(fname):
            return out
        with open(fname) as f:
            for line in f:
                vals = [float(v) for v in line.split()]
                if len(vals) < 10:
                    continue
                frame, oid = int(vals[0]), int(vals[1])
                out.setdefault(frame, {})[oid] = _yaw_pose(np.array(vals[6:9]), vals[9])
        return out

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def intrinsics(self) -> cam.CameraIntrinsics:
        return self._intr

    def frame_host(self, k: int) -> FrameInputs:
        """Frame k decoded on the host, as CPU tensors."""
        name = f"{k:06d}"
        rgb = native.read_png(os.path.join(self.path, "image_0", name + ".png"), color=True)
        rgb = rgb.astype(np.float32) / np.float32(255.0)
        raw = native.read_png(os.path.join(self.path, "depth", name + ".png"))
        depth = native.disparity_to_depth(raw, self.base_line, self.depth_scale_factor)
        if k > 0:
            flow = native.read_flo(
                os.path.join(self.path, "flow", f"{k - 1:06d}.flo"), self._h, self._w
            )
        else:
            flow = np.zeros((self._h, self._w, 2), np.float32)
        if self.mask_format == "txt":
            mask = native.read_txt_mask(
                os.path.join(self.path, self.mask_folder, name + ".txt"), self._h, self._w
            )
        else:
            mask = native.read_png(os.path.join(self.path, self.mask_folder, name + ".png"), order="bgr")
            mask = mask.astype(np.int32)
        return FrameInputs(
            frame_id=torch.tensor(k, dtype=torch.int32),
            rgb=torch.from_numpy(np.ascontiguousarray(self._pad(rgb))),
            depth=torch.from_numpy(np.ascontiguousarray(self._pad(depth))),
            flow=torch.from_numpy(np.ascontiguousarray(self._pad(flow))),
            mask=torch.from_numpy(np.ascontiguousarray(self._pad(mask))),
        )

    def frame(self, k: int) -> FrameInputs:
        """Frame k on the provider's device."""
        return self.frame_host(k).to(self.device)

    def ground_truth(self, k: int) -> Optional[GroundTruthFrame]:
        if k >= len(self._poses):
            return None
        return object_ground_truth(self._poses[k], self._object_gt.get(k, {}), self._object_gt.get(k - 1, {}),
                                   self._poses[k - 1] if k > 0 else None, self.max_objects)

    def __iter__(self):
        for k in range(len(self)):
            yield self.frame(k), self.ground_truth(k)
