"""Oxford Multimotion Dataset (OMD) reader, dyno-preprocessed layout (port
of dynosam_tpu/dataproviders/omd.py; OMDDataProvider.cc:963-1380):

  times.txt           one timestamp per line
  image_0/*.png       RGB frames (sorted directory listing)
  depth/*.png         uint16 disparity; depth = baseline * fx / (raw / 256)
  semantic/*.txt      instance masks as whitespace-separated int grids
  flow/*.flo          dense flow k -> k+1 stored at index k (frame k carries
                      flow k-1 -> k)
  pose_gt.txt         "frame" + 16 row-major 4x4 camera pose entries, aligned
                      so the first equals identity
  object_pose.txt     "frame obj tx ty tz rx ry rz": object pose in the
                      original (unaligned) world with an axis-angle rotation,
                      re-aligned through the camera pose
  oxford.yaml         Camera.fx/fy/cx/cy, Camera.baseline
  imu.csv             optional "t ax ay az gx gy gz" rows
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dynosam_tpu_torch import native
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.base import host_frame, imu_window, pad_image, padded, sorted_files
from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame


def _axis_angle(r: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(r)
    if angle < 1e-12:
        return np.eye(3)
    k = r / angle
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _load_oxford_yaml(path: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            try:
                out[k.strip()] = float(v.strip())
            except ValueError:
                pass
    return out


class OmdDataProvider:
    """DatasetType 3."""

    def __init__(
        self,
        path: str,
        max_objects: int = 16,
        pad_to_multiple: int = 0,
        imu_window: int = 64,
        device="cuda",
    ):
        self.path = path
        self.device = torch.device(device)
        self.max_objects = max_objects
        self.pad_to_multiple = pad_to_multiple
        self.imu_window = imu_window

        y = _load_oxford_yaml(os.path.join(path, "oxford.yaml"))
        self.fx = y.get("Camera.fx", 430.0)
        self.fy = y.get("Camera.fy", 430.0)
        self.cx = y.get("Camera.cx", 320.0)
        self.cy = y.get("Camera.cy", 240.0)
        self.baseline = y.get("Camera.baseline", 0.119)

        self._rgb = sorted_files(os.path.join(path, "image_0"), ".png")
        self._depth = sorted_files(os.path.join(path, "depth"), ".png")
        self._mask = sorted_files(os.path.join(path, "semantic"), ".txt")
        self._flow = sorted_files(os.path.join(path, "flow"), ".flo")
        self._n = len(self._rgb)

        self.timestamps: List[float] = []
        tf = os.path.join(path, "times.txt")
        if os.path.exists(tf):
            with open(tf) as f:
                self.timestamps = [float(s) for s in f.read().split()]

        self._h, self._w = native.read_png(self._rgb[0], color=True).shape[:2]
        m = pad_to_multiple
        self._intr = cam.CameraIntrinsics.create(
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
            width=padded(self._w, m), height=padded(self._h, m), baseline=self.baseline,
        )
        self._poses, self._pose_raw = self._load_camera_poses()
        self._object_gt = self._load_object_poses()
        self._imu = self._load_imu()

    # ------------------------------------------------------------------
    def _load_camera_poses(self):
        fname = os.path.join(self.path, "pose_gt.txt")
        aligned, raw = [], []
        if not os.path.exists(fname):
            return aligned, raw
        first_inv = None
        with open(fname) as f:
            for line in f:
                vals = line.split()
                if len(vals) < 17:
                    continue
                T = np.array([float(v) for v in vals[1:17]]).reshape(4, 4)
                raw.append(T)
                if first_inv is None:
                    first_inv = np.linalg.inv(T)
                aligned.append(first_inv @ T)
        return aligned, raw

    def _load_object_poses(self) -> Dict[int, Dict[int, np.ndarray]]:
        """frame -> {oid -> L in the original world frame}."""
        fname = os.path.join(self.path, "object_pose.txt")
        out: Dict[int, Dict[int, np.ndarray]] = {}
        if not os.path.exists(fname):
            return out
        with open(fname) as f:
            for line in f:
                vals = [float(v) for v in line.split()]
                if len(vals) < 8:
                    continue
                L = np.eye(4)
                L[:3, 3] = vals[2:5]
                L[:3, :3] = _axis_angle(np.asarray(vals[5:8]))
                out.setdefault(int(vals[0]), {})[int(vals[1])] = L
        return out

    def _load_imu(self):
        fname = os.path.join(self.path, "imu.csv")
        if not os.path.exists(fname):
            return None
        rows = []
        with open(fname) as f:
            for line in f:
                line = line.replace(",", " ").split()
                if len(line) >= 7:
                    try:
                        rows.append([float(v) for v in line[:7]])
                    except ValueError:
                        continue
        return np.asarray(rows) if rows else None

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def intrinsics(self) -> cam.CameraIntrinsics:
        return self._intr

    def imu_window_for(self, k: int):
        """Padded (S, 7) [dt a g] rows + mask for (t_{k-1}, t_k]; None if the
        dataset has no imu.csv."""
        if self._imu is None or k <= 0 or k >= len(self.timestamps):
            return None
        return imu_window(self._imu, self.timestamps[k - 1], self.timestamps[k], self.imu_window)

    def frame_host(self, k: int) -> FrameInputs:
        """Frame k decoded on the host, as CPU tensors."""
        rgb = native.read_png(self._rgb[k], color=True).astype(np.float32) / np.float32(255.0)
        raw = native.read_png(self._depth[k]).astype(np.float64)
        # depth = baseline * fx / (raw / 256)   (OMDDataProvider.cc:1003-1015)
        disp = raw / 256.0
        depth = np.where(disp > 1e-6, self.baseline * self.fx / np.maximum(disp, 1e-6), 0.0).astype(np.float32)
        if k > 0 and k - 1 < len(self._flow):
            flow = native.read_flo(self._flow[k - 1], self._h, self._w)
        else:
            flow = np.zeros((self._h, self._w, 2), np.float32)
        mask = native.read_txt_mask(self._mask[k], self._h, self._w)
        h, w, m = self._h, self._w, self.pad_to_multiple
        return host_frame(k, pad_image(rgb, h, w, m), pad_image(depth, h, w, m), pad_image(flow, h, w, m),
                          pad_image(mask, h, w, m), self.imu_window_for(k))

    def frame(self, k: int) -> FrameInputs:
        """Frame k on the provider's device."""
        return self.frame_host(k).to(self.device)

    def ground_truth(self, k: int) -> Optional[GroundTruthFrame]:
        if k >= len(self._poses):
            return None
        X, X_raw = self._poses[k], self._pose_raw[k]
        J = self.max_objects
        ids = np.full((J,), -1, np.int32)
        poses = np.tile(np.eye(4), (J, 1, 1))
        motions = np.tile(np.eye(4), (J, 1, 1))
        valid = np.zeros((J,), bool)
        objs = self._object_gt.get(k, {})
        prev = self._object_gt.get(k - 1, {})
        for j, (oid, L_raw) in enumerate(sorted(objs.items())[:J]):
            ids[j] = oid
            # relative pose in the camera, re-expressed in the aligned world
            L_w = X @ (np.linalg.inv(X_raw) @ L_raw)
            poses[j] = L_w
            valid[j] = True
            if oid in prev and k > 0:
                L_w_prev = self._poses[k - 1] @ (np.linalg.inv(self._pose_raw[k - 1]) @ prev[oid])
                motions[j] = L_w @ np.linalg.inv(L_w_prev)
        return GroundTruthFrame(
            X_world_cam=np.asarray(X, np.float32),
            object_ids=ids,
            object_poses=np.asarray(poses, np.float32),
            object_motions=np.asarray(motions, np.float32),
            object_valid=valid,
        )

    def __iter__(self):
        for k in range(len(self)):
            yield self.frame(k), self.ground_truth(k)
