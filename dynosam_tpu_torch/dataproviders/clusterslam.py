"""ClusterSlam (CARLA) reader: stereo with cluster-labelled landmark ground
truth (port of dynosam_tpu/dataproviders/clusterslam.py;
ClusterSlamDataProvider.cc):

  images/left/*.png  images/right/*.png
  optical_flow/*.flo        flow k -> k+1 at index k; the flow-file count is
                            the dataset's length (= images - 1). Frame k
                            carries the (k-1 -> k) flow.
  instance_masks/*          detection masks whose labels are not the GT
                            cluster ids: relabelled per frame by assigning
                            mask objects to landmark clusters with a
                            keypoints-in-bounding-box vote solved as a linear
                            assignment (scipy's Hungarian solver)
  landmarks/left/%04d.txt   lines `landmark_id u v` per frame
  landmark_mapping.txt      lines `landmark_id cluster_id`; cluster 0 is the
                            camera trajectory, object ids start at 1
  pose/%04d.txt             line 0 the camera pose, line i > 0 cluster i's,
                            `x y z qw qx qy qz`; camera poses aligned to the
                            first frame, object rotations through the fixed
                            carla -> opencv rotation, re-anchored through the
                            frame's camera pose
  intrinsic.txt             two 3x4 projection matrices (left, right) split
                            by a blank line; baseline from K^-1 P of the right

Depth is dense stereo: `cv/stereo.py::dense_stereo_depth` inside
`frame_host`, on the provider's device and on the caller's current stream
(the prefetch worker's side stream in a pipeline run with prefetch, whose
event the consuming stream waits on); never on the CPU when the device is a
card. The grey images it matches are OpenCV's fixed-point BGR(A) -> grey.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dynosam_tpu_torch import native
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.base import host_frame, pad_image, padded, sorted_files, stereo_depth
from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame

# object rotations: carla -> opencv (ClusterSlamDataProvider.cc:644-647)
R_CARLA_CV_OBJ = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]])


def _quat_wxyz_to_R(qw, qx, qy, qz) -> np.ndarray:
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


def relabel_mask_by_landmarks(mask: np.ndarray, keypoints: Dict[int, np.ndarray]) -> np.ndarray:
    """Relabel detection-mask objects to GT cluster ids.

    `keypoints` maps cluster_id -> (N, 2) [u, v]. Each mask object votes for
    the clusters with keypoints inside its bounding box; the assignment
    maximising the votes is solved as a linear-sum assignment. Unassigned
    objects are zeroed."""
    from scipy.optimize import linear_sum_assignment

    out = np.zeros_like(mask)
    obj_ids = [int(v) for v in np.unique(mask) if v != 0]
    cluster_ids = sorted(keypoints)
    if not obj_ids or not cluster_ids:
        return out
    counts = np.zeros((len(obj_ids), len(cluster_ids)))
    for i, oid in enumerate(obj_ids):
        ys, xs = np.nonzero(mask == oid)
        x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
        for j, cid in enumerate(cluster_ids):
            kp = keypoints[cid]
            inside = (kp[:, 0] >= x0) & (kp[:, 0] <= x1) & (kp[:, 1] >= y0) & (kp[:, 1] <= y1)
            counts[i, j] = inside.sum()
    rows, cols = linear_sum_assignment(-counts)
    for i, j in zip(rows, cols):
        if counts[i, j] > 0:
            out[mask == obj_ids[i]] = cluster_ids[j]
    return out


def _gray_and_rgb(img: np.ndarray, path: str):
    """An image as cv2.IMREAD_UNCHANGED reads it (BGR order) -> (grey uint8,
    RGB uint8), as the reference converts it with cv2."""
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: {img.dtype} stereo images are not read (8-bit are)")
    if img.ndim == 2:
        return img, np.repeat(img[..., None], 3, axis=-1)
    return native.gray_from_bgr(img), np.ascontiguousarray(img[..., 2::-1])


class ClusterSlamDataProvider:
    """DatasetType 2."""

    def __init__(
        self,
        path: str,
        max_objects: int = 16,
        pad_to_multiple: int = 0,
        num_disparities: int = 128,
        stereo_block_size: int = 5,
        device="cuda",
    ):
        self.path = path
        self.device = torch.device(device)
        self.max_objects = max_objects
        self.pad_to_multiple = pad_to_multiple
        self.num_disparities = num_disparities
        self.stereo_block_size = stereo_block_size

        def listing(sub):
            return sorted_files(os.path.join(path, sub))

        self._left = listing("images/left")
        self._right = listing("images/right")
        self._flow = listing("optical_flow")
        self._masks = listing("instance_masks")
        self._n = len(self._flow)
        if self._n == 0:
            raise FileNotFoundError(f"no flow files under {path}/optical_flow")

        self._landmarks = self._load_landmarks(listing("landmarks/left"))
        self._mapping = self._load_mapping(os.path.join(path, "landmark_mapping.txt"))
        self._load_intrinsics(os.path.join(path, "intrinsic.txt"))
        self._load_poses(listing("pose"))

        self._h, self._w = native.read_png(self._left[0], color=True).shape[:2]
        m = pad_to_multiple
        self._intr = cam.CameraIntrinsics.create(
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
            width=padded(self._w, m), height=padded(self._h, m), baseline=self.baseline,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _load_landmarks(files: List[str]) -> Dict[int, Dict[int, np.ndarray]]:
        """frame -> {landmark_id -> (u, v)}; frame id from the file stem."""
        out: Dict[int, Dict[int, np.ndarray]] = {}
        for fname in files:
            per: Dict[int, np.ndarray] = {}
            with open(fname) as f:
                for line in f:
                    vals = line.split()
                    if len(vals) == 3:
                        per[int(vals[0])] = np.array([float(vals[1]), float(vals[2])])
            out[int(os.path.splitext(os.path.basename(fname))[0])] = per
        return out

    @staticmethod
    def _load_mapping(fname: str) -> Dict[int, int]:
        out: Dict[int, int] = {}
        with open(fname) as f:
            for line in f:
                vals = line.split()
                if len(vals) == 2:
                    out[int(vals[0])] = int(vals[1])
        return out

    def _load_intrinsics(self, fname: str) -> None:
        with open(fname) as f:
            rows = [[float(v) for v in line.split()] for line in f if line.split()]
        P1, P2 = np.asarray(rows[0:3]), np.asarray(rows[3:6])
        K1 = P1[:, :3]
        self.fx, self.fy = float(K1[0, 0]), float(K1[1, 1])
        self.cx, self.cy = float(K1[0, 2]), float(K1[1, 2])
        # extrinsics_right = inv(K2^-1 @ P2); baseline = |t_x|
        E2 = np.eye(4)
        E2[:3, :] = np.linalg.inv(P2[:, :3]) @ P2
        self.baseline = float(abs(np.linalg.inv(E2)[0, 3])) or 0.5

    def _load_poses(self, files: List[str]) -> None:
        """pose/%04d.txt: camera pose (line 0) + cluster poses (lines 1..)."""
        self._cam_poses: Dict[int, np.ndarray] = {}
        self._obj_poses: Dict[int, Dict[int, np.ndarray]] = {}
        initial_inv = None
        for fname in sorted(files):
            frame = int(os.path.splitext(os.path.basename(fname))[0])
            with open(fname) as f:
                lines = [[float(v) for v in line.split()] for line in f if line.split()]
            poses = []
            for vals in lines:
                T = np.eye(4)
                T[:3, :3] = _quat_wxyz_to_R(*vals[3:7])
                T[:3, 3] = vals[0:3]
                poses.append(T)
            original_cam = poses[0]
            if initial_inv is None:
                initial_inv = np.linalg.inv(original_cam)
            aligned_cam = initial_inv @ original_cam
            self._cam_poses[frame] = aligned_cam
            objs: Dict[int, np.ndarray] = {}
            for i, T in enumerate(poses[1:], start=1):
                obj = T.copy()
                obj[:3, :3] = R_CARLA_CV_OBJ @ T[:3, :3]
                objs[i] = aligned_cam @ (np.linalg.inv(original_cam) @ obj)
            self._obj_poses[frame] = objs

    def _cluster_keypoints(self, k: int) -> Dict[int, np.ndarray]:
        """cluster_id -> (N, 2) keypoints at frame k (ids > 0 only)."""
        out: Dict[int, List[np.ndarray]] = {}
        for lid, uv in self._landmarks.get(k, {}).items():
            cid = self._mapping.get(lid, 0)
            if cid > 0:
                out.setdefault(cid, []).append(uv)
        return {cid: np.stack(v) for cid, v in out.items()}

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def intrinsics(self) -> cam.CameraIntrinsics:
        return self._intr

    def frame_host(self, k: int) -> FrameInputs:
        """Frame k decoded on the host as CPU tensors, but for its depth:
        dense stereo on the provider's device (see the module's doc)."""
        left_gray, rgb = _gray_and_rgb(native.read_png(self._left[k], order="bgr"), self._left[k])
        right_gray, _ = _gray_and_rgb(native.read_png(self._right[k], order="bgr"), self._right[k])
        rgb = rgb.astype(np.float32) / np.float32(255.0)
        h, w, m = self._h, self._w, self.pad_to_multiple
        depth = stereo_depth(left_gray, right_gray, self.device, (h, w), m,
                             fx=self.fx, baseline=self.baseline, num_disparities=self.num_disparities,
                             block_size=self.stereo_block_size)
        mask_raw = native.read_png(self._masks[k], order="bgr")
        if mask_raw.ndim == 3:
            mask_raw = mask_raw[..., 0]
        mask = relabel_mask_by_landmarks(mask_raw.astype(np.int32), self._cluster_keypoints(k))
        if k > 0:
            flow = native.read_flo(self._flow[k - 1], h, w)
        else:
            flow = np.zeros((h, w, 2), np.float32)
        return host_frame(k, pad_image(rgb, h, w, m), depth, pad_image(flow, h, w, m), pad_image(mask, h, w, m))

    def frame(self, k: int) -> FrameInputs:
        """Frame k on the provider's device."""
        return self.frame_host(k).to(self.device)

    def ground_truth(self, k: int) -> Optional[GroundTruthFrame]:
        if k not in self._cam_poses:
            return None
        X = self._cam_poses[k]
        J = self.max_objects
        ids = np.full((J,), -1, np.int32)
        poses = np.tile(np.eye(4), (J, 1, 1))
        motions = np.tile(np.eye(4), (J, 1, 1))
        valid = np.zeros((J,), bool)
        objs = self._obj_poses.get(k, {})
        prev = self._obj_poses.get(k - 1, {})
        for j, (oid, L_w) in enumerate(sorted(objs.items())[:J]):
            ids[j] = oid
            poses[j] = L_w
            valid[j] = True
            if oid in prev and k > 0:
                motions[j] = L_w @ np.linalg.inv(prev[oid])
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
