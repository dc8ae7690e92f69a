"""VIODE reader: stereo + IMU, simulated urban driving, dyno-preprocessed
(port of dynosam_tpu/dataproviders/viode.py; ViodeDataProvider.cc):

  cam0/flow_0/<t_ns>.flo    dense flow; the flow files drive the frame list:
                            each stem is a nanosecond timestamp and a frame
                            exists only where a ground-truth odometry row
                            lies within 3 ms of it
  cam0/image_raw/<t_ns>.png left RGB
  cam1/image_raw/<t_ns>.png right image
  cam0/mask_0/<t_ns>.png    instance masks (single-channel int; 3-channel
                            colour masks are packed and relabelled)
  odometry_odom.csv         t tx ty tz qx qy qz qw (body pose, seconds);
                            rotation through the fixed NED -> CV transform,
                            translation kept as is, aligned to the first pose
  imu0_imu.csv              t ax ay az wx wy wz (seconds); frame k's window
                            covers (t_{k-1}, t_k]

There is no depth folder: the reference computes dense depth by stereo
matching. Here `cv/stereo.py::dense_stereo_depth` computes it inside
`frame_host`, on the provider's device and on the caller's current stream:
in a pipeline run with prefetch that is the prefetch worker's side stream,
and the event the consuming stream waits on follows it. It never falls back
to the CPU when the device is a card.

Camera (setSensorParams): fx = fy = 376, cx = 376, cy = 240, 752 x 480, no
distortion, baseline 0.05 m.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from dynosam_tpu_torch import native
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.base import host_frame, imu_window, pad_image, padded, stereo_depth
from dynosam_tpu_torch.dataproviders.tartanair import R_NED_CV, _quat_to_R, camera_only_ground_truth
from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame

INTRINSICS = dict(fx=376.0, fy=376.0, cx=376.0, cy=240.0)
BASELINE = 0.05
SYNC_TOLERANCE = 0.003  # seconds (ViodeDataProvider.cc:267)

IMU_PARAMS = dict(
    acc_noise_density=0.2,
    gyro_noise_density=0.05,
    acc_random_walk=0.02,
    gyro_random_walk=4.0e-5,
    gravity=(0.0, 9.8, 0.0),
)


def pack_colour_mask(mask: np.ndarray) -> np.ndarray:
    """(H, W, 3) colour semantic mask -> contiguous int32 instance labels,
    each unique colour one label, black staying background 0."""
    packed = (
        mask[..., 0].astype(np.int64) * 65536
        + mask[..., 1].astype(np.int64) * 256
        + mask[..., 2].astype(np.int64)
    )
    labels, inv = np.unique(packed, return_inverse=True)
    remap = np.arange(len(labels))
    zero = np.nonzero(labels == 0)[0]
    if len(zero) and zero[0] != 0:
        remap[zero[0]] = 0
        remap[: zero[0]] += 1
    return remap[inv].reshape(mask.shape[:2]).astype(np.int32)


def load_csv(fname: str, ncols: int) -> np.ndarray:
    """Numeric rows of a csv / whitespace file, header and comment lines
    skipped -> (N, ncols) float64."""
    if not os.path.exists(fname):
        return np.zeros((0, ncols))
    rows = []
    with open(fname) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in "#t":
                continue
            try:
                rows.append([float(v) for v in line.replace(",", " ").split()[:ncols]])
            except ValueError:
                continue
    out = np.asarray(rows, np.float64)
    return out if out.size else np.zeros((0, ncols))


class ViodeDataProvider:
    """DatasetType 6."""

    def __init__(
        self,
        path: str,
        max_objects: int = 16,
        pad_to_multiple: int = 0,
        imu_window: int = 64,
        num_disparities: int = 128,
        stereo_block_size: int = 5,
        intrinsics: Optional[dict] = None,
        baseline: float = BASELINE,
        device="cuda",
    ):
        self.path = path
        self.device = torch.device(device)
        self.max_objects = max_objects
        self.pad_to_multiple = pad_to_multiple
        self.imu_window = imu_window
        self.num_disparities = num_disparities
        self.stereo_block_size = stereo_block_size
        self._ip = dict(INTRINSICS)
        if intrinsics:
            self._ip.update(intrinsics)
        self.baseline = baseline

        odom = load_csv(os.path.join(path, "odometry_odom.csv"), 8)
        self._imu = load_csv(os.path.join(path, "imu0_imu.csv"), 7)
        stems = sorted(f[: -len(".flo")] for f in os.listdir(os.path.join(path, "cam0", "flow_0"))
                       if f.endswith(".flo"))

        # sync: keep frames whose ns stamp matches a GT row within 3 ms
        self._stems: List[str] = []
        self.timestamps: List[float] = []
        self._poses: List[np.ndarray] = []
        first_inv = None
        for stem in stems:
            t = float(stem) / 1e9
            if len(odom) == 0:
                continue
            i = int(np.argmin(np.abs(odom[:, 0] - t)))
            if abs(odom[i, 0] - t) > SYNC_TOLERANCE:
                continue
            T = np.eye(4)
            T[:3, :3] = _quat_to_R(*odom[i, 4:8]) @ R_NED_CV
            T[:3, 3] = odom[i, 1:4]
            if first_inv is None:
                first_inv = np.linalg.inv(T)
            self._poses.append(first_inv @ T)
            self._stems.append(stem)
            self.timestamps.append(t)
        self._n = len(self._stems)
        if self._n == 0:
            raise FileNotFoundError(f"no flow/odometry-synchronised frames under {path}")

        self._h, self._w = native.read_png(self._img_path("cam0", self._stems[0]), color=True).shape[:2]
        m = pad_to_multiple
        self._intr = cam.CameraIntrinsics.create(width=padded(self._w, m), height=padded(self._h, m),
                                                 baseline=self.baseline, **self._ip)

    # ------------------------------------------------------------------
    def _img_path(self, cam_name: str, stem: str) -> str:
        if cam_name == "flow":
            return os.path.join(self.path, "cam0", "flow_0", stem + ".flo")
        return os.path.join(self.path, cam_name, "image_raw", stem + ".png")

    def imu_window_for(self, k: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Padded (S, 7) [dt a g] rows + mask covering (t_{k-1}, t_k]."""
        if len(self._imu) == 0 or k <= 0:
            return None
        return imu_window(self._imu, self.timestamps[k - 1], self.timestamps[k], self.imu_window)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def intrinsics(self) -> cam.CameraIntrinsics:
        return self._intr

    def frame_host(self, k: int) -> FrameInputs:
        """Frame k decoded on the host as CPU tensors, but for its depth:
        dense stereo on the provider's device (see the module's doc)."""
        stem = self._stems[k]
        left = native.read_png(self._img_path("cam0", stem), order="bgr", color=True)
        right = native.read_png(self._img_path("cam1", stem), order="bgr", color=True)
        rgb = left[..., ::-1].astype(np.float32) / np.float32(255.0)
        h, w, m = self._h, self._w, self.pad_to_multiple
        depth = stereo_depth(native.gray_from_bgr(left), native.gray_from_bgr(right), self.device, (h, w), m,
                             fx=self._ip["fx"], baseline=self.baseline, num_disparities=self.num_disparities,
                             block_size=self.stereo_block_size)
        mask_raw = native.read_png(os.path.join(self.path, "cam0", "mask_0", stem + ".png"), order="bgr")
        mask = pack_colour_mask(mask_raw) if mask_raw.ndim == 3 else mask_raw.astype(np.int32)
        if k > 0:
            flow = native.read_flo(self._img_path("flow", self._stems[k - 1]), h, w)
        else:
            flow = np.zeros((h, w, 2), np.float32)
        return host_frame(k, pad_image(rgb, h, w, m), depth, pad_image(flow, h, w, m), pad_image(mask, h, w, m),
                          self.imu_window_for(k))

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
