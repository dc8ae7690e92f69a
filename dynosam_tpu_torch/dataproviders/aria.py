"""Project Aria reader: egocentric RGB-D, dyno-preprocessed layout (port of
dynosam_tpu/dataproviders/aria.py; ProjectAriaDataProvider.cc):

  rgb_sync/*.png        RGB frames (synchronised)
  right/*.png           right greyscale stream (raw: one extra file, which
                        the reference pops)
  depth_sync/*.png      depth, read unchanged -> float; `depth_scale` divides
                        the raw values of 16-bit-packed fixtures
  optical_flow/<t_ns>.flo  flow files; their count is the dataset's length
                        and their stems are nanosecond timestamps
  instance_masks/*.png  masks with arbitrary ids, relabelled 1..N with a
                        mapping that persists across frames (so frames are
                        read in order)

The reference hard-codes the rectified pinhole: fx = 267.644012,
fy = 311.656128, cx = 267.644012, cy = 174.2612, 640 x 360. No ground truth
ships with the preprocessed sequences.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dynosam_tpu_torch import native
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.base import host_frame, pad_image, padded, sorted_files
from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame

INTRINSICS = dict(fx=267.644012, fy=311.656128, cx=267.644012, cy=174.2612)


class ProjectAriaDataProvider:
    """DatasetType 4."""

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

        self._rgb = sorted_files(os.path.join(path, "rgb_sync"))
        self._right = sorted_files(os.path.join(path, "right"))
        if len(self._right) == len(self._rgb) + 1:
            self._right = self._right[:-1]      # the raw stream has one extra
        self._depth = sorted_files(os.path.join(path, "depth_sync"))
        self._mask = sorted_files(os.path.join(path, "instance_masks"))
        self._flow = sorted_files(os.path.join(path, "optical_flow"))
        self._n = len(self._flow)
        if self._n == 0:
            raise FileNotFoundError(f"no flow files under {path}/optical_flow")
        self.timestamps: List[float] = [float(os.path.splitext(os.path.basename(f))[0]) / 1e9
                                        for f in self._flow]

        self._h, self._w = native.read_png(self._rgb[0], color=True).shape[:2]
        m = pad_to_multiple
        self._intr = cam.CameraIntrinsics.create(width=padded(self._w, m), height=padded(self._h, m),
                                                 **INTRINSICS)
        # persistent mask relabelling 1..N (getInstanceMask, :108-137)
        self._relabel: Dict[int, int] = {}

    def _relabel_mask(self, mask: np.ndarray) -> np.ndarray:
        out = np.zeros_like(mask)
        for old in (int(v) for v in np.unique(mask) if v != 0):
            if old not in self._relabel:
                self._relabel[old] = len(self._relabel) + 1
            out[mask == old] = self._relabel[old]
        return out

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def timestamp(self, k: int) -> float:
        return self.timestamps[k]

    def intrinsics(self) -> cam.CameraIntrinsics:
        return self._intr

    def frame_host(self, k: int) -> FrameInputs:
        """Frame k decoded on the host, as CPU tensors."""
        rgb = native.read_png(self._rgb[k], color=True).astype(np.float32) / np.float32(255.0)
        depth = native.read_png(self._depth[k], order="bgr").astype(np.float32)
        if self.depth_scale != 1.0:
            depth = depth / np.float32(self.depth_scale)
        mask_raw = native.read_png(self._mask[k], order="bgr")
        if mask_raw.ndim == 3:
            mask_raw = mask_raw[..., 0]
        mask = self._relabel_mask(mask_raw.astype(np.int32))
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
        return None  # no GT ships with the preprocessed Aria sequences

    def __iter__(self):
        for k in range(len(self)):
            yield self.frame(k), self.ground_truth(k)
