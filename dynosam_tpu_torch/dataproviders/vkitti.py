"""Virtual KITTI 2 reader, native layout (port of
dynosam_tpu/dataproviders/vkitti.py; VirtualKittidataProvider.cc). On-disk
layout (scene / scene_type e.g. Scene01 / clone):

  vkitti_2.0.3_rgb/{scene}/{type}/frames/rgb/Camera_0/rgb_%05d.jpg
        baseline JPEG, decoded by dynosam_tpu_torch/jpeg.py
  vkitti_2.0.3_depth/.../depth/Camera_0/depth_%05d.png
        uint16 depth in centimetres -> / 100 m
  vkitti_2.0.3_forwardFlow/.../forwardFlow/Camera_0/flow_%05d.png
        16-bit BGR: R, G = flow x, y normalised to [0, 2^16-1] over
        (w-1), (h-1); B == 0 marks invalid. File k holds the k -> k+1 flow;
        frame k serves file k-1
  vkitti_2.0.3_instanceSegmentation/.../instanceSegmentation/Camera_0/
        instancegt_%05d.png — indexed PNG, palette index = trackID + 1
  vkitti_2.0.3_textgt/{scene}/{type}/
        intrinsic.txt  frame cameraID K[0,0] K[1,1] K[0,2] K[1,2]
        extrinsic.txt  frame cameraID + 16 row-major T_camera_world values;
                       X_k = align(inv(T))
        pose.txt       per-object camera-space pose (Euler angles)
        bbox.txt       per-object bbox + isMoving flag

Track ids are offset by +1 everywhere to match the instance PNG indexing.
mask_type "motion" removes the objects whose isMoving flag is false.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dynosam_tpu_torch import jpeg, native
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.base import host_frame, object_ground_truth, pad_image, padded
from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame


def decode_vkitti_flow(bgr16: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint16 BGR png content -> (H, W, 2) float32 flow."""
    h, w = bgr16.shape[:2]
    f = bgr16.astype(np.float32) * (2.0 / (2.0**16 - 1.0)) - 1.0
    flow_x = f[..., 2] * (w - 1.0)     # R channel
    flow_y = f[..., 1] * (h - 1.0)     # G channel
    invalid = bgr16[..., 0] == 0       # B == 0
    out = np.stack([flow_x, flow_y], axis=-1)
    out[invalid] = 0.0
    return out


def _euler_camera_rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    """The reference's explicit Euler composition for camera-space object
    rotations (VirtualKittidataProvider.cc:512-545)."""
    cy, sy = np.cos(ry), np.sin(ry)
    cx, sx = np.cos(rx), np.sin(rx)
    cz, sz = np.cos(rz), np.sin(rz)
    return np.array(
        [
            [cy * cz + sy * sx * sz, -cy * sz + sy * sx * cz, sy * cx],
            [cx * sz, cx * cz, -sx],
            [-sy * cz + cy * sx * sz, sy * sz + cy * sx * cz, cy * cx],
        ]
    )


class VirtualKittiDataProvider:
    """DatasetType 1. mask_type "motion" removes static objects."""

    def __init__(
        self,
        path: str,
        scene: str = "Scene01",
        scene_type: str = "clone",
        mask_type: str = "motion",
        max_objects: int = 16,
        pad_to_multiple: int = 0,
        version: str = "vkitti_2.0.3",
        device="cuda",
    ):
        self.path = path
        self.device = torch.device(device)
        self.max_objects = max_objects
        self.pad_to_multiple = pad_to_multiple
        self.mask_type = mask_type

        def sub(kind, leaf):
            return os.path.join(path, f"{version}_{kind}", scene, scene_type, "frames", leaf, "Camera_0")

        self._rgb_dir = sub("rgb", "rgb")
        self._depth_dir = sub("depth", "depth")
        self._flow_dir = sub("forwardFlow", "forwardFlow")
        self._inst_dir = sub("instanceSegmentation", "instanceSegmentation")
        self._textgt = os.path.join(path, f"{version}_textgt", scene, scene_type)

        self._n = len([f for f in os.listdir(self._rgb_dir) if f.startswith("rgb_")])
        self._h, self._w = jpeg.read_jpeg(os.path.join(self._rgb_dir, "rgb_00000.jpg")).shape[:2]

        self._K = self._load_intrinsics()
        m = pad_to_multiple
        self._intr = cam.CameraIntrinsics.create(
            fx=self._K[0], fy=self._K[1], cx=self._K[2], cy=self._K[3],
            width=padded(self._w, m), height=padded(self._h, m),
            baseline=0.532725,           # KITTI rig baseline (vkitti clone)
        )
        self._poses = self._load_extrinsics()
        self._objects = self._load_pose_txt()    # frame -> {oid: L_cam}
        self._moving = self._load_bbox_moving()  # frame -> {oid: isMoving}

    # ------------------------------------------------------------------
    def _load_intrinsics(self) -> Tuple[float, float, float, float]:
        fname = os.path.join(self._textgt, "intrinsic.txt")
        with open(fname) as f:
            next(f)  # header
            for line in f:
                vals = line.split()
                if len(vals) >= 6 and int(vals[1]) == 0:
                    return tuple(float(v) for v in vals[2:6])
        raise ValueError(f"no camera-0 intrinsics in {fname}")

    def _load_extrinsics(self) -> List[np.ndarray]:
        poses = []
        first_inv = None
        with open(os.path.join(self._textgt, "extrinsic.txt")) as f:
            next(f)  # header
            for line in f:
                vals = line.split()
                if len(vals) != 18 or int(vals[1]) != 0:
                    continue
                X = np.linalg.inv(np.array([float(v) for v in vals[2:18]]).reshape(4, 4))
                if first_inv is None:
                    first_inv = np.linalg.inv(X)
                poses.append(first_inv @ X)
        return poses

    def _load_pose_txt(self) -> Dict[int, Dict[int, np.ndarray]]:
        out: Dict[int, Dict[int, np.ndarray]] = {}
        with open(os.path.join(self._textgt, "pose.txt")) as f:
            col = {name: i for i, name in enumerate(f.readline().split())}
            for line in f:
                vals = line.split()
                if not vals or int(vals[col["cameraID"]]) != 0:
                    continue
                L = np.eye(4)
                L[:3, :3] = _euler_camera_rotation(
                    float(vals[col["rotation_camera_space_x"]]),
                    float(vals[col["rotation_camera_space_y"]]),
                    float(vals[col["rotation_camera_space_z"]]),
                )
                L[:3, 3] = [float(vals[col[c]]) for c in ("camera_space_X", "camera_space_Y", "camera_space_Z")]
                out.setdefault(int(vals[col["frame"]]), {})[int(vals[col["trackID"]]) + 1] = L
        return out

    def _load_bbox_moving(self) -> Dict[int, Dict[int, bool]]:
        fname = os.path.join(self._textgt, "bbox.txt")
        out: Dict[int, Dict[int, bool]] = {}
        if not os.path.exists(fname):
            return out
        with open(fname) as f:
            col = {name: i for i, name in enumerate(f.readline().split())}
            for line in f:
                vals = line.split()
                if not vals or int(vals[col["cameraID"]]) != 0:
                    continue
                frame = int(vals[col["frame"]])
                out.setdefault(frame, {})[int(vals[col["trackID"]]) + 1] = vals[col["isMoving"]] == "True"
        return out

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def intrinsics(self) -> cam.CameraIntrinsics:
        return self._intr

    def _load_instance_mask(self, k: int) -> np.ndarray:
        """Indexed PNG: the palette index is the label (trackID + 1)."""
        mask = native.read_png_index(os.path.join(self._inst_dir, f"instancegt_{k:05d}.png")).astype(np.int32)
        if self.mask_type == "motion":
            static_ids = [oid for oid, m in self._moving.get(k, {}).items() if not m]
            if static_ids:
                mask = np.where(np.isin(mask, static_ids), 0, mask)
        return mask

    def frame_host(self, k: int) -> FrameInputs:
        """Frame k decoded on the host, as CPU tensors."""
        rgb = jpeg.read_jpeg(os.path.join(self._rgb_dir, f"rgb_{k:05d}.jpg"))
        rgb = rgb.astype(np.float32) / np.float32(255.0)
        depth_cm = native.read_png(os.path.join(self._depth_dir, f"depth_{k:05d}.png"))
        depth = depth_cm.astype(np.float32) / np.float32(100.0)
        if k > 0:
            bgr16 = native.read_png(os.path.join(self._flow_dir, f"flow_{k - 1:05d}.png"), order="bgr")
            flow = decode_vkitti_flow(bgr16)
        else:
            flow = np.zeros((self._h, self._w, 2), np.float32)
        mask = self._load_instance_mask(k)
        h, w, m = self._h, self._w, self.pad_to_multiple
        return host_frame(k, pad_image(rgb, h, w, m), pad_image(depth, h, w, m), pad_image(flow, h, w, m),
                          pad_image(mask, h, w, m))

    def frame(self, k: int) -> FrameInputs:
        """Frame k on the provider's device."""
        return self.frame_host(k).to(self.device)

    def ground_truth(self, k: int) -> Optional[GroundTruthFrame]:
        if k >= len(self._poses):
            return None
        return object_ground_truth(self._poses[k], self._objects.get(k, {}), self._objects.get(k - 1, {}),
                                   self._poses[k - 1] if k > 0 else None, self.max_objects)

    def __iter__(self):
        for k in range(len(self)):
            yield self.frame(k), self.ground_truth(k)
