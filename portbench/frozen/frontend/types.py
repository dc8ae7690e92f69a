"""Frontend <-> backend data contracts (port of dynosam_tpu/frontend/types.py).

Fixed-capacity tables with validity masks, as in the reference. Every
table may carry a leading batch axis of sequences (the batched step,
parallel/batched.py): a (B, N, 2) track table holds B sequences' tables. The IMU
window and the right image of `FrameInputs` are optional (None when a
dataset has neither).
`GroundTruthFrame` holds host numpy arrays: ground truth is read only on
the host (logging, evaluation).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def first_true(x, dim):
    """Index of the first True along `dim` (0 if none), as jnp.argmax on a
    bool array; torch.argmax does not take bool tensors on CUDA."""
    return torch.argmax(x.to(torch.uint8), dim=dim)


def rows(idx, nb: int):
    """Index tuple that takes, per sequence, the rows `idx` of a table.

    With no batch axis (nb = 0) it is `(idx,)`: t[rows(idx, 0)] = t[idx].
    With a leading batch axis (nb = 1) `idx` is (B, ...) and the tuple pairs
    it with the batch arange, so sequence b reads (or writes) only its own
    rows: t[rows(idx, 1)][b] = t[b][idx[b]]."""
    if nb == 0:
        return (idx,)
    b = torch.arange(idx.shape[0], device=idx.device)
    return (b.reshape((-1,) + (1,) * (idx.ndim - 1)), idx)


@dataclass
class TrackTable:
    uv: torch.Tensor          # (N, 2)
    depth: torch.Tensor       # (N,)
    tracklet_id: torch.Tensor # (N,) int32, -1 = empty slot
    object_id: torch.Tensor   # (N,) int32, 0 = static background
    age: torch.Tensor         # (N,) int32
    valid: torch.Tensor       # (N,) bool

    @classmethod
    def empty(cls, n: int, dtype=torch.float32, device="cuda") -> "TrackTable":
        def full(shape, value, dt):
            return torch.full(shape, value, dtype=dt, device=device)

        return cls(uv=full((n, 2), 0.0, dtype), depth=full((n,), 0.0, dtype),
                   tracklet_id=full((n,), -1, torch.int32), object_id=full((n,), 0, torch.int32),
                   age=full((n,), 0, torch.int32), valid=full((n,), False, torch.bool))

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]


@dataclass
class VisionPacket:
    frame_id: torch.Tensor          # () int32
    X_world_cam: torch.Tensor       # (4, 4)
    odom_prev_curr: torch.Tensor    # (4, 4)
    static_tracks: TrackTable
    dynamic_tracks: TrackTable
    object_ids: torch.Tensor        # (J,) int32, -1 pad
    object_motions: torch.Tensor    # (J, 4, 4)
    object_valid: torch.Tensor      # (J,) bool
    object_resampled: torch.Tensor  # (J,) bool
    pose_valid: torch.Tensor        # () bool

    @classmethod
    def empty(cls, n_static: int, n_dynamic: int, max_objects: int, dtype=torch.float32,
              device="cuda") -> "VisionPacket":
        eye = torch.eye(4, dtype=dtype, device=device)
        return cls(
            frame_id=torch.zeros((), dtype=torch.int32, device=device),
            X_world_cam=eye,
            odom_prev_curr=eye.clone(),
            static_tracks=TrackTable.empty(n_static, dtype, device),
            dynamic_tracks=TrackTable.empty(n_dynamic, dtype, device),
            object_ids=torch.full((max_objects,), -1, dtype=torch.int32, device=device),
            object_motions=eye.expand(max_objects, 4, 4).clone(),
            object_valid=torch.zeros((max_objects,), dtype=torch.bool, device=device),
            object_resampled=torch.zeros((max_objects,), dtype=torch.bool, device=device),
            pose_valid=torch.zeros((), dtype=torch.bool, device=device),
        )


@dataclass
class FrameInputs:
    """Per-frame sensor inputs: rgb (H, W, 3) float, depth (H, W) metric z,
    flow (H, W, 2) k-1 -> k on frame k-1 pixels, mask (H, W) int32 labels;
    optionally the IMU window over (t_{k-1}, t_k] for preintegration
    (frontend/imu.py: (S, 7) rows [dt ax ay az gx gy gz] and an (S,) mask)
    and the rectified right image (H, W[, 3]) that turns on the in-loop
    stereo depth."""

    frame_id: torch.Tensor  # () int32
    rgb: torch.Tensor
    depth: torch.Tensor
    flow: torch.Tensor
    mask: torch.Tensor
    imu_samples: Optional[torch.Tensor] = None
    imu_valid: Optional[torch.Tensor] = None
    right: Optional[torch.Tensor] = None

    def tensors(self) -> dict:
        """{field name: tensor} of the fields that are set."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    def to(self, device, non_blocking=False) -> "FrameInputs":
        """These inputs with every tensor on `device` (unset fields stay None)."""
        return dataclasses.replace(self, **{
            k: v.to(device, non_blocking=non_blocking) for k, v in self.tensors().items()
        })


@dataclass
class GroundTruthFrame:
    """Ground truth of one frame, padded over objects (host numpy)."""

    X_world_cam: np.ndarray      # (4, 4)
    object_ids: np.ndarray       # (J,) int32, -1 pad
    object_poses: np.ndarray     # (J, 4, 4) L_world_object
    object_motions: np.ndarray   # (J, 4, 4) H_w (k-1 -> k); identity at k=0
    object_valid: np.ndarray     # (J,) bool
