"""Frontend <-> backend data contracts (port of dynosam_tpu/frontend/types.py).

Fixed-capacity tables with validity masks, as in the reference. The IMU and
right-image fields of `FrameInputs` are not part of this port yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def first_true(x, dim):
    """Index of the first True along `dim` (0 if none), as jnp.argmax on a
    bool array; torch.argmax does not take bool tensors on CUDA."""
    return torch.argmax(x.to(torch.uint8), dim=dim)


@dataclass
class TrackTable:
    uv: torch.Tensor          # (N, 2)
    depth: torch.Tensor       # (N,)
    tracklet_id: torch.Tensor # (N,) int32, -1 = empty slot
    object_id: torch.Tensor   # (N,) int32, 0 = static background
    age: torch.Tensor         # (N,) int32
    valid: torch.Tensor       # (N,) bool


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


@dataclass
class FrameInputs:
    """Per-frame sensor inputs: rgb (H, W, 3) float, depth (H, W) metric z,
    flow (H, W, 2) k-1 -> k on frame k-1 pixels, mask (H, W) int32 labels."""

    frame_id: torch.Tensor  # () int32
    rgb: torch.Tensor
    depth: torch.Tensor
    flow: torch.Tensor
    mask: torch.Tensor
