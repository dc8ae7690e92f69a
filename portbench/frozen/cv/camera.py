"""Pinhole camera model, fully batched (port of dynosam_tpu/cv/camera.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics. fx, fy, cx, cy are Python floats (rounded to f32,
    as the reference stores them as f32 arrays); width/height are ints."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 0
    height: int = 0
    baseline: float = 0.1

    @classmethod
    def create(cls, fx, fy, cx, cy, width=0, height=0, baseline=0.1):
        def f32(x):
            return float(torch.tensor(float(x), dtype=torch.float32))

        return cls(
            fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
            width=int(width), height=int(height), baseline=float(baseline),
        )

    def matrix(self, dtype=torch.float32, device="cuda"):
        """The (3, 3) calibration matrix K."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                            dtype=dtype, device=device)


def project(pts_cam, intr: CameraIntrinsics, eps: float = 1e-6):
    """(..., 3) camera-frame points -> (..., 2) pixels (mask z > 0 yourself)."""
    z = pts_cam[..., 2]
    safe_z = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    u = intr.fx * pts_cam[..., 0] / safe_z + intr.cx
    v = intr.fy * pts_cam[..., 1] / safe_z + intr.cy
    return torch.stack([u, v], dim=-1)


def backproject(uv, depth, intr: CameraIntrinsics):
    """uv (..., 2), depth (...,) -> (..., 3) camera-frame points (z = depth)."""
    x = (uv[..., 0] - intr.cx) / intr.fx * depth
    y = (uv[..., 1] - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def backproject_uvz(uvz, intr: CameraIntrinsics):
    """(..., 3) rows [u, v, depth] -> (..., 3) camera-frame points."""
    return backproject(uvz[..., :2], uvz[..., 2], intr)


def bearing(uv, intr: CameraIntrinsics):
    """Unit bearing vectors of pixels: (..., 2) -> (..., 3)."""
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def depth_to_disparity(depth, intr: CameraIntrinsics):
    """Metric depth -> the virtual disparity fx * baseline / depth."""
    return intr.fx * intr.baseline / torch.clamp(depth, min=1e-6)


def disparity_to_depth(disparity, intr: CameraIntrinsics):
    """Virtual disparity (px) -> metric depth fx * baseline / disparity."""
    return intr.fx * intr.baseline / torch.clamp(disparity, min=1e-6)


def in_image(uv, intr: CameraIntrinsics, border: float = 0.0):
    """Containment mask of pixels (..., 2) in the image."""
    return (
        (uv[..., 0] >= border)
        & (uv[..., 0] <= intr.width - 1 - border)
        & (uv[..., 1] >= border)
        & (uv[..., 1] <= intr.height - 1 - border)
    )
