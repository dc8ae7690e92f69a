"""Closed-form batched 3x3 inverse (port of `inv3` from
dynosam_tpu/ops/block_tridiag.py; the hybrid backend uses nothing else of it)."""

from __future__ import annotations

import torch


def inv3(A, eps: float = 1e-12):
    """Batched 3x3 inverse via the adjugate. (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    safe_det = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    inv = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return inv / safe_det[..., None, None]
