"""Image sampling primitives (port of dynosam_tpu/ops/interp.py).

Images are (H, W) or (H, W, C); points are (..., 2) in (u, v) = (column, row).
"""

from __future__ import annotations

import torch


def _clip_uv(uv, h, w):
    u = torch.clamp(uv[..., 0], 0.0, w - 1.0)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.0)
    return u, v


def sample_nearest(img, uv):
    """Nearest-neighbour sample. torch.round rounds half to even, as jnp.round."""
    h, w = img.shape[0], img.shape[1]
    u, v = _clip_uv(uv, h, w)
    ui = torch.round(u).long()
    vi = torch.round(v).long()
    return img[vi, ui]


def sample_flow(flow, uv):
    return sample_nearest(flow, uv)


def sample_label(mask, uv):
    return sample_nearest(mask, uv)


def sample_depth(depth, uv):
    return sample_nearest(depth, uv)


def image_gradients(img):
    """Central differences over the last two axes -> (gx, gy), with the
    wrap-around border columns (gx) and rows (gy) zeroed."""
    gx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    gy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    gx[..., :, 0] = 0.0
    gx[..., :, -1] = 0.0
    gy[..., 0, :] = 0.0
    gy[..., -1, :] = 0.0
    return gx, gy
