"""Image sampling primitives (port of dynosam_tpu/ops/interp.py).

Images are (H, W) or (H, W, C); points are (..., 2) in (u, v) = (column, row).
With `nb=1` the image carries a leading batch axis of sequences, (B, H, W[,
C]), and the points are (B, N, 2), or (N, 2) shared by every sequence: each
sequence samples its own image.
"""

from __future__ import annotations

import torch


def _clip_uv(uv, h, w):
    u = torch.clamp(uv[..., 0], 0.0, w - 1.0)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.0)
    return u, v


def sample_nearest(img, uv, nb: int = 0):
    """Nearest-neighbour sample. torch.round rounds half to even, as jnp.round."""
    h, w = img.shape[nb], img.shape[nb + 1]
    u, v = _clip_uv(uv, h, w)
    ui = torch.round(u).long()
    vi = torch.round(v).long()
    if nb == 0:
        return img[vi, ui]
    b = torch.arange(img.shape[0], device=img.device)[:, None]
    return img[b, vi, ui]


def sample_bilinear(img, uv):
    """Bilinear sample of img (H, W[, C]) at uv (..., 2) -> (...[, C])."""
    h, w = img.shape[0], img.shape[1]
    u, v = _clip_uv(uv, h, w)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    u0i, v0i = u0.long(), v0.long()
    u1i = torch.clamp(u0i + 1, max=w - 1)
    v1i = torch.clamp(v0i + 1, max=h - 1)
    if img.ndim == 3:
        du, dv = du[..., None], dv[..., None]
    top = img[v0i, u0i] * (1.0 - du) + img[v0i, u1i] * du
    bot = img[v1i, u0i] * (1.0 - du) + img[v1i, u1i] * du
    return top * (1.0 - dv) + bot * dv


def sample_flow(flow, uv, nb: int = 0):
    return sample_nearest(flow, uv, nb)


def sample_label(mask, uv, nb: int = 0):
    return sample_nearest(mask, uv, nb)


def sample_depth(depth, uv, nb: int = 0):
    return sample_nearest(depth, uv, nb)


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
