"""CLAHE, contrast-limited adaptive histogram equalization (port of
dynosam_tpu/ops/clahe.py).

Per-tile histograms by one scatter-add, clip + uniform redistribution of the
excess, CDF lookup tables, and a bilinear blend of the 4 neighbouring tile
LUTs at every pixel by gathers. The reference's one-hot histogram and its
quadrant reduce only select LUT entries, so both of its paths (even and odd
half-tiles) give what the gathers give; what can differ is the rounding of
the 256-bin CDF's prefix sum, a few ulps.
"""

from __future__ import annotations

import torch


def clahe(gray, grid: int = 8, bins: int = 256, clip_limit: float = 2.0):
    """gray (H, W) float in [0, 1] -> equalized (H, W) float in [0, 1].
    H and W must be divisible by `grid` (the tracker pads otherwise);
    clip_limit is a multiple of the uniform bin height."""
    H, W = gray.shape
    th, tw = H // grid, W // grid
    npx = th * tw
    dev = gray.device

    x = torch.clamp(gray, 0.0, 1.0)
    b = torch.clamp((x * (bins - 1) + 0.5).to(torch.int32), 0, bins - 1).to(torch.int64)

    # per-tile histograms: one scatter-add of ones over (tile, bin); counts
    # are small integers, exact in f32 in any order (bincount would read its
    # input's maximum back to the host)
    tile = (torch.arange(H, device=dev) // th)[:, None] * grid + (torch.arange(W, device=dev) // tw)[None, :]
    idx = (tile * bins + b).reshape(-1)
    hist = torch.zeros(grid * grid * bins, dtype=torch.float32, device=dev)
    hist = hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32)).reshape(grid * grid, bins)

    # clip + redistribute the excess uniformly
    cap = clip_limit * npx / bins
    excess = torch.sum(torch.clamp(hist - cap, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=cap) + excess / bins

    cdf = torch.cumsum(hist, dim=1)
    cdf0 = cdf[:, :1]
    lut = ((cdf - cdf0) / torch.clamp(npx - cdf0, min=1.0)).reshape(-1)

    # bilinear blend of the 4 surrounding tile LUTs at each pixel
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, grid - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xs), 0, grid - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, grid - 1)
    x1 = torch.clamp(x0 + 1, 0, grid - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[None, :]

    def look(ty, tx):
        return lut[(ty[:, None] * grid + tx[None, :]) * bins + b]

    top = look(y0, x0) * (1 - wx) + look(y0, x1) * wx
    bot = look(y1, x0) * (1 - wx) + look(y1, x1) * wx
    return top * (1 - wy) + bot * wy

