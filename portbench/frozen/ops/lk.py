"""Sparse pyramidal Lucas-Kanade optical flow (port of dynosam_tpu/ops/lk.py).

Inverse-compositional LK: per pyramid level the template patch, its
gradients and the 2x2 normal matrix G are built once; each iteration samples
the warped patch from the target image and solves G d = b. All keypoints
advance in lock-step (fixed levels x iterations), padded slots masked.
`lk_track` adds the forward-backward check: a point passes iff tracking it
back from the solution lands within `fb_threshold` of its start.

The reference samples inside integer-aligned strips fetched once per level
(Sr rows x two 128-lane column blocks), the layout a TPU gathers at full
rate. Here every bilinear sample is a direct gather on the level image, but
at the strip's clamping: a sample position is clamped first to the image
([0, dim - 1.001]) and then to its strip window, so a track that drifts past
its window reads the window's edge, as the reference's does. The window of
a keypoint starts at row clip(floor(y0), 0, H - Sr) and at column block
clip(floor(x0) // 128, 0, nb - 2) of the image edge-padded to nb = max(
ceil(W / 128), 2) blocks. Bilinear samples blend horizontally first, then
vertically, the order of the reference's two contractions.

Every function also takes a leading batch axis of sequences (the batched
step): (B, H, W) images and (B, N, 2) points, each sequence's points
sampling its own images. The strip windows depend on the image size only,
which the batch shares.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

_LANES = 128


def _blur_121(img):
    """Separable [1,2,1]/4 binomial blur over the last two axes; borders
    wrap around (jnp.roll)."""
    v = 0.25 * (torch.roll(img, 1, -2) + 2.0 * img + torch.roll(img, -1, -2))
    return 0.25 * (torch.roll(v, 1, -1) + 2.0 * v + torch.roll(v, -1, -1))


def build_pyramid(gray, levels: int) -> List[torch.Tensor]:
    """`levels` images, level 0 = full resolution; each next level is the
    blurred previous one decimated by 2."""
    pyr = [gray]
    for _ in range(levels - 1):
        pyr.append(_blur_121(pyr[-1])[..., ::2, ::2].contiguous())
    return pyr


def _row_window(g0, Sr: int, H: int):
    """First global row of each keypoint's Sr-row window."""
    r0 = torch.floor(g0).to(torch.int64)
    return torch.clamp(r0, 0, max(H - Sr, 0))


def _col_window(g0, W: int):
    """First global column of each keypoint's two-block (256-column) window."""
    nb = max((W + _LANES - 1) // _LANES, 2)
    c0 = torch.floor(g0).to(torch.int64)
    return torch.clamp(torch.div(c0, _LANES, rounding_mode="floor"), 0, nb - 2) * _LANES


def _axis_taps(g0, start, size: int, dim_global: int, dim_local: int):
    """Bilinear taps of the samples at g0 + 0..size-1 along one axis, clamped
    to the image and then to the window of dim_local elements that starts at
    global `start` -> (first tap (..., N, size), second tap (..., N, size),
    weight of the second). Taps past the image's last element read that
    element (the edge padding of the reference's strips)."""
    pos = g0[..., None] + torch.arange(size, dtype=g0.dtype, device=g0.device)
    pos = torch.clamp(pos, 0.0, dim_global - 1.001) - start[..., None].to(g0.dtype)
    pos = torch.clamp(pos, 0.0, dim_local - 1.001)
    p0 = torch.floor(pos)
    fr = pos - p0
    i0 = start[..., None] + p0.to(torch.int64)
    return (torch.clamp(i0, max=dim_global - 1), torch.clamp(i0 + 1, max=dim_global - 1), fr)


def _sample(img, rows, cols):
    """Bilinear samples (..., N, Sy, Sx) of img (..., H, W) at the taps of
    `_axis_taps` along y (rows) and x (cols); each sequence of a batch
    gathers from its own image."""
    r0, r1, fy = rows
    c0, c1, fx = cols
    W = img.shape[-1]
    lead = img.shape[:-2]
    flat = img.reshape(lead + (-1,))

    def at(idx):
        return torch.take_along_dim(flat, idx.reshape(lead + (-1,)), dim=-1).reshape(idx.shape)

    a, b = (r0 * W)[..., :, :, None], (r1 * W)[..., :, :, None]
    c0, c1, fx = c0[..., :, None, :], c1[..., :, None, :], fx[..., :, None, :]
    top = at(a + c0) * (1 - fx) + at(a + c1) * fx
    bot = at(b + c0) * (1 - fx) + at(b + c1) * fx
    fy = fy[..., :, :, None]
    return top * (1 - fy) + bot * fy


def _lk_level(img0, img1, uv0, d, half: int, iters: int, min_eig: float, margin: int = 6):
    """One pyramid level of inverse-compositional LK. uv0 (..., N, 2)
    keypoints in this level's pixels, d (..., N, 2) the current flow ->
    (d, ok); ok is False
    where G is degenerate (min eigenvalue per pixel below min_eig). The
    search window lets d move `margin` px from its level-entry value before
    samples clamp to the window's edge."""
    lead = uv0.shape[:-1]
    S = 2 * half + 1
    P = S * S
    H, W = img0.shape[-2:]

    # template with a 1-px halo; gradients by central differences inside it
    y0t = uv0[..., 1] - (half + 1)
    x0t = uv0[..., 0] - (half + 1)
    Sr = S + 3
    big = _sample(
        img0,
        _axis_taps(y0t, _row_window(y0t, Sr, H), S + 2, H, Sr),
        _axis_taps(x0t, _col_window(x0t, W), S + 2, W, 2 * _LANES),
    )
    t = big[..., 1:-1, 1:-1].reshape(lead + (P,))
    tx = (0.5 * (big[..., 1:-1, 2:] - big[..., 1:-1, :-2])).reshape(lead + (P,))
    ty = (0.5 * (big[..., 2:, 1:-1] - big[..., :-2, 1:-1])).reshape(lead + (P,))

    gxx = torch.sum(tx * tx, dim=-1)
    gxy = torch.sum(tx * ty, dim=-1)
    gyy = torch.sum(ty * ty, dim=-1)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_ev = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    ok = min_ev / P >= min_eig
    inv_det = torch.where(torch.abs(det) > 1e-9, 1.0 / det, 0.0)

    # search window on img1, fixed for the level
    yw = uv0[..., 1] + d[..., 1] - (half + margin)
    xw = uv0[..., 0] + d[..., 0] - (half + margin)
    Srw = S + 2 * margin + 1
    row0w, col0w = _row_window(yw, Srw, H), _col_window(xw, W)

    for _ in range(iters):
        w = _sample(
            img1,
            _axis_taps(uv0[..., 1] + d[..., 1] - half, row0w, S, H, Srw),
            _axis_taps(uv0[..., 0] + d[..., 0] - half, col0w, S, W, 2 * _LANES),
        ).reshape(lead + (P,))
        e = w - t
        bx = torch.sum(e * tx, dim=-1)
        by = torch.sum(e * ty, dim=-1)
        # solve G [du dv]^T = -b (inverse compositional: subtract)
        du = (gyy * bx - gxy * by) * inv_det
        dv = (gxx * by - gxy * bx) * inv_det
        d = d - torch.stack([du, dv], dim=-1)
    return d, ok


def lk_flow(pyr0: Sequence[torch.Tensor], pyr1: Sequence[torch.Tensor], uv0, valid, *,
            half: int = 3, iters: int = 8, min_eig: float = 1e-4):
    """Coarse-to-fine flow of sparse keypoints uv0 (..., N, 2) (level-0
    pixels) -> (flow (..., N, 2), ok (..., N)). The coarsest level starts from d = 0 with a
    search margin of 12 px, the finer ones refine with 6 px; the eigenvalue
    gate binds at full resolution only."""
    L = len(pyr0)
    d = torch.zeros_like(uv0)
    ok = valid
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        d, ok_l = _lk_level(pyr0[lvl], pyr1[lvl], uv0 / s, d, half, iters, min_eig,
                            margin=(12 if lvl == L - 1 else 6))
        ok = ok & (ok_l | (lvl > 0))
        if lvl > 0:
            d = d * 2.0
    return d, ok


def lk_track(gray0, gray1, uv0, valid, *, levels: int = 3, half: int = 3, iters: int = 8,
             min_eig: float = 1e-4, fb_check: bool = True, fb_threshold: float = 1.0):
    """Track keypoints gray0 -> gray1 ((..., H, W)) -> (uv1 (..., N, 2),
    ok (..., N)). With fb_check, a track must come back within fb_threshold
    px of its start."""
    pyr0 = build_pyramid(gray0, levels)
    pyr1 = build_pyramid(gray1, levels)
    flow, ok = lk_flow(pyr0, pyr1, uv0, valid, half=half, iters=iters, min_eig=min_eig)
    uv1 = uv0 + flow
    if fb_check:
        back, ok_b = lk_flow(pyr1, pyr0, uv1, valid, half=half, iters=iters, min_eig=min_eig)
        err = torch.linalg.norm(uv1 + back - uv0, dim=-1)
        ok = ok & ok_b & (err < fb_threshold)
    H, W = gray0.shape[-2:]
    inb = (uv1[..., 0] >= 0) & (uv1[..., 0] <= W - 1) & (uv1[..., 1] >= 0) & (uv1[..., 1] <= H - 1)
    return uv1, ok & inb & valid
