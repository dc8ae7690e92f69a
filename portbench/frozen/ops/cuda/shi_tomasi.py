"""Shi-Tomasi corner response and its per-cell argmax in plain PyTorch (the
port's `ops/cuda/shi_tomasi.py` without its kernel): the response map with
gradients zeroed on the border rows/columns and box sums wrapping around,
and the per-cell reduction with the first index on ties, NaN the largest."""

from __future__ import annotations

import torch

from portbench.frozen.ops import interp


def shi_tomasi_response_reference(gray: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch min-eigenvalue response, (H, W) or (B, H, W) -> same."""
    gx, gy = interp.image_gradients(gray)
    ixx, iyy, ixy = gx * gx, gy * gy, gx * gy

    def box3(img):
        v = img + torch.roll(img, 1, dims=-2) + torch.roll(img, -1, dims=-2)
        return v + torch.roll(v, 1, dims=-1) + torch.roll(v, -1, dims=-1)

    sxx, syy, sxy = box3(ixx), box3(iyy), box3(ixy)
    tr = 0.5 * (sxx + syy)
    det = torch.sqrt(torch.clamp((0.5 * (sxx - syy)) ** 2 + sxy * sxy, min=0.0))
    return tr - det


def cell_reduce(score: torch.Tensor, cell: int):
    """Per-cell max + argmax pixel coords (first index on ties).
    score (..., H, W) -> best, u, v each (..., H//cell * W//cell)."""
    H, W = score.shape[-2:]
    lead = score.shape[:-2]
    gh, gw = H // cell, W // cell
    s = score[..., : gh * cell, : gw * cell].reshape(*lead, gh, cell, gw, cell)
    s = s.transpose(-3, -2).reshape(*lead, gh, gw, cell * cell)
    best = torch.amax(s, dim=-1)
    arg = torch.argmax(s, dim=-1)
    dy, dx = arg // cell, arg % cell
    dev = score.device
    vs = torch.arange(gh, device=dev)[:, None] * cell + dy
    us = torch.arange(gw, device=dev)[None, :] * cell + dx
    flat = (*lead, gh * gw)
    return best.reshape(flat), us.reshape(flat).to(score.dtype), vs.reshape(flat).to(score.dtype)


def shi_tomasi_cell_max_reference(gray: torch.Tensor, cell: int):
    """Plain version of `shi_tomasi_cell_max`: the response map, then the
    per-cell reduction."""
    return cell_reduce(shi_tomasi_response_reference(gray), cell)


# The benchmark's reference has no kernel: both entries are the plain
# versions above, which the kernel matches bit for bit at the tracker's shapes.
shi_tomasi_cell_max = shi_tomasi_cell_max_reference
shi_tomasi_response = shi_tomasi_response_reference
