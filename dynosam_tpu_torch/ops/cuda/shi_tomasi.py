"""Shi-Tomasi corner response and its per-cell argmax: CUDA kernel wrappers
and their plain versions.

Both entries launch the hand-written kernel `csrc/shi_tomasi.cu` (the port
of the Pallas kernel `dynosam_tpu/ops/pallas/shi_tomasi.py`) for a CUDA
tensor and take their plain PyTorch versions only for a CPU tensor:

- `shi_tomasi_cell_max(gray, cell)`: per full `cell` x `cell` cell, the
  largest response and the (u, v) pixel of its first occurrence, what
  `cell_reduce(shi_tomasi_response_reference(gray), cell)` gives. The
  tracker's detection calls it; the response map stays on chip.
- `shi_tomasi_response(gray)`: the response map itself.

They hold the XLA reference semantics of
`dynosam_tpu/frontend/tracker.py::shi_tomasi_response` over the whole frame
(gradients zeroed on the border rows/columns, box sums wrapping around) and
of `tracker.py::_cell_reduce` (first index on ties, NaN the largest).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dynosam_tpu_torch.ops import interp
from dynosam_tpu_torch.ops.cuda import _build

SOURCE = "shi_tomasi.cu"
_FN = "dyno_shi_tomasi_f32"
CELL_SIZES = (8, 16)          # the kernel's template instances
_MAP_TILE_CELL = 16           # the tile shape of a map-only launch


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


@functools.cache
def _kernel_fn():
    """The kernel's C entry point; builds and loads it on first use."""
    fn = getattr(_build.load(SOURCE), _FN)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, gray: torch.Tensor):
    if gray.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {gray.dtype}")
    if gray.ndim not in (2, 3):
        raise ValueError(f"{name} takes (H, W) or (B, H, W), got {tuple(gray.shape)}")
    if not gray.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if gray.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {gray.device}")


def _launch(name, gray, map_out, cell_out, cell):
    B = 1 if gray.ndim == 2 else gray.shape[0]
    H, W = gray.shape[-2:]
    best, u, v = cell_out if cell_out is not None else (None, None, None)

    def ptr(x):
        return None if x is None else x.data_ptr()

    fn = _kernel_fn()
    with torch.cuda.device(gray.device):
        stream = torch.cuda.current_stream(gray.device).cuda_stream
        err = fn(gray.data_ptr(), ptr(map_out), ptr(best), ptr(u), ptr(v), B, H, W, cell, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def shi_tomasi_cell_max(gray: torch.Tensor, cell: int):
    """(H, W) or (B, H, W) contiguous float32 -> (best, u, v), each
    (H//cell * W//cell,) or (B, H//cell * W//cell) float32: per full cell in
    row-major order, the largest corner response and its pixel (u = column,
    v = row) of first occurrence. `cell` is 8 or 16.

    CUDA tensor: one launch of the fused kernel on the current stream
    (counted in `shi_tomasi_cell_max.launches`); the response map is not
    written to device memory. CPU tensor: the plain version."""
    if cell not in CELL_SIZES:
        raise ValueError(f"shi_tomasi_cell_max: the kernel takes cell sizes {CELL_SIZES}, got {cell}")
    _check("shi_tomasi_cell_max", gray)
    if gray.device.type == "cpu":
        return shi_tomasi_cell_max_reference(gray, cell)
    H, W = gray.shape[-2:]
    shape = (*gray.shape[:-2], (H // cell) * (W // cell))
    out = tuple(torch.empty(shape, dtype=torch.float32, device=gray.device) for _ in range(3))
    if out[0].numel() == 0:
        return out
    _launch("shi_tomasi_cell_max", gray, None, out, cell)
    shi_tomasi_cell_max.launches += 1
    return out


def shi_tomasi_response(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) or (B, H, W) contiguous float32 -> response of the same shape.

    CUDA tensor: one launch of the same kernel with only its map output
    (counted in `shi_tomasi_response.launches`). CPU tensor: the plain
    version."""
    _check("shi_tomasi_response", gray)
    if gray.device.type == "cpu":
        return shi_tomasi_response_reference(gray)
    out = torch.empty_like(gray)
    if out.numel() == 0:
        return out
    _launch("shi_tomasi_response", gray, out, None, _MAP_TILE_CELL)
    shi_tomasi_response.launches += 1
    return out


shi_tomasi_cell_max.launches = 0
shi_tomasi_response.launches = 0
