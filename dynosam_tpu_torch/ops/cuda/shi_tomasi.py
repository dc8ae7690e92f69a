"""Shi-Tomasi corner response: CUDA kernel wrapper and its plain version.

`shi_tomasi_response` launches the hand-written kernel
`csrc/shi_tomasi.cu` for a CUDA tensor (the port of the Pallas kernel
`dynosam_tpu/ops/pallas/shi_tomasi.py`) and takes the plain PyTorch version
`shi_tomasi_response_reference` only for a CPU tensor. Both hold the XLA
reference semantics of `dynosam_tpu/frontend/tracker.py::shi_tomasi_response`
over the whole frame: gradients zeroed on the border rows/columns, box sums
wrapping around.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dynosam_tpu_torch.ops import interp
from dynosam_tpu_torch.ops.cuda import _build

SOURCE = "shi_tomasi.cu"
_FN = "dyno_shi_tomasi_response_f32"


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


@functools.cache
def _kernel_fn():
    """The kernel's C entry point; builds and loads it on first use."""
    fn = getattr(_build.load(SOURCE), _FN)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def shi_tomasi_response(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) or (B, H, W) contiguous float32 -> response of the same shape.

    CUDA tensor: one launch of the CUDA kernel on the current stream (counted
    in `shi_tomasi_response.launches`). CPU tensor: the plain version."""
    if gray.dtype != torch.float32:
        raise TypeError(f"shi_tomasi_response takes float32, got {gray.dtype}")
    if gray.ndim not in (2, 3):
        raise ValueError(f"shi_tomasi_response takes (H, W) or (B, H, W), got {tuple(gray.shape)}")
    if not gray.is_contiguous():
        raise ValueError("shi_tomasi_response takes a contiguous tensor")
    if gray.device.type == "cpu":
        return shi_tomasi_response_reference(gray)
    if gray.device.type != "cuda":
        raise RuntimeError(f"shi_tomasi_response: no kernel for device {gray.device}")
    B = 1 if gray.ndim == 2 else gray.shape[0]
    H, W = gray.shape[-2], gray.shape[-1]
    out = torch.empty_like(gray)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(gray.device):
        stream = torch.cuda.current_stream(gray.device).cuda_stream
        err = fn(gray.data_ptr(), out.data_ptr(), B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"shi_tomasi kernel launch failed: cudaError_t {err}")
    shi_tomasi_response.launches += 1
    return out


shi_tomasi_response.launches = 0
