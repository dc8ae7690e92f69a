"""YOLO mask combination: CUDA kernel wrapper and its plain version.

`mask_combine` launches the hand-written kernel `csrc/mask_combine.cu` (the
port of the Pallas kernel `dynosam_tpu/ops/pallas/mask_combine.py`) for a
CUDA tensor and takes the plain PyTorch version `mask_combine_reference`
only for a CPU tensor. Both compute sigmoid(coef @ proto^T) per prototype
pixel, the XLA path of `dynosam_tpu/nn/postprocess.py::combine_masks`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dynosam_tpu_torch.ops.cuda import _build

SOURCE = "mask_combine.cu"
_FN = "dyno_mask_combine_f32"
_SMEM_FN = "dyno_mask_combine_smem_bytes"
_MAX_NM = 64                 # csrc/mask_combine.cu MAX_NM; nm % 4 == 0
_SMEM_LIMIT = 48 * 1024


def mask_combine_reference(proto: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: proto (Hp, Wp, nm), coef (K, nm) -> (K, Hp, Wp)."""
    Hp, Wp, nm = proto.shape
    return torch.sigmoid(coef @ proto.reshape(-1, nm).T).reshape(-1, Hp, Wp)


@functools.cache
def _kernel_fns():
    """The kernel's C entry points; builds and loads it on first use."""
    lib = _build.load(SOURCE)
    fn = getattr(lib, _FN)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    smem = getattr(lib, _SMEM_FN)
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_int
    return fn, smem


def mask_combine(proto: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """proto (Hp, Wp, nm) and coef (K, nm), contiguous float32 on one device
    -> sigmoid masks (K, Hp, Wp).

    CUDA tensors: one launch of the CUDA kernel on the current stream
    (counted in `mask_combine.launches`). CPU tensors: the plain version."""
    for name, x, nd in (("proto", proto, 3), ("coef", coef, 2)):
        if x.dtype != torch.float32:
            raise TypeError(f"mask_combine takes float32 {name}, got {x.dtype}")
        if x.ndim != nd:
            raise ValueError(f"mask_combine: {name} must have {nd} dims, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"mask_combine takes a contiguous {name}")
    if proto.device != coef.device:
        raise ValueError(f"mask_combine: proto on {proto.device}, coef on {coef.device}")
    Hp, Wp, nm = proto.shape
    K = coef.shape[0]
    if coef.shape[1] != nm:
        raise ValueError(f"mask_combine: coef has {coef.shape[1]} coefficients, proto {nm}")
    if proto.device.type == "cpu":
        return mask_combine_reference(proto, coef)
    if proto.device.type != "cuda":
        raise RuntimeError(f"mask_combine: no kernel for device {proto.device}")
    out = torch.empty((K, Hp, Wp), dtype=torch.float32, device=proto.device)
    if out.numel() == 0:
        return out
    if nm == 0 or nm % 4 or nm > _MAX_NM:
        raise ValueError(f"mask_combine: the kernel takes nm a multiple of 4 up to {_MAX_NM}, got {nm}")
    fn, smem = _kernel_fns()
    if smem(K, nm) > _SMEM_LIMIT:
        raise ValueError(f"mask_combine: K={K}, nm={nm} exceed the kernel's shared memory")
    with torch.cuda.device(proto.device):
        stream = torch.cuda.current_stream(proto.device).cuda_stream
        err = fn(proto.data_ptr(), coef.data_ptr(), out.data_ptr(), Hp * Wp, K, nm, stream)
    if err != 0:
        raise RuntimeError(f"mask_combine kernel launch failed: cudaError_t {err}")
    mask_combine.launches += 1
    return out


mask_combine.launches = 0
