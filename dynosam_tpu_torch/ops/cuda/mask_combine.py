"""YOLO mask combination and the instance-label image: CUDA kernel wrappers
and their plain versions.

Both entries launch the hand-written kernel `csrc/mask_combine.cu` (the port
of the Pallas kernel `dynosam_tpu/ops/pallas/mask_combine.py`) for CUDA
tensors and take their plain PyTorch versions only for CPU tensors:

- `mask_combine(proto, coef)` (entry A): sigmoid(coef @ proto^T) per
  prototype pixel, the XLA path of
  `dynosam_tpu/nn/postprocess.py::combine_masks`, -> (K, Hp, Wp).
- `mask_label(proto, coef, boxes, scores, valid, out_hw, ...)` (entry B):
  the (H, W) int32 label image that `combine_masks` (x4 bilinear upsample,
  box crop widened by `box_pad`, threshold) followed by
  `masks_to_label_image` gives, in one launch. The detector calls it.

The prototype is a (Hp, Wp, nm) view whose pixels lie on one grid, strides
(Wp * sp, sp, sc) for a pixel stride sp and a channel stride sc, in one of
two layouts: planar (sp == 1, the network's NCHW output seen as (Hp, Wp,
nm)) or interleaved (sc == 1, sp a multiple of 4, 16-byte aligned:
contiguous NHWC). Both are read without a copy; any other view is refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dynosam_tpu_torch.ops.cuda import _build

SOURCE = "mask_combine.cu"
COMBINE_NM = (16, 32)        # csrc/mask_combine.cu's instances of entry A
LABEL_NM = (32,)             # and of entry B
_SMEM_REFUSED = -1           # the C entries' code for too much shared memory


def _check(name, x, dtype, nd):
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.ndim != nd:
        raise ValueError(f"{name} must have {nd} dims, got {tuple(x.shape)}")


def proto_strides(proto: torch.Tensor) -> tuple[int, int]:
    """(pixel stride, channel stride) of a (Hp, Wp, nm) prototype view;
    raises ValueError unless its rows follow each other on one pixel grid
    (row stride Wp * pixel stride) in a planar or an interleaved layout."""
    Hp, Wp, _ = proto.shape
    s0, s1, s2 = proto.stride()
    sp = s1 if Wp > 1 else s0 if Hp > 1 else 1
    planar = sp == 1
    interleaved = s2 == 1 and sp % 4 == 0 and proto.data_ptr() % 16 == 0
    if (Hp > 1 and s0 != Wp * sp) or not (planar or interleaved):
        raise ValueError(f"proto strides {tuple(proto.stride())} for shape {tuple(proto.shape)} are "
                         f"neither planar (Wp, 1, sc) nor interleaved (Wp * sp, sp, 1) with sp a "
                         f"multiple of 4 and 16-byte alignment")
    return sp, s2


def _check_proto_coef(who, proto, coef):
    _check(f"{who}: proto", proto, torch.float32, 3)
    _check(f"{who}: coef", coef, torch.float32, 2)
    if not coef.is_contiguous():
        raise ValueError(f"{who} takes a contiguous coef")
    if proto.device != coef.device:
        raise ValueError(f"{who}: proto on {proto.device}, coef on {coef.device}")
    if coef.shape[1] != proto.shape[2]:
        raise ValueError(f"{who}: coef has {coef.shape[1]} coefficients, proto {proto.shape[2]}")
    return proto_strides(proto)


def _kernel_nm(who, nm, sizes):
    if nm not in sizes:
        raise ValueError(f"{who}: the kernel is instantiated for nm in {sizes}, got {nm}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(who, err, report, what):
    """Turns an entry's return code into an exception: ValueError for the
    shared-memory refusal (report holds the bytes needed and the device's
    limit), RuntimeError for a cudaError_t."""
    if err == _SMEM_REFUSED:
        raise ValueError(f"{who}: {what} needs {report[0]} bytes of shared memory per block, "
                         f"the device allows {report[1]}")
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError_t {err}")


# ---- entry A ---------------------------------------------------------------------

def mask_combine_reference(proto: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: proto (Hp, Wp, nm), coef (K, nm) -> (K, Hp, Wp)."""
    Hp, Wp, nm = proto.shape
    return torch.sigmoid(coef @ proto.reshape(-1, nm).T).reshape(-1, Hp, Wp)


@functools.cache
def _combine_fn():
    """Entry A's C function; builds and loads the kernel on first use."""
    fn = _build.load(SOURCE).dyno_mask_combine_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mask_combine(proto: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """proto (Hp, Wp, nm) on one pixel grid and contiguous coef (K, nm),
    float32 on one device -> sigmoid masks (K, Hp, Wp).

    CUDA tensors: one launch of entry A on the current stream (counted in
    `mask_combine.launches`). CPU tensors: the plain version."""
    sp, sc = _check_proto_coef("mask_combine", proto, coef)
    Hp, Wp, nm = proto.shape
    K = coef.shape[0]
    if proto.device.type == "cpu":
        return mask_combine_reference(proto, coef)
    if proto.device.type != "cuda":
        raise RuntimeError(f"mask_combine: no kernel for device {proto.device}")
    out = torch.empty((K, Hp, Wp), dtype=torch.float32, device=proto.device)
    if out.numel() == 0:
        return out
    _kernel_nm("mask_combine", nm, COMBINE_NM)
    report = (ctypes.c_int * 2)()
    with torch.cuda.device(proto.device):
        err = _combine_fn()(proto.data_ptr(), sp, sc, coef.data_ptr(), out.data_ptr(), Hp * Wp, K, nm,
                            report, _stream(proto.device))
    _raise_on("mask_combine", err, report, f"K={K}, nm={nm}")
    mask_combine.launches += 1
    return out


mask_combine.launches = 0


# ---- entry B ---------------------------------------------------------------------

def crop_threshold(low, boxes, valid, out_hw, mask_threshold=0.5, box_pad=0.0):
    """(K, Hp, Wp) sigmoid masks -> (K, H, W) bool: bilinear upsample to
    `out_hw`, zero outside each box widened by `box_pad` pixels and outside
    the valid rows, threshold (the rest of postprocess.py::combine_masks)."""
    H, W = out_hw
    masks = F.interpolate(low[None], size=(H, W), mode="bilinear", align_corners=False)[0]
    ys = torch.arange(H, dtype=torch.float32, device=low.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=low.device)[None, None, :]
    b = boxes
    inside = (
        (xs >= b[:, 0, None, None] - box_pad)
        & (xs <= b[:, 2, None, None] + box_pad)
        & (ys >= b[:, 1, None, None] - box_pad)
        & (ys <= b[:, 3, None, None] + box_pad)
    )
    return (masks > mask_threshold) & inside & valid[:, None, None]


def label_image(masks, scores):
    """(K, H, W) bool + (K,) scores -> (H, W) int32 label image: 0 for the
    background, 1..K by detection index, overlaps to the higher score (the
    lower index on a tie)."""
    s = torch.where(masks, scores[:, None, None], -torch.inf)
    best = torch.argmax(s, dim=0)
    return torch.where(torch.any(masks, dim=0), best + 1, 0).to(torch.int32)


def mask_label_reference(proto, coef, boxes, scores, valid, out_hw, mask_threshold=0.5,
                         box_pad=0.0) -> torch.Tensor:
    """Plain version of `mask_label`: entry A's plain version, then
    `crop_threshold` and `label_image`."""
    low = mask_combine_reference(proto, coef)
    return label_image(crop_threshold(low, boxes, valid, out_hw, mask_threshold, box_pad), scores)


@functools.cache
def _label_fn():
    """Entry B's C function; builds and loads the kernel on first use."""
    fn = _build.load(SOURCE).dyno_mask_label_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mask_label(proto, coef, boxes, scores, valid, out_hw, mask_threshold: float = 0.5,
               box_pad: float = 0.0) -> torch.Tensor:
    """proto (Hp, Wp, nm) on one pixel grid, contiguous coef (K, nm), boxes
    (K, 4) xyxy in output pixels, scores (K,), float32, and valid (K,) bool,
    on one device -> the (H, W) int32 label image of `mask_label_reference`.

    CUDA tensors: one launch of entry B on the current stream (counted in
    `mask_label.launches`). CPU tensors: the plain version."""
    sp, sc = _check_proto_coef("mask_label", proto, coef)
    Hp, Wp, nm = proto.shape
    K = coef.shape[0]
    H, W = (int(v) for v in out_hw)
    for name, x, dtype, shape in (("boxes", boxes, torch.float32, (K, 4)),
                                  ("scores", scores, torch.float32, (K,)),
                                  ("valid", valid, torch.bool, (K,))):
        _check(f"mask_label: {name}", x, dtype, len(shape))
        if tuple(x.shape) != shape:
            raise ValueError(f"mask_label: {name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"mask_label takes a contiguous {name}")
        if x.device != proto.device:
            raise ValueError(f"mask_label: {name} on {x.device}, proto on {proto.device}")
    if H <= 0 or W <= 0 or Hp == 0 or Wp == 0:
        raise ValueError(f"mask_label: empty prototypes {tuple(proto.shape)} or output {(H, W)}")
    if proto.device.type == "cpu":
        return mask_label_reference(proto, coef, boxes, scores, valid, (H, W), mask_threshold, box_pad)
    if proto.device.type != "cuda":
        raise RuntimeError(f"mask_label: no kernel for device {proto.device}")
    if K == 0:
        return torch.zeros((H, W), dtype=torch.int32, device=proto.device)
    _kernel_nm("mask_label", nm, LABEL_NM)
    if boxes.data_ptr() % 16:
        raise ValueError("mask_label takes boxes aligned to 16 bytes")
    label = torch.empty((H, W), dtype=torch.int32, device=proto.device)
    report = (ctypes.c_int * 2)()
    with torch.cuda.device(proto.device):
        err = _label_fn()(proto.data_ptr(), sp, sc, coef.data_ptr(), boxes.data_ptr(), scores.data_ptr(),
                          valid.data_ptr(), label.data_ptr(), K, nm, Hp, Wp, H, W, float(mask_threshold),
                          float(box_pad), report, _stream(proto.device))
    _raise_on("mask_label", err, report, f"K={K} at {Hp}x{Wp} -> {H}x{W}")
    mask_label.launches += 1
    return label


mask_label.launches = 0
