"""Exact flat-vector packing of tensor dicts (device) and unpacking (host)
(port of dynosam_tpu/utils/packing.py).

A per-frame record of ~15 small tensors costs one device->host copy per
tensor when read one by one. Packed into one float32 row on the device, and
rows gathered into one (rows, width) buffer, a whole backlog comes to the
host in a single copy.

Exactness: int32 fields are bitcast into float32 lanes (`Tensor.view`, not
a value cast), so any id round-trips; bools go through int32. The host
reinterprets the bytes back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_INT_TYPES = (torch.int8, torch.int16, torch.int32, torch.uint8)


def build_packer(sample: Dict[str, torch.Tensor]):
    """From {key: tensor} (only shapes and dtypes are read) build
    (pack, unpack, width).

    pack(d, out=None): dict of tensors -> (width,) float32 tensor, written
    into `out` (a contiguous (width,) float32 tensor, e.g. one row of a
    ring buffer) when given. unpack(row): (width,) numpy float32 -> dict of
    numpy arrays of the original shapes and dtypes."""
    spec = []
    off = 0
    for k in sorted(sample):
        v = sample[k]
        dt = v.dtype
        # only dtypes that round-trip exactly through float32 lanes
        if not (dt == torch.float32 or dt == torch.bool or dt in _INT_TYPES):
            raise TypeError(
                f"build_packer: field {k!r} has dtype {dt} — only float32, "
                "bool, and <=32-bit integers pack exactly into float32 lanes"
            )
        shape = tuple(v.shape)
        size = int(np.prod(shape)) if shape else 1
        np_dt = np.dtype(bool) if dt == torch.bool else torch.empty((), dtype=dt).numpy().dtype
        spec.append((k, off, shape, np_dt))
        off += size
    width = off

    def pack(d, out=None):
        parts = []
        for k, _, _, np_dt in spec:
            v = d[k]
            if np_dt != np.float32:
                v = v.to(torch.int32).view(torch.float32)
            parts.append(v.reshape(-1))
        if out is None:
            return torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.float32)
        return torch.cat(parts, out=out)

    def unpack(row: np.ndarray) -> Dict[str, np.ndarray]:
        row = np.asarray(row, np.float32)
        res = {}
        for k, o, shape, np_dt in spec:
            size = int(np.prod(shape)) if shape else 1
            flat = row[o:o + size]
            if np_dt == np.bool_:
                flat = flat.view(np.int32) != 0
            elif np_dt != np.float32:
                flat = flat.view(np.int32).astype(np_dt)
            res[k] = flat.reshape(shape) if shape else flat.reshape(())[()]
        return res

    return pack, unpack, width


def to_host(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A dict of tensors as numpy arrays, in one device->host copy."""
    pack, unpack, _ = build_packer(d)
    return unpack(pack(d).cpu().numpy())
