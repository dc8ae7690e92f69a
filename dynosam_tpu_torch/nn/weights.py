"""Read the committed flax YOLOv8-seg checkpoint, or an ultralytics
YOLOv8-seg state_dict (`load_ultralytics_weights`), and map it onto the
port's module (nn/yolov8.py).

The checkpoint (`dynosam_tpu/nn/checkpoints/yolov8t_seg_synth.msgpack`) is
what `flax.serialization.to_bytes` wrote: a msgpack map of maps whose leaves
are msgpack extension type 1, an ndarray, with the payload msgpack
`[shape, dtype name, C-order bytes]` (`flax.serialization._ndarray_to_bytes`).
`read_flax_msgpack` decodes that subset in pure Python, so loading needs
neither flax nor the msgpack package; `write_flax_msgpack` encodes it, so a
checkpoint the port trains (train_detector.py) loads into both the port
and the reference's `serialization.from_bytes`. `flax_from_state_dict` is
the inverse of `state_dict_from_flax`.

Mapping onto the torch module, whose submodules carry the flax names:
conv kernels HWIO -> OIHW; the transposed conv's kernel (kh, kw, in, out)
-> (in, out, kh, kw) flipped in space (flax's `transpose_kernel=False`
with SAME padding places tap t of a stride-2 kernel at output 2i + 1 - t,
torch's ConvTranspose2d at 2i + t); BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder for the msgpack subset flax writes."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n):
        out = self.buf[self.pos: self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(out)

    def _unpack(self, fmt):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "str":
                return self._take(n).decode()
            if kind == "arr":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(self._unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self._unpack(">b"), fixext[b])
        scalars = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self._unpack(scalars[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the flax subset")

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code, n):
        payload = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not in the flax subset")
        shape, dtype, data = _Reader(payload).read()
        arr = np.frombuffer(data, dtype=np.dtype(dtype))
        return arr.reshape(shape).copy() if code == _EXT_NDARRAY else arr[0]


def read_flax_msgpack(path: str) -> dict:
    """Nested dict of numpy arrays from a `flax.serialization.to_bytes` file."""
    with open(path, "rb") as fh:
        r = _Reader(fh.read())
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{path}: {len(r.buf) - r.pos} trailing bytes")
    return tree


class _Writer:
    """Encoder for the msgpack subset flax writes (`msgpack.packb` with
    `use_bin_type=True`: the smallest header for each length)."""

    def __init__(self):
        self.out = bytearray()

    def _head(self, n, fix, fix_max, wide):
        """A length header: the fix form below fix_max, else the smallest
        of `wide` ((type byte, struct format, limit), ...)."""
        if fix is not None and n < fix_max:
            self.out.append(fix | n)
            return
        for byte, fmt, limit in wide:
            if n < limit:
                self.out.append(byte)
                self.out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack length {n} is too large")

    def write(self, v):
        if isinstance(v, dict):
            self._head(len(v), 0x80, 16, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))
            for k, x in v.items():
                self.write(k)
                self.write(x)
        elif isinstance(v, (list, tuple)):
            self._head(len(v), 0x90, 16, ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
            for x in v:
                self.write(x)
        elif isinstance(v, str):
            b = v.encode()
            self._head(len(b), 0xA0, 32, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)))
            self.out += b
        elif isinstance(v, bytes):
            self._head(len(v), None, 0, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32)))
            self.out += v
        elif isinstance(v, (int, np.integer)) and 0 <= v:
            v = int(v)
            if v < 0x80:
                self.out.append(v)
            else:
                self._head(v, None, 0, ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                                        (0xCF, ">Q", 1 << 64)))
        elif isinstance(v, np.ndarray):
            w = _Writer()
            w.write((tuple(v.shape), v.dtype.name, np.ascontiguousarray(v).tobytes()))
            payload = bytes(w.out)
            n = len(payload)
            fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
            if n in fixext:
                self.out.append(fixext[n])
            else:
                self._head(n, None, 0, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32)))
            self.out += struct.pack(">b", _EXT_NDARRAY)
            self.out += payload
        else:
            raise TypeError(f"{type(v).__name__} is not in the flax msgpack subset")


def write_flax_msgpack(path: str, tree: dict, dtype=np.float16) -> None:
    """Write a nested dict of arrays (numpy or torch) as
    `flax.serialization.to_bytes` writes it, each array cast to `dtype`
    (float16, as the reference stores its checkpoint). Keys go out sorted
    at every level, the order in which `jax.tree.map` rebuilds a dict, so
    the bytes equal `to_bytes` of the reference's `jax.tree.map`-cast tree."""
    def conv(t):
        if isinstance(t, dict):
            return {str(k): conv(t[k]) for k in sorted(t)}
        a = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
        return a.astype(dtype)

    w = _Writer()
    w.write(conv(tree))
    with open(path, "wb") as fh:
        fh.write(bytes(w.out))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables: dict) -> dict:
    """{'params': ..., 'batch_stats': ...} of nn/yolov8.py's flax module ->
    a state_dict of the port's YoloV8Seg (float32 tensors)."""
    sd = {}
    for path, a in _flatten(variables.get("params", {})):
        a = np.asarray(a, np.float32)
        name, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and path[-2] == "upsample":
            sd[name + ".weight"] = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == "kernel":
            sd[name + ".weight"] = a.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            sd[name + ".weight"] = a
        elif leaf == "bias":
            sd[name + ".bias"] = a
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, a in _flatten(variables.get("batch_stats", {})):
        sd[".".join(path[:-1]) + "." + stat_names[path[-1]]] = np.asarray(a, np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def flax_from_state_dict(state_dict: dict) -> dict:
    """The inverse of `state_dict_from_flax`: a YoloV8Seg state_dict (or the
    training leaves of train_detector.py) -> {'params': ..., 'batch_stats':
    ...} nested as the reference's flax module, float32 numpy arrays.
    BatchNorm's batch counter has no flax counterpart and is dropped."""
    tree = {"params": {}, "batch_stats": {}}
    stat_names = {"running_mean": "mean", "running_var": "var"}
    for name, v in state_dict.items():
        path = name.split(".")
        leaf = path[-1]
        if leaf == "num_batches_tracked":
            continue
        a = (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)).astype(np.float32)
        if leaf in stat_names:
            coll, leaf = "batch_stats", stat_names[leaf]
        elif leaf == "weight" and path[-2] == "upsample":
            coll, leaf, a = "params", "kernel", a.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif leaf == "weight" and a.ndim == 4:
            coll, leaf, a = "params", "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            coll, leaf = "params", "scale"
        elif leaf == "bias":
            coll = "params"
        else:
            raise KeyError(f"unexpected tensor {name}")
        node = tree[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def load_flax_checkpoint(path: str):
    """-> (YoloV8Seg in eval mode with the checkpoint's weights, metadata)."""
    from dynosam_tpu_torch.nn import yolov8

    with open(path + ".json") as fh:
        meta = json.load(fh)
    model = yolov8.YoloV8Seg(num_classes=meta["num_classes"], scale=meta["scale"])
    sd = state_dict_from_flax(read_flax_msgpack(path))
    # BatchNorm's batch counter has no flax counterpart
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model.eval(), meta


# ---------------------------------------------------------------------------
# ultralytics YOLOv8-seg state dicts
# ---------------------------------------------------------------------------

# the port's module name -> ultralytics layer index (yolov8-seg.yaml: 0-9
# backbone, 12 / 15 FPN C2f, 16-21 PAN, 22 the Segment head)
_BLOCK_MAP = {
    "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4,
    "b5": 5, "b6": 6, "b7": 7, "b8": 8, "b9": 9,
    "n12": 12, "n15": 15, "n16": 16, "n18": 18, "n19": 19, "n21": 21,
}
_HEAD = "model.22"
# the Segment head's branches: the port's box / cls / m -> ultralytics' cv2 / cv3 / cv4
_BRANCHES = {"box": "cv2", "cls": "cv3", "m": "cv4"}


def _ultralytics_names(model) -> dict:
    """{ultralytics state_dict name: the port's state_dict name} of every
    tensor of the port's YoloV8Seg, BatchNorm counters included. The two
    networks' tensors have the same layout (both are torch modules; the
    proto upsample is a ConvTranspose2d in both), so the map is by name
    only."""
    names = {}
    for ours in model.state_dict():
        head, rest = ours.split(".", 1)
        if head in _BLOCK_MAP:
            parts = rest.split(".")
            if parts[0].startswith("m") and parts[0][1:].isdigit():   # C2f bottleneck m{i}
                parts = ["m", parts[0][1:]] + parts[1:]
            names[f"model.{_BLOCK_MAP[head]}." + ".".join(parts)] = ours
        elif head == "proto":
            names[f"{_HEAD}.proto.{rest}"] = ours
        else:                                     # box{l}_{k}, cls{l}_{k}, m{l}_{k}
            branch, lvl, k = head[:-3], head[-3], head[-1]
            names[f"{_HEAD}.{_BRANCHES[branch]}.{lvl}.{k}.{rest}"] = ours
    return names


def ultralytics_state_dict(model) -> dict:
    """The port's YoloV8Seg weights under ultralytics' names (what
    `model.model.state_dict()` of an ultralytics YOLOv8-seg holds), plus
    the head's fixed DFL convolution."""
    sd = model.state_dict()
    out = {u: sd[ours].detach().clone() for u, ours in _ultralytics_names(model).items()}
    out[f"{_HEAD}.dfl.conv.weight"] = torch.arange(model.reg_max, dtype=torch.float32).view(1, -1, 1, 1)
    return out


def load_ultralytics_weights(state_dict_or_path, num_classes: int = 80, scale: str = "n", device="cuda"):
    """A YoloV8Seg (eval mode, on `device`) holding an ultralytics
    YOLOv8-seg state_dict: a dict of tensors or arrays, or the path of a
    `torch.save`d one (read with weights_only=True). A full ultralytics .pt
    pickles its Model class and cannot be read without that package:
    export `torch.save(model.model.state_dict(), path)` first. Names with
    the wrapping Model's `model.model.` prefix are accepted. The DFL
    convolution's fixed weight is not a parameter of the port's head and
    is ignored. Every tensor of the network must be present, with its
    shape."""
    from dynosam_tpu_torch.nn import yolov8

    sd = state_dict_or_path
    if isinstance(sd, (str, bytes, os.PathLike)):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if any(k.startswith("model.model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    model = yolov8.YoloV8Seg(num_classes=num_classes, scale=scale)
    ours = model.state_dict()
    mapped = {}
    for u, name in _ultralytics_names(model).items():
        if u not in sd:
            if name.endswith("num_batches_tracked"):
                mapped[name] = ours[name]
                continue
            raise KeyError(f"ultralytics tensor {u} (the port's {name}) is missing")
        v = sd[u]
        v = v.detach() if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        if tuple(v.shape) != tuple(ours[name].shape):
            raise ValueError(f"{u}: shape {tuple(v.shape)}, the port's {name} is {tuple(ours[name].shape)}")
        mapped[name] = v.to(ours[name].dtype)
    model.load_state_dict(mapped, strict=True)
    return model.eval().to(device)
