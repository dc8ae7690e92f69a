"""VisionPacket (de)serialization, offline frontend replay and graph-state
checkpoints (port of dynosam_tpu/frontend/serialization.py).

A packet stream is one compressed .npz: `n` (the number of packets) and
`arr_0 .. arr_{N-1}`, each a leaf stacked over the packets, in the
reference's pytree leaf order, which is the dataclass field order with
nested dataclasses in place (TrackTable inside VisionPacket). A graph-state
checkpoint is `arr_i` per leaf the same way; the host `num_frames` is
written as the 0-d int32 array the reference's state carries. So a file
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Iterator, List

import numpy as np
import torch

from dynosam_tpu_torch.frontend.types import VisionPacket


def _leaves(obj) -> Iterator:
    """The leaves of a nested dataclass in field order (None skipped, as the
    reference's pytrees skip it)."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v)
        elif v is not None:
            yield v


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.int32)


def _build(cls, leaves: Iterator, device):
    """Instance of the dataclass `cls` from its leaves in field order: int
    fields become host ints, the others tensors on `device`."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            kw[f.name] = _build(t, leaves, device)
        elif t is int:
            kw[f.name] = int(next(leaves))
        else:
            kw[f.name] = torch.from_numpy(np.array(next(leaves), copy=True)).to(device)
    return cls(**kw)


def save_packets(path: str, packets: List[VisionPacket]) -> None:
    """Save a packet stream to one .npz (each leaf stacked over frames)."""
    flat = [np.stack(leaf) for leaf in zip(*([_host(v) for v in _leaves(p)] for p in packets))]
    np.savez_compressed(path, n=len(packets), **{f"arr_{i}": a for i, a in enumerate(flat)})


def load_packets(path: str, device="cuda") -> List[VisionPacket]:
    data = np.load(path)
    n = int(data["n"])
    n_leaves = sum(1 for k in data.files if k.startswith("arr_"))
    flat = [data[f"arr_{i}"] for i in range(n_leaves)]
    return [_build(VisionPacket, iter([a[k] for a in flat]), device) for k in range(n)]


class PacketReplayProvider:
    """Feeds saved packets straight to a backend: offline frontend replay."""

    def __init__(self, path: str, device="cuda"):
        self.packets = load_packets(path, device)

    def __len__(self):
        return len(self.packets)

    def __iter__(self):
        return iter(self.packets)


# ---------------------------------------------------------------------------
# Graph-state checkpointing (backend resume)
# ---------------------------------------------------------------------------

def save_graph_state(path: str, state) -> None:
    """Checkpoint a backend GraphState (or any nested dataclass of tensors
    and host ints) to .npz."""
    np.savez_compressed(path, **{f"arr_{i}": _host(a) for i, a in enumerate(_leaves(state))})


def load_graph_state(path: str, template):
    """Restore a checkpoint into `template`'s structure, on the device of
    its first tensor."""
    data = np.load(path)
    device = next(v for v in _leaves(template) if torch.is_tensor(v)).device
    n = sum(1 for _ in _leaves(template))
    return _build(type(template), iter([data[f"arr_{i}"] for i in range(n)]), device)
