"""Carry pipeline state between the JAX reference and the port.

`pipeline_state_from_numpy` takes the nested dict of numpy arrays that
`flax.serialization.to_state_dict` gives for the reference's PipelineState
and builds the port's `PipelineState`; `pipeline_state_to_numpy` does the
reverse for the fields the port has, the tracker's ByteTrack state and
the KLT, mask-propagation and IMU carries included. The one leaf the port
does not carry is dropped: the RANSAC key (a torch.Generator replaces it).

Both take a batched state too (`batched=True`): the reference's vmapped
PipelineState, every leaf with a leading axis of B sequences, against the
port's batched state (parallel/batched.py::make_batched_pipeline), whose one
host `num_frames` stands for the B equal per-sequence counts of the
reference.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from dynosam_tpu_torch.parallel.batched import PipelineState


def _host_int(v, batched: bool) -> int:
    v = np.asarray(v)
    if batched:
        if v.ndim != 1 or not (v == v[0]).all():
            raise ValueError(f"a batched host counter must be equal across the batch, got {v}")
        v = v[0]
    return int(v)


def dataclass_from_numpy(cls, d, device, batched: bool = False):
    """Build the port dataclass `cls` from a nested dict of numpy arrays
    keyed by its field names; extra keys are ignored."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        t, v = hints[f.name], d[f.name]
        if dataclasses.is_dataclass(t):
            kw[f.name] = dataclass_from_numpy(t, v, device, batched)
        elif t is int:                       # host-side counters
            kw[f.name] = _host_int(v, batched)
        else:
            kw[f.name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return cls(**kw)


def pipeline_state_from_numpy(d, device, batched: bool = False) -> PipelineState:
    return dataclass_from_numpy(PipelineState, d, device, batched)


def dataclass_to_numpy(obj, batch=None):
    """Nested dict of numpy arrays from a port dataclass; with `batch` = B,
    host counters repeat B times, as the reference's vmapped leaves."""
    if dataclasses.is_dataclass(obj):
        return {f.name: dataclass_to_numpy(getattr(obj, f.name), batch) for f in dataclasses.fields(obj)}
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    return np.asarray(obj, np.int32) if batch is None else np.full((batch,), obj, np.int32)


def pipeline_state_to_numpy(state: PipelineState, batched: bool = False) -> dict:
    batch = state.frontend.frame_idx.shape[0] if batched else None
    return dataclass_to_numpy(state, batch)
