"""Carry pipeline state between the JAX reference and the port.

`pipeline_state_from_numpy` takes the nested dict of numpy arrays that
`flax.serialization.to_state_dict` gives for the reference's PipelineState
and builds the port's `PipelineState`; `pipeline_state_to_numpy` does the
reverse for the fields the port has. Leaves the port does not carry are
dropped: the RANSAC key (a torch.Generator replaces it), the ByteTrack state,
and the KLT, mask-propagation and IMU carries.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from dynosam_tpu_torch.parallel.batched import PipelineState


def dataclass_from_numpy(cls, d, device):
    """Build the port dataclass `cls` from a nested dict of numpy arrays
    keyed by its field names; extra keys are ignored."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        t, v = hints[f.name], d[f.name]
        if dataclasses.is_dataclass(t):
            kw[f.name] = dataclass_from_numpy(t, v, device)
        elif t is int:                       # host-side counters
            kw[f.name] = int(np.asarray(v))
        else:
            kw[f.name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return cls(**kw)


def pipeline_state_from_numpy(d, device) -> PipelineState:
    return dataclass_from_numpy(PipelineState, d, device)


def dataclass_to_numpy(obj):
    """Nested dict of numpy arrays from a port dataclass."""
    if dataclasses.is_dataclass(obj):
        return {f.name: dataclass_to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    return np.asarray(obj, np.int32)


def pipeline_state_to_numpy(state: PipelineState) -> dict:
    return dataclass_to_numpy(state)
