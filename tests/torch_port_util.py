"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Data crosses between the JAX reference and the port as numpy arrays.
"""

import numpy as np
import torch
from flax import serialization

from dynosam_tpu.config import (
    BackendParams,
    DynoConfig,
    FrontendParams,
    OptimizerParams,
    TrackerParams,
)
from dynosam_tpu_torch import convert


def small_cfg(max_frames=4):
    """A few-slot configuration of the bench's settings: hybrid backend,
    incremental mode, 2 LM iterations."""
    return DynoConfig(
        frontend=FrontendParams(
            max_objects=4,
            tracker=TrackerParams(
                max_features_per_frame=128,
                min_features_per_frame=64,
                max_dynamic_features_per_frame=128,
                detection_cell_size=8,
                min_corner_response=1e-6,
            ),
        ),
        backend=BackendParams(
            optimization_mode=2,
            backend_updater_enum=3,
            max_frames=max_frames,
            max_objects=4,
            max_static_landmarks=128,
            max_dynamic_landmarks=128,
            optimizer=OptimizerParams(max_iterations=2),
        ),
    )


def np_tree(obj):
    """Nested dict of numpy arrays from a flax struct (or dict of arrays)."""
    d = serialization.to_state_dict(obj)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return None if x is None else np.asarray(x)

    return conv(d)


def to_port(cls, jax_obj):
    """The port dataclass `cls` holding the values of a JAX flax struct."""
    return convert.dataclass_from_numpy(cls, np_tree(jax_obj), "cpu")


def t(x):
    """A torch tensor holding a copy of `x` (numpy or JAX array)."""
    return torch.from_numpy(np.array(x))


def assert_tree_matches(ref, got, atol, rtol=0.0, path=""):
    """Integer and bool leaves must be equal; float leaves within
    atol + rtol * |ref|. Compares the keys of `got` (the port's fields)."""
    for k, v in got.items():
        r = ref[k]
        p = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            assert_tree_matches(r, v, atol, rtol, p)
            continue
        r, v = np.asarray(r), np.asarray(v)
        assert r.shape == v.shape, (p, r.shape, v.shape)
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(v, r, err_msg=p)
        else:
            np.testing.assert_allclose(v, r, atol=atol, rtol=rtol, err_msg=p)
