"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Data crosses between the JAX reference and the port as numpy arrays.
"""

import dataclasses

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
from dynosam_tpu_torch import config as tconfig
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


def port_cfg(cfg):
    """The port's config dataclass (of the same class name, from
    dynosam_tpu_torch.config) holding the values of a reference config."""
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: port_cfg(v) if dataclasses.is_dataclass(v := getattr(cfg, f.name)) else v
                  for f in dataclasses.fields(cfg)})


def jax_spec(spec):
    """The JAX ScenarioSpec of a port ScenarioSpec (no point clouds: the
    dense renderer draws the scene)."""
    from dynosam_tpu.dataproviders.simulator import ObjectSpec, ScenarioSpec

    return ScenarioSpec(
        num_frames=spec.num_frames, num_static=0, camera_motion_xi=spec.camera_motion_xi,
        frame_dt=spec.frame_dt, objects=[ObjectSpec(object_id=o.object_id, initial_pose_xi=o.initial_pose_xi,
                            motion_xi=o.motion_xi, num_points=0) for o in spec.objects],
    )


def jax_intr(intr):
    """The JAX CameraIntrinsics of port intrinsics."""
    from dynosam_tpu.cv import camera as jcam

    return jcam.CameraIntrinsics.create(intr.fx, intr.fy, intr.cx, intr.cy, width=intr.width,
                                        height=intr.height, baseline=intr.baseline)


def jax_dense(scene):
    """The JAX DenseScenario rendering the same scene as a port DenseScenario."""
    from dynosam_tpu.dataproviders.synthetic_dense import DenseScenario

    return DenseScenario(
        jax_spec(scene.scn.spec), jax_intr(scene.intr), ground_y=scene.ground_y,
        far_depth=scene.far_depth, world_texture=scene.world_texture, object_texture=scene.object_texture,
        object_half_extents=scene.obj_extents, object_classes=scene.object_classes,
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


def reference_draws(key, fp, n_frames):
    """The uniforms of the JAX frontend's RANSAC draws over `n_frames` frames
    from its state key `key`, in the order the port samples: per frame the
    camera's (M, Ns), then the objects' (J, M, Nd)."""
    import jax

    rs = fp.motion_solver
    out = []
    for _ in range(n_frames):
        key, k_cam, k_obj = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.uniform(
            k_cam, (rs.camera.num_hypotheses(), fp.tracker.max_features_per_frame))))
        shape = (rs.object.num_hypotheses(), fp.tracker.max_dynamic_features_per_frame)
        keys = jax.random.split(k_obj, fp.max_objects)
        out.append(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)))
    return out


def inject_draws(monkeypatch, draws):
    """Make the port's RANSAC sample from `draws` (reference_draws), one
    array per call, in order."""
    from dynosam_tpu_torch.ops import ransac

    orig = ransac._sample_indices
    queue = list(draws)

    def sample(generator, valid, num_hypotheses, sample_size, uniforms=None):
        return orig(generator, valid, num_hypotheses, sample_size, uniforms=t(queue.pop(0)))

    monkeypatch.setattr(ransac, "_sample_indices", sample)
    return queue
