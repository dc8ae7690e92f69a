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


def stack_frames(frames):
    """One port FrameInputs with a leading batch axis from per-sequence
    frames."""
    f0 = frames[0]
    return dataclasses.replace(f0, **{k: torch.stack([getattr(f, k) for f in frames])
                                      for k in f0.tensors()})


def seq_of(obj, b):
    """Sequence b of a batched output dict or (nested) dataclass; host ints
    stay."""
    from dynosam_tpu_torch.parallel.batched import _map_tensors

    if isinstance(obj, dict):
        return {k: v[b] for k, v in obj.items()}
    return _map_tensors(lambda x: x[b], obj)


def port_intr(intr):
    """The port's CameraIntrinsics of JAX intrinsics."""
    from dynosam_tpu_torch.cv import camera as tcam

    return tcam.CameraIntrinsics.create(float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
                                        width=intr.width, height=intr.height, baseline=intr.baseline)


def port_spec(spec):
    """The port's ScenarioSpec of a JAX ScenarioSpec, point clouds included."""
    from dynosam_tpu_torch.dataproviders import simulator as tsim

    objects = [tsim.ObjectSpec(**{f.name: getattr(o, f.name) for f in dataclasses.fields(tsim.ObjectSpec)})
               for o in spec.objects]
    kw = {f.name: getattr(spec, f.name) for f in dataclasses.fields(tsim.ScenarioSpec) if f.name != "objects"}
    return tsim.ScenarioSpec(objects=objects, **kw)


def scenario_uniforms(spec):
    """The uniforms the JAX Scenario draws its static and object landmark
    clouds from (its key split and fold_in), for the port's Scenario."""
    import jax

    _, k_obj, _ = keys = jax.random.split(jax.random.PRNGKey(spec.seed), 3)
    return {"static": np.asarray(jax.random.uniform(keys[0], (spec.num_static, 3))),
            "objects": [np.asarray(jax.random.uniform(jax.random.fold_in(k_obj, i), (o.num_points, 3)))
                        for i, o in enumerate(spec.objects)]}


def scenario_normals(spec, K):
    """The standard normals behind the JAX Scenario's measurement noise over
    frames 0..K-1, for the port's Scenario(normals=): per frame k its key
    fold_in(noise_key, k) split into pixel and depth keys, each folded with
    observe's block (0 static, j + 1 object j)."""
    import jax

    noise_key = jax.random.split(jax.random.PRNGKey(spec.seed), 3)[2]
    blocks = [spec.num_static] + [o.num_points for o in spec.objects]
    px = [[] for _ in blocks]
    d = [[] for _ in blocks]
    for k in range(K):
        k_px, k_d = jax.random.split(jax.random.fold_in(noise_key, k))
        for b, n in enumerate(blocks):
            px[b].append(np.asarray(jax.random.normal(jax.random.fold_in(k_px, b), (n, 2))))
            d[b].append(np.asarray(jax.random.normal(jax.random.fold_in(k_d, b), (n,))))
    pairs = [(np.stack(p), np.stack(q)) for p, q in zip(px, d)]
    return {"static": pairs[0], "objects": pairs[1:]}


def reference_native(tmp_dir):
    """The JAX package's native IO library (dynosam_tpu/native.py), loaded in
    this process whatever another process is doing. get_lib builds
    native/libdynoio.so beside its source at first use, unlocked across
    processes: an xdist worker that loads the file while another is writing
    it gets OSError, marks itself tried for good and falls back to Python
    arithmetic (disparity_to_depth divides in float64). Where the library is
    not loaded, this builds the source into `tmp_dir` by the module's own
    _build (its flags) and loads it by get_lib (its argtypes), pointing the
    module's _LIB there for that one call. The module's state is patched,
    its code is not changed."""
    import os

    from dynosam_tpu import native as jnative

    if jnative._lib is not None:
        return jnative._lib
    shared = jnative._LIB
    jnative._LIB = os.path.join(str(tmp_dir), "libdynoio.so")
    jnative._tried, jnative._lib = False, None
    try:
        lib = jnative.get_lib()
    finally:
        jnative._LIB = shared
    assert lib is not None, "g++ could not build native/dynoio.cpp"
    return lib


def packet_backend_cfg(**kw):
    """The reference backend tests' settings on default_two_objects
    (tests/test_backend.py small_cfg): 256 static + 96 dynamic slots, 4
    objects, range-independent noise, and `kw`."""
    from dynosam_tpu.config import NoiseParams

    base = dict(max_frames=5, max_objects=4, max_static_landmarks=256, max_dynamic_landmarks=96,
                noise=NoiseParams(use_range_dependent_noise=False),
                optimizer=OptimizerParams(max_iterations=3))
    base.update(kw)
    return BackendParams(**base)


def reference_window_run(cfg, packets, intr, update_fn, optimize_fn, advance_fn):
    """A reference run of one formulation over `packets`: per frame the
    graph before and after ingestion, and the optimised full window before
    each advance -> (records [(g_in, packet, g_out)], windows)."""
    import jax

    upd = jax.jit(lambda g, p: update_fn(g, p, intr, cfg))
    opt = jax.jit(lambda g: optimize_fn(g, cfg))
    adv = jax.jit(lambda g: advance_fn(g, cfg))
    from dynosam_tpu.backend import graph as jgraph

    g = jgraph.empty_graph(cfg)
    records, windows = [], []
    for p in packets:
        if int(g.num_frames) >= cfg.max_frames:
            windows.append(g)
            g = adv(g)
        g_out = upd(g, p)
        records.append((g, p, g_out))
        g = opt(g_out)
    return records, windows


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


def check_advanced(ref_state, got_state, unique_sqrt=True, **rel):
    """A window advance of the port against the reference's: the rolled
    tables, the square-root prior (prior_L, prior_b) and its invariants, the
    information prior_L^T prior_L and the gradient prior_L^T prior_b. `rel`
    overrides the bounds relative to each one's largest entry (prior_L and
    prior_b 1e-3, info and grad 1e-4)."""
    rel = {"prior_L": 1e-3, "prior_b": 1e-3, "info": 1e-4, "grad": 1e-4, **rel}
    ref = np_tree(ref_state)
    got = convert.dataclass_to_numpy(got_state)
    assert bool(ref["prior_valid"])
    # the square-root prior: Cholesky factors (unique) of matrices equal to
    # ~1e-5 relative, so rows agree to ~1e-3 of the largest entry. The eigh
    # path's rows are eigenvectors, fixed only up to sign and rotation within
    # an eigenspace: there only the invariants below are compared.
    for name in ("prior_L", "prior_b"):
        r, v = ref.pop(name), got.pop(name)
        if unique_sqrt:
            np.testing.assert_allclose(v, r, rtol=1e-3, atol=rel[name] * _scale(r), err_msg=name)
    # every other table is rolled, not recomputed: exact for integers and
    # bools, the float tables within f32 rounding of the ingestion
    assert_tree_matches(ref, got, atol=1e-5, rtol=1e-6)
    # the prior's information, which the solver uses, and its gradient at
    # the linearisation point
    info_r = np.asarray(ref_state.prior_L.T @ ref_state.prior_L)
    info = (got_state.prior_L.T @ got_state.prior_L).numpy()
    np.testing.assert_allclose(info, info_r, rtol=1e-3, atol=rel["info"] * _scale(info_r), err_msg="info")
    grad_r = np.asarray(ref_state.prior_L.T @ ref_state.prior_b)
    grad = (got_state.prior_L.T @ got_state.prior_b).numpy()
    np.testing.assert_allclose(grad, grad_r, rtol=1e-3, atol=rel["grad"] * _scale(grad_r), err_msg="grad")


def xla_cholesky(monkeypatch):
    """Make the port's torch.linalg.cholesky_ex factor with XLA's Cholesky
    (through JAX on the CPU), so both sides pass or fail the same
    factorisations: a system at the edge of f32 positive definiteness
    passes one implementation and fails another. A batch of matrices gets
    one status per matrix."""
    import jax.numpy as jnp

    def cholesky_ex(a, *args, **kw):
        L = np.asarray(jnp.linalg.cholesky(jnp.asarray(a.numpy())))
        # per matrix of a batch, as torch reports it
        ok = np.isfinite(L).reshape(L.shape[:-2] + (-1,)).all(-1)
        return torch.from_numpy(np.array(L)), torch.from_numpy(np.where(ok, 0, 1).astype(np.int32))

    monkeypatch.setattr(torch.linalg, "cholesky_ex", cholesky_ex)


def fused_step_readings(cfg, n):
    """The fused step of both packages over the first `n` frames of the
    dense test scene -> (largest camera-pose entry difference, largest
    object-motion entry difference over the motions valid on both sides,
    motions compared, the port's final graph, the reference's). Object ids
    and motion validity must be equal in every frame. The scene is
    noise-free: RANSAC's outcome does not depend on the draws."""
    import jax

    from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
    from dynosam_tpu.parallel import batched as jbatched
    from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
    from dynosam_tpu_torch.parallel import batched as tbatched

    jd, td = j_dense(num_frames=n), t_dense(num_frames=n, device="cpu")
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr))
    js = jbatched.init_pipeline_state(cfg)
    tcfg = port_cfg(cfg)
    tstep = tbatched.make_fused_step(tcfg, td.intr, torch.Generator().manual_seed(0))
    ts = tbatched.init_pipeline_state(tcfg, "cpu")
    pose_err, motion_err, n_motions = 0.0, 0.0, 0
    for k in range(n):
        js, jo = jstep(js, jd.frame(k))
        ts, to = tstep(ts, td.frame(k))
        assert ts.graph.num_frames == min(k + 1, cfg.backend.max_frames)
        pose_err = max(pose_err, float(np.abs(to["X_world_cam"].numpy() - np.asarray(jo["X_world_cam"])).max()))
        np.testing.assert_array_equal(to["object_ids"].numpy(), np.asarray(jo["object_ids"]))
        v = np.asarray(jo["object_motion_valid"])
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        d = np.abs(to["object_motions"].numpy()[v] - np.asarray(jo["object_motions"])[v])
        motion_err = max(motion_err, float(d.max(initial=0.0)))
        n_motions += int(v.sum())
    return pose_err, motion_err, n_motions, ts.graph, js.graph
