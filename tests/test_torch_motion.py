"""Parity of the port's closed-form alignment, RANSAC and motion solvers with
the JAX reference. RANSAC draws are the reference's own uniforms, injected,
so both sides score the same hypotheses: models agree within 1e-4 and inlier
masks exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.config import MotionSolverParams, RansacParams
from dynosam_tpu.cv import camera as jcam
from dynosam_tpu.frontend import motion as jmotion
from dynosam_tpu.ops import kabsch as jkabsch
from dynosam_tpu.ops import ransac as jransac
from dynosam_tpu.utils import lie as jlie
from dynosam_tpu_torch.cv import camera as tcam
from dynosam_tpu_torch.frontend import motion as tmotion
from dynosam_tpu_torch.ops import kabsch as tkabsch
from dynosam_tpu_torch.ops import ransac as transac
from torch_port_util import t

torch.set_num_threads(1)
ATOL = 1e-4

PARAMS = MotionSolverParams(
    camera=RansacParams(ransac_iterations=64),
    object=RansacParams(ransac_iterations=64, min_inliers=8),
    refinement_iterations=3,
    object_refinement_iterations=2,
    refit_rounds=1,
)
J_INTR = jcam.CameraIntrinsics.create(200.0, 200.0, 80.0, 60.0, width=160, height=120)
T_INTR = tcam.CameraIntrinsics.create(200.0, 200.0, 80.0, 60.0, width=160, height=120)


def _pose(xi):
    return np.array(jlie.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _transform(T, p):
    return p @ T[:3, :3].T + T[:3, 3]


def _project(p):
    return np.stack([200.0 * p[:, 0] / p[:, 2] + 80.0, 200.0 * p[:, 1] / p[:, 2] + 60.0], -1)


def _scene(n=96, seed=0):
    """World points, camera-from-world pose T_cw, observations with pixel
    noise, 20% gross outliers and a few invalid slots."""
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(6, 20, n)], -1)
    T_cw = _pose([0.01, -0.02, 0.005, 0.1, -0.05, 0.4])
    pc = _transform(T_cw, pw)
    uv = _project(pc) + rng.normal(0, 0.2, (n, 2))
    out = rng.random(n) < 0.2
    uv[out] += rng.uniform(-15, 15, (int(out.sum()), 2))
    pc_noisy = pc + rng.normal(0, 0.01, pc.shape)
    valid = rng.random(n) > 0.05
    f32 = lambda a: a.astype(np.float32)
    return f32(pw), f32(uv), f32(pc_noisy), valid, T_cw


def test_rigid_solvers():
    rng = np.random.default_rng(1)
    T = _pose([0.2, -0.1, 0.3, 1.0, 0.5, -0.2])
    p = rng.standard_normal((8, 20, 3)).astype(np.float32)
    q = (_transform(T, p) + rng.normal(0, 0.01, p.shape)).astype(np.float32)
    w = rng.random((8, 20)).astype(np.float32)
    R0 = _pose([0.25, -0.1, 0.25, 0, 0, 0])[:3, :3]
    pairs = [
        (jkabsch.solve_rigid_3pt(jnp.asarray(p[:, :3]), jnp.asarray(q[:, :3])),
         tkabsch.solve_rigid_3pt(t(p[:, :3]), t(q[:, :3]))),
        (jkabsch.solve_rigid_quat(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w), R0=jnp.asarray(R0)),
         tkabsch.solve_rigid_quat(t(p), t(q), t(w), R0=t(R0))),
        (jkabsch.solve_rigid(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w)),
         tkabsch.solve_rigid(t(p), t(q), t(w))),
    ]
    for j, o in pairs:
        np.testing.assert_allclose(o.numpy(), np.asarray(j), atol=ATOL)


def test_sample_indices_from_injected_uniforms():
    valid = np.random.default_rng(2).random(50) > 0.3
    key = jax.random.PRNGKey(7)
    ref = jransac._sample_indices(key, jnp.asarray(valid), 32, 3)
    u = np.asarray(jax.random.uniform(key, (32, 50)))
    got = transac._sample_indices(None, t(valid), 32, 3, uniforms=t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert valid[got.numpy()].all()


def test_sample_indices_from_generator_pick_valid_distinct_slots():
    valid = torch.from_numpy(np.random.default_rng(3).random(40) > 0.5)
    idx = transac._sample_indices(torch.Generator().manual_seed(0), valid, 64, 3)
    assert idx.shape == (64, 3)
    assert bool(valid[idx].all())
    assert bool((idx[:, 0] != idx[:, 1]).all() & (idx[:, 1] != idx[:, 2]).all())


def test_solve_camera_pose():
    pw, uv, pc, valid, _ = _scene()
    key = jax.random.PRNGKey(11)
    M = PARAMS.camera.num_hypotheses()
    X_prior = np.eye(4, dtype=np.float32)
    ref = jmotion.solve_camera_pose(
        key, jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(pc), jnp.asarray(valid),
        J_INTR, PARAMS, jnp.asarray(X_prior),
    )
    u = np.asarray(jax.random.uniform(key, (M, pw.shape[0])))
    got = tmotion.solve_camera_pose(
        None, t(pw), t(uv), t(pc), t(valid), T_INTR, PARAMS, t(X_prior), uniforms=t(u)
    )
    assert bool(ref.valid) and bool(got.valid)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=ATOL)


def test_solve_all_object_motions():
    rng = np.random.default_rng(4)
    X_k = _pose([0.0, 0.02, 0.0, 0.1, 0.0, 0.5])
    object_ids = np.array([1, 2, -1, 3], np.int32)
    # object 3 gets too few points for min_inliers: invalid, identity motion
    labels = np.concatenate([np.full(50, 1), np.full(40, 2), np.full(5, 3), np.full(9, 0)]).astype(np.int32)
    n = labels.shape[0]
    centers = {1: [-3, 0.5, 12], 2: [3, 0.2, 16], 3: [0, 0, 20], 0: [0, 0, 10]}
    motions = {1: [0, 0.02, 0, 0.4, 0, 0.1], 2: [0, -0.01, 0, -0.3, 0, 0.2],
               3: [0, 0, 0, 0, 0, 0.5], 0: [0, 0, 0, 0, 0, 0]}
    p_prev = np.stack([np.asarray(centers[int(l)]) + rng.uniform(-1, 1, 3) for l in labels])
    p_k = np.stack([_transform(_pose(motions[int(l)]), p[None])[0] for l, p in zip(labels, p_prev)])
    p_k = p_k + rng.normal(0, 0.005, p_k.shape)
    uv = _project(_transform(np.linalg.inv(X_k), p_k)) + rng.normal(0, 0.3, (n, 2))
    uv[rng.random(n) < 0.15] += 12.0                                # outliers
    valid = rng.random(n) > 0.05
    f32 = lambda a: a.astype(np.float32)
    p_prev, p_k, uv = f32(p_prev), f32(p_k), f32(uv)

    key = jax.random.PRNGKey(5)
    M = PARAMS.object.num_hypotheses()
    ref = jmotion.solve_all_object_motions(
        key, jnp.asarray(object_ids), jnp.asarray(labels), jnp.asarray(p_prev),
        jnp.asarray(uv), jnp.asarray(p_k), jnp.asarray(valid), jnp.asarray(X_k), J_INTR, PARAMS,
    )
    keys = jax.random.split(key, object_ids.shape[0])
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (M, n)))(keys))
    got = tmotion.solve_all_object_motions(
        None, t(object_ids), t(labels), t(p_prev), t(uv), t(p_k), t(valid), t(X_k),
        T_INTR, PARAMS, uniforms=t(u),
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.valid.numpy().tolist() == [True, True, False, False]
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_joint_flow_pose_refine(batched):
    pw, uv, _, valid, T_cw = _scene(seed=6)
    rng = np.random.default_rng(6)
    kp_prev = (uv + rng.normal(0, 2.0, uv.shape)).astype(np.float32)
    flow = (uv - kp_prev + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    T0 = (T_cw @ _pose([0.003, -0.002, 0.001, 0.02, 0.01, -0.03])).astype(np.float32)
    if batched:
        T0 = np.stack([T0, T_cw.astype(np.float32), T0 @ _pose([0, 0.01, 0, 0, 0, 0.05])])
        valid = np.stack([valid, valid & (np.arange(valid.size) % 2 == 0), valid])
        ref = jax.vmap(
            lambda T, v: jmotion.joint_flow_pose_refine(
                T, jnp.asarray(pw), jnp.asarray(kp_prev), jnp.asarray(flow), v, J_INTR, PARAMS)
        )(jnp.asarray(T0), jnp.asarray(valid))
    else:
        ref = jmotion.joint_flow_pose_refine(
            jnp.asarray(T0), jnp.asarray(pw), jnp.asarray(kp_prev), jnp.asarray(flow),
            jnp.asarray(valid), J_INTR, PARAMS,
        )
    got = tmotion.joint_flow_pose_refine(
        t(T0), t(pw), t(kp_prev), t(flow), t(valid), T_INTR, PARAMS
    )
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(r, g.shape), atol=ATOL)
