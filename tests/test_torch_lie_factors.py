"""Parity of the port's Lie-group library, factors and inv3 with the JAX
reference, on random and near-zero (Taylor-branch) inputs. atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import factors as jfactors
from dynosam_tpu.ops import block_tridiag as jbt
from dynosam_tpu.utils import lie as jlie
from dynosam_tpu_torch.backend import factors as tfactors
from dynosam_tpu_torch.ops import block_tridiag as tbt
from dynosam_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)
ATOL = 1e-5


def _tangents(scale):
    rng = np.random.default_rng(int(scale * 1e6) % 2**31)
    return (rng.standard_normal((16, 6)) * scale).astype(np.float32)


def _poses(scale):
    return np.array(jlie.se3_exp(jnp.asarray(_tangents(scale))))


def _both(fn_name, *args):
    j = getattr(jlie, fn_name)(*[jnp.asarray(a) for a in args])
    t = getattr(tlie, fn_name)(*[torch.from_numpy(np.array(a)) for a in args])
    return np.asarray(j), t.numpy()


# scale 0.5: generic branch; 1e-4: every small-angle Taylor branch
SCALES = [0.5, 1e-4]

TANGENT_FNS = ["so3_exp", "so3_left_jacobian", "so3_left_jacobian_inv", "hat"]
SE3_TANGENT_FNS = ["se3_exp", "se3_left_jacobian_inv", "se3_right_jacobian_inv"]
POSE_FNS = ["se3_log", "inverse", "adjoint", "normalize_rotation"]


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("fn", TANGENT_FNS)
def test_so3_tangent_functions(fn, scale):
    j, t = _both(fn, _tangents(scale)[:, :3])
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("fn", SE3_TANGENT_FNS)
def test_se3_tangent_functions(fn, scale):
    j, t = _both(fn, _tangents(scale))
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("fn", POSE_FNS)
def test_pose_functions(fn, scale):
    j, t = _both(fn, _poses(scale))
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_so3_log_near_pi():
    axis = np.array([[1.0, 0.0, 0.0], [0.0, 0.6, 0.8], [0.48, 0.6, 0.64]], np.float32)
    w = axis * np.float32(np.pi - 1e-4)
    R = np.array(jlie.so3_exp(jnp.asarray(w)))
    j, t = _both("so3_log", R)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_compose_transform_retract_local():
    A, B = _poses(0.5), _poses(0.3)
    pts = np.random.default_rng(1).standard_normal((16, 3)).astype(np.float32)
    xi = _tangents(0.2)
    for fn, args in [
        ("compose", (A, B)),
        ("transform_points", (A, pts)),
        ("rotate_points", (A[:, :3, :3], pts)),
        ("retract", (A, xi)),
        ("local_coordinates", (A, B)),
    ]:
        j, t = _both(fn, *args)
        np.testing.assert_allclose(t, j, atol=ATOL, err_msg=fn)


def test_quaternions():
    R = _poses(0.8)[:, :3, :3]
    j, t = _both("rot_to_quat", R)
    np.testing.assert_allclose(t, j, atol=ATOL)
    j, t = _both("quat_to_rot", j)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("scale", SCALES)
def test_between_and_prior_factors(scale):
    A, B, Z = _poses(0.5), _poses(0.4), _poses(scale)
    jA, jB, jZ = (jnp.asarray(x) for x in (A, B, Z))
    tA, tB, tZ = (torch.from_numpy(x) for x in (A, B, Z))
    pairs = [
        (jfactors.between_residual(jA, jB, jZ), tfactors.between_residual(tA, tB, tZ)),
        (jfactors.prior_residual(jA, jZ), tfactors.prior_residual(tA, tZ)),
        (jfactors.prior_jacobian(jA, jZ), tfactors.prior_jacobian(tA, tZ)),
    ]
    pairs += list(zip(jfactors.between_jacobians(jA, jB, jZ),
                      tfactors.between_jacobians(tA, tB, tZ)))
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_point_factors():
    rng = np.random.default_rng(2)
    X, H = _poses(0.5), _poses(0.2)
    m = rng.standard_normal((16, 3)).astype(np.float32) * 5
    z = rng.standard_normal((16, 3)).astype(np.float32)
    J_ = [jnp.asarray(a) for a in (X, H, m, z)]
    T_ = [torch.from_numpy(a) for a in (X, H, m, z)]
    pairs = [
        (jfactors.pose_to_point_residual(J_[0], J_[2], J_[3]),
         tfactors.pose_to_point_residual(T_[0], T_[2], T_[3])),
        (jfactors.motion_ternary_residual(J_[2], J_[3], J_[1]),
         tfactors.motion_ternary_residual(T_[2], T_[3], T_[1])),
    ]
    pairs += list(zip(jfactors.pose_to_point_jacobians(J_[0], J_[2]),
                      tfactors.pose_to_point_jacobians(T_[0], T_[2])))
    pairs += list(zip(jfactors.motion_ternary_jacobians(J_[2], J_[1]),
                      tfactors.motion_ternary_jacobians(T_[2], T_[1])))
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_inv3():
    A = np.random.default_rng(3).standard_normal((32, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    j = np.asarray(jbt.inv3(jnp.asarray(A)))
    t = tbt.inv3(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(t, j, atol=ATOL)
