"""Factor residuals and closed-form Jacobians (port of dynosam_tpu/backend/factors.py).

Poses are world-from-camera with right perturbation X <- X exp(xi), tangent
order [omega, v]. Every function broadcasts over leading dimensions.
"""

from __future__ import annotations

import torch

from dynosam_tpu_torch.utils import lie


# ---------------------------------------------------------------------------
# Pose-to-point: r = X^{-1} m - z            (dim 3)
# ---------------------------------------------------------------------------

def pose_to_point_residual(X, m, z):
    return lie.transform_points(lie.inverse(X), m) - z


def pose_to_point_jacobians(X, m):
    """Returns (J_pose (...,3,6), J_point (...,3,3)): hat(y) | -I and R^T."""
    R = lie.rotation(X)
    y = lie.transform_points(lie.inverse(X), m)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(y.shape + (3,))
    J_pose = torch.cat([lie.hat(y), -eye], dim=-1)
    return J_pose, R.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Landmark motion ternary: r = m_k - H m_{k-1}    (dim 3)
# ---------------------------------------------------------------------------

def motion_ternary_residual(m_prev, m_curr, H):
    return m_curr - lie.transform_points(H, m_prev)


def motion_ternary_jacobians(m_prev, H):
    """Returns (J_prev, J_curr, J_H = [R_H hat(p) | -R_H])."""
    R = lie.rotation(H)
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand(R.shape)
    J_H = torch.cat([lie.mm(R, lie.hat(m_prev)), -R], dim=-1)
    return -R, eye, J_H


# ---------------------------------------------------------------------------
# SE(3) between: r = log(Z^{-1} A^{-1} B)          (dim 6)
# ---------------------------------------------------------------------------

def between_residual(A, B, Z):
    return lie.se3_log(lie.mm(lie.inverse(Z), lie.mm(lie.inverse(A), B)))


def between_jacobians(A, B, Z, r=None):
    """(J_A, J_B) = (-Jr^{-1}(r) Ad(B^{-1} A), Jr^{-1}(r))."""
    if r is None:
        r = between_residual(A, B, Z)
    Jr_inv = lie.se3_right_jacobian_inv(r)
    Ad = lie.adjoint(lie.mm(lie.inverse(B), A))
    return -lie.mm(Jr_inv, Ad), Jr_inv


# ---------------------------------------------------------------------------
# SE(3) prior: r = log(Z^{-1} X)                   (dim 6)
# ---------------------------------------------------------------------------

def prior_residual(X, Z):
    return lie.se3_log(lie.mm(lie.inverse(Z), X))


def prior_jacobian(X, Z, r=None):
    if r is None:
        r = prior_residual(X, Z)
    return lie.se3_right_jacobian_inv(r)


def huber_weight(r_norm, k):
    safe = torch.clamp(r_norm, min=1e-12)
    return torch.where(r_norm <= k, torch.ones_like(safe), k / safe)
