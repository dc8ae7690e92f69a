"""Batched SE(3)/SO(3) Lie-group library (PyTorch port of dynosam_tpu/utils/lie.py).

Poses are ``(..., 4, 4)`` homogeneous matrices; tangents are ``(..., 6)`` in
GTSAM order ``[omega, v]``. Small-angle branches use Taylor series through
``torch.where`` on sanitised operands, as the JAX reference does.

The reference forces HIGHEST-precision f32 matmuls (TPU matmuls default to
bf16 inputs). Here the same is set once for the process: TF32 off for CUDA
matmuls and cuDNN, so every ``mm``/``einsum`` below is full f32 on the card.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_EPS = 1e-6


def mm(a, b):
    return torch.matmul(a, b)


def einsum(subscripts, *operands):
    return torch.einsum(subscripts, *operands)


def _taylor_safe(theta2):
    is_small = theta2 < _EPS
    safe = torch.where(is_small, torch.ones_like(theta2), theta2)
    return is_small, safe


def _eye_like(x, n, shape):
    return torch.eye(n, dtype=x.dtype, device=x.device).expand(shape)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w):
    theta2 = torch.sum(w * w, dim=-1)
    is_small, safe_theta2 = _taylor_safe(theta2)
    theta = torch.sqrt(safe_theta2)
    a = torch.where(is_small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(is_small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_theta2)
    W = hat(w)
    W2 = mm(W, W)
    eye = _eye_like(w, 3, W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    Rt = R.transpose(-1, -2)
    s = vee(R - Rt) * 0.5
    s2 = torch.sum(s * s, dim=-1)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)

    small_sin = s2 < _EPS
    near_pi = small_sin & (cos_theta < 0.0)
    near_zero = small_sin & (cos_theta >= 0.0)

    safe_s2 = torch.where(small_sin, torch.ones_like(s2), s2)
    sin_theta = torch.sqrt(safe_s2)
    theta = torch.atan2(sin_theta, cos_theta)

    k = torch.where(near_zero, 1.0 + s2 / 6.0, theta / sin_theta)
    w_generic = s * k[..., None]

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    denom = torch.where(near_pi, 1.0 - cos_theta, torch.ones_like(cos_theta))
    axis_sq = torch.clamp((diag - cos_theta[..., None]) / denom[..., None], min=0.0)
    axis_sq = torch.where(near_pi[..., None], axis_sq, torch.ones_like(axis_sq))
    axis = torch.sqrt(axis_sq)
    signs = torch.sign(torch.where(torch.abs(s) < 1e-12, torch.ones_like(s), s))
    axis = axis * signs
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.clamp(norm, min=1e-12)
    sin_small = torch.sqrt(s2 + 1e-24)
    theta_pi = math.pi - torch.arcsin(torch.clamp(sin_small, 0.0, 1.0))
    w_pi = axis * theta_pi[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w):
    theta2 = torch.sum(w * w, dim=-1)
    is_small, safe_theta2 = _taylor_safe(theta2)
    theta = torch.sqrt(safe_theta2)
    W = hat(w)
    W2 = mm(W, W)
    b = torch.where(is_small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_theta2)
    c = torch.where(
        is_small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (safe_theta2 * theta),
    )
    eye = _eye_like(w, 3, W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def so3_left_jacobian_inv(w):
    theta2 = torch.sum(w * w, dim=-1)
    is_small, safe_theta2 = _taylor_safe(theta2)
    theta = torch.sqrt(safe_theta2)
    W = hat(w)
    W2 = mm(W, W)
    half_theta = 0.5 * theta
    sin_half = torch.sin(half_theta)
    safe_sin_half = torch.where(is_small, torch.ones_like(sin_half), sin_half)
    cot = torch.where(
        is_small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta) / safe_sin_half) / safe_theta2,
    )
    eye = _eye_like(w, 3, W.shape)
    return eye - 0.5 * W + cot[..., None, None] * W2


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def make_pose(R, t):
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    bottom = torch.cat(
        [R.new_zeros(batch + (1, 3)), R.new_ones(batch + (1, 1))], dim=-1
    )
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def identity(batch_shape=(), dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch_shape) + (4, 4))


def rotation(T):
    return T[..., :3, :3]


def translation(T):
    return T[..., :3, 3]


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make_pose(Rt, -einsum("...ij,...j->...i", Rt, t))


def compose(A, B):
    return mm(A, B)


def transform_points(T, pts):
    """T (..., 4, 4), pts (..., 3) -> (..., 3), component arithmetic."""
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    qx = T[..., 0, 0] * px + T[..., 0, 1] * py + T[..., 0, 2] * pz + T[..., 0, 3]
    qy = T[..., 1, 0] * px + T[..., 1, 1] * py + T[..., 1, 2] * pz + T[..., 1, 3]
    qz = T[..., 2, 0] * px + T[..., 2, 1] * py + T[..., 2, 2] * pz + T[..., 2, 3]
    return torch.stack([qx, qy, qz], dim=-1)


def rotate_points(R, pts):
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    qx = R[..., 0, 0] * px + R[..., 0, 1] * py + R[..., 0, 2] * pz
    qy = R[..., 1, 0] * px + R[..., 1, 1] * py + R[..., 1, 2] * pz
    qz = R[..., 2, 0] * px + R[..., 2, 1] * py + R[..., 2, 2] * pz
    return torch.stack([qx, qy, qz], dim=-1)


def se3_exp(xi):
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    Jl = so3_left_jacobian(w)
    t = einsum("...ij,...j->...i", Jl, v)
    return make_pose(R, t)


def se3_log(T):
    w = so3_log(T[..., :3, :3])
    Jl_inv = so3_left_jacobian_inv(w)
    v = einsum("...ij,...j->...i", Jl_inv, T[..., :3, 3])
    return torch.cat([w, v], dim=-1)


def _se3_Q(xi):
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    is_small, safe_theta2 = _taylor_safe(theta2)
    theta = torch.sqrt(safe_theta2)
    s, c = torch.sin(theta), torch.cos(theta)
    t3 = safe_theta2 * theta
    t4 = safe_theta2 * safe_theta2
    t5 = t4 * theta

    c1 = torch.where(is_small, 1.0 / 6.0 - theta2 / 120.0, (theta - s) / t3)
    c2 = torch.where(is_small, 1.0 / 24.0 - theta2 / 720.0, -(1.0 - theta2 / 2.0 - c) / t4)
    c3 = 0.5 * (
        c2
        + 3.0
        * torch.where(is_small, -1.0 / 120.0 + theta2 / 5040.0, (theta - s - t3 / 6.0) / t5)
    )

    W = hat(w)
    V = hat(v)
    WV, VW = mm(W, V), mm(V, W)
    WVW = mm(WV, W)
    W2 = mm(W, W)
    c1t = c1[..., None, None]
    c2t = c2[..., None, None]
    c3t = c3[..., None, None]
    return (
        0.5 * V
        + c1t * (WV + VW + WVW)
        + c2t * (mm(W2, V) + mm(V, W2) - 3.0 * WVW)
        + c3t * (mm(WVW, W) + mm(W, WVW))
    )


def se3_left_jacobian_inv(xi):
    w = xi[..., :3]
    Jw_inv = so3_left_jacobian_inv(w)
    Q = _se3_Q(xi)
    bl = -mm(mm(Jw_inv, Q), Jw_inv)
    zeros = torch.zeros_like(Jw_inv)
    top = torch.cat([Jw_inv, zeros], dim=-1)
    bottom = torch.cat([bl, Jw_inv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_right_jacobian_inv(xi):
    return se3_left_jacobian_inv(-xi)


def adjoint(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = mm(hat(t), R)
    zeros = torch.zeros_like(R)
    top = torch.cat([R, zeros], dim=-1)
    bottom = torch.cat([tR, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def retract(T, xi):
    """Right-retraction T * exp(xi) (GTSAM Pose3::retract)."""
    return mm(T, se3_exp(xi))


def local_coordinates(T_a, T_b):
    return se3_log(mm(inverse(T_a), T_b))


def normalize_rotation(T):
    R = T[..., :3, :3]
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(mm(u, vt))
    d = torch.ones(u.shape[:-2] + (3,), dtype=T.dtype, device=T.device)
    d[..., 2] = det
    R_fixed = mm(u * d[..., None, :], vt)
    return make_pose(R_fixed, T[..., :3, 3])


# ---------------------------------------------------------------------------
# Quaternions (xyzw)
# ---------------------------------------------------------------------------

def rot_to_quat(R):
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) * 0.5
    k0 = 0.25 / qw0
    c0 = torch.stack([(m21 - m12) * k0, (m02 - m20) * k0, (m10 - m01) * k0, qw0], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    k1 = 0.25 / qx1
    c1 = torch.stack([qx1, (m01 + m10) * k1, (m02 + m20) * k1, (m21 - m12) * k1], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    k2 = 0.25 / qy2
    c2 = torch.stack([(m01 + m10) * k2, qy2, (m12 + m21) * k2, (m02 - m20) * k2], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    k3 = 0.25 / qz3
    c3 = torch.stack([(m02 + m20) * k3, (m12 + m21) * k3, qz3, (m10 - m01) * k3], dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, c0, torch.where(cond1, c1, torch.where(cond2, c2, c3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
