"""Closed-form rigid alignment (port of dynosam_tpu/ops/kabsch.py).

`solve_rigid_3pt` (3-point triad, for RANSAC hypotheses) and
`solve_rigid_quat` (weighted Horn quaternion refit by warm-started power
iteration) are the two solvers the motion solvers call; both avoid SVD, as in
the reference. `solve_rigid` keeps the SVD form for completeness.
"""

from __future__ import annotations

import torch

from dynosam_tpu_torch.utils import lie


def solve_rigid(p, q, w=None):
    """Rigid T (4x4) with q ~= T p, batched over leading dims."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    w = w[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2), min=1e-9)
    mu_p = torch.sum(p * w, dim=-2) / wsum
    mu_q = torch.sum(q * w, dim=-2) / wsum
    pc = p - mu_p[..., None, :]
    qc = q - mu_q[..., None, :]
    H = lie.einsum("...ni,...nj->...ij", qc * w, pc)
    H = H + 1e-12 * torch.eye(3, dtype=p.dtype, device=p.device)
    u, _, vt = torch.linalg.svd(H)
    det = torch.linalg.det(lie.mm(u, vt))
    d = torch.ones(u.shape[:-2] + (3,), dtype=p.dtype, device=p.device)
    d[..., 2] = det
    R = lie.mm(u * d[..., None, :], vt)
    t = mu_q - lie.einsum("...ij,...j->...i", R, mu_p)
    return lie.make_pose(R, t)


def _normalize(v, eps=1e-12):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)


def _triad(p):
    d1 = p[..., 1, :] - p[..., 0, :]
    d2 = p[..., 2, :] - p[..., 0, :]
    e1 = _normalize(d1)
    e2 = _normalize(d2 - torch.sum(d2 * e1, dim=-1, keepdim=True) * e1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-2)


def solve_rigid_3pt(p, q):
    """Exact rigid transform from 3 correspondences (..., 3, 3) -> (..., 4, 4)."""
    Bp = _triad(p)
    Bq = _triad(q)
    R = lie.mm(Bq.transpose(-1, -2), Bp)
    mu_p = torch.mean(p, dim=-2)
    mu_q = torch.mean(q, dim=-2)
    t = mu_q - lie.rotate_points(R, mu_p)
    return lie.make_pose(R, t)


def _quat_to_rot(q):
    """Unit quaternion (..., 4) [w,x,y,z] -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def _rot_to_quat(R):
    """Rotation (..., 3, 3) -> unit quaternion [w,x,y,z] (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    traces = torch.stack(
        [1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
         1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1,
    )
    best = torch.argmax(traces, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.take_along_dim(cands, idx, dim=-2)[..., 0, :]
    return _normalize(q)


def solve_rigid_quat(p, q, w=None, R0=None, iters=24):
    """Weighted rigid alignment q ~= T p via Horn's quaternion method.

    p, q: (..., N, 3) (broadcast against w's leading dims); w: (..., N)."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    ww = w[..., None]
    wsum = torch.clamp(torch.sum(ww, dim=-2), min=1e-9)
    mu_p = torch.sum(p * ww, dim=-2) / wsum
    mu_q = torch.sum(q * ww, dim=-2) / wsum
    pc = p - mu_p[..., None, :]
    qc = q - mu_q[..., None, :]

    S = lie.einsum("...ni,...nj->...ij", pc * ww, qc)
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    row0 = torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1)
    row1 = torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1)
    row2 = torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1)
    row3 = torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1)
    N = torch.stack([row0, row1, row2, row3], dim=-2)

    shift = torch.amax(torch.sum(torch.abs(N), dim=-1), dim=-1)[..., None, None]
    Ns = N + shift * torch.eye(4, dtype=p.dtype, device=p.device)

    if R0 is not None:
        v = _rot_to_quat(R0)
    else:
        v = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=p.dtype, device=p.device).expand(
            N.shape[:-1]
        )
    for _ in range(iters):
        v = lie.einsum("...ij,...j->...i", Ns, v)
        v = _normalize(v)
    R = _quat_to_rot(v)
    t = mu_q - lie.rotate_points(R, mu_p)
    return lie.make_pose(R, t)
