"""Batched block-tridiagonal (3x3 blocks) solver: the chain elimination of
the WCME and WCPE backends (port of dynosam_tpu/ops/block_tridiag.py).

Dynamic-landmark chains have block-tridiagonal Hessians (point-to-point
diagonal blocks, motion-ternary off-diagonals). A block Thomas recursion
needs 2F batched steps of closed-form 3x3 inverses and small matmuls; the
recursion runs as Python loops over F, as the reference writes it.

Shapes: diag (..., F, 3, 3), upper (..., F, 3, 3) where upper[f] is the
(f, f+1) block (entry F-1 ignored), rhs (..., F, 3, R).
"""

from __future__ import annotations

import torch

from portbench.frozen.utils import lie


def inv3(A, eps: float = 1e-12):
    """Batched 3x3 inverse via the adjugate. (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    safe_det = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    inv = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return inv / safe_det[..., None, None]


def factorize(diag, upper):
    """Block-LDL' forward factorisation -> (Dp_inv (..., F, 3, 3),
    W (..., F, 3, 3)) with Dp_f = D_f - W_f U_{f-1},
    W_f = U_{f-1}^T Dp_{f-1}^{-1} (W_0 = 0)."""
    F = diag.shape[-3]
    Dp_prev_inv = inv3(diag[..., 0, :, :])
    Dp_inv = [Dp_prev_inv]
    Ws = [torch.zeros_like(Dp_prev_inv)]
    for f in range(1, F):
        U_prev = upper[..., f - 1, :, :]
        W = lie.mm(U_prev.transpose(-1, -2), Dp_prev_inv)
        Dp_prev_inv = inv3(diag[..., f, :, :] - lie.mm(W, U_prev))
        Dp_inv.append(Dp_prev_inv)
        Ws.append(W)
    return torch.stack(Dp_inv, dim=-3), torch.stack(Ws, dim=-3)


def solve_factored(Dp_inv, W, upper, rhs):
    """Solve P x = rhs given factorize()'s output. rhs (..., F, 3, R)."""
    F = rhs.shape[-3]
    # forward: y_f = b_f - W_f y_{f-1}
    ys = [rhs[..., 0, :, :]]
    for f in range(1, F):
        ys.append(rhs[..., f, :, :] - lie.mm(W[..., f, :, :], ys[-1]))
    # backward: x_{F-1} = Dp_inv y; x_f = Dp_inv (y_f - U_f x_{f+1})
    xs = [None] * F
    xs[F - 1] = lie.mm(Dp_inv[..., F - 1, :, :], ys[F - 1])
    for f in range(F - 2, -1, -1):
        xs[f] = lie.mm(Dp_inv[..., f, :, :], ys[f] - lie.mm(upper[..., f, :, :], xs[f + 1]))
    return torch.stack(xs, dim=-3)


def solve(diag, upper, rhs):
    Dp_inv, W = factorize(diag, upper)
    return solve_factored(Dp_inv, W, upper, rhs)


def full_inverse(diag, upper):
    """Dense inverse as blocks: (..., F, 3, F, 3)."""
    F = diag.shape[-3]
    batch = diag.shape[:-3]
    eye = torch.eye(3 * F, dtype=diag.dtype, device=diag.device).reshape(F, 3, 3 * F)
    X = solve(diag, upper, eye.expand(batch + (F, 3, 3 * F)))     # (..., F, 3, 3F)
    return X.reshape(batch + (F, 3, F, 3))
