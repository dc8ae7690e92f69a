"""Fixed-iteration Gauss-Newton / IRLS pose refinement
(port of dynosam_tpu/ops/gauss_newton.py), batched over leading dims.

The Jacobian with respect to the right-retraction tangent at xi = 0 is
taken in forward mode, as the reference's `jax.jacfwd` does. Since
d(T exp(xi))/dxi_i at 0 is T G_i for the se(3) generators G_i, it is the
forward derivative of the residual along the pose tangents T G_i.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jvp, vmap

from portbench.frozen.utils import lie


def huber_weights(residual_norms, k):
    safe = torch.clamp(residual_norms, min=1e-12)
    return torch.where(residual_norms <= k, torch.ones_like(safe), k / safe)


_GENERATORS = {}


def _generators(dtype, device):
    """(6, 4, 4) se(3) generators in [omega, v] order, built once per dtype
    and device: writing their unit entries copies host scalars to the
    device, a host sync per refinement iteration otherwise."""
    key = (dtype, torch.device(device))
    if key not in _GENERATORS:
        G = torch.zeros((6, 4, 4), dtype=dtype, device=device)
        G[:3, :3, :3] = lie.hat(torch.eye(3, dtype=dtype, device=device))
        G[3:, :3, 3] = torch.eye(3, dtype=dtype, device=device)
        _GENERATORS[key] = G
    return _GENERATORS[key]


def residual_and_jacobian(fn: Callable, T: torch.Tensor):
    """fn: pose (*B, 4, 4) -> r (*B, ...). Returns (r, J (*B, ..., 6)) with
    J[..., i] = d fn(T exp(eps e_i)) / d eps at 0."""
    G = _generators(T.dtype, T.device).reshape((6,) + (1,) * (T.ndim - 2) + (4, 4))
    tangents = lie.mm(T.unsqueeze(0), G)                        # (6, *B, 4, 4)
    r = fn(T)
    cols = vmap(lambda dT: jvp(fn, (T,), (dT,))[1])(tangents)   # (6, *B, ...)
    return r, torch.movedim(cols, 0, -1)


def solve6(H, g):
    """x = H^{-1} g for (..., 6, 6) systems; like jnp.linalg.solve, a singular
    system yields non-finite values instead of raising."""
    x, _ = torch.linalg.solve_ex(H, g[..., None])
    return x[..., 0]


def refine_pose(
    residual_fn: Callable,   # (T (*B, 4, 4)) -> (*B, N, D)
    T0: torch.Tensor,
    weights: torch.Tensor,   # (*B, N)
    *,
    iterations: int = 8,
    k_huber: float | None = None,
    damping: float = 1e-6,
):
    """Minimise sum_i w_i rho(||r_i(T)||) over T in SE(3).

    Returns (T_refined, final_weights)."""
    T = T0
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    for _ in range(iterations):
        r, J = residual_and_jacobian(residual_fn, T)
        w = weights
        if k_huber is not None:
            w = w * huber_weights(torch.linalg.norm(r, dim=-1), k_huber)
        Jw = J * w[..., None, None]
        H = lie.einsum("...ndi,...ndj->...ij", Jw, J) + damping * eye6
        g = lie.einsum("...ndi,...nd->...i", Jw, r)
        T = lie.retract(T, -solve6(H, g))
    if k_huber is not None:
        norms = torch.linalg.norm(residual_fn(T), dim=-1)
        final_w = weights * huber_weights(norms, k_huber)
    else:
        final_w = weights
    return T, final_w
