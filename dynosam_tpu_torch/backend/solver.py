"""Shared backend helpers and the accept/reject LM loop
(port of the parts of dynosam_tpu/backend/solver.py the hybrid backend uses).

Tangent layout of the reduced system (D = 6F + 6JF):
  pose f      -> dx[6f : 6f+6]
  motion j,f  -> dx[6F + 6(jF + f) : +6]
"""

from __future__ import annotations

import dataclasses

import torch

from dynosam_tpu.config import BackendParams
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.utils import lie

_EPS_REG = 1e-5  # Tikhonov floor so padded/unconstrained variables stay SPD


def _huber_rho(e, k):
    return torch.where(e <= k, 0.5 * e * e, k * (e - 0.5 * k))


def _irls_w(e, k, use_robust):
    if not use_robust:
        return torch.ones_like(e)
    safe = torch.clamp(e, min=1e-12)
    return torch.where(e <= k, torch.ones_like(safe), k / safe)


def _sigmas(cfg: BackendParams, dtype, device):
    """Noise sigmas as device tensors, built by fills: a tensor made from
    host data would be a blocking host-to-device copy on every call."""
    n = cfg.noise

    def t(rot, trans=None):
        if trans is None:
            return torch.full((), rot, dtype=dtype, device=device)
        return torch.cat([torch.full((3,), rot, dtype=dtype, device=device),
                          torch.full((3,), trans, dtype=dtype, device=device)])

    return dict(
        static_pt=t(n.static_point_noise_sigma),
        dyn_pt=t(n.dynamic_point_noise_sigma),
        ternary=t(n.motion_ternary_factor_noise_sigma),
        odom=t(n.odometry_rotation_sigma, n.odometry_translation_sigma),
        smooth=t(
            n.constant_object_motion_rotation_sigma,
            n.constant_object_motion_translation_sigma,
        ),
        prior0=t(n.initial_pose_prior_sigma),
    )


def _object_onehot(state: GraphState, dtype):
    """(Ld, J) float one-hot of each tracklet's object slot (0 rows if none)."""
    J = state.J
    slots = torch.arange(J, device=state.d_obj.device)
    oh = (state.d_obj[:, None] == slots[None, :]) & (state.d_obj >= 0)[:, None]
    return oh.to(dtype)


def _static_residuals(state: GraphState):
    Xinv = lie.inverse(state.X)
    y = lie.transform_points(Xinv[:, None], state.ms[None, :, :])
    return y - state.s_z, y  # (F, Ls, 3)


def _static_gate(state: GraphState, cfg: BackendParams):
    return torch.sum(state.s_valid, dim=0) >= cfg.min_static_observations


def _odom_mask(state: GraphState):
    f = torch.arange(state.F, device=state.X.device)
    return state.odom_valid & (f > 0) & (f < state.num_frames)


def _prior_dx(state: GraphState):
    dX = lie.local_coordinates(state.prior_lin_X, state.X).reshape(-1)
    dH = lie.local_coordinates(state.prior_lin_H, state.H).reshape(-1)
    return torch.cat([dX, dH])


def _eye_k(n, k, dtype, device):
    """jnp.eye(n, k=k): ones where column = row + k."""
    i = torch.arange(n, device=device)
    return (i[:, None] + k == i[None, :]).to(dtype)


def _block_diag_embed(blocks):
    """(..., F, 6, 6) -> (..., 6F, 6F) block-diagonal."""
    F = blocks.shape[-3]
    eyeF = torch.eye(F, dtype=blocks.dtype, device=blocks.device)
    out = lie.einsum("...fab,fg->...fagb", blocks, eyeF)
    return out.reshape(out.shape[:-4] + (6 * F, 6 * F))


def _chain_se3_blocks(r, J_A, J_B, w):
    """Dense block matrix + gradient for a chain of binary SE(3) factors:
    factor f sits between slots f-1 and f (entry 0 must have w = 0).
    r (..., F, 6), J_A/J_B (..., F, 6, 6), w (..., F, 6) ->
    (block (..., F, 6, F, 6), g (..., F, 6))."""
    JAw = J_A.transpose(-1, -2) * w[..., None, :]
    JBw = J_B.transpose(-1, -2) * w[..., None, :]
    Haa = lie.mm(JAw, J_A)      # at (f-1, f-1)
    Hbb = lie.mm(JBw, J_B)      # at (f, f)
    Hab = lie.mm(JAw, J_B)      # at (f-1, f)
    ga = lie.einsum("...fab,...fb->...fa", JAw, r)   # at f-1
    gb = lie.einsum("...fab,...fb->...fa", JBw, r)   # at f

    F = r.shape[-2]
    eyeF = _eye_k(F, 0, r.dtype, r.device)
    E_prev = _eye_k(F, 1, r.dtype, r.device)         # E[g, f] = 1 iff g = f-1

    diag = lie.einsum("...fab,fg->...fagb", Hbb, eyeF)
    diag_prev = lie.einsum("...fab,gf,gh->...gahb", Haa, E_prev, eyeF)
    off = lie.einsum("...fab,gf,fh->...gahb", Hab, E_prev, eyeF)
    offT = off.transpose(-4, -2).transpose(-3, -1)
    block = diag + diag_prev + off + offT
    g = gb + lie.einsum("...fa,gf->...ga", ga, E_prev)
    return block, g


def gate_dx_by_type(dx, F, op):
    """Per-variable-type sub-threshold delta skip: a camera or object tangent
    block whose rotation and translation sub-norms both fall under the
    type's thresholds is zeroed. A type gates only when both its thresholds
    are > 0."""
    x_on = op.x_update_threshold_rot > 0 and op.x_update_threshold_trans > 0
    h_on = op.h_update_threshold_rot > 0 and op.h_update_threshold_trans > 0
    if not (x_on or h_on):
        return dx
    n = 6 * F

    def gate(blocks, thr_rot, thr_trans):
        rn = torch.linalg.norm(blocks[:, :3], dim=-1)
        tn = torch.linalg.norm(blocks[:, 3:], dim=-1)
        small = (rn < thr_rot) & (tn < thr_trans)
        return torch.where(small[:, None], torch.zeros_like(blocks), blocks)

    dX = dx[:n].reshape(-1, 6)
    dH = dx[n:].reshape(-1, 6)
    if x_on:
        dX = gate(dX, op.x_update_threshold_rot, op.x_update_threshold_trans)
    if h_on:
        dH = gate(dH, op.h_update_threshold_rot, op.h_update_threshold_trans)
    return torch.cat([dX.reshape(-1), dH.reshape(-1)])


def damping_update(ok, lam, op, lam0):
    """Failed-solve recovery: a non-finite step escalates damping, a good one
    decays it back toward the floor."""
    return torch.where(
        ok,
        torch.clamp(lam / op.lm_lambda_factor, min=lam0),
        torch.clamp(lam * op.lm_lambda_factor, max=op.lm_max_lambda),
    )


def _select(accept, cand: GraphState, st: GraphState) -> GraphState:
    """Field-wise torch.where(accept, cand, st); fields the update did not
    replace are shared and kept as they are."""
    out = {}
    for fld in dataclasses.fields(st):
        a, b = getattr(cand, fld.name), getattr(st, fld.name)
        out[fld.name] = a if a is b or not torch.is_tensor(a) else torch.where(accept, a, b)
    return dataclasses.replace(st, **out)


def lm_accept_reject(
    state, cfg, linearize_fn, apply_fn, solve_fn, error_fn, iterations=None
):
    """Fixed-length accept/reject LM with GTSAM-style convergence: once the
    error decrease falls below absolute_error_tol or relative_error_tol * err,
    the remaining iterations are masked no-ops. `accept`, `done` and the
    damping stay tensors, so the loop never waits on the device."""
    op = cfg.optimizer
    err = error_fn(state, cfg)
    lam = torch.full((), op.lm_initial_lambda, dtype=state.X.dtype, device=state.X.device)
    done = torch.zeros((), dtype=torch.bool, device=state.X.device)
    for _ in range(op.max_iterations if iterations is None else iterations):
        lin = linearize_fn(state, cfg, lam)
        cand = apply_fn(state, lin, solve_fn(lin))
        new_err = error_fn(cand, cfg)
        accept = (new_err < err) & torch.isfinite(new_err) & ~done
        state = _select(accept, cand, state)
        decrease = err - new_err
        done = done | (
            accept
            & ((decrease < op.absolute_error_tol) | (decrease < op.relative_error_tol * err))
        )
        err = torch.where(accept, new_err, err)
        lam = torch.where(
            accept,
            torch.clamp(lam / op.lm_lambda_factor, min=op.lm_min_lambda),
            torch.clamp(lam * op.lm_lambda_factor, max=op.lm_max_lambda),
        )
    return state
