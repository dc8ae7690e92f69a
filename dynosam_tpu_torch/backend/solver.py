"""World-centric motion (WCME) Levenberg-Marquardt with Schur-complement
landmark elimination, and the helpers and accept/reject LM loop every
formulation shares (port of dynosam_tpu/backend/solver.py).

Each iteration linearises every factor in closed form, eliminates the
static landmarks (per-landmark 3x3 blocks) and the dynamic landmark chains
m_{i,0..F-1} (block-tridiagonal Hessians, eliminated with the block-Thomas
recursion of ops/block_tridiag.py), solves the reduced (pose + object
motion) system by Cholesky and back-substitutes the landmark updates. Huber
IRLS weights; accept/reject LM on the true robust cost, or plain damped GN.

Tangent layout of the reduced system (D = 6F + 6JF):
  pose f      -> dx[6f : 6f+6]
  motion j,f  -> dx[6F + 6(jF + f) : +6]

Every function here also takes a GraphState with a leading batch axis of
sequences (the batched step): the reduced systems are then (B, D, D), and
the damping, the errors, the accept/reject and the GN scan's finiteness
decisions are per sequence, as under the reference's vmap.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from dynosam_tpu_torch.config import BackendParams
from dynosam_tpu_torch.backend import factors
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.ops import block_tridiag as bt
from dynosam_tpu_torch.utils import lie
from dynosam_tpu_torch.utils.stats import count, count_tensor, span

_EPS_REG = 1e-5  # Tikhonov floor so padded/unconstrained variables stay SPD


def _huber_rho(e, k):
    return torch.where(e <= k, 0.5 * e * e, k * (e - 0.5 * k))


def _irls_w(e, k, use_robust):
    if not use_robust:
        return torch.ones_like(e)
    safe = torch.clamp(e, min=1e-12)
    return torch.where(e <= k, torch.ones_like(safe), k / safe)


def _per_seq(x, k):
    """A per-sequence scalar (a Python float, a 0-dim or a (B,) tensor) with
    k unit axes appended, to broadcast against (B, ...) terms; a view."""
    return x.reshape(x.shape + (1,) * k) if torch.is_tensor(x) else x


def _sum_per_seq(x, nb):
    """Sum over everything but the `nb` leading batch axes."""
    return torch.sum(x) if nb == 0 else x.flatten(nb).sum(-1)


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
    oh = (state.d_obj[..., :, None] == slots) & (state.d_obj >= 0)[..., :, None]
    return oh.to(dtype)


def _static_residuals(state: GraphState):
    Xinv = lie.inverse(state.X)
    y = lie.transform_points(Xinv[..., :, None, :, :], state.ms[..., None, :, :])
    return y - state.s_z, y  # (F, Ls, 3)


def _static_gate(state: GraphState, cfg: BackendParams):
    return torch.sum(state.s_valid, dim=-2) >= cfg.min_static_observations


def _odom_mask(state: GraphState):
    f = torch.arange(state.F, device=state.X.device)
    return state.odom_valid & (f > 0) & (f < state.num_frames)


def _prior_dx(state: GraphState):
    lead = state.batch_shape
    dX = lie.local_coordinates(state.prior_lin_X, state.X).reshape(lead + (-1,))
    dH = lie.local_coordinates(state.prior_lin_H, state.H).reshape(lead + (-1,))
    return torch.cat([dX, dH], dim=-1)


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
    lead = dx.shape[:-1]

    def gate(blocks, thr_rot, thr_trans):
        rn = torch.linalg.norm(blocks[..., :3], dim=-1)
        tn = torch.linalg.norm(blocks[..., 3:], dim=-1)
        small = (rn < thr_rot) & (tn < thr_trans)
        return torch.where(small[..., None], torch.zeros_like(blocks), blocks)

    dX = dx[..., :n].reshape(lead + (-1, 6))
    dH = dx[..., n:].reshape(lead + (-1, 6))
    if x_on:
        dX = gate(dX, op.x_update_threshold_rot, op.x_update_threshold_trans)
    if h_on:
        dH = gate(dH, op.h_update_threshold_rot, op.h_update_threshold_trans)
    return torch.cat([dX.reshape(lead + (-1,)), dH.reshape(lead + (-1,))], dim=-1)


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
    replace are shared and kept as they are. A (B,) `accept` selects per
    sequence."""
    out = {}
    for fld in dataclasses.fields(st):
        a, b = getattr(cand, fld.name), getattr(st, fld.name)
        out[fld.name] = (a if a is b or not torch.is_tensor(a)
                         else torch.where(_per_seq(accept, a.ndim - accept.ndim), a, b))
    return dataclasses.replace(st, **out)


def lm_accept_reject(
    state, cfg, linearize_fn, apply_fn, solve_fn, error_fn, iterations=None
):
    """Fixed-length accept/reject LM with GTSAM-style convergence: once the
    error decrease falls below absolute_error_tol or relative_error_tol * err,
    the remaining iterations are masked no-ops. `accept`, `done` and the
    damping stay tensors, so the loop never waits on the device; over a
    batch of sequences each is per sequence. While tracing, the lanes run
    per iteration and the lanes already done at its start are counted."""
    op = cfg.optimizer
    with span("lm.error"):
        err = error_fn(state, cfg)
    lead = state.batch_shape
    lanes = math.prod(lead)
    lam = torch.full(lead, op.lm_initial_lambda, dtype=state.X.dtype, device=state.X.device)
    done = torch.zeros(lead, dtype=torch.bool, device=state.X.device)
    for _ in range(op.max_iterations if iterations is None else iterations):
        count("lm.lane_iterations", lanes)
        count_tensor("lm.idle_lane_iterations", done)
        with span("lm.linearize"):
            lin = linearize_fn(state, cfg, lam)
        with span("lm.solve"):
            cand = apply_fn(state, lin, solve_fn(lin))
        with span("lm.error"):
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


# ---------------------------------------------------------------------------
# WCME terms
# ---------------------------------------------------------------------------

def _dyn_ptp_residuals(state: GraphState):
    Xinv = lie.inverse(state.X)
    y = lie.transform_points(Xinv[..., None, :, :, :], state.md)
    return y - state.d_z, y  # (Ld, F, 3)


def _shift_prev(x, axis):
    """out[..., f, ...] = x[..., f-1, ...] along `axis`, with f = 0 keeping
    x[..., 0, ...] (the odometry / ternary / smoothing chains' previous
    slot)."""
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)


def _ternary_terms(state: GraphState, onehot):
    Hj = lie.einsum("...lj,...jfab->...lfab", onehot, state.H)   # (Ld, F, 4, 4)
    m_prev = _shift_prev(state.md, -2)
    r = state.md - lie.transform_points(Hj, m_prev)
    return r, m_prev, Hj


def _ternary_mask(state: GraphState, onehot):
    v = state.d_valid
    Hv = lie.einsum("...lj,...jf->...lf", onehot, state.H_valid.to(onehot.dtype)) > 0.5
    in_window = torch.arange(state.F, device=v.device) < state.num_frames
    return v & _shift_frame_down(v, -1) & Hv & in_window


def _smooth_mask(state: GraphState, cfg: BackendParams):
    if not cfg.use_smoothing_factor:
        return torch.zeros_like(state.H_valid)
    return state.H_valid & _shift_frame_down(state.H_valid, -1)


def _smooth_terms(state: GraphState):
    """Residuals of the WCME smoothing chain between H_{j,f-1} and H_{j,f}
    and the pair (H_prev, identity) they were taken at."""
    H_prev = _shift_prev(state.H, -3)
    eye4 = torch.eye(4, dtype=state.X.dtype, device=state.X.device).expand(state.H.shape)
    return factors.between_residual(H_prev, state.H, eye4), H_prev, eye4


def total_error(state: GraphState, cfg: BackendParams):
    """True robust cost over all factors (the LM accept/reject metric); per
    sequence over a batch."""
    dtype, dev = state.X.dtype, state.X.device
    nb = len(state.batch_shape)
    sig = _sigmas(cfg, dtype, dev)
    k = cfg.noise.robust_k_huber
    use_rob = cfg.noise.use_robust_kernel
    onehot = _object_onehot(state, dtype)

    def rho(e):
        return _huber_rho(e, k) if use_rob else 0.5 * e * e

    r_s, _ = _static_residuals(state)
    gate = _static_gate(state, cfg)
    e = torch.linalg.norm(r_s / state.s_sig, dim=-1)
    err = _sum_per_seq(torch.where(state.s_valid & gate[..., None, :], rho(e), 0.0), nb)

    r_d, _ = _dyn_ptp_residuals(state)
    e = torch.linalg.norm(r_d / state.d_sig, dim=-1)
    err = err + _sum_per_seq(torch.where(state.d_valid & (state.d_obj >= 0)[..., None], rho(e), 0.0), nb)

    r_t, _, _ = _ternary_terms(state, onehot)
    e = torch.linalg.norm(r_t, dim=-1) / sig["ternary"]
    err = err + _sum_per_seq(torch.where(_ternary_mask(state, onehot), rho(e), 0.0), nb)

    if cfg.use_vo_factor:
        X_prev = _shift_prev(state.X, -3)
        r_o = factors.between_residual(X_prev, state.X, state.odom) / sig["odom"]
        err = err + _sum_per_seq(torch.where(_odom_mask(state)[..., None], 0.5 * r_o * r_o, 0.0), nb)

    r_sm = _smooth_terms(state)[0] / sig["smooth"]
    err = err + _sum_per_seq(torch.where(_smooth_mask(state, cfg)[..., None], 0.5 * r_sm * r_sm, 0.0), nb)

    gauge_on = (~state.prior_valid).to(dtype)
    r_p = factors.prior_residual(state.X[..., 0, :, :], state.X0_prior) / sig["prior0"]
    err = err + gauge_on * _sum_per_seq(0.5 * r_p * r_p, nb)

    r_mp = state.prior_b + lie.mv(state.prior_L, _prior_dx(state))
    return err + torch.where(state.prior_valid, _sum_per_seq(0.5 * r_mp * r_mp, nb), 0.0)


# ---------------------------------------------------------------------------
# Frame embeddings and shifts
# ---------------------------------------------------------------------------

def _embed_same_frame(blk, F):
    """blk (Ld, F, A, B) -> (Ld, F, A, F, B) nonzero at [f, :, f, :]."""
    return lie.einsum("...lfab,fg->...lfagb", blk, _eye_k(F, 0, blk.dtype, blk.device))


def _embed_prev_frame(blk, F):
    """blk (Ld, F, A, B) placed at [f, :, f-1, :]."""
    return lie.einsum("...lfab,gf->...lfagb", blk, _eye_k(F, 1, blk.dtype, blk.device))


def _shift_frame_down(x, axis):
    """out[..., f, ...] = x[..., f-1, ...] along `axis` (zero at f=0)."""
    n = x.shape[axis]
    return torch.cat([torch.zeros_like(x.narrow(axis, 0, 1)), x.narrow(axis, 0, n - 1)], dim=axis)


def _shift_frame_up(x, axis):
    """out[..., f, ...] = x[..., f+1, ...] (zero at f=F-1)."""
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 1, n - 1), torch.zeros_like(x.narrow(axis, 0, 1))], dim=axis)


# ---------------------------------------------------------------------------
# Linearisation
# ---------------------------------------------------------------------------

class _Linearization(NamedTuple):
    S: torch.Tensor         # (D, D) reduced Hessian (damped)
    rhs: torch.Tensor       # (D,)
    Hpp_inv_s: torch.Tensor # (Ls, 3, 3) static landmark backsub
    g_s: torch.Tensor       # (Ls, 3)
    A_s: torch.Tensor       # (F, Ls, 6, 3)
    Pd: torch.Tensor        # (Ld, F, 3, 3) chain diagonal blocks
    Pu: torch.Tensor        # (Ld, F, 3, 3) chain upper blocks (f, f+1)
    Dp_inv: torch.Tensor    # (Ld, F, 3, 3) Thomas factor
    Wm: torch.Tensor        # (Ld, F, 3, 3) Thomas factor
    g_d: torch.Tensor       # (Ld, F, 3)
    Bx_blk: torch.Tensor    # (Ld, F, 6, 3) pose-f x point-f
    Bh_curr: torch.Tensor   # (Ld, F, 6, 3) motion-f x point-f
    Bh_prev: torch.Tensor   # (Ld, F, 6, 3) motion-f x point-(f-1)
    onehot: torch.Tensor    # (Ld, J)


def _static_terms(state: GraphState, cfg: BackendParams, lam, S, rhs):
    """Static landmarks eliminated by per-landmark 3x3 Schur complements
    (anisotropic camera-frame weights); adds into S and rhs in place ->
    (Hpp_inv_s, g_s, A_s) for the back-substitution."""
    n = 6 * state.F
    lead = state.batch_shape
    dtype, dev = state.X.dtype, state.X.device
    R = lie.rotation(state.X)
    Rt = R.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    r_s, y_s = _static_residuals(state)
    gate = _static_gate(state, cfg)
    e_s = torch.linalg.norm(r_s / state.s_sig, dim=-1)
    iw_s = (state.s_valid & gate[..., None, :]).to(dtype)[..., None] * _irls_w(
        e_s, cfg.noise.robust_k_huber, cfg.noise.use_robust_kernel
    )[..., None] / (state.s_sig ** 2)                          # (F, Ls, 3)
    hat_y = lie.hat(y_s)
    Jx_s = torch.cat([hat_y, -eye3.expand(hat_y.shape)], dim=-1)   # (F, Ls, 3, 6)
    # Hpp = sum_f R diag(iw) R^T (Jp = R^T, W diagonal in the camera frame)
    Hpp_s = lie.einsum("...fab,...flb,...fcb->...lac", R, iw_s, R) + _per_seq(_EPS_REG + lam, 3) * eye3
    Hpp_inv_s = bt.inv3(Hpp_s)
    g_s = lie.einsum("...fab,...flb->...la", R, iw_s * r_s)
    A_s = lie.einsum("...flba,...flb,...fbc->...flac", Jx_s, iw_s, Rt)
    Hxx_s = lie.einsum("...flab,...fla,...flac->...fbc", Jx_s, iw_s, Jx_s)
    gx_s = lie.einsum("...flab,...fla->...fb", Jx_s, iw_s * r_s)
    S_pp = lie.einsum("...flab,...lbc,...gldc->...fagd", A_s, Hpp_inv_s, A_s)
    S[..., :n, :n] += _block_diag_embed(Hxx_s) - S_pp.reshape(lead + (n, n))
    rhs[..., :n] += (-gx_s + lie.einsum("...flab,...lbc,...lc->...fa", A_s, Hpp_inv_s, g_s)).reshape(lead + (-1,))
    return Hpp_inv_s, g_s, A_s


def _fixed_terms(state: GraphState, cfg: BackendParams, S, rhs, sig, fixed_scale: float = 1.0):
    """Odometry chain, gauge prior and linear marginal prior; adds into S
    and rhs in place. `fixed_scale` scales all three (the landmark-chunked
    assembly of parallel/sharded.py adds 1/P of them per chunk)."""
    n = 6 * state.F
    lead = state.batch_shape
    dtype = S.dtype

    def scaled(w):
        return w if fixed_scale == 1.0 else fixed_scale * w

    if cfg.use_vo_factor:
        X_prev = torch.cat([state.X[..., :1, :, :], state.X[..., :-1, :, :]], dim=-3)
        r_o = factors.between_residual(X_prev, state.X, state.odom)
        J_A, J_B = factors.between_jacobians(X_prev, state.X, state.odom, r=r_o)
        w_o = scaled(_odom_mask(state).to(dtype)[..., None] / sig["odom"] ** 2)
        od_block, od_g = _chain_se3_blocks(r_o, J_A, J_B, w_o)
        S[..., :n, :n] += od_block.reshape(lead + (n, n))
        rhs[..., :n] -= od_g.reshape(lead + (-1,))

    X0 = state.X[..., 0, :, :]
    r_p = factors.prior_residual(X0, state.X0_prior)
    J_p = factors.prior_jacobian(X0, state.X0_prior, r=r_p)
    w_p = scaled((~state.prior_valid).to(dtype) / sig["prior0"] ** 2)
    S[..., :6, :6] += _per_seq(w_p, 2) * lie.mm(J_p.mT, J_p)
    rhs[..., :6] -= _per_seq(w_p, 1) * lie.mv(J_p.mT, r_p)

    r_mp = state.prior_b + lie.mv(state.prior_L, _prior_dx(state))
    pv = scaled(state.prior_valid.to(dtype))
    S += _per_seq(pv, 2) * lie.mm(state.prior_L.mT, state.prior_L)
    rhs -= _per_seq(pv, 1) * lie.mv(state.prior_L.mT, r_mp)


def _final_reg(S, lam):
    """Padded-variable floor + Marquardt damping relative to the diagonal.
    Information weights reach 1/sigma^2 ~ 1e6, so f32 cancellation in the
    Schur subtractions perturbs eigenvalues by ~|S| * 1e-7; the relative
    term keeps S positive definite."""
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    lam = _per_seq(lam, 1)
    return S + torch.diag_embed((_EPS_REG + lam) + (1e-5 + lam) * torch.abs(diag))


def linearize(state: GraphState, cfg: BackendParams, lam) -> _Linearization:
    F, J, Ld = state.F, state.J, state.Ld
    D = state.D
    n = 6 * F
    lead = state.batch_shape
    dtype, dev = state.X.dtype, state.X.device
    sig = _sigmas(cfg, dtype, dev)
    k_rob = cfg.noise.robust_k_huber
    use_rob = cfg.noise.use_robust_kernel
    onehot = _object_onehot(state, dtype)

    S = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    rhs = torch.zeros(lead + (D,), dtype=dtype, device=dev)
    R = lie.rotation(state.X)
    Rt = R.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    # ================= static landmarks ==================================
    Hpp_inv_s, g_s, A_s = _static_terms(state, cfg, lam, S, rhs)

    # ================= dynamic landmark chains ===========================
    r_d, y_d = _dyn_ptp_residuals(state)
    has_obj_f = torch.sum(onehot, dim=-1)                      # (Ld,) 1.0 if assigned
    e_d = torch.linalg.norm(r_d / state.d_sig, dim=-1)
    iw_d = (state.d_valid.to(dtype) * has_obj_f[..., None])[..., None] * _irls_w(
        e_d, k_rob, use_rob
    )[..., None] / (state.d_sig ** 2)                          # (Ld, F, 3)

    r_t, m_prev, Hj = _ternary_terms(state, onehot)
    mask_t = _ternary_mask(state, onehot)
    e_t = torch.linalg.norm(r_t, dim=-1) / sig["ternary"]
    w_t = mask_t.to(dtype) * _irls_w(e_t, k_rob, use_rob) / (sig["ternary"] ** 2)   # (Ld, F)

    RH = lie.rotation(Hj)
    J_H = torch.cat([lie.mm(RH, lie.hat(m_prev)), -RH], dim=-1)
    hat_yd = lie.hat(y_d)
    Jx_d = torch.cat([hat_yd, -eye3.expand(hat_yd.shape)], dim=-1)   # (Ld, F, 3, 6)

    # ---- chain blocks (block-tridiagonal, never materialised densely) ----
    Pd_ptp = lie.einsum("...fab,...lfb,...fcb->...lfac", R, iw_d, R)
    diag_scalar = w_t + _shift_frame_up(w_t, -1) + _EPS_REG + _per_seq(lam, 2)
    Pd = Pd_ptp + diag_scalar[..., None, None] * eye3            # (Ld, F, 3, 3)
    # block (f-1, f) = -w_t[f] RH[f]^T  =>  upper[f'] = block (f', f'+1)
    Pu = _shift_frame_up(-RH.transpose(-1, -2) * w_t[..., None, None], -3)

    g_d = lie.einsum("...fab,...lfb->...lfa", R, iw_d * r_d)
    g_ter_curr = r_t * w_t[..., None]
    g_ter_prev = -lie.einsum("...lfba,...lfb->...lfa", RH, r_t * w_t[..., None])
    g_d = g_d + g_ter_curr + _shift_frame_up(g_ter_prev, -2)

    Bx_blk = lie.einsum("...lfba,...lfb,...fbc->...lfac", Jx_d, iw_d, Rt)    # (Ld, F, 6, 3)
    JHT = J_H.transpose(-1, -2)
    Bh_curr = JHT * w_t[..., None, None]
    Bh_prev = -lie.einsum("...lfab,...lfbc->...lfac", JHT * w_t[..., None, None], RH)

    # ---- direct reduced-system contributions ----------------------------
    Hxx_d = lie.einsum("...lfab,...lfa,...lfac->...fbc", Jx_d, iw_d, Jx_d)
    gx_d = lie.einsum("...lfab,...lfa->...fb", Jx_d, iw_d * r_d)
    S[..., :n, :n] += _block_diag_embed(Hxx_d)
    rhs[..., :n] -= gx_d.reshape(lead + (-1,))

    Hhh_blk = lie.einsum("...lfab,...lf,...lfac->...lfbc", J_H, w_t, J_H)    # (Ld, F, 6, 6)
    gh_blk = lie.einsum("...lfab,...lf,...lfa->...lfb", J_H, w_t, r_t)
    Hhh = lie.einsum("...lfbc,...lj->...jfbc", Hhh_blk, onehot)            # (J, F, 6, 6)
    gh = lie.einsum("...lfb,...lj->...jfb", gh_blk, onehot)

    # ---- chain Schur via the block-Thomas inverse -------------------------
    Dp_inv, Wm = bt.factorize(Pd, Pu)
    Pinv = bt.full_inverse(Pd, Pu)                                # (Ld, F, 3, F, 3)

    # pose-pose correction
    T = lie.einsum("...lfai,...lfigj->...lfagj", Bx_blk, Pinv)             # (Ld, F, 6, F, 3)
    S_xx_corr = lie.einsum("...lfagj,...lgcj->...fagc", T, Bx_blk)
    # pose-motion correction (motion column g couples points g and g-1)
    T_colprev = _shift_frame_down(T, -2)
    Sxh = lie.einsum("...lfagj,...lgcj->...lfagc", T, Bh_curr) + lie.einsum(
        "...lfagj,...lgcj->...lfagc", T_colprev, Bh_prev
    )
    S_xh_obj = lie.einsum("...lfagc,...lj->...jfagc", Sxh, onehot)         # (J, F, 6, F, 6)
    # motion-motion correction
    Vc = lie.einsum("...lfci,...lfigj->...lfcgj", Bh_curr, Pinv)
    Vp = lie.einsum("...lfci,...lfigj->...lfcgj", Bh_prev, _shift_frame_down(Pinv, -4))
    V = Vc + Vp
    V_colprev = _shift_frame_down(V, -2)
    Shh = lie.einsum("...lfcgj,...lgdj->...lfcgd", V, Bh_curr) + lie.einsum(
        "...lfcgj,...lgdj->...lfcgd", V_colprev, Bh_prev
    )
    S_hh_obj = lie.einsum("...lfcgd,...lj->...jfcgd", Shh, onehot)

    # rhs corrections
    Pinv_g = lie.einsum("...lfigj,...lgj->...lfi", Pinv, g_d)
    rhs_x_corr = lie.einsum("...lfai,...lfi->...fa", Bx_blk, Pinv_g)
    Pg_prev = _shift_frame_down(Pinv_g, -2)
    rhs_h_blk = lie.einsum("...lfci,...lfi->...lfc", Bh_curr, Pinv_g) + lie.einsum(
        "...lfci,...lfi->...lfc", Bh_prev, Pg_prev
    )
    rhs_h_corr = lie.einsum("...lfc,...lj->...jfc", rhs_h_blk, onehot)     # (J, F, 6)

    S[..., :n, :n] -= S_xx_corr.reshape(lead + (n, n))
    rhs[..., :n] += rhs_x_corr.reshape(lead + (-1,))

    # ================= smoothing between (per object, batched) ============
    r_m, H_prev, eye4 = _smooth_terms(state)                      # (J, F, 6)
    J_Am, J_Bm = factors.between_jacobians(H_prev, state.H, eye4, r=r_m)
    w_m = _smooth_mask(state, cfg).to(dtype)[..., None] / sig["smooth"] ** 2
    sm_block, sm_g = _chain_se3_blocks(r_m, J_Am, J_Bm, w_m)      # (J, F, 6, F, 6)

    # assemble the motion region: block-diagonal over objects
    motion_diag = (_block_diag_embed(Hhh) - S_hh_obj.reshape(lead + (J, n, n))
                   + sm_block.reshape(lead + (J, n, n)))
    eyeJ = torch.eye(J, dtype=dtype, device=dev)
    S[..., n:, n:] += lie.einsum("...jab,jk->...jakb", motion_diag, eyeJ).reshape(lead + (J * n, J * n))
    cross_flat = (-S_xh_obj.reshape(lead + (J, n, n))).transpose(-3, -2).reshape(lead + (n, J * n))
    S[..., :n, n:] += cross_flat
    S[..., n:, :n] += cross_flat.mT
    rhs[..., n:] += ((-gh - sm_g).reshape(lead + (J, n)) + rhs_h_corr.reshape(lead + (J, n))).reshape(lead + (-1,))

    # ================= odometry, gauge prior, marginal prior ==============
    _fixed_terms(state, cfg, S, rhs, sig)
    return _Linearization(
        S=_final_reg(S, lam), rhs=rhs, Hpp_inv_s=Hpp_inv_s, g_s=g_s, A_s=A_s,
        Pd=Pd, Pu=Pu, Dp_inv=Dp_inv, Wm=Wm, g_d=g_d,
        Bx_blk=Bx_blk, Bh_curr=Bh_curr, Bh_prev=Bh_prev, onehot=onehot,
    )


# ---------------------------------------------------------------------------
# Solve + update
# ---------------------------------------------------------------------------

def _apply_update(state: GraphState, lin: _Linearization, dx):
    F, J = state.F, state.J
    lead = state.batch_shape
    dX = dx[..., : 6 * F].reshape(lead + (F, 6))
    dH = dx[..., 6 * F:].reshape(lead + (J, F, 6))

    X_new = lie.retract(state.X, dX)
    H_new = lie.retract(state.H, dH)

    At_dx = lie.einsum("...flab,...fa->...lb", lin.A_s, dX)
    ms_new = state.ms + lie.einsum("...lab,...lb->...la", lin.Hpp_inv_s, -lin.g_s - At_dx)

    # chain backsub: dp = P^{-1} (-g - Bx^T dx - Bh^T dh)
    dh_l = lie.einsum("...lj,...jfc->...lfc", lin.onehot, dH)              # (Ld, F, 6)
    bx_term = lie.einsum("...lfai,...fa->...lfi", lin.Bx_blk, dX)
    bh_term = lie.einsum("...lfai,...lfa->...lfi", lin.Bh_curr, dh_l)
    # Bh_prev couples motion f to point f-1: point p receives from motion p+1
    bh_prev_term = _shift_frame_up(lie.einsum("...lfai,...lfa->...lfi", lin.Bh_prev, dh_l), -2)
    rhs_blk = -(lin.g_d + bx_term + bh_term + bh_prev_term)
    dmd = bt.solve_factored(lin.Dp_inv, lin.Wm, lin.Pu, rhs_blk[..., None])[..., 0]
    return dataclasses.replace(state, X=X_new, H=H_new, ms=ms_new, md=state.md + dmd)


def _clip_step(dx, max_step):
    """Scale 6-dof tangent blocks so none exceeds max_step (trust region)."""
    blocks = dx.reshape(dx.shape[:-1] + (-1, 6))
    norms = torch.linalg.norm(blocks, dim=-1, keepdim=True)
    scale = torch.clamp(max_step / torch.clamp(norms, min=1e-12), max=1.0)
    return (blocks * scale).reshape(dx.shape)


def chol_solve(S, g):
    """S x = g by Cholesky, over leading batch dims. Like jnp.linalg.cholesky,
    a factorisation that fails gives NaN (which the LM accept/reject or the
    GN finiteness check then rejects), without a host round trip to check
    it."""
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(_per_seq(info == 0, 2), L, torch.nan)
    z = torch.linalg.solve_triangular(L, g[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]


def gn_scan(state, cfg, linearize_fn, apply_fn, solve_fn):
    """Plain damped Gauss-Newton (iSAM2-style non-backtracking updates) for
    op.max_iterations steps. A non-finite step, NaN from a failed Cholesky
    included, keeps the state and escalates the damping for the retry; a
    good one relaxes it toward the floor. Both decisions stay on the
    device, and over a batch each is per sequence."""
    op = cfg.optimizer
    lead = state.batch_shape
    lam = torch.full(lead, op.lm_initial_lambda, dtype=state.X.dtype, device=state.X.device)
    for _ in range(op.max_iterations):
        lin = linearize_fn(state, cfg, lam)
        cand = apply_fn(state, lin, _clip_step(solve_fn(lin), op.gn_max_step))
        # per sequence: one sequence's failed solve keeps only its own state
        ok = (torch.isfinite(cand.X).flatten(len(lead)).all(-1)
              & torch.isfinite(cand.H).flatten(len(lead)).all(-1))
        state = _select(ok, cand, state)
        lam = damping_update(ok, lam, op, op.lm_initial_lambda)
    return state


def optimize(state: GraphState, cfg: BackendParams) -> GraphState:
    """WCME: accept/reject LM, or the damped GN scan when
    optimizer.accept_reject is off."""
    op = cfg.optimizer
    F = state.F

    def solve_dx(lin):
        return gate_dx_by_type(chol_solve(lin.S, lin.rhs), F, op)

    if not op.accept_reject:
        return gn_scan(state, cfg, linearize, _apply_update, solve_dx)
    return lm_accept_reject(state, cfg, linearize, _apply_update, solve_dx, total_error)
