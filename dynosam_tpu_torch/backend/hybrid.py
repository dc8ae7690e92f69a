"""Object-centric keyframed ("Hybrid") backend: linearisation and the
decoupled two-phase LM (port of dynosam_tpu/backend/hybrid.py).

Each object j carries a constant embedded keyframe L_e and keyframed
world-frame motions ^W_eH_k; each dynamic tracklet is one 3-dof point m_L
in the embedded frame, observed through r = X_k^{-1} ^W_eH_k L_e m_L - Z_k.
Points are eliminated by per-tracklet 3x3 Schur complements, leaving a dense
(camera + motion) system of size D = 6F + 6JF solved by Cholesky.

F2F motions for output: H_f2f(k) = H_{e,k} H_{e,k-1}^{-1}.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from dynosam_tpu.config import BackendParams
from dynosam_tpu_torch.backend import factors
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.backend.solver import (
    _EPS_REG,
    _block_diag_embed,
    _chain_se3_blocks,
    _eye_k,
    _huber_rho,
    _irls_w,
    _object_onehot,
    _odom_mask,
    _prior_dx,
    _sigmas,
    _static_gate,
    _static_residuals,
    gate_dx_by_type,
    lm_accept_reject,
)
from dynosam_tpu_torch.ops.block_tridiag import inv3
from dynosam_tpu_torch.utils import lie


class _HybridLin(NamedTuple):
    S: torch.Tensor
    rhs: torch.Tensor
    Hpp_inv_s: torch.Tensor  # (Ls, 3, 3)
    g_s: torch.Tensor        # (Ls, 3)
    A_s: torch.Tensor        # (F, Ls, 6, 3) static cross blocks
    Hpp_inv_d: torch.Tensor  # (Ld, 3, 3) point Hessian inverses
    g_d: torch.Tensor        # (Ld, 3)
    Ax_d: torch.Tensor       # (Ld, F, 6, 3) pose cross blocks
    Ah_d: torch.Tensor       # (Ld, F, 6, 3) motion cross blocks
    onehot: torch.Tensor     # (Ld, J)


# ---------------------------------------------------------------------------
# Hybrid observation terms
# ---------------------------------------------------------------------------

def _assigned(onehot):
    return torch.sum(onehot, dim=1) > 0.5


def _hybrid_obs_terms(state: GraphState, onehot):
    """Returns (r (Ld,F,3), y (Ld,F,3) camera-frame predictions,
    q (Ld,3) world point at the keyframe, RH (Ld,F,3,3))."""
    eye4 = torch.eye(4, dtype=state.X.dtype, device=state.X.device)
    assigned = _assigned(onehot)
    Lj = lie.einsum("lj,jab->lab", onehot, state.L_e)
    Lj = torch.where(assigned[:, None, None], Lj, eye4)
    q = lie.transform_points(Lj, state.m_hyb)
    Hj = lie.einsum("lj,jfab->lfab", onehot, state.H)
    Hj = torch.where(assigned[:, None, None, None], Hj, eye4)
    m_w = lie.transform_points(Hj, q[:, None, :])
    Xinv = lie.inverse(state.X)
    y = lie.transform_points(Xinv[None], m_w)
    r = y - state.d_z
    return r, y, q, lie.rotation(Hj)


def _kf_match(state: GraphState, onehot):
    """(Ld, F) — frame f is the keyframe slot of the tracklet's object."""
    kf = lie.einsum("lj,j->l", onehot, state.kf_slot.to(onehot.dtype))
    f = torch.arange(state.F, device=onehot.device)
    return f[None, :] == kf.to(torch.int32)[:, None]


def _h_is_variable(state: GraphState, onehot):
    """(Ld, F) — the motion at (tracklet's object, f) is a free variable."""
    Hv = lie.einsum("lj,jf->lf", onehot, state.H_valid.to(onehot.dtype)) > 0.5
    return Hv & ~_kf_match(state, onehot)


def _obs_mask(state: GraphState, onehot):
    kf_ok = lie.einsum("lj,j->l", onehot, state.kf_valid.to(onehot.dtype)) > 0.5
    in_window = torch.arange(state.F, device=onehot.device)[None, :] < state.num_frames
    # the motion at (j, f) must be a free variable or the keyframe identity
    h_ok = _h_is_variable(state, onehot) | _kf_match(state, onehot)
    return state.d_valid & _assigned(onehot)[:, None] & kf_ok[:, None] & in_window & h_ok


def _smooth_triple_mask(state: GraphState, cfg: BackendParams):
    """(J, F) — ternary smoothing factor between slots (f-2, f-1, f)."""
    Hv = state.H_valid
    if not cfg.use_smoothing_factor:
        return torch.zeros_like(Hv)
    f = torch.arange(state.F, device=Hv.device)[None, :]
    kf = state.kf_slot[:, None]
    # the keyframe-slot equality must exclude departed keyframes (-1)
    exists_prev2 = (
        torch.cat([torch.zeros_like(Hv[:, :2]), Hv[:, :-2]], dim=1)
        | ((kf == f - 2) & (kf >= 0))
        | ((kf < 0) & (f >= 2))
    )
    valid_prev = torch.cat([torch.zeros_like(Hv[:, :1]), Hv[:, :-1]], dim=1)
    return Hv & valid_prev & exists_prev2 & state.kf_valid[:, None]


def _smooth_triple_terms(state: GraphState):
    """r_f = log(A B^{-1} C B^{-1}) with A, B, C = H_{f-2}, H_{f-1}, H_f and
    its right-perturbation Jacobians J_A = Jl^{-1}(r) Ad(A),
    J_C = Jr^{-1}(r) Ad(B), J_B = -(J_A + J_C)."""
    H = state.H
    A = torch.roll(H, 2, dims=1)
    B = torch.roll(H, 1, dims=1)
    Binv = lie.inverse(B)
    M = lie.mm(lie.mm(lie.mm(A, Binv), H), Binv)
    r = lie.se3_log(M)
    Jl_inv = lie.se3_left_jacobian_inv(r)
    Jr_inv = lie.se3_left_jacobian_inv(-r)
    J_A = lie.mm(Jl_inv, lie.adjoint(A))
    J_C = lie.mm(Jr_inv, lie.adjoint(B))
    return r, J_A, -(J_A + J_C), J_C


def _odom_terms(state: GraphState):
    X_prev = torch.cat([state.X[:1], state.X[:-1]], dim=0)
    r_o = factors.between_residual(X_prev, state.X, state.odom)
    return X_prev, r_o


def total_error(state: GraphState, cfg: BackendParams, dynamic_scale: float = 1.0):
    """Graph error. dynamic_scale=0.0 gives the static-only objective of the
    decoupled camera phase."""
    dtype, dev = state.X.dtype, state.X.device
    sig = _sigmas(cfg, dtype, dev)
    k = cfg.noise.robust_k_huber
    use_rob = cfg.noise.use_robust_kernel
    onehot = _object_onehot(state, dtype)

    def rho(e):
        return _huber_rho(e, k) if use_rob else 0.5 * e * e

    r_s, _ = _static_residuals(state)
    gate = _static_gate(state, cfg)
    e = torch.linalg.norm(r_s, dim=-1) / sig["static_pt"]
    err = torch.sum(torch.where(state.s_valid & gate[None, :], rho(e), 0.0))

    if dynamic_scale:
        r_h, _, _, _ = _hybrid_obs_terms(state, onehot)
        mask = _obs_mask(state, onehot)
        e = torch.linalg.norm(r_h / state.d_sig, dim=-1)
        err = err + dynamic_scale * torch.sum(torch.where(mask, rho(e), 0.0))

        r_sm, _, _, _ = _smooth_triple_terms(state)
        sm_mask = _smooth_triple_mask(state, cfg)
        err = err + dynamic_scale * torch.sum(
            torch.where(sm_mask[..., None], 0.5 * (r_sm / sig["smooth"]) ** 2, 0.0)
        )

    if cfg.use_vo_factor:
        _, r_o = _odom_terms(state)
        r_o = r_o / sig["odom"]
        err = err + torch.sum(torch.where(_odom_mask(state)[:, None], 0.5 * r_o * r_o, 0.0))

    gauge_on = (~state.prior_valid).to(dtype)
    r_p = factors.prior_residual(state.X[0], state.X0_prior) / sig["prior0"]
    err = err + gauge_on * torch.sum(0.5 * r_p * r_p)

    r_mp = state.prior_b + state.prior_L @ _prior_dx(state)
    err = err + torch.where(state.prior_valid, torch.sum(0.5 * r_mp * r_mp), 0.0)
    return err


# ---------------------------------------------------------------------------
# Linearisation
# ---------------------------------------------------------------------------

def linearize(state: GraphState, cfg: BackendParams, lam, dynamic_scale: float = 1.0):
    """Reduced (camera + motion) normal equations, damped by `lam`.

    `dynamic_scale` (a Python float) scales every dynamic-observation and
    smoothing weight; 0.0 gives the static-only system of the decoupled
    camera phase and skips the dynamic terms entirely."""
    F, J, Ld = state.F, state.J, state.Ld
    D = state.D
    n = 6 * F
    dtype, dev = state.X.dtype, state.X.device
    sig = _sigmas(cfg, dtype, dev)
    k_rob = cfg.noise.robust_k_huber
    use_rob = cfg.noise.use_robust_kernel
    onehot = _object_onehot(state, dtype)

    S = torch.zeros((D, D), dtype=dtype, device=dev)
    rhs = torch.zeros((D,), dtype=dtype, device=dev)

    R = lie.rotation(state.X)
    Rt = R.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    # ================= static landmarks ==================================
    r_s, y_s = _static_residuals(state)
    gate = _static_gate(state, cfg)
    e_s = torch.linalg.norm(r_s / state.s_sig, dim=-1)
    iw_s = (state.s_valid & gate[None, :]).to(dtype)[..., None] * _irls_w(
        e_s, k_rob, use_rob
    )[..., None] / (state.s_sig ** 2)                          # (F, Ls, 3)

    hat_y = lie.hat(y_s)
    Jx_s = torch.cat([hat_y, -eye3.expand(hat_y.shape)], dim=-1)
    Hpp_s = lie.einsum("fab,flb,fcb->lac", R, iw_s, R) + (_EPS_REG + lam) * eye3
    Hpp_inv_s = inv3(Hpp_s)
    g_s = lie.einsum("fab,flb->la", R, iw_s * r_s)
    A_s = lie.einsum("flba,flb,fbc->flac", Jx_s, iw_s, Rt)
    Hxx_s = lie.einsum("flab,fla,flac->fbc", Jx_s, iw_s, Jx_s)
    gx_s = lie.einsum("flab,fla->fb", Jx_s, iw_s * r_s)
    S_pp = lie.einsum("flab,lbc,gldc->fagd", A_s, Hpp_inv_s, A_s)
    S[:n, :n] += _block_diag_embed(Hxx_s) - S_pp.reshape(n, n)
    rhs[:n] += (-gx_s + lie.einsum("flab,lbc,lc->fa", A_s, Hpp_inv_s, g_s)).reshape(-1)

    if dynamic_scale == 0.0:
        S, rhs = _fixed_terms(state, cfg, S, rhs, sig)
        S = _final_reg(S, lam)
        zeros3 = torch.zeros((Ld, 3), dtype=dtype, device=dev)
        zeros_blk = torch.zeros((Ld, F, 6, 3), dtype=dtype, device=dev)
        return _HybridLin(
            S=S, rhs=rhs, Hpp_inv_s=Hpp_inv_s, g_s=g_s, A_s=A_s,
            Hpp_inv_d=torch.zeros((Ld, 3, 3), dtype=dtype, device=dev),
            g_d=zeros3, Ax_d=zeros_blk, Ah_d=zeros_blk, onehot=onehot,
        )

    # ================= hybrid dynamic observations ========================
    r_h, y_h, q, RH = _hybrid_obs_terms(state, onehot)
    mask = _obs_mask(state, onehot)
    e_h = torch.linalg.norm(r_h / state.d_sig, dim=-1)
    iw_h = mask.to(dtype)[..., None] * _irls_w(e_h, k_rob, use_rob)[..., None] / (
        state.d_sig ** 2
    )
    iw_h = iw_h * dynamic_scale                                # (Ld, F, 3)

    hat_yh = lie.hat(y_h)
    Jx = torch.cat([hat_yh, -eye3.expand(hat_yh.shape)], dim=-1)   # (Ld,F,3,6)
    # J_h = R_X^T R_H [-hat(q) | I]; zero where the motion is not a variable
    RtRH = lie.einsum("fba,lfbc->lfac", R, RH)
    hvar = _h_is_variable(state, onehot).to(dtype)
    Jh = torch.cat(
        [-lie.mm(RtRH, lie.hat(q)[:, None]), RtRH], dim=-1
    ) * hvar[..., None, None]
    # J_m = R_X^T R_H R_L
    assigned = _assigned(onehot)
    Lj_R = lie.einsum("lj,jab->lab", onehot, lie.rotation(state.L_e))
    Lj_R = torch.where(assigned[:, None, None], Lj_R, eye3)
    Jm = lie.einsum("lfab,lbc->lfac", RtRH, Lj_R)

    Hpp_d = lie.einsum("lfba,lfb,lfbc->lac", Jm, iw_h, Jm) + (_EPS_REG + lam) * eye3
    Hpp_inv_d = inv3(Hpp_d)
    g_d = lie.einsum("lfba,lfb->la", Jm, iw_h * r_h)
    Ax_d = lie.einsum("lfba,lfb,lfbc->lfac", Jx, iw_h, Jm)
    Ah_d = lie.einsum("lfba,lfb,lfbc->lfac", Jh, iw_h, Jm)

    # direct blocks
    Hxx_d = lie.einsum("lfab,lfa,lfac->fbc", Jx, iw_h, Jx)
    gx_d = lie.einsum("lfab,lfa->fb", Jx, iw_h * r_h)
    S[:n, :n] += _block_diag_embed(Hxx_d)
    rhs[:n] -= gx_d.reshape(-1)

    Hhh_blk = lie.einsum("lfab,lfa,lfac->lfbc", Jh, iw_h, Jh)
    gh_blk = lie.einsum("lfab,lfa->lfb", Jh, iw_h * r_h)
    Hxh_blk = lie.einsum("lfab,lfa,lfac->lfbc", Jx, iw_h, Jh)
    Hhh = lie.einsum("lfbc,lj->jfbc", Hhh_blk, onehot)
    gh = lie.einsum("lfb,lj->jfb", gh_blk, onehot)
    Hxh = lie.einsum("lfbc,lj->jfbc", Hxh_blk, onehot)

    # Schur corrections over points (Hpp per tracklet)
    Sxx_c = lie.einsum("lfab,lbc,lgdc->fagd", Ax_d, Hpp_inv_d, Ax_d)
    rx_c = lie.einsum("lfab,lbc,lc->fa", Ax_d, Hpp_inv_d, g_d)
    # per-object Schur blocks: per-tracklet (6F, 6F) outer products grouped
    # by object with one (J, Ld) x (Ld, 36F^2) matmul
    Ax2 = Ax_d.reshape(Ld, n, 3)
    Ah2 = Ah_d.reshape(Ld, n, 3)
    AhPinv = lie.einsum("lab,lbc->lac", Ah2, Hpp_inv_d)
    t_xh = lie.einsum("lab,lcb->lac", Ax2, AhPinv)
    t_hh = lie.einsum("lab,lcb->lac", Ah2, AhPinv)
    onehot_T = onehot.T
    Sxh_c = (onehot_T @ t_xh.reshape(Ld, n * n)).reshape(J, F, 6, F, 6)
    Shh_c = (onehot_T @ t_hh.reshape(Ld, n * n)).reshape(J, F, 6, F, 6)
    rh_c = lie.einsum("lab,lb,lj->ja", AhPinv, g_d, onehot).reshape(J, F, 6)

    S[:n, :n] -= Sxx_c.reshape(n, n)
    rhs[:n] += rx_c.reshape(-1)

    # ================= smoothing ternary (per object, batched) ============
    r_sm, J_A, J_B, J_C = _smooth_triple_terms(state)
    w_sm = dynamic_scale * _smooth_triple_mask(state, cfg).to(dtype)[..., None] / (
        sig["smooth"] ** 2
    )
    JAw = J_A.transpose(-1, -2) * w_sm[..., None, :]
    JBw = J_B.transpose(-1, -2) * w_sm[..., None, :]
    JCw = J_C.transpose(-1, -2) * w_sm[..., None, :]
    eyeF = _eye_k(F, 0, dtype, dev)
    E1 = _eye_k(F, 1, dtype, dev)    # E1[g, f] = 1 iff g = f-1
    E2 = _eye_k(F, 2, dtype, dev)    # E2[g, f] = 1 iff g = f-2

    def place(blk, Eg, Eh):
        return lie.einsum("jfab,gf,hf->jgahb", blk, Eg, Eh)

    blocks = (
        place(lie.mm(JAw, J_A), E2, E2)
        + place(lie.mm(JBw, J_B), E1, E1)
        + place(lie.mm(JCw, J_C), eyeF, eyeF)
        + _sym2(place(lie.mm(JAw, J_B), E2, E1))
        + _sym2(place(lie.mm(JAw, J_C), E2, eyeF))
        + _sym2(place(lie.mm(JBw, J_C), E1, eyeF))
    )
    g_sm = (
        lie.einsum("jfab,jfb,gf->jga", JAw, r_sm, E2)
        + lie.einsum("jfab,jfb,gf->jga", JBw, r_sm, E1)
        + lie.einsum("jfab,jfb->jfa", JCw, r_sm)
    )

    # ================= assemble motion region ==============================
    motion_diag = _block_diag_embed(Hhh) - Shh_c.reshape(J, n, n) + blocks.reshape(J, n, n)
    eyeJ = torch.eye(J, dtype=dtype, device=dev)
    motion_block = lie.einsum("jab,jk->jakb", motion_diag, eyeJ)
    S[n:, n:] += motion_block.reshape(J * n, J * n)
    cross = _block_diag_embed(Hxh) - Sxh_c.reshape(J, n, n)
    cross_flat = cross.transpose(0, 1).reshape(n, J * n)
    S[:n, n:] += cross_flat
    S[n:, :n] += cross_flat.T
    rhs[n:] += ((-gh - g_sm).reshape(J, n) + rh_c.reshape(J, n)).reshape(-1)

    # ================= odometry / gauge / marginal prior ==================
    S, rhs = _fixed_terms(state, cfg, S, rhs, sig)
    S = _final_reg(S, lam)
    return _HybridLin(
        S=S, rhs=rhs, Hpp_inv_s=Hpp_inv_s, g_s=g_s, A_s=A_s,
        Hpp_inv_d=Hpp_inv_d, g_d=g_d, Ax_d=Ax_d, Ah_d=Ah_d, onehot=onehot,
    )


def _final_reg(S, lam):
    """Padded-variable floor + Marquardt damping relative to the diagonal."""
    diag = torch.diagonal(S)
    return S + torch.diag((_EPS_REG + lam) + (1e-5 + lam) * torch.abs(diag))


def _fixed_terms(state: GraphState, cfg: BackendParams, S, rhs, sig):
    """Non-landmark terms: odometry chain, gauge prior, marginal prior.
    Adds into S and rhs in place."""
    F = state.F
    n = 6 * F
    dtype = S.dtype
    if cfg.use_vo_factor:
        X_prev, r_o = _odom_terms(state)
        J_Ao, J_Bo = factors.between_jacobians(X_prev, state.X, state.odom, r=r_o)
        w_o = _odom_mask(state).to(dtype)[:, None] / (sig["odom"] ** 2)
        od_block, od_g = _chain_se3_blocks(r_o, J_Ao, J_Bo, w_o)
        S[:n, :n] += od_block.reshape(n, n)
        rhs[:n] -= od_g.reshape(-1)

    r_p = factors.prior_residual(state.X[0], state.X0_prior)
    J_p = factors.prior_jacobian(state.X[0], state.X0_prior, r=r_p)
    w_p = (~state.prior_valid).to(dtype) / sig["prior0"] ** 2
    S[:6, :6] += w_p * lie.mm(J_p.T, J_p)
    rhs[:6] -= w_p * (J_p.T @ r_p)

    r_mp = state.prior_b + state.prior_L @ _prior_dx(state)
    pv = state.prior_valid.to(dtype)
    S += pv * lie.mm(state.prior_L.T, state.prior_L)
    rhs -= pv * (state.prior_L.T @ r_mp)
    return S, rhs


def _sym2(B):
    """B (J, F, 6, F, 6): B + its block transpose."""
    return B + B.permute(0, 3, 4, 1, 2)


# ---------------------------------------------------------------------------
# Update + optimize
# ---------------------------------------------------------------------------

def _apply_update(state: GraphState, lin: _HybridLin, dx):
    F, J = state.F, state.J
    dX = dx[: 6 * F].reshape(F, 6)
    dH = dx[6 * F:].reshape(J, F, 6)

    X_new = lie.retract(state.X, dX)
    H_new = lie.retract(state.H, dH)

    At_dx = lie.einsum("flab,fa->lb", lin.A_s, dX)
    ms_new = state.ms + lie.einsum("lab,lb->la", lin.Hpp_inv_s, -lin.g_s - At_dx)

    dh_l = lie.einsum("lj,jfc->lfc", lin.onehot, dH)
    corr = lie.einsum("lfab,fa->lb", lin.Ax_d, dX) + lie.einsum("lfab,lfa->lb", lin.Ah_d, dh_l)
    m_hyb_new = state.m_hyb + lie.einsum("lab,lb->la", lin.Hpp_inv_d, -lin.g_d - corr)
    return dataclasses.replace(state, X=X_new, H=H_new, ms=ms_new, m_hyb=m_hyb_new)


def _clip_step(dx, max_step):
    """Scale 6-dof tangent blocks so none exceeds max_step (trust region)."""
    blocks = dx.reshape(-1, 6)
    norms = torch.linalg.norm(blocks, dim=-1, keepdim=True)
    scale = torch.clamp(max_step / torch.clamp(norms, min=1e-12), max=1.0)
    return (blocks * scale).reshape(-1)


def chol_solve(S, g):
    """S x = g by Cholesky. Like jnp.linalg.cholesky, a factorisation that
    fails gives NaN (which the LM accept/reject then rejects), without a
    host round trip to check it."""
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, torch.nan)
    z = torch.linalg.solve_triangular(L, g[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]


def optimize_decoupled(state: GraphState, cfg: BackendParams) -> GraphState:
    """ParallelHybrid solve order: the camera/static scene first (no dynamic
    factors), then every object with the camera frozen. With the camera
    frozen the motion block is per-object block-diagonal, so the batched
    solve is the reference's per-object loop."""
    op = cfg.optimizer
    F = state.F
    n = 6 * F
    D = state.D
    obj_iters = cfg.num_dynamic_optimize or op.max_iterations

    # Phase 1 — camera/static, accept/reject on the static-only objective
    def lin_cam(st, cfg_, lam):
        return linearize(st, cfg_, lam, dynamic_scale=0.0)

    def solve_cam(lin):
        dx_x = chol_solve(lin.S[:n, :n], lin.rhs[:n])
        dx = torch.cat([_clip_step(dx_x, op.gn_max_step), dx_x.new_zeros(D - n)])
        return gate_dx_by_type(dx, F, op)

    def err_cam(st, cfg_):
        return total_error(st, cfg_, dynamic_scale=0.0)

    state = lm_accept_reject(state, cfg, lin_cam, _apply_update, solve_cam, err_cam)

    # Phase 2 — every object with the camera frozen, full objective
    def solve_obj(lin):
        dh = chol_solve(lin.S[n:, n:], lin.rhs[n:])
        dx = torch.cat([dh.new_zeros(n), _clip_step(dh, op.gn_max_step)])
        return gate_dx_by_type(dx, F, op)

    return lm_accept_reject(
        state, cfg, linearize, _apply_update, solve_obj, total_error,
        iterations=obj_iters,
    )


def optimize(state: GraphState, cfg: BackendParams) -> GraphState:
    """The hybrid optimizer; this port runs the decoupled route only."""
    if not cfg.decoupled_object_solve:
        raise NotImplementedError(
            "joint hybrid solve (decoupled_object_solve=False) is not ported"
        )
    return optimize_decoupled(state, cfg)


# ---------------------------------------------------------------------------
# Accessor helpers
# ---------------------------------------------------------------------------

def f2f_motion(state: GraphState, f: int):
    """F2F world motions at frame slot f: H_{e,f} H_{e,f-1}^{-1}. (J,4,4)."""
    return lie.mm(state.H[:, f], lie.inverse(state.H[:, max(f - 1, 0)]))
