"""World-centric object-POSE formulation (WCPE) (port of
dynosam_tpu/backend/wcpe.py).

Object poses L_{j,k} are the variables instead of WCME's motions:

  * motion-pose factor: r = m_k - L_k L_{k-1}^{-1} m_{k-1}
  * pose smoothing: r = log((L_{k-1} L_{k-2}^{-1})^{-1} (L_k L_{k-1}^{-1})),
    the algebra of the hybrid formulation's constant-motion ternary.

The dynamic-point chains are WCME's, so the same block-tridiagonal
elimination applies; each chain factor couples two pose variables
(L_{k-1}, L_k) with J_{L_{k-1}} = -J_{L_k}, which makes the per-object pose
Hessian block tridiagonal. Cross blocks are assembled densely per tracklet.

State reuse: GraphState.H holds L_{j,k}; H_valid marks existing pose
variables; md holds per-frame dynamic points (as in WCME). F2F motions for
output: H_k = L_k L_{k-1}^{-1}.

Every function also takes a GraphState with a leading batch axis of
sequences (the batched step), as solver.py's WCME does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.frozen.backend.graph import GraphState, update_from_packet
from portbench.frozen.backend.hybrid import _smooth_triple_terms, _sym2
from portbench.frozen.backend.solver import (
    _EPS_REG,
    _block_diag_embed,
    _dyn_ptp_residuals,
    _embed_prev_frame,
    _embed_same_frame,
    _eye_k,
    _final_reg,
    _fixed_terms,
    _huber_rho,
    _irls_w,
    _object_onehot,
    _odom_mask,
    _per_seq,
    _prior_dx,
    _shift_frame_down,
    _shift_frame_up,
    _shift_prev,
    _sigmas,
    _static_gate,
    _static_residuals,
    _static_terms,
    _sum_per_seq,
    chol_solve,
    gate_dx_by_type,
    gn_scan,
    lm_accept_reject,
)
from portbench.frozen.backend import factors
from portbench.frozen.config import BackendParams
from portbench.frozen.cv import camera as cam
from portbench.frozen.frontend.types import VisionPacket, first_true, rows
from portbench.frozen.ops import block_tridiag as bt
from portbench.frozen.utils import lie


# ---------------------------------------------------------------------------
# Ingestion: initialise object POSES instead of motions
# ---------------------------------------------------------------------------

def update_from_packet_wcpe(
    state: GraphState,
    packet: VisionPacket,
    intr: cam.CameraIntrinsics,
    cfg: BackendParams,
) -> GraphState:
    """WCME ingestion plus pose-variable initialisation:
    L_{j,f} = H_f2f(packet) L_{j,f-1}; new objects anchor at their point
    centroid with identity rotation."""
    f = state.num_frames
    nb = len(state.batch_shape)
    prev_obj_ids = state.obj_ids
    base = update_from_packet(state, packet, intr, cfg)
    dtype, dev = base.X.dtype, base.X.device
    J = base.J

    existed = (prev_obj_ids > 0) & (base.obj_ids > 0)

    d_obs_valid = base.d_valid[..., f]
    dt = packet.dynamic_tracks
    zd_world = lie.transform_points(base.X[..., f, None, :, :],
                                    cam.backproject(dt.uv, dt.depth, intr).to(dtype))
    onehot = (
        (base.d_obj[..., :, None] == torch.arange(J, device=dev)) & d_obs_valid[..., :, None]
    ).to(dtype)
    counts = torch.sum(onehot, dim=-2)
    centroid = lie.einsum("...lj,...lc->...jc", onehot, zd_world) / torch.clamp(counts[..., None], min=1.0)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    L_new = lie.make_pose(eye3.expand(centroid.shape[:-1] + (3, 3)), centroid)

    eq = base.obj_ids[..., :, None] == packet.object_ids[..., None, :]
    pkt_ok = packet.object_valid & (packet.object_ids > 0)
    hit = torch.any(eq & pkt_ok[..., None, :], dim=-1)
    # the first matching packet slot (0 where none; the where discards it)
    idx = first_true(eq & pkt_ok[..., None, :], -1)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    H_f2f = torch.where((hit & existed)[..., None, None], packet.object_motions[rows(idx, nb)].to(dtype), eye4)
    L_prev = base.H[..., max(f - 1, 0), :, :]
    L_init = torch.where((existed & (f > 0))[..., None, None], lie.compose(H_f2f, L_prev), L_new)
    H = base.H.clone()
    H[..., f, :, :] = L_init
    # an L variable exists where the object has enough observations this frame
    min_obs = max(cfg.min_dynamic_observations, 1)
    H_valid = base.H_valid.clone()
    H_valid[..., f] = (counts >= min_obs) & (base.obj_ids > 0)
    return dataclasses.replace(base, H=H, H_valid=H_valid)


# ---------------------------------------------------------------------------
# Residual terms
# ---------------------------------------------------------------------------

def _pose_chain_terms(state: GraphState, onehot):
    """Motion-pose residuals r_f = m_f - G_f m_{f-1}, G_f = L_f L_{f-1}^{-1}
    -> (r (Ld, F, 3), RG (Ld, F, 3, 3), J_L (Ld, F, 3, 6)), J_L the
    Jacobian w.r.t. L_f (and -J_L w.r.t. L_{f-1})."""
    Lj = lie.einsum("...lj,...jfab->...lfab", onehot, state.H)       # (Ld, F, 4, 4)
    assigned = torch.sum(onehot, dim=-1) > 0.5
    eye4 = torch.eye(4, dtype=state.X.dtype, device=state.X.device)
    Lj = torch.where(assigned[..., None, None, None], Lj, eye4)
    L_prev = _shift_prev(Lj, -3)
    G = lie.mm(Lj, lie.inverse(L_prev))
    m_prev = _shift_prev(state.md, -2)
    r = state.md - lie.transform_points(G, m_prev)
    # u = L_{f-1}^{-1} m_{f-1}: the point in the object frame
    u = lie.transform_points(lie.inverse(L_prev), m_prev)
    RL = lie.rotation(Lj)
    J_L = torch.cat([lie.mm(RL, lie.hat(u)), -RL], dim=-1)
    return r, lie.rotation(G), J_L


def _pose_chain_mask(state: GraphState, onehot):
    v = state.d_valid
    Lv = lie.einsum("...lj,...jf->...lf", onehot, state.H_valid.to(onehot.dtype)) > 0.5
    in_window = torch.arange(state.F, device=v.device) < state.num_frames
    return v & _shift_frame_down(v, -1) & Lv & _shift_frame_down(Lv, -1) & in_window


def _smooth_triple_mask_wcpe(state: GraphState, cfg: BackendParams):
    if not cfg.use_smoothing_factor:
        return torch.zeros_like(state.H_valid)
    Hv = state.H_valid
    prev1 = _shift_frame_down(Hv, -1)
    return Hv & prev1 & _shift_frame_down(prev1, -1)


def total_error(state: GraphState, cfg: BackendParams):
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

    r_t, _, _ = _pose_chain_terms(state, onehot)
    e = torch.linalg.norm(r_t, dim=-1) / sig["ternary"]
    err = err + _sum_per_seq(torch.where(_pose_chain_mask(state, onehot), rho(e), 0.0), nb)

    r_sm, _, _, _ = _smooth_triple_terms(state)
    sm_mask = _smooth_triple_mask_wcpe(state, cfg)
    err = err + _sum_per_seq(torch.where(sm_mask[..., None], 0.5 * (r_sm / sig["smooth"]) ** 2, 0.0), nb)

    if cfg.use_vo_factor:
        X_prev = _shift_prev(state.X, -3)
        r_o = factors.between_residual(X_prev, state.X, state.odom) / sig["odom"]
        err = err + _sum_per_seq(torch.where(_odom_mask(state)[..., None], 0.5 * r_o * r_o, 0.0), nb)

    gauge_on = (~state.prior_valid).to(dtype)
    r_p = factors.prior_residual(state.X[..., 0, :, :], state.X0_prior) / sig["prior0"]
    err = err + gauge_on * _sum_per_seq(0.5 * r_p * r_p, nb)

    r_mp = state.prior_b + lie.mv(state.prior_L, _prior_dx(state))
    return err + torch.where(state.prior_valid, _sum_per_seq(0.5 * r_mp * r_mp, nb), 0.0)


# ---------------------------------------------------------------------------
# Linearisation
# ---------------------------------------------------------------------------

class _WcpeLin(NamedTuple):
    S: torch.Tensor
    rhs: torch.Tensor
    Hpp_inv_s: torch.Tensor  # (Ls, 3, 3)
    g_s: torch.Tensor
    A_s: torch.Tensor
    Pd: torch.Tensor
    Pu: torch.Tensor
    Dp_inv: torch.Tensor
    Wm: torch.Tensor
    g_d: torch.Tensor        # (Ld, 3F)
    Bx: torch.Tensor         # (Ld, 6F, 3F) dense pose-chain cross
    Bl: torch.Tensor         # (Ld, 6F, 3F) dense object-pose cross
    onehot: torch.Tensor


def _embed_row_prev(blk, F):
    """blk (Ld, F, A, B) placed at (row f-1, col f)."""
    E = _eye_k(F, 1, blk.dtype, blk.device)   # E[g, f] = 1 iff g = f-1
    return lie.einsum("...lfab,gf,fh->...lgahb", blk, E, _eye_k(F, 0, blk.dtype, blk.device))


def _embed_row_col_prev(blk, F):
    """blk (Ld, F, A, B) placed at (row f-1, col f-1)."""
    E = _eye_k(F, 1, blk.dtype, blk.device)
    return lie.einsum("...lfab,gf,hf->...lgahb", blk, E, E)


def linearize(state: GraphState, cfg: BackendParams, lam) -> _WcpeLin:
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

    # ---- static (as WCME) --------------------------------------------------
    Hpp_inv_s, g_s, A_s = _static_terms(state, cfg, lam, S, rhs)

    # ---- dynamic PTP + pose-chain factors --------------------------------
    r_d, y_d = _dyn_ptp_residuals(state)
    has_obj_f = torch.sum(onehot, dim=-1)
    e_d = torch.linalg.norm(r_d / state.d_sig, dim=-1)
    iw_d = (state.d_valid.to(dtype) * has_obj_f[..., None])[..., None] * _irls_w(
        e_d, k_rob, use_rob
    )[..., None] / (state.d_sig ** 2)

    r_t, RG, J_L = _pose_chain_terms(state, onehot)
    mask_t = _pose_chain_mask(state, onehot)
    e_t = torch.linalg.norm(r_t, dim=-1) / sig["ternary"]
    w_t = mask_t.to(dtype) * _irls_w(e_t, k_rob, use_rob) / (sig["ternary"] ** 2)

    hat_yd = lie.hat(y_d)
    Jx_d = torch.cat([hat_yd, -eye3.expand(hat_yd.shape)], dim=-1)

    # chain Hessian (WCME's structure: J_prev = -RG, J_curr = I)
    Pd_ptp = lie.einsum("...fab,...lfb,...fcb->...lfac", R, iw_d, R)
    diag_scalar = w_t + _shift_frame_up(w_t, -1) + _EPS_REG + _per_seq(lam, 2)
    Pd = Pd_ptp + diag_scalar[..., None, None] * eye3
    Pu = _shift_frame_up(-RG.transpose(-1, -2) * w_t[..., None, None], -3)

    g_d = lie.einsum("...fab,...lfb->...lfa", R, iw_d * r_d)
    g_ter_curr = r_t * w_t[..., None]
    g_ter_prev = -lie.einsum("...lfba,...lfb->...lfa", RG, r_t * w_t[..., None])
    g_d = g_d + g_ter_curr + _shift_frame_up(g_ter_prev, -2)

    # cross blocks, dense per tracklet
    Bx_blk = lie.einsum("...lfba,...lfb,...fbc->...lfac", Jx_d, iw_d, Rt)
    Bx = _embed_same_frame(Bx_blk, F).reshape(lead + (Ld, n, 3 * F))

    JLT = J_L.transpose(-1, -2)                              # (Ld, F, 6, 3)
    Bl_curr = JLT * w_t[..., None, None]                     # J_L^T W J_curr
    Bl_prev = -lie.einsum("...lfab,...lfbc->...lfac", JLT * w_t[..., None, None], RG)
    # rows L_f from factor f; rows L_{f-1} get the negations
    Bl = (
        _embed_same_frame(Bl_curr, F)
        + _embed_prev_frame(Bl_prev, F)
        + _embed_row_prev(-Bl_curr, F)           # (row f-1, col f)
        + _embed_row_col_prev(-Bl_prev, F)       # (row f-1, col f-1)
    ).reshape(lead + (Ld, n, 3 * F))

    # direct reduced blocks
    Hxx_d = lie.einsum("...lfab,...lfa,...lfac->...fbc", Jx_d, iw_d, Jx_d)
    gx_d = lie.einsum("...lfab,...lfa->...fb", Jx_d, iw_d * r_d)
    S[..., :n, :n] += _block_diag_embed(Hxx_d)
    rhs[..., :n] -= gx_d.reshape(lead + (-1,))

    # pose-pose direct blocks (per object, tridiagonal via +-J_L)
    HLL = lie.einsum("...lfab,...lf,...lfac->...lfbc", J_L, w_t, J_L)    # (Ld, F, 6, 6)
    gL = lie.einsum("...lfab,...lf,...lfa->...lfb", J_L, w_t, r_t)
    eyeF = _eye_k(F, 0, dtype, dev)
    E1 = _eye_k(F, 1, dtype, dev)
    blocks_l = (
        lie.einsum("...lfab,fg,fh->...lgahb", HLL, eyeF, eyeF)            # (f, f)
        + lie.einsum("...lfab,gf,hf->...lgahb", HLL, E1, E1)              # (f-1, f-1)
        - lie.einsum("...lfab,gf,fh->...lgahb", HLL, E1, eyeF)            # (f-1, f)
        - lie.einsum("...lfab,fg,hf->...lgahb", HLL, eyeF, E1)            # (f, f-1)
    )
    g_l = lie.einsum("...lfb,fg->...lgb", gL, eyeF) - lie.einsum("...lfb,gf->...lgb", gL, E1)
    HLL_obj = lie.einsum("...lgahb,...lj->...jgahb", blocks_l, onehot)
    gL_obj = lie.einsum("...lgb,...lj->...jgb", g_l, onehot)

    # smoothing ternary on L (the hybrid module's algebra)
    r_sm, J_A, J_B, J_C = _smooth_triple_terms(state)
    w_sm = _smooth_triple_mask_wcpe(state, cfg).to(dtype)[..., None] / (sig["smooth"] ** 2)
    JAw = J_A.transpose(-1, -2) * w_sm[..., None, :]
    JBw = J_B.transpose(-1, -2) * w_sm[..., None, :]
    JCw = J_C.transpose(-1, -2) * w_sm[..., None, :]
    E2 = _eye_k(F, 2, dtype, dev)
    sm_blocks = (
        lie.einsum("...jfab,gf,hf->...jgahb", lie.mm(JAw, J_A), E2, E2)
        + lie.einsum("...jfab,gf,hf->...jgahb", lie.mm(JBw, J_B), E1, E1)
        + lie.einsum("...jfab,fg,fh->...jgahb", lie.mm(JCw, J_C), eyeF, eyeF)
        + _sym2(lie.einsum("...jfab,gf,hf->...jgahb", lie.mm(JAw, J_B), E2, E1))
        + _sym2(lie.einsum("...jfab,gf,fh->...jgahb", lie.mm(JAw, J_C), E2, eyeF))
        + _sym2(lie.einsum("...jfab,gf,fh->...jgahb", lie.mm(JBw, J_C), E1, eyeF))
    )
    g_sm = (
        lie.einsum("...jfab,...jfb,gf->...jga", JAw, r_sm, E2)
        + lie.einsum("...jfab,...jfb,gf->...jga", JBw, r_sm, E1)
        + lie.einsum("...jfab,...jfb->...jfa", JCw, r_sm)
    )

    # ---- chain Schur ------------------------------------------------------
    Dp_inv, Wm = bt.factorize(Pd, Pu)
    Pinv = bt.full_inverse(Pd, Pu).reshape(lead + (Ld, 3 * F, 3 * F))
    g_df = g_d.reshape(lead + (Ld, 3 * F))

    PinvBxT = lie.einsum("...lij,...lbj->...lib", Pinv, Bx)
    PinvBlT = lie.einsum("...lij,...lbj->...lib", Pinv, Bl)
    Pinv_g = lie.einsum("...lij,...lj->...li", Pinv, g_df)

    Sxx_c = lie.einsum("...lai,...lib->...ab", Bx, PinvBxT)
    Sxl_c = lie.einsum("...lai,...lib,...lj->...jab", Bx, PinvBlT, onehot)
    Sll_c = lie.einsum("...lai,...lib,...lj->...jab", Bl, PinvBlT, onehot)
    rx_c = lie.einsum("...lai,...li->...a", Bx, Pinv_g)
    rl_c = lie.einsum("...lai,...li,...lj->...ja", Bl, Pinv_g, onehot)

    S[..., :n, :n] -= Sxx_c
    rhs[..., :n] += rx_c

    motion_diag = HLL_obj.reshape(lead + (J, n, n)) + sm_blocks.reshape(lead + (J, n, n)) - Sll_c
    eyeJ = torch.eye(J, dtype=dtype, device=dev)
    S[..., n:, n:] += lie.einsum("...jab,jk->...jakb", motion_diag, eyeJ).reshape(lead + (J * n, J * n))
    cross_flat = (-Sxl_c).transpose(-3, -2).reshape(lead + (n, J * n))
    S[..., :n, n:] += cross_flat
    S[..., n:, :n] += cross_flat.mT
    rhs[..., n:] += ((-gL_obj - g_sm).reshape(lead + (J, n)) + rl_c).reshape(lead + (-1,))

    # ---- odometry / gauge / marginal prior -------------------------------
    _fixed_terms(state, cfg, S, rhs, sig)
    return _WcpeLin(
        S=_final_reg(S, lam), rhs=rhs, Hpp_inv_s=Hpp_inv_s, g_s=g_s, A_s=A_s,
        Pd=Pd, Pu=Pu, Dp_inv=Dp_inv, Wm=Wm, g_d=g_df, Bx=Bx, Bl=Bl, onehot=onehot,
    )


# ---------------------------------------------------------------------------
# Update + optimize
# ---------------------------------------------------------------------------

def _apply_update(state: GraphState, lin: _WcpeLin, dx):
    F, J = state.F, state.J
    lead = state.batch_shape
    dX = dx[..., : 6 * F].reshape(lead + (F, 6))
    dL = dx[..., 6 * F:].reshape(lead + (J, F, 6))

    X_new = lie.retract(state.X, dX)
    L_new = lie.retract(state.H, dL)

    At_dx = lie.einsum("...flab,...fa->...lb", lin.A_s, dX)
    ms_new = state.ms + lie.einsum("...lab,...lb->...la", lin.Hpp_inv_s, -lin.g_s - At_dx)

    dl_l = lie.einsum("...lj,...jfc->...lfc", lin.onehot, dL).reshape(lead + (state.Ld, 6 * F))
    rhs_blk = -(
        lin.g_d
        + lie.einsum("...lai,...a->...li", lin.Bx, dx[..., : 6 * F])
        + lie.einsum("...lai,...la->...li", lin.Bl, dl_l)
    ).reshape(lead + (state.Ld, F, 3))
    dmd = bt.solve_factored(lin.Dp_inv, lin.Wm, lin.Pu, rhs_blk[..., None])[..., 0]
    return dataclasses.replace(state, X=X_new, H=L_new, ms=ms_new, md=state.md + dmd)


def optimize(state: GraphState, cfg: BackendParams) -> GraphState:
    """Accept/reject LM, or the damped GN scan when accept_reject is off.
    The h thresholds of the step gate act on the object-pose (L) blocks."""
    op = cfg.optimizer
    F = state.F

    def solve_dx(lin):
        return gate_dx_by_type(chol_solve(lin.S, lin.rhs), F, op)

    if not op.accept_reject:
        return gn_scan(state, cfg, linearize, _apply_update, solve_dx)
    return lm_accept_reject(state, cfg, linearize, _apply_update, solve_dx, total_error)


def f2f_motion(state: GraphState, f):
    """F2F world motions H_k = L_k L_{k-1}^{-1} at slot f (an int). (J, 4, 4)."""
    return lie.mm(state.H[..., f, :, :], lie.inverse(state.H[..., max(f - 1, 0), :, :]))
