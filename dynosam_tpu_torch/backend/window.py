"""Sliding-window advance with a marginal prior, for the three
formulations (port of dynosam_tpu/backend/window.py).

When the window is full, an advance:
  1. linearises the departing factor set of {X_0, H_{:,0}}:
     - WCME (`advance`): the slot-0 point-to-point factors and the ternary
       factors (0 -> 1), with the departing points m_{:,0} Schur-eliminated
       and the coupled m_{:,1} held at their estimates, the smoothing
       factors (H_{j,0}, H_{j,1});
     - WCPE (`advance_wcpe`): the slot-(0, 1) motion-pose factors (points
       held fixed), a coupled (L_0, L_1) block per object;
     - hybrid (`advance_hybrid`): the slot-0 observation factors (points
       held at their estimates, their noise inflated by the first-order
       point uncertainty) and the straddling constant-motion ternary
       (H_0, H_1, H_2);
     and, for all three, odometry (0, 1), the gauge prior and the previous
     marginal prior;
  2. eliminates the departing variables and keeps the marginal over the
     rest as a square-root prior (prior_L, prior_b);
  3. rolls every frame-indexed table left by one slot; the hybrid advance
     also frees object slots that nothing in the window references any
     more.

The reference places blocks with constant one-hot matrices contracted on the
MXU (a TPU layout choice, window.py:398-399); here they are index
operations, which add the same values in the same places.

All three advances also take a GraphState with a leading batch axis of
sequences (the batched step). Their one host read then covers the batch:
the sequences whose factorisation broke down take the eigh path, the others
the Cholesky path, merged per sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynosam_tpu_torch.config import BackendParams
from dynosam_tpu_torch.backend import factors
from dynosam_tpu_torch.backend import hybrid as hyb
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.backend import wcpe as wp
from dynosam_tpu_torch.backend.solver import _EPS_REG, _object_onehot, _per_seq, _prior_dx, _sigmas
from dynosam_tpu_torch.frontend.types import rows
from dynosam_tpu_torch.ops.block_tridiag import inv3
from dynosam_tpu_torch.utils import lie
from dynosam_tpu_torch.utils.stats import count, span


def _slot_index(F: int, J: int, f: int, device):
    """(J, 6) tangent indices of the motions H_{j,f}, j = 0..J-1."""
    j = torch.arange(J, device=device)
    return 6 * F + 6 * (j[:, None] * F + f) + torch.arange(6, device=device)[None, :]


def _place_blocks(M, g, rows, cols, B, gb=None):
    """M[rows[j], cols[j]] += B[j]; g[rows[j]] += gb[j], in place. rows and
    cols are (J, 6) index tables whose rows never repeat across j; M, g and
    the blocks may carry a leading batch axis of sequences."""
    lead = ()
    if M.ndim == 3:
        lead = (torch.arange(M.shape[0], device=M.device)[:, None, None, None],)
    M.index_put_(lead + (rows[:, :, None], cols[:, None, :]), B, accumulate=True)
    if gb is not None:
        g.index_put_(tuple(b[..., 0] for b in lead) + (rows,), gb, accumulate=True)


def _odometry_01(state: GraphState, cfg: BackendParams, M, g, sig, pass_r: bool):
    """Odometry factor (0, 1) into M and g, in place. The WCME advance of
    the reference linearises it without handing the residual to the
    Jacobians (`pass_r=False`), the others with it; both give the same
    values."""
    X0, X1, Z1 = state.X[..., 0, :, :], state.X[..., 1, :, :], state.odom[..., 1, :, :]
    r_o = factors.between_residual(X0, X1, Z1)
    if pass_r:
        J_A, J_B = factors.between_jacobians(X0, X1, Z1, r=r_o)
    else:
        J_A, J_B = factors.between_jacobians(X0, X1, Z1)
    active = (state.odom_valid[..., 1] & (state.num_frames > 1)).to(M.dtype)
    wv = _per_seq(active, 1) / sig["odom"] ** 2       # (6,) per-dim information
    JAw = J_A.mT * wv[..., None, :]
    JBw = J_B.mT * wv[..., None, :]
    M[..., :6, :6] += JAw @ J_A
    M[..., 6:12, 6:12] += JBw @ J_B
    M[..., :6, 6:12] += JAw @ J_B
    M[..., 6:12, :6] += (JAw @ J_B).mT
    g[..., :6] += lie.mv(JAw, r_o)
    g[..., 6:12] += lie.mv(JBw, r_o)


def _gauge_and_prior(state: GraphState, M, g, sig, pass_r: bool = True):
    """Gauge prior on X_0 (before the first marginalisation) and the
    previous marginal prior -> (M, g)."""
    dtype = M.dtype
    X0 = state.X[..., 0, :, :]
    gauge_on = (~state.prior_valid).to(dtype)
    r_p = factors.prior_residual(X0, state.X0_prior)
    J_p = (factors.prior_jacobian(X0, state.X0_prior, r=r_p) if pass_r
           else factors.prior_jacobian(X0, state.X0_prior))
    w_p = gauge_on / sig["prior0"] ** 2
    M[..., :6, :6] += _per_seq(w_p, 2) * (J_p.mT @ J_p)
    g[..., :6] += _per_seq(w_p, 1) * lie.mv(J_p.mT, r_p)
    r_mp = state.prior_b + lie.mv(state.prior_L, _prior_dx(state))
    pv = state.prior_valid.to(dtype)
    return (M + _per_seq(pv, 2) * lie.mm(state.prior_L.mT, state.prior_L),
            g + _per_seq(pv, 1) * lie.mv(state.prior_L.mT, r_mp))


def _departing_information(state: GraphState, cfg: BackendParams):
    """WCME: dense (D, D) Hessian and (D,) gradient of the departing factor
    set, with the departing dynamic points m_{:,0} Schur-eliminated and the
    coupled m_{:,1} held fixed."""
    F, J = state.F, state.J
    D = state.D
    lead = state.batch_shape
    nb = len(lead)
    dtype, dev = state.X.dtype, state.X.device
    sig = _sigmas(cfg, dtype, dev)

    M = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    g = torch.zeros(lead + (D,), dtype=dtype, device=dev)

    # ---- per tracklet: PTP(X_0, m_0) + ternary(m_0, m_1, H_{j,1}) --------
    X0 = state.X[..., 0, :, :]
    R0 = lie.rotation(X0)
    m0 = state.md[..., 0, :]                             # (Ld, 3)
    m1 = state.md[..., 1, :]
    z0 = state.d_z[..., 0, :]
    has_obj = state.d_obj >= 0
    iw_ptp = (state.d_valid[..., 0] & has_obj).to(dtype)[..., None] / (state.d_sig[..., 0, :] ** 2)

    j_idx = torch.clamp(state.d_obj, 0, J - 1).long()
    H1 = state.H[..., 1, :, :][rows(j_idx, nb)]          # (Ld, 4, 4)
    # the ternary (0, 1) mask, solver._ternary_mask at f = 1
    Hv1 = state.H_valid[..., 1][rows(j_idx, nb)]
    w_ter = (state.d_valid[..., 0] & state.d_valid[..., 1] & Hv1 & has_obj).to(dtype) / (sig["ternary"] ** 2)

    # PTP residual and Jacobians at slot 0
    y0 = lie.transform_points(lie.inverse(X0)[..., None, :, :], m0)
    r_ptp = y0 - z0
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    hat_y0 = lie.hat(y0)
    Jx0 = torch.cat([hat_y0, -eye3.expand(hat_y0.shape)], dim=-1)      # (Ld, 3, 6)
    Jp_ptp = R0.mT                                       # (3, 3), the same for all tracklets

    # ternary residual and Jacobians with m1 fixed
    r_ter = m1 - lie.transform_points(H1, m0)
    RH = lie.rotation(H1)
    Jm0_ter = -RH                                        # (Ld, 3, 3)
    JH_ter = torch.cat([lie.mm(RH, lie.hat(m0)), -RH], dim=-1)        # (Ld, 3, 6)

    # per-tracklet elimination of m_0: Hpp = R0 diag(iw) R0^T + w_ter I + eps
    hpp = lie.einsum("...ab,...lb,...cb->...lac", R0, iw_ptp, R0) + (w_ter + _EPS_REG)[..., None, None] * eye3
    inv_hpp = inv3(hpp)                                  # (Ld, 3, 3)
    g_m0 = lie.einsum("...ab,...lb->...la", R0, iw_ptp * r_ptp) + w_ter[..., None] * lie.einsum(
        "...lba,...lb->...la", Jm0_ter, r_ter
    )
    # cross blocks (variable row, m0 column): X0 from PTP, H1 from the ternary
    C_x0 = lie.einsum("...lba,...lb,...bc->...lac", Jx0, iw_ptp, Jp_ptp)           # (Ld, 6, 3)
    C_h1 = w_ter[..., None, None] * lie.einsum("...lba,...lbc->...lac", JH_ter, Jm0_ter)

    # direct blocks
    H_x0x0 = lie.einsum("...lba,...lb,...lbc->...ac", Jx0, iw_ptp, Jx0)            # (6, 6)
    g_x0 = lie.einsum("...lba,...lb->...a", Jx0, iw_ptp * r_ptp)
    H_h1h1 = lie.einsum("...lba,...l,...lbc->...lac", JH_ter, w_ter, JH_ter)       # (Ld, 6, 6)
    g_h1 = lie.einsum("...lba,...l,...lb->...la", JH_ter, w_ter, r_ter)

    # Schur corrections after eliminating m0
    S_x0x0 = lie.einsum("...lab,...lbc,...ldc->...ad", C_x0, inv_hpp, C_x0)
    S_x0h1 = lie.einsum("...lab,...lbc,...ldc->...lad", C_x0, inv_hpp, C_h1)       # (Ld, 6, 6)
    S_h1h1 = lie.einsum("...lab,...lbc,...ldc->...lad", C_h1, inv_hpp, C_h1)
    gs_x0 = lie.einsum("...lab,...lbc,...lc->...a", C_x0, inv_hpp, g_m0)
    gs_h1 = lie.einsum("...lab,...lbc,...lc->...la", C_h1, inv_hpp, g_m0)

    M[..., :6, :6] += H_x0x0 - S_x0x0
    g[..., :6] += g_x0 - gs_x0

    # per-object sums; row J collects the unassigned tracklets and is dropped
    # (over a batch, sequence b's rows are b (J + 1) .. b (J + 1) + J of one
    # flat table)
    seg = torch.where(has_obj, state.d_obj, J).long()
    if nb:
        seg = seg + (J + 1) * torch.arange(seg.shape[0], device=dev)[:, None]

    def segment_sum(x):
        tail = x.shape[nb + 1:]
        out = torch.zeros((seg.numel() // state.Ld * (J + 1),) + tail, dtype=x.dtype, device=dev)
        out.index_add_(0, seg.reshape(-1), x.reshape((-1,) + tail))
        return out.reshape(lead + (J + 1,) + tail).narrow(nb, 0, J)

    H_h1h1_obj = segment_sum(H_h1h1 - S_h1h1)            # (J, 6, 6)
    g_h1_obj = segment_sum(g_h1 - gs_h1)
    S_x0h1_obj = segment_sum(S_x0h1)

    S0, S1 = (_slot_index(F, J, f, dev) for f in range(2))   # H_{:,0}, H_{:,1}
    _place_blocks(M, g, S1, S1, H_h1h1_obj, g_h1_obj)
    cross = torch.zeros(lead + (6, D), dtype=dtype, device=dev)
    cross[..., S1.reshape(-1)] = (-S_x0h1_obj).transpose(-3, -2).reshape(lead + (6, 6 * J))
    M[..., :6, :] += cross
    M[..., :, :6] += cross.mT

    # ---- odometry (0, 1) ---------------------------------------------------
    if cfg.use_vo_factor:
        _odometry_01(state, cfg, M, g, sig, pass_r=False)

    # ---- smoothing (H_{j,0}, H_{j,1}) --------------------------------------
    if cfg.use_smoothing_factor:
        sm_mask = (state.H_valid[..., 0] & state.H_valid[..., 1]).to(dtype)
        H0, H1 = state.H[..., 0, :, :], state.H[..., 1, :, :]
        eye4 = torch.eye(4, dtype=dtype, device=dev).expand(H0.shape)
        r_m = factors.between_residual(H0, H1, eye4)
        J_Am, J_Bm = factors.between_jacobians(H0, H1, eye4)
        w_sm = sm_mask[..., None] / sig["smooth"] ** 2   # (J, 6)
        JAw = J_Am.transpose(-1, -2) * w_sm[..., None, :]
        JBw = J_Bm.transpose(-1, -2) * w_sm[..., None, :]
        _place_blocks(M, g, S0, S0, lie.mm(JAw, J_Am), lie.einsum("...jab,...jb->...ja", JAw, r_m))
        _place_blocks(M, g, S1, S1, lie.mm(JBw, J_Bm), lie.einsum("...jab,...jb->...ja", JBw, r_m))
        _place_blocks(M, g, S0, S1, lie.mm(JAw, J_Bm))
        _place_blocks(M, g, S1, S0, lie.mm(JAw, J_Bm).transpose(-1, -2))

    # ---- gauge prior on X_0 and the previous marginal prior ---------------
    return _gauge_and_prior(state, M, g, sig, pass_r=False)


def advance(state: GraphState, cfg: BackendParams) -> GraphState:
    """WCME window advance: marginalise frame slot 0 and roll left by one."""
    M, g = _departing_information(state, cfg)
    return _eliminate_and_roll(state, cfg, M, g)


def _departing_information_hybrid(state: GraphState, cfg: BackendParams):
    """Dense (D, D) Hessian and (D,) gradient of the factors that leave the
    window with {X_0, H_{:,0}} (see the module docstring)."""
    F = state.F
    D = state.D
    lead = state.batch_shape
    dtype, dev = state.X.dtype, state.X.device
    sig = _sigmas(cfg, dtype, dev)
    J = state.J

    M = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    g = torch.zeros(lead + (D,), dtype=dtype, device=dev)

    onehot = _object_onehot(state, dtype)
    r_h, y_h, q, RH = hyb._hybrid_obs_terms(state, onehot)
    mask = hyb._obs_mask(state, onehot)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    y0 = y_h[..., 0, :]
    hat_y0 = lie.hat(y0)
    Jx = torch.cat([hat_y0, -eye3.expand(hat_y0.shape)], dim=-1)      # (Ld,3,6)
    R0 = lie.rotation(state.X[..., 0, :, :])
    RtRH = lie.einsum("...ba,...lbc->...lac", R0, RH[..., 0, :, :])
    hvar = hyb._h_is_variable(state, onehot)[..., 0].to(dtype)
    Jh = torch.cat([-lie.mm(RtRH, lie.hat(q)), RtRH], dim=-1) * hvar[..., None, None]

    # observation weights with first-order point uncertainty:
    # C_l = diag(sigma_l^2) + J_m Sigma_m J_m^T, W_l = C_l^{-1}
    if cfg.marginal_point_uncertainty:
        iw_full = mask.to(dtype)[..., None] / (state.d_sig ** 2)
        RtRH_all = lie.einsum("...fba,...lfbc->...lfac", lie.rotation(state.X), RH)
        Lj_R = lie.einsum("...lj,...jab->...lab", onehot, lie.rotation(state.L_e))
        assigned = torch.sum(onehot, dim=-1) > 0.5
        Lj_R = torch.where(assigned[..., None, None], Lj_R, eye3)
        Jm_all = lie.einsum("...lfab,...lbc->...lfac", RtRH_all, Lj_R)
        Hpp = lie.einsum("...lfba,...lfb,...lfbc->...lac", Jm_all, iw_full, Jm_all) + _EPS_REG * eye3
        Sigma_m = inv3(Hpp)                                              # (Ld,3,3)
        Jm0 = Jm_all[..., 0, :, :]
        C = (state.d_sig[..., 0, :] ** 2)[..., :, None] * eye3 + lie.mm(
            lie.mm(Jm0, Sigma_m), Jm0.transpose(-1, -2)
        )
        W = inv3(C) * mask[..., 0].to(dtype)[..., None, None]
    else:
        W = (mask[..., 0].to(dtype)[..., None] / (state.d_sig[..., 0, :] ** 2))[..., None] * eye3

    r0 = r_h[..., 0, :]
    H_xx = lie.einsum("...lba,...lbc,...lcd->...ad", Jx, W, Jx)
    g_x = lie.einsum("...lba,...lbc,...lc->...a", Jx, W, r0)
    H_hh = lie.einsum("...lba,...lbc,...lcd->...lad", Jh, W, Jh)
    g_h = lie.einsum("...lba,...lbc,...lc->...la", Jh, W, r0)
    H_xh = lie.einsum("...lba,...lbc,...lcd->...lad", Jx, W, Jh)
    H_hh_obj = lie.einsum("...lac,...lj->...jac", H_hh, onehot)
    g_h_obj = lie.einsum("...la,...lj->...ja", g_h, onehot)
    H_xh_obj = lie.einsum("...lac,...lj->...jac", H_xh, onehot)

    M[..., :6, :6] += H_xx
    g[..., :6] += g_x
    S_f = [_slot_index(F, J, f, dev) for f in range(3)]      # H_{:,0/1/2}
    _place_blocks(M, g, S_f[0], S_f[0], H_hh_obj, g_h_obj)
    cross = torch.zeros(lead + (6, D), dtype=dtype, device=dev)
    cross[..., S_f[0].reshape(-1)] = H_xh_obj.transpose(-3, -2).reshape(lead + (6, 6 * J))
    M[..., :6, :] += cross
    M[..., :, :6] += cross.mT

    # straddling constant-motion ternary: the factor at f=2 couples
    # (H_0, H_1, H_2)
    if cfg.use_smoothing_factor:
        r_sm, J_A, J_B, J_C = hyb._smooth_triple_terms(state)
        sm_w = hyb._smooth_triple_mask(state, cfg)[..., 2].to(dtype)[..., None] / (sig["smooth"] ** 2)
        rA = r_sm[..., 2, :]
        Js = (J_A[..., 2, :, :], J_B[..., 2, :, :], J_C[..., 2, :, :])
        Jws = tuple(Jk.transpose(-1, -2) * sm_w[..., None, :] for Jk in Js)
        for a in range(3):
            _place_blocks(M, g, S_f[a], S_f[a], lie.mm(Jws[a], Js[a]),
                          lie.einsum("...jab,...jb->...ja", Jws[a], rA))
            for b in range(3):
                if a != b:
                    _place_blocks(M, g, S_f[a], S_f[b], lie.mm(Jws[a], Js[b]))

    # odometry (0, 1), gauge prior, previous marginal prior
    if cfg.use_vo_factor:
        _odometry_01(state, cfg, M, g, sig, pass_r=True)
    return _gauge_and_prior(state, M, g, sig)


_ADVANCE_INDICES = {}


def _advance_indices(F: int, J: int, device):
    """(perm [departing; keep], new_cols, keep_cols, nd) of an advance,
    built once per window shape and device: copying them from the host on
    every advance would cost a host sync each."""
    key = (F, J, torch.device(device))
    if key not in _ADVANCE_INDICES:
        D = 6 * F + 6 * J * F
        dep = _departing_indices(F, J)
        nd = dep.shape[0]
        keep = np.setdiff1d(np.arange(D), dep)
        # keep-space column feeding each new-layout column
        old_of_new = _remaining_old_for_new(F, J)
        keep_pos = -np.ones(D, np.int64)
        keep_pos[keep] = np.arange(D - nd)
        rows = np.nonzero(old_of_new >= 0)[0]
        cols = keep_pos[old_of_new[rows]]
        ok = cols >= 0
        _ADVANCE_INDICES[key] = tuple(
            torch.as_tensor(a, device=device) for a in (np.concatenate([dep, keep]), rows[ok], cols[ok])
        ) + (nd,)
    return _ADVANCE_INDICES[key]


def _departing_indices(F: int, J: int):
    """Tangent indices of {X_0, H_{:,0}} in the old layout (static numpy)."""
    idx = [np.arange(6)]
    for j in range(J):
        o = 6 * F + 6 * (j * F)
        idx.append(np.arange(o, o + 6))
    return np.concatenate(idx)


def _remaining_old_for_new(F: int, J: int):
    """Old tangent index feeding each new tangent index; -1 for the fresh
    last slots (static numpy)."""
    out = -np.ones((6 * F + 6 * J * F,), np.int64)
    for f in range(F - 1):
        out[6 * f: 6 * f + 6] = np.arange(6 * (f + 1), 6 * (f + 1) + 6)
    off0 = 6 * F
    for j in range(J):
        for f in range(F - 1):
            new_o = off0 + 6 * (j * F + f)
            old_o = off0 + 6 * (j * F + f + 1)
            out[new_o: new_o + 6] = np.arange(old_o, old_o + 6)
    return out


def _chol_sqrt(L_full, g_perm, nd):
    """Marginal square root from the full factor: Schur(M_dd) = L22 L22^T."""
    L11, L21, L22 = L_full[..., :nd, :nd], L_full[..., nd:, :nd], L_full[..., nd:, nd:]
    b1 = torch.linalg.solve_triangular(L11, g_perm[..., :nd, None], upper=False)
    b0 = torch.linalg.solve_triangular(L22, g_perm[..., nd:, None] - L21 @ b1, upper=False)
    return L22.mT, b0[..., 0]


def _eigh_sqrt(M_perm, g_perm, nd):
    """Rare path: PSD-projected eigendecomposition of the explicit Schur
    complement, for a window whose full factorisation broke down."""
    L_dd, info = torch.linalg.cholesky_ex(M_perm[..., :nd, :nd])     # _EPS_REG already added
    L_dd = torch.where(_per_seq(info == 0, 2), L_dd, torch.nan)
    M_dk = M_perm[..., :nd, nd:]
    rhs = torch.cat([M_dk, g_perm[..., :nd, None]], dim=-1)
    sol = torch.cholesky_solve(rhs, L_dd, upper=False)
    H_keep = M_perm[..., nd:, nd:] - M_dk.mT @ sol[..., :, :-1]
    g_mk = g_perm[..., nd:] - lie.mv(M_dk.mT, sol[..., :, -1])
    H_keep = 0.5 * (H_keep + H_keep.mT)
    w_eig, V = torch.linalg.eigh(H_keep)
    floor = 1e-8 * torch.clamp(torch.amax(w_eig, dim=-1, keepdim=True), min=1.0)
    informative = w_eig > floor
    w_cl = torch.where(informative, w_eig, floor)
    Lp = torch.sqrt(w_cl)[..., :, None] * V.mT                # Lp^T Lp = H_psd
    bp = torch.where(informative, lie.mv(V.mT, g_mk) / torch.sqrt(w_cl), 0.0)
    return Lp, bp


def _eliminate_and_roll(state: GraphState, cfg: BackendParams, M, g) -> GraphState:
    """Eliminate {X_0, H_{:,0}}, re-index the prior to the rolled layout and
    roll every frame-indexed table."""
    F, J = state.F, state.J
    D = state.D
    lead = state.batch_shape
    dtype, dev = state.X.dtype, state.X.device

    # f32 hygiene: the assembly rounds differently above and below the
    # diagonal; symmetrise before factorising
    M = 0.5 * (M + M.mT)

    perm, new_cols, keep_cols, nd = _advance_indices(F, J, dev)
    M_perm = M[..., perm, :][..., perm]                        # [departing; keep]
    g_perm = g[..., perm]

    # elimination jitter on the departing block; a tiny relative floor on
    # dead (structurally unused) directions only
    diag0 = torch.diagonal(M_perm, dim1=-2, dim2=-1)
    max_d = torch.clamp(torch.amax(diag0, dim=-1, keepdim=True), min=1.0)
    dead = diag0 <= 1e-10 * max_d
    reg = torch.where(dead, 1e-6 * max_d, 0.0) + torch.where(
        torch.arange(D, device=dev) < nd, _EPS_REG, 0.0
    )
    M_perm = M_perm + torch.diag_embed(reg)

    # f32-safe marginalisation without an explicit Schur complement: factor
    # the whole equilibrated matrix once; Schur(M_dd) == L22 L22^T (the
    # explicit subtraction cancels into indefiniteness in f32,
    # window.py:452-479). A breakdown takes the eigh path, decided by one
    # host read of every sequence's factorisation status (one sequence
    # goes as a batch of one).
    s_eq = torch.sqrt(torch.diagonal(M_perm, dim1=-2, dim2=-1))
    Mn = M_perm / (s_eq[..., :, None] * s_eq[..., None, :])
    Mn = Mn + 1e-5 * torch.eye(D, dtype=dtype, device=dev)
    Ln, info = torch.linalg.cholesky_ex(Mn)
    args = (M_perm, g_perm, s_eq, Ln, info)
    L_red, b_red = _marginal_sqrt(*(args if lead else (x[None] for x in args)), nd)
    if not lead:
        L_red, b_red = L_red[0], b_red[0]

    # rows stay in keep-space (padded with nd zero rows to (D, D)); columns
    # map keep -> new layout
    prior_L = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    prior_L[..., : D - nd, new_cols] = L_red[..., :, keep_cols]
    prior_b = torch.cat([b_red, b_red.new_zeros(lead + (nd,))], dim=-1)

    def roll(x, axis, last=None):
        # drop slot 0 along `axis`; the freed last slot takes zeros or `last`
        n = x.shape[axis]
        tail = torch.zeros_like(x.narrow(axis, 0, 1)) if last is None else last
        return torch.cat([x.narrow(axis, 1, n - 1), tail], dim=axis)

    X = roll(state.X, -3, state.X[..., -1:, :, :])
    H = roll(state.H, -3, state.H[..., -1:, :, :])
    md = roll(state.md, -2, state.md[..., -1:, :] * 0)
    return dataclasses.replace(
        state,
        X=X,
        H=H,
        md=md,
        frame_ids=roll(state.frame_ids, -1, state.frame_ids.new_full(lead + (1,), -1)),
        num_frames=state.num_frames - 1,
        H_valid=roll(state.H_valid, -1),
        s_z=roll(state.s_z, -3),
        s_valid=roll(state.s_valid, -2),
        d_z=roll(state.d_z, -2),
        d_valid=roll(state.d_valid, -1),
        s_sig=roll(state.s_sig, -3),
        d_sig=roll(state.d_sig, -2),
        odom=roll(state.odom, -3, state.odom[..., -1:, :, :]),
        odom_valid=roll(state.odom_valid, -1),
        kf_slot=torch.clamp(state.kf_slot - 1, min=-1),
        prior_L=prior_L,
        prior_b=prior_b,
        prior_lin_X=X,
        prior_lin_H=H,
        prior_valid=torch.ones_like(state.prior_valid),
    )


def _marginal_sqrt(M_perm, g_perm, s_eq, Ln, info, nd):
    """The marginal square root of a batch of windows: one host read of
    every sequence's factorisation status; the Cholesky route for all, and
    the eigh route for the sequences whose factorisation broke down only,
    gathered without a further read and merged back per sequence."""
    ok = (info == 0) & torch.isfinite(Ln).flatten(-2).all(-1)
    ok_host = ok.tolist()
    L_red, b_red = _chol_sqrt(s_eq[..., :, None] * Ln, g_perm, nd)
    n_bad = ok_host.count(False)
    count("advance.lanes", len(ok_host))
    count("advance.eigh_lanes", n_bad)
    if n_bad:
        with span("backend.advance.eigh"):
            # the failed sequences first (a stable sort keeps their order)
            bad = torch.argsort(ok.to(torch.int8), stable=True)[:n_bad]
            L_eig, b_eig = _eigh_sqrt(M_perm[bad], g_perm[bad], nd)
            L_red = L_red.index_copy(0, bad, L_eig)
            b_red = b_red.index_copy(0, bad, b_eig)
    return L_red, b_red


def advance_hybrid(state: GraphState, cfg: BackendParams) -> GraphState:
    """Hybrid-formulation window advance (marginalise + roll), then slot
    recycling: an object slot with no in-window motion variable, no
    in-window keyframe and no live tracklet is freed and re-opened. The
    reference's design notes (window.py:560-589) say why there is no
    keyframe re-anchoring here."""
    M, g = _departing_information_hybrid(state, cfg)
    state = _eliminate_and_roll(state, cfg, M, g)
    J = state.J
    obs_any = torch.any(state.d_valid, dim=-1).to(torch.int32)
    seg = torch.where(state.d_obj >= 0, state.d_obj, J).long()  # J: dump slot
    ref = torch.zeros(state.batch_shape + (J + 1,), dtype=torch.int32, device=obs_any.device)
    ref = ref.scatter_add_(-1, seg, obs_any)[..., :J] > 0
    live = torch.any(state.H_valid, dim=-1) | (state.kf_valid & (state.kf_slot >= 0)) | ref
    free = (state.obj_ids > 0) & ~live
    return dataclasses.replace(
        state,
        obj_ids=torch.where(free, -1, state.obj_ids).to(torch.int32),
        kf_valid=state.kf_valid & ~free,
        kf_slot=torch.where(free, -1, state.kf_slot).to(torch.int32),
        slot_open=state.slot_open | free,
    )


# ---------------------------------------------------------------------------
# WCPE-formulation advance
# ---------------------------------------------------------------------------

def _departing_information_wcpe(state: GraphState, cfg: BackendParams):
    """Departing-factor information of the world-centric pose formulation:
    the slot-(0, 1) motion-pose factors (points held fixed) give a coupled
    (L_0, L_1) block per object; plus odometry (0, 1), the gauge prior and
    the previous marginal prior."""
    F, J = state.F, state.J
    D = state.D
    dtype, dev = state.X.dtype, state.X.device
    sig = _sigmas(cfg, dtype, dev)

    lead = state.batch_shape
    M = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    g = torch.zeros(lead + (D,), dtype=dtype, device=dev)

    onehot = _object_onehot(state, dtype)
    r_t, _, J_L = wp._pose_chain_terms(state, onehot)
    mask = wp._pose_chain_mask(state, onehot)
    w = mask[..., 1].to(dtype) / (sig["ternary"] ** 2)        # the factor at f = 1

    JL1 = J_L[..., 1, :, :]                                   # (Ld, 3, 6)
    r1 = r_t[..., 1, :]
    H11 = lie.einsum("...lba,...l,...lbc->...lac", JL1, w, JL1)           # (Ld, 6, 6)
    g1 = lie.einsum("...lba,...l,...lb->...la", JL1, w, r1)
    H11_obj = lie.einsum("...lac,...lj->...jac", H11, onehot)
    g1_obj = lie.einsum("...la,...lj->...ja", g1, onehot)

    # J_{L_0} = -J_{L_1}: blocks (0,0) = H, (1,1) = H, (0,1) = (1,0) = -H
    S0, S1 = (_slot_index(F, J, f, dev) for f in range(2))
    _place_blocks(M, g, S0, S0, H11_obj, -g1_obj)
    _place_blocks(M, g, S1, S1, H11_obj, g1_obj)
    _place_blocks(M, g, S0, S1, -H11_obj)
    _place_blocks(M, g, S1, S0, -H11_obj)

    if cfg.use_vo_factor:
        _odometry_01(state, cfg, M, g, sig, pass_r=True)
    return _gauge_and_prior(state, M, g, sig)


def advance_wcpe(state: GraphState, cfg: BackendParams) -> GraphState:
    """WCPE window advance (marginalise + roll)."""
    M, g = _departing_information_wcpe(state, cfg)
    return _eliminate_and_roll(state, cfg, M, g)
