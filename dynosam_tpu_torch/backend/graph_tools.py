"""Factor-graph analysis and export (port of dynosam_tpu/backend/graph_tools.py).

Per-factor-type error breakdowns of a window, sparsity statistics and a
sparsity-pattern image of a (reduced) Hessian, and a JSON summary of the
window's graph. The image is written with the port's own PNG encoder
(`native.write_png`), so no imaging package is needed.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from dynosam_tpu_torch import native
from dynosam_tpu_torch.backend import factors
from dynosam_tpu_torch.backend import hybrid as H
from dynosam_tpu_torch.backend import solver as S
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.config import BackendParams


def error_breakdown(
    state: GraphState, cfg: BackendParams, hybrid: bool = False
) -> Dict[str, Dict[str, float]]:
    """Per-factor-type robust chi2 and active-factor counts of one window
    (no batch axis): static_point, dynamic_point (WCME's point-to-point or
    the hybrid observation), ternary (WCME), smoothing, odometry,
    gauge_prior and marginal_prior."""
    dtype, dev = state.X.dtype, state.X.device
    sig = S._sigmas(cfg, dtype, dev)
    onehot = S._object_onehot(state, dtype)
    out: Dict[str, Dict[str, float]] = {}
    gate = S._static_gate(state, cfg)
    m_s = state.s_valid & gate[None, :]
    r_s, _ = S._static_residuals(state)
    if hybrid:
        e_s = torch.linalg.norm(r_s, dim=-1) / sig["static_pt"]
        out["static_point"] = _entry(e_s, m_s)

        r_h, _, _, _ = H._hybrid_obs_terms(state, onehot)
        e_h = torch.linalg.norm(r_h / state.d_sig, dim=-1)
        out["dynamic_point"] = _entry(e_h, H._obs_mask(state, onehot))

        r_sm, _, _, _ = H._smooth_triple_terms(state)
        e_sm = torch.linalg.norm(r_sm / sig["smooth"], dim=-1)
        out["smoothing"] = _entry(e_sm, H._smooth_triple_mask(state, cfg))
    else:
        e_s = torch.linalg.norm(r_s / state.s_sig, dim=-1)
        out["static_point"] = _entry(e_s, m_s)

        r_d, _ = S._dyn_ptp_residuals(state)
        e_d = torch.linalg.norm(r_d / state.d_sig, dim=-1)
        out["dynamic_point"] = _entry(e_d, state.d_valid & (state.d_obj >= 0)[:, None])

        r_t, _, _ = S._ternary_terms(state, onehot)
        e_t = torch.linalg.norm(r_t, dim=-1) / sig["ternary"]
        out["ternary"] = _entry(e_t, S._ternary_mask(state, onehot))

        r_sm = S._smooth_terms(state)[0]
        e_sm = torch.linalg.norm(r_sm / sig["smooth"], dim=-1)
        out["smoothing"] = _entry(e_sm, S._smooth_mask(state, cfg))

    X_prev = S._shift_prev(state.X, -3)
    r_o = factors.between_residual(X_prev, state.X, state.odom)
    e_o = torch.linalg.norm(r_o / sig["odom"], dim=-1)
    out["odometry"] = _entry(e_o, S._odom_mask(state))

    gauge_on = float(~state.prior_valid)
    r_p = factors.prior_residual(state.X[0], state.X0_prior) / sig["prior0"]
    out["gauge_prior"] = {"count": gauge_on, "chi2": gauge_on * float(torch.sum(0.5 * r_p * r_p))}
    prior_on = float(state.prior_valid)
    r_mp = state.prior_b + state.prior_L @ S._prior_dx(state)
    out["marginal_prior"] = {"count": prior_on, "chi2": prior_on * float(torch.sum(0.5 * r_mp * r_mp))}
    return out


def _entry(e, mask) -> Dict[str, float]:
    return {
        "count": float(torch.sum(mask)),
        "chi2": float(torch.sum(torch.where(mask, 0.5 * e * e, 0.0))),
    }


def sparsity_stats(S_mat, tol: float = 0.0) -> Dict[str, float]:
    """Dimensions, non-zero count and fill ratio of a (reduced) Hessian or
    information matrix (a tensor or an array)."""
    A = _host(S_mat)
    nnz = int(np.sum(np.abs(A) > tol))
    return {"rows": int(A.shape[0]), "cols": int(A.shape[1]), "nnz": nnz, "fill": nnz / max(A.size, 1)}


def save_sparsity_png(S_mat, path: str, tol: float = 0.0) -> None:
    """Sparsity-pattern image: black where |S| > tol, white elsewhere, one
    pixel per entry (8-bit greyscale PNG)."""
    A = (np.abs(_host(S_mat)) > tol).astype(np.uint8) * 255
    native.write_png(path, 255 - A)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def export_graph_json(
    state: GraphState, cfg: BackendParams, path: str, hybrid: bool = False
) -> dict:
    """The window's graph as JSON: frames and their ids, the static
    landmarks observed, per object its tracklets and observations, and per
    factor type its count and chi2 (the reference's keys)."""
    n = int(state.num_frames)
    obj_ids = _host(state.obj_ids)
    d_obj = _host(state.d_obj)
    d_valid = _host(state.d_valid)
    per_object = {}
    for j, oid in enumerate(obj_ids):
        if oid <= 0:
            continue
        sel = d_obj == j
        per_object[int(oid)] = {"tracklets": int(sel.sum()), "observations": int(d_valid[sel].sum())}
    breakdown = error_breakdown(state, cfg, hybrid)
    doc = {
        "frames": n,
        "frame_ids": [int(v) for v in _host(state.frame_ids)[:n]],
        "static_landmarks": int(_host(state.s_valid).any(axis=0).sum()),
        "objects": per_object,
        "factors": {k: v["count"] for k, v in breakdown.items()},
        "errors": {k: v["chi2"] for k, v in breakdown.items()},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc
