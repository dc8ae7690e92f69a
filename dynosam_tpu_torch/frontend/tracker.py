"""Dense-flow feature tracker over fixed-capacity track tables
(port of dynosam_tpu/frontend/tracker.py, provided-flow mode).

The provided-flow / provided-mask branch of `track_frame` is ported with its
detection (Shi-Tomasi response + per-cell argmax), spread dynamic sampling,
requiresSampling IoU and object-slot bookkeeping. The KLT branch, ByteTrack
relabelling and CLAHE are not ported: asking for them raises
NotImplementedError.

The corner response goes through `ops/cuda/shi_tomasi.py::shi_tomasi_response`
when `tracker.use_pallas_kernels` is set (the CUDA kernel for a CUDA tensor,
its plain version for a CPU tensor).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dynosam_tpu.config import FrontendParams, TrackerParams
from dynosam_tpu_torch.frontend.types import first_true
from dynosam_tpu_torch.ops import interp
from dynosam_tpu_torch.ops.cuda.shi_tomasi import (
    shi_tomasi_response as shi_tomasi_response_kernel,
    shi_tomasi_response_reference as shi_tomasi_response,
)

_INT32_MAX = 2**31 - 1


@dataclass
class TrackerState:
    # static features
    s_uv: torch.Tensor        # (Ns, 2)
    s_depth: torch.Tensor     # (Ns,)
    s_tid: torch.Tensor       # (Ns,) int32, -1 = free slot
    s_age: torch.Tensor       # (Ns,) int32
    s_valid: torch.Tensor     # (Ns,) bool
    # dynamic features
    d_uv: torch.Tensor        # (Nd, 2)
    d_depth: torch.Tensor     # (Nd,)
    d_tid: torch.Tensor       # (Nd,) int32
    d_oid: torch.Tensor       # (Nd,) int32 object label from the mask
    d_age: torch.Tensor       # (Nd,) int32
    d_valid: torch.Tensor     # (Nd,) bool
    # object slots
    obj_ids: torch.Tensor       # (J,) int32, -1 free
    obj_resampled: torch.Tensor # (J,) bool
    obj_mask_iou: torch.Tensor  # (J,) float
    obj_det_area: torch.Tensor  # (J,) float
    next_tid: torch.Tensor      # () int32 tracklet id counter


def empty_tracker_state(params: FrontendParams, device, dtype=torch.float32) -> TrackerState:
    ns = params.tracker.max_features_per_frame
    nd = params.tracker.max_dynamic_features_per_frame
    j = params.max_objects

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    return TrackerState(
        s_uv=full((ns, 2), 0.0, dtype),
        s_depth=full((ns,), 0.0, dtype),
        s_tid=full((ns,), -1, torch.int32),
        s_age=full((ns,), 0, torch.int32),
        s_valid=full((ns,), False, torch.bool),
        d_uv=full((nd, 2), 0.0, dtype),
        d_depth=full((nd,), 0.0, dtype),
        d_tid=full((nd,), -1, torch.int32),
        d_oid=full((nd,), 0, torch.int32),
        d_age=full((nd,), 0, torch.int32),
        d_valid=full((nd,), False, torch.bool),
        obj_ids=full((j,), -1, torch.int32),
        obj_resampled=full((j,), False, torch.bool),
        obj_mask_iou=full((j,), 1.0, dtype),
        obj_det_area=full((j,), 1e9, dtype),
        next_tid=full((), 0, torch.int32),
    )


# ---------------------------------------------------------------------------
# Detection primitives
# ---------------------------------------------------------------------------

def _cell_reduce(score, cell):
    """Per-cell max + argmax pixel coords (first index on ties).
    score (H, W) -> best, u, v each (H//cell * W//cell,)."""
    H, W = score.shape
    gh, gw = H // cell, W // cell
    s = score[: gh * cell, : gw * cell].reshape(gh, cell, gw, cell)
    s = s.permute(0, 2, 1, 3).reshape(gh, gw, cell * cell)
    best = torch.amax(s, dim=-1)
    arg = torch.argmax(s, dim=-1)
    dy, dx = arg // cell, arg % cell
    dev = score.device
    vs = torch.arange(gh, device=dev)[:, None] * cell + dy
    us = torch.arange(gw, device=dev)[None, :] * cell + dx
    return best.reshape(-1), us.reshape(-1).to(score.dtype), vs.reshape(-1).to(score.dtype)


def _occupancy(uv, valid, cell, gh, gw):
    """Grid cells holding a valid feature -> (gh*gw,) bool. Invalid rows
    scatter into a dump slot that is sliced off (the reference drops them)."""
    ui = torch.clamp(torch.div(uv[:, 0], cell, rounding_mode="floor").long(), 0, gw - 1)
    vi = torch.clamp(torch.div(uv[:, 1], cell, rounding_mode="floor").long(), 0, gh - 1)
    flat = torch.where(valid, vi * gw + ui, gh * gw)
    occ = torch.zeros((gh * gw + 1,), dtype=torch.bool, device=uv.device)
    occ[flat] = True
    return occ[: gh * gw]


def _fill_free_slots(slot_tid, slot_valid, cand_score, cand_ok, max_new):
    """Candidate index per slot (or -1): free slots take the candidates
    ranked by score (stable order, as jnp.argsort)."""
    score = torch.where(cand_ok, cand_score, -torch.inf)
    order = torch.argsort(-score, stable=True)
    n_cand = order.shape[0]
    cand_rank_ok = torch.arange(n_cand, device=order.device) < torch.clamp(
        torch.sum(cand_ok), max=max_new
    )
    free = ~slot_valid
    free_rank = torch.cumsum(free, 0) - 1
    take = torch.where(free, free_rank, n_cand)
    take_ok = free & (free_rank < torch.sum(cand_rank_ok))
    cand_idx = order[torch.clamp(take, 0, n_cand - 1)]
    return torch.where(take_ok, cand_idx, -1)


# ---------------------------------------------------------------------------
# Main per-frame step
# ---------------------------------------------------------------------------

def check_supported(tp: TrackerParams):
    """Raise NotImplementedError for the tracker branches this port lacks."""
    if not tp.prefer_provided_optical_flow:
        raise NotImplementedError("KLT tracking (prefer_provided_optical_flow=False) is not ported")
    if not tp.prefer_provided_object_detection:
        raise NotImplementedError("ByteTrack relabelling (prefer_provided_object_detection=False) is not ported")


def track_frame(
    state: TrackerState,
    gray,                 # (H, W) float32 grayscale of frame k
    depth,                # (H, W) float metric depth at k
    flow,                 # (H, W, 2) float flow k-1 -> k on k-1 pixels
    mask,                 # (H, W) int32 instance labels at k
    params: FrontendParams,
    first_frame,          # () bool tensor
) -> TrackerState:
    """One tracking step (provided-flow mode). See the reference docstring
    for the slot correspondence contract."""
    tp = params.tracker
    check_supported(tp)
    H, W = gray.shape
    dtype = gray.dtype
    dev = gray.device
    border_u, border_v = tp.shrink_col, tp.shrink_row
    not_first = ~first_frame

    def in_bounds(uv):
        return (
            (uv[:, 0] >= border_u)
            & (uv[:, 0] <= W - 1 - border_u)
            & (uv[:, 1] >= border_v)
            & (uv[:, 1] <= H - 1 - border_v)
        )

    def stagger(n):
        if tp.stagger_track_expiry:
            return torch.arange(n, device=dev) % (2 * tp.dynamic_feature_age_buffer)
        return 0

    # ======== propagate tracks by the provided dense flow =================
    s_uv = state.s_uv + interp.sample_flow(flow, state.s_uv)
    d_uv = state.d_uv + interp.sample_flow(flow, state.d_uv)

    # ======== static track validity =======================================
    s_label = interp.sample_label(mask, s_uv)
    s_depth = interp.sample_depth(depth, s_uv).to(dtype)
    s_ok = (
        state.s_valid
        & not_first
        & in_bounds(s_uv)
        & (s_label == 0)
        & (s_depth > 0)
        & (s_depth < params.max_background_depth)
        & (state.s_age < tp.max_feature_track_age + stagger(state.s_age.shape[0]))
    )

    # ======== dynamic track validity ======================================
    d_label = interp.sample_label(mask, d_uv)
    d_depth = interp.sample_depth(depth, d_uv).to(dtype)
    d_ok = (
        state.d_valid
        & not_first
        & in_bounds(d_uv)
        & (d_label == state.d_oid)
        & (d_label > 0)
        & (d_depth > 0)
        & (d_depth < params.max_object_depth)
        & (state.d_age < tp.max_dynamic_feature_age + stagger(state.d_age.shape[0]))
    )

    # ======== detection: static (Shi-Tomasi + grid ANMS) =================
    cell = tp.detection_cell_size
    gh, gw = H // cell, W // cell
    if tp.use_pallas_kernels:
        response = shi_tomasi_response_kernel(gray)
    else:
        response = shi_tomasi_response(gray)
    best, cu, cv = _cell_reduce(response, cell)
    cand_uv = torch.stack([cu, cv], dim=-1)
    cand_label = interp.sample_label(mask, cand_uv)
    cand_depth = interp.sample_depth(depth, cand_uv).to(dtype)
    margin = tp.object_boundary_margin
    if margin < 0:
        margin = max(1, round(H * W / (640.0 * 480.0) * (640.0 / 480.0) * 7.51))
    if margin > 0:
        interior_map = (
            (torch.roll(mask, margin, 0) == mask)
            & (torch.roll(mask, -margin, 0) == mask)
            & (torch.roll(mask, margin, 1) == mask)
            & (torch.roll(mask, -margin, 1) == mask)
        )
    else:
        interior_map = torch.ones_like(mask, dtype=torch.bool)

    def away_from_boundaries(uv):
        return interp.sample_nearest(interior_map, uv)

    occ_s = _occupancy(s_uv, s_ok, cell, gh, gw)
    cand_ok_s = (
        (best > tp.min_corner_response)
        & (cand_label == 0)
        & (cand_depth > 0)
        & (cand_depth < params.max_background_depth)
        & ~occ_s
        & away_from_boundaries(cand_uv)
        & in_bounds(cand_uv)
    )
    sup = tp.min_distance_btw_tracked_and_detected_static_features
    if sup > cell:
        sgh, sgw = max(H // sup, 1), max(W // sup, 1)
        occ_sup = _occupancy(s_uv, s_ok, sup, sgh, sgw).reshape(sgh, sgw)
        su = torch.clamp(torch.div(cand_uv[:, 0], sup, rounding_mode="floor").long(), 0, sgw - 1)
        sv = torch.clamp(torch.div(cand_uv[:, 1], sup, rounding_mode="floor").long(), 0, sgh - 1)
        cand_ok_s = cand_ok_s & ~occ_sup[sv, su]
    need_static = torch.sum(s_ok) < tp.min_features_per_frame
    ns = state.s_uv.shape[0]
    max_new_s = torch.where(need_static | first_frame, ns, 0)
    assign_s = _fill_free_slots(state.s_tid, s_ok, best, cand_ok_s, max_new_s)

    new_s = assign_s >= 0
    a_s = torch.clamp(assign_s, 0, cand_uv.shape[0] - 1)
    n_new_s = torch.cumsum(new_s, 0).to(torch.int32)
    s_uv = torch.where(new_s[:, None], cand_uv[a_s], s_uv)
    s_depth = torch.where(new_s, cand_depth[a_s], s_depth)
    s_tid = torch.where(new_s, state.next_tid + n_new_s - 1, state.s_tid)
    s_age = torch.where(new_s, 0, state.s_age + 1).to(torch.int32)
    s_valid = s_ok | new_s
    next_tid = state.next_tid + n_new_s[-1]

    # ======== detection: dynamic (grid sampling on object masks) =========
    dcell = max(tp.min_distance_btw_tracked_and_detected_dynamic_features, 4)
    dgh, dgw = H // dcell, W // dcell
    ccu = (torch.arange(dgw, dtype=dtype, device=dev)[None, :] * dcell + dcell // 2)
    ccv = (torch.arange(dgh, dtype=dtype, device=dev)[:, None] * dcell + dcell // 2)
    ccu = ccu.expand(dgh, dgw).reshape(-1)
    ccv = ccv.expand(dgh, dgw).reshape(-1)
    dcand_uv = torch.stack([ccu, ccv], dim=-1)
    dcand_label = interp.sample_label(mask, dcand_uv)
    dcand_depth = interp.sample_depth(depth, dcand_uv).to(dtype)
    occ_d = _occupancy(d_uv, d_ok, dcell, dgh, dgw)

    # ---- per-object re-sampling decision (requiresSampling) -------------
    age_buffer = max(3, tp.dynamic_feature_age_buffer)
    expiry_age = tp.max_dynamic_feature_age - age_buffer
    obj = state.obj_ids                                      # (J,)
    trk = (state.d_oid[None, :] == obj[:, None]) & d_ok[None, :]
    n_tracked = torch.sum(trk, dim=1)
    geriatric = torch.sum(trk & (state.d_age[None, :] > expiry_age), dim=1)
    many_old = geriatric > 0.8 * n_tracked
    too_few = n_tracked < tp.min_dynamic_tracks

    def _bbox(sel, uv):
        # sel (J, N) bool; uv (N, 2) -> (J, 4) [umin, vmin, umax, vmax]
        u, v = uv[None, :, 0], uv[None, :, 1]
        return torch.stack(
            [
                torch.amin(torch.where(sel, u, 1e9), dim=1),
                torch.amin(torch.where(sel, v, 1e9), dim=1),
                torch.amax(torch.where(sel, u, -1e9), dim=1),
                torch.amax(torch.where(sel, v, -1e9), dim=1),
            ],
            dim=-1,
        )

    det_sel = dcand_label[None, :] == obj[:, None]
    bb_trk = _bbox(trk, d_uv)
    bb_det = _bbox(det_sel, dcand_uv)
    ix = torch.clamp(
        torch.minimum(bb_trk[:, 2], bb_det[:, 2]) - torch.maximum(bb_trk[:, 0], bb_det[:, 0]),
        min=0.0,
    )
    iy = torch.clamp(
        torch.minimum(bb_trk[:, 3], bb_det[:, 3]) - torch.maximum(bb_trk[:, 1], bb_det[:, 1]),
        min=0.0,
    )
    inter = ix * iy

    def area(b):
        return torch.clamp(b[:, 2] - b[:, 0], min=0.0) * torch.clamp(b[:, 3] - b[:, 1], min=0.0)

    union = area(bb_trk) + area(bb_det) - inter
    iou = inter / torch.clamp(union, min=1e-6)
    small_iou = iou < tp.min_dynamic_mask_iou
    collapse_iou = iou < tp.reanchor_mask_iou
    resample = many_old | too_few | small_iou | collapse_iou | (n_tracked == 0)

    cand_match = dcand_label[None, :] == obj[:, None]        # (J, C)
    cand_known = torch.any(cand_match & (obj > 0)[:, None], dim=0)
    cand_resample = torch.any(cand_match & resample[:, None], dim=0)
    sampling_ok = ~cand_known | cand_resample

    dcand_ok = (
        (dcand_label > 0)
        & (dcand_depth > 0)
        & (dcand_depth < params.max_object_depth)
        & ~occ_d
        & sampling_ok
        & away_from_boundaries(dcand_uv)
        & in_bounds(dcand_uv)
    )
    # per-cell hash in uint32 wraparound arithmetic, computed in int64
    nc = dcand_uv.shape[0]
    cell_hash = (
        ((torch.arange(nc, dtype=torch.int64, device=dev) * 2654435761) & 0xFFFFFFFF)
        % (1 << 20)
    ).to(dtype) / (1 << 20)
    dscore = -(torch.floor(dcand_depth / 4.0) + cell_hash)
    nd = state.d_uv.shape[0]
    assign_d = _fill_free_slots(state.d_tid, d_ok, dscore, dcand_ok, nd)
    new_d = assign_d >= 0
    a_d = torch.clamp(assign_d, 0, nc - 1)
    n_new_d = torch.cumsum(new_d, 0).to(torch.int32)
    d_uv = torch.where(new_d[:, None], dcand_uv[a_d], d_uv)
    d_depth = torch.where(new_d, dcand_depth[a_d], d_depth)
    d_oid = torch.where(new_d, dcand_label[a_d], state.d_oid).to(torch.int32)
    d_tid = torch.where(new_d, next_tid + n_new_d - 1, state.d_tid)
    d_age = torch.where(new_d, 0, state.d_age + 1).to(torch.int32)
    d_valid = d_ok | new_d
    next_tid = next_tid + n_new_d[-1]

    # ======== object slot bookkeeping ====================================
    obj_ids = _update_object_slots(state.obj_ids, d_oid, d_valid)

    iou_collapse = (obj > 0) & (n_tracked > 0) & collapse_iou & not_first
    neg2 = torch.full_like(obj, -2)
    obj_resampled = (obj_ids > 0) & torch.any(
        obj_ids[:, None] == torch.where(iou_collapse, obj, neg2)[None, :], dim=1
    )
    align = obj_ids[:, None] == torch.where(obj > 0, obj, neg2)[None, :]   # (J, J)
    obj_mask_iou = torch.where(
        torch.any(align, dim=1),
        torch.sum(torch.where(align, iou[None, :], 0.0), dim=1),
        1.0,
    ).to(dtype)

    det_sel_new = dcand_label[None, :] == obj_ids[:, None]
    obj_det_area = torch.sum(det_sel_new, dim=1).to(dtype) * float(dcell * dcell)
    obj_det_area = torch.where(obj_ids > 0, obj_det_area, 0.0)

    return TrackerState(
        s_uv=s_uv,
        s_depth=s_depth,
        s_tid=s_tid.to(torch.int32),
        s_age=s_age,
        s_valid=s_valid,
        d_uv=d_uv,
        d_depth=d_depth,
        d_tid=d_tid.to(torch.int32),
        d_oid=d_oid,
        d_age=d_age,
        d_valid=d_valid,
        obj_ids=obj_ids,
        obj_resampled=obj_resampled,
        obj_mask_iou=obj_mask_iou,
        obj_det_area=obj_det_area,
        next_tid=next_tid.to(torch.int32),
    )


def _update_object_slots(obj_ids, d_oid, d_valid):
    """Stable (J,) table of object ids seen among valid tracks: vanished ids
    free their slot; each of J rounds admits the smallest unrepresented label
    into the first free slot."""
    J = obj_ids.shape[0]
    present = (obj_ids[:, None] == d_oid[None, :]) & d_valid[None, :]
    keep = torch.any(present, dim=1) & (obj_ids > 0)
    ids = torch.where(keep, obj_ids, -1).to(torch.int32)
    slot = torch.arange(J, device=obj_ids.device)
    for _ in range(J):
        known = torch.any(ids[:, None] == d_oid[None, :], dim=0)
        cand = torch.where(d_valid & (d_oid > 0) & ~known, d_oid, _INT32_MAX)
        new_id = torch.amin(cand)
        has_new = new_id != _INT32_MAX
        free = ids < 0
        first_free = first_true(free, 0)
        can = has_new & torch.any(free)
        ids = torch.where((slot == first_free) & can, new_id, ids).to(torch.int32)
    return ids
