"""Feature tracker over fixed-capacity track tables (port of
dynosam_tpu/frontend/tracker.py), and the flow advection of the previous
instance mask (`propagate_mask`).

`track_frame` propagates the tracks in either of the reference's modes: by
the provided dense flow (prefer_provided_optical_flow), or by sparse
pyramidal KLT with the forward-backward check over the static and dynamic
tracks in one batch (ops/lk.py), on a pre-equalized pair when use_clahe is
on (`_clahe_padded`; frontend_step equalizes each frame once). Then come the
validity gates, detection (Shi-Tomasi response + per-cell argmax), spread
dynamic sampling, the requiresSampling IoU and the object-slot bookkeeping,
with the ByteTrack relabelling of masks that carry no persistent ids
(prefer_provided_object_detection=False).

Detection goes through `ops/cuda/shi_tomasi.py::shi_tomasi_cell_max` when
`tracker.use_pallas_kernels` is set (the fused response + per-cell argmax
kernel for a CUDA tensor, its plain version for a CPU tensor), else through
the plain response and `_cell_reduce`. It always runs on the raw `gray`.

`track_frame` also takes a leading batch axis of sequences: a (B, H, W)
frame with a TrackerState of (B, ...) tables, in the provided-flow mode,
with provided object ids or ByteTrack's (the batched step's,
parallel/batched.py). Each operation then runs once for the batch;
detection launches the kernel's batched entry once for all B frames.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.frozen.config import FrontendParams
from portbench.frozen.frontend.types import first_true, rows
from portbench.frozen.nn import bytetrack as bt
from portbench.frozen.ops import interp, lk
from portbench.frozen.ops.clahe import clahe
from portbench.frozen.ops.cuda.shi_tomasi import (
    cell_reduce as _cell_reduce,
    shi_tomasi_cell_max,
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
    # object-level tracker for masks without persistent ids
    bt_state: bt.ByteTrackState


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
        bt_state=bt.empty_state(capacity=2 * j, device=device),
    )


# ---------------------------------------------------------------------------
# Detection primitives
# ---------------------------------------------------------------------------

def _occupancy(uv, valid, cell, gh, gw):
    """Grid cells holding a valid feature -> (..., gh*gw) bool. Invalid rows
    scatter into a dump slot that is sliced off (the reference drops them)."""
    ui = torch.clamp(torch.div(uv[..., 0], cell, rounding_mode="floor").long(), 0, gw - 1)
    vi = torch.clamp(torch.div(uv[..., 1], cell, rounding_mode="floor").long(), 0, gh - 1)
    flat = torch.where(valid, vi * gw + ui, gh * gw)
    occ = torch.zeros(flat.shape[:-1] + (gh * gw + 1,), dtype=torch.bool, device=uv.device)
    occ.scatter_(-1, flat, True)        # a scalar fill: no host value to copy
    return occ[..., : gh * gw]


def _fill_free_slots(slot_tid, slot_valid, cand_score, cand_ok, max_new):
    """Candidate index per slot (or -1): free slots take the candidates
    ranked by score (stable order, as jnp.argsort). Over the last axis;
    `max_new` is an int or a tensor of the leading shape."""
    score = torch.where(cand_ok, cand_score, -torch.inf)
    order = torch.argsort(-score, dim=-1, stable=True)
    n_cand = order.shape[-1]
    cand_rank_ok = torch.arange(n_cand, device=order.device) < torch.clamp(
        torch.sum(cand_ok, dim=-1), max=max_new
    )[..., None]
    free = ~slot_valid
    free_rank = torch.cumsum(free, -1) - 1
    take = torch.where(free, free_rank, n_cand)
    take_ok = free & (free_rank < torch.sum(cand_rank_ok, dim=-1)[..., None])
    cand_idx = torch.gather(order, -1, torch.clamp(take, 0, n_cand - 1))
    return torch.where(take_ok, cand_idx, -1)


# ---------------------------------------------------------------------------
# Main per-frame step
# ---------------------------------------------------------------------------

def _clahe_padded(gray, grid: int, clip: float):
    """CLAHE for any H, W: edge-pad to multiples of `grid`, equalize, crop."""
    H, W = gray.shape
    ph, pw = (-H) % grid, (-W) % grid
    if ph or pw:
        g = torch.nn.functional.pad(gray[None, None], (0, pw, 0, ph), mode="replicate")[0, 0]
        return clahe(g, grid=grid, clip_limit=clip)[:H, :W]
    return clahe(gray, grid=grid, clip_limit=clip)


def track_frame(
    state: TrackerState,
    gray,                 # (H, W) float32 grayscale of frame k
    depth,                # (H, W) float metric depth at k
    flow,                 # (H, W, 2) float flow k-1 -> k on k-1 pixels
    mask,                 # (H, W) int32 instance labels at k
    params: FrontendParams,
    first_frame,          # () bool tensor
    prev_gray=None,       # (H, W) grayscale of k-1, KLT mode only
    gray_lk=None,         # (H, W) CLAHE-equalized frame k for the LK pair
) -> TrackerState:
    """One tracking step. See the reference docstring for the slot
    correspondence contract. In KLT mode (prefer_provided_optical_flow
    False) the LK pair is (prev_gray, gray_lk), both equalized when
    use_clahe is on; gray_lk defaults to `gray` with CLAHE off.

    A (B, H, W) `gray` with (B, ...) state, images and `first_frame` steps
    B sequences at once (provided flow only)."""
    tp = params.tracker
    nb = gray.ndim - 2
    H, W = gray.shape[-2:]
    dtype = gray.dtype
    dev = gray.device
    border_u, border_v = tp.shrink_col, tp.shrink_row
    not_first = ~first_frame[..., None]
    if nb and not tp.prefer_provided_optical_flow:
        raise ValueError(
            "track_frame with a batch axis tracks by the provided flow: KLT needs the previous "
            "frame in the state, and the reference's batch is built without an image_shape "
            "(_init_batch), so its empty_frontend_state raises in KLT mode"
        )

    def in_bounds(uv):
        return (
            (uv[..., 0] >= border_u)
            & (uv[..., 0] <= W - 1 - border_u)
            & (uv[..., 1] >= border_v)
            & (uv[..., 1] <= H - 1 - border_v)
        )

    def stagger(n):
        if tp.stagger_track_expiry:
            return torch.arange(n, device=dev) % (2 * tp.dynamic_feature_age_buffer)
        return 0

    # ======== object-level tracking of untracked masks ===================
    # per-frame detector labels without temporal identity are relabelled by
    # ByteTrack so downstream object ids persist
    bt_state = state.bt_state
    if not tp.prefer_provided_object_detection:
        max_dets = 2 * params.max_objects
        boxes, scores, det_valid, det_labels = bt.masks_to_detections(mask, max_dets=max_dets)
        bt_state, det_ids = bt.bytetrack_step(bt_state, boxes, scores, det_valid)
        # each sequence's labels -> its own ids: a per-row scatter and gather
        remap = torch.zeros(det_ids.shape[:-1] + (max_dets + 2,), dtype=torch.int32, device=dev)
        remap.scatter_(-1, torch.clamp(det_labels, 0, max_dets + 1).long(),
                       torch.where(det_valid & (det_ids > 0), det_ids, 0).to(torch.int32))
        lab = torch.clamp(mask, 0, max_dets + 1).long()
        mask = torch.take_along_dim(remap, lab.reshape(lab.shape[:nb] + (-1,)), dim=-1).reshape(mask.shape)

    # ======== propagate tracks (provided dense flow OR sparse KLT) ========
    ns = state.s_uv.shape[-2]
    if tp.prefer_provided_optical_flow:
        s_uv = state.s_uv + interp.sample_flow(flow, state.s_uv, nb)
        d_uv = state.d_uv + interp.sample_flow(flow, state.d_uv, nb)
        s_prop_ok = d_prop_ok = True
    else:
        if prev_gray is None:
            raise ValueError(
                "prefer_provided_optical_flow=False requires prev_gray "
                "(carry it in FrontendState; see frontend_step)"
            )
        if tp.use_clahe and gray_lk is None:
            raise ValueError(
                "use_clahe=True requires gray_lk (the CLAHE-equalized current "
                "frame): the LK pair must arrive pre-equalized; frontend_step "
                "equalizes each frame once and carries the result as prev_gray"
            )
        uv1_all, ok_all = lk.lk_track(
            prev_gray,
            gray_lk if gray_lk is not None else gray,
            torch.cat([state.s_uv, state.d_uv], dim=0),
            torch.cat([state.s_valid, state.d_valid], dim=0),
            levels=tp.klt_levels,
            half=tp.klt_window_half,
            iters=tp.klt_iterations,
            min_eig=tp.klt_min_eig,
            fb_threshold=tp.klt_fb_threshold,
        )
        s_uv, d_uv = uv1_all[:ns], uv1_all[ns:]
        s_prop_ok, d_prop_ok = ok_all[:ns], ok_all[ns:]

    # ======== static track validity =======================================
    s_label = interp.sample_label(mask, s_uv, nb)
    s_depth = interp.sample_depth(depth, s_uv, nb).to(dtype)
    s_ok = (
        state.s_valid
        & s_prop_ok
        & not_first
        & in_bounds(s_uv)
        & (s_label == 0)
        & (s_depth > 0)
        & (s_depth < params.max_background_depth)
        & (state.s_age < tp.max_feature_track_age + stagger(state.s_age.shape[-1]))
    )

    # ======== dynamic track validity ======================================
    d_label = interp.sample_label(mask, d_uv, nb)
    d_depth = interp.sample_depth(depth, d_uv, nb).to(dtype)
    d_ok = (
        state.d_valid
        & d_prop_ok
        & not_first
        & in_bounds(d_uv)
        & (d_label == state.d_oid)
        & (d_label > 0)
        & (d_depth > 0)
        & (d_depth < params.max_object_depth)
        & (state.d_age < tp.max_dynamic_feature_age + stagger(state.d_age.shape[-1]))
    )

    # ======== detection: static (Shi-Tomasi + grid ANMS) =================
    cell = tp.detection_cell_size
    gh, gw = H // cell, W // cell
    if tp.use_pallas_kernels:
        best, cu, cv = shi_tomasi_cell_max(gray, cell)
    else:
        best, cu, cv = _cell_reduce(shi_tomasi_response(gray), cell)
    cand_uv = torch.stack([cu, cv], dim=-1)
    cand_label = interp.sample_label(mask, cand_uv, nb)
    cand_depth = interp.sample_depth(depth, cand_uv, nb).to(dtype)
    margin = tp.object_boundary_margin
    if margin < 0:
        margin = max(1, round(H * W / (640.0 * 480.0) * (640.0 / 480.0) * 7.51))
    if margin > 0:
        interior_map = (
            (torch.roll(mask, margin, -2) == mask)
            & (torch.roll(mask, -margin, -2) == mask)
            & (torch.roll(mask, margin, -1) == mask)
            & (torch.roll(mask, -margin, -1) == mask)
        )
    else:
        interior_map = torch.ones_like(mask, dtype=torch.bool)

    def away_from_boundaries(uv):
        return interp.sample_nearest(interior_map, uv, nb)

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
        occ_sup = _occupancy(s_uv, s_ok, sup, sgh, sgw).reshape(s_ok.shape[:-1] + (sgh, sgw))
        su = torch.clamp(torch.div(cand_uv[..., 0], sup, rounding_mode="floor").long(), 0, sgw - 1)
        sv = torch.clamp(torch.div(cand_uv[..., 1], sup, rounding_mode="floor").long(), 0, sgh - 1)
        cand_ok_s = cand_ok_s & ~occ_sup[rows(sv, nb) + (su,)]
    need_static = torch.sum(s_ok, dim=-1) < tp.min_features_per_frame
    max_new_s = torch.where(need_static | first_frame, ns, 0)
    assign_s = _fill_free_slots(state.s_tid, s_ok, best, cand_ok_s, max_new_s)

    new_s = assign_s >= 0
    a_s = torch.clamp(assign_s, 0, cand_uv.shape[-2] - 1)
    n_new_s = torch.cumsum(new_s, -1).to(torch.int32)
    s_uv = torch.where(new_s[..., None], cand_uv[rows(a_s, nb)], s_uv)
    s_depth = torch.where(new_s, cand_depth[rows(a_s, nb)], s_depth)
    s_tid = torch.where(new_s, state.next_tid[..., None] + n_new_s - 1, state.s_tid)
    s_age = torch.where(new_s, 0, state.s_age + 1).to(torch.int32)
    s_valid = s_ok | new_s
    next_tid = state.next_tid + n_new_s[..., -1]

    # ======== detection: dynamic (grid sampling on object masks) =========
    dcell = max(tp.min_distance_btw_tracked_and_detected_dynamic_features, 4)
    dgh, dgw = H // dcell, W // dcell
    ccu = (torch.arange(dgw, dtype=dtype, device=dev)[None, :] * dcell + dcell // 2)
    ccv = (torch.arange(dgh, dtype=dtype, device=dev)[:, None] * dcell + dcell // 2)
    ccu = ccu.expand(dgh, dgw).reshape(-1)
    ccv = ccv.expand(dgh, dgw).reshape(-1)
    dcand_uv = torch.stack([ccu, ccv], dim=-1)
    dcand_label = interp.sample_label(mask, dcand_uv, nb)
    dcand_depth = interp.sample_depth(depth, dcand_uv, nb).to(dtype)
    occ_d = _occupancy(d_uv, d_ok, dcell, dgh, dgw)

    # ---- per-object re-sampling decision (requiresSampling) -------------
    age_buffer = max(3, tp.dynamic_feature_age_buffer)
    expiry_age = tp.max_dynamic_feature_age - age_buffer
    obj = state.obj_ids                                      # (J,)
    trk = (state.d_oid[..., None, :] == obj[..., :, None]) & d_ok[..., None, :]
    n_tracked = torch.sum(trk, dim=-1)
    geriatric = torch.sum(trk & (state.d_age[..., None, :] > expiry_age), dim=-1)
    many_old = geriatric > 0.8 * n_tracked
    too_few = n_tracked < tp.min_dynamic_tracks

    def _bbox(sel, uv):
        # sel (J, N) bool; uv (N, 2) -> (J, 4) [umin, vmin, umax, vmax]
        u, v = uv[..., None, :, 0], uv[..., None, :, 1]
        return torch.stack(
            [
                torch.amin(torch.where(sel, u, 1e9), dim=-1),
                torch.amin(torch.where(sel, v, 1e9), dim=-1),
                torch.amax(torch.where(sel, u, -1e9), dim=-1),
                torch.amax(torch.where(sel, v, -1e9), dim=-1),
            ],
            dim=-1,
        )

    det_sel = dcand_label[..., None, :] == obj[..., :, None]
    bb_trk = _bbox(trk, d_uv)
    bb_det = _bbox(det_sel, dcand_uv)
    ix = torch.clamp(
        torch.minimum(bb_trk[..., 2], bb_det[..., 2]) - torch.maximum(bb_trk[..., 0], bb_det[..., 0]),
        min=0.0,
    )
    iy = torch.clamp(
        torch.minimum(bb_trk[..., 3], bb_det[..., 3]) - torch.maximum(bb_trk[..., 1], bb_det[..., 1]),
        min=0.0,
    )
    inter = ix * iy

    def area(b):
        return torch.clamp(b[..., 2] - b[..., 0], min=0.0) * torch.clamp(b[..., 3] - b[..., 1], min=0.0)

    union = area(bb_trk) + area(bb_det) - inter
    iou = inter / torch.clamp(union, min=1e-6)
    small_iou = iou < tp.min_dynamic_mask_iou
    collapse_iou = iou < tp.reanchor_mask_iou
    resample = many_old | too_few | small_iou | collapse_iou | (n_tracked == 0)

    cand_match = dcand_label[..., None, :] == obj[..., :, None]        # (J, C)
    cand_known = torch.any(cand_match & (obj > 0)[..., :, None], dim=-2)
    cand_resample = torch.any(cand_match & resample[..., :, None], dim=-2)
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
    nc = dcand_uv.shape[-2]
    cell_hash = (
        ((torch.arange(nc, dtype=torch.int64, device=dev) * 2654435761) & 0xFFFFFFFF)
        % (1 << 20)
    ).to(dtype) / (1 << 20)
    dscore = -(torch.floor(dcand_depth / 4.0) + cell_hash)
    nd = state.d_uv.shape[-2]
    assign_d = _fill_free_slots(state.d_tid, d_ok, dscore, dcand_ok, nd)
    new_d = assign_d >= 0
    a_d = torch.clamp(assign_d, 0, nc - 1)
    n_new_d = torch.cumsum(new_d, -1).to(torch.int32)
    # the candidate grid is shared by every sequence; its labels and depths
    # are per sequence
    d_uv = torch.where(new_d[..., None], dcand_uv[a_d], d_uv)
    d_depth = torch.where(new_d, dcand_depth[rows(a_d, nb)], d_depth)
    d_oid = torch.where(new_d, dcand_label[rows(a_d, nb)], state.d_oid).to(torch.int32)
    d_tid = torch.where(new_d, next_tid[..., None] + n_new_d - 1, state.d_tid)
    d_age = torch.where(new_d, 0, state.d_age + 1).to(torch.int32)
    d_valid = d_ok | new_d
    next_tid = next_tid + n_new_d[..., -1]

    # ======== object slot bookkeeping ====================================
    obj_ids = _update_object_slots(state.obj_ids, d_oid, d_valid)

    iou_collapse = (obj > 0) & (n_tracked > 0) & collapse_iou & not_first
    neg2 = torch.full_like(obj, -2)
    obj_resampled = (obj_ids > 0) & torch.any(
        obj_ids[..., :, None] == torch.where(iou_collapse, obj, neg2)[..., None, :], dim=-1
    )
    align = obj_ids[..., :, None] == torch.where(obj > 0, obj, neg2)[..., None, :]   # (J, J)
    obj_mask_iou = torch.where(
        torch.any(align, dim=-1),
        torch.sum(torch.where(align, iou[..., None, :], 0.0), dim=-1),
        1.0,
    ).to(dtype)

    det_sel_new = dcand_label[..., None, :] == obj_ids[..., :, None]
    obj_det_area = torch.sum(det_sel_new, dim=-1).to(dtype) * float(dcell * dcell)
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
        bt_state=bt_state,
    )


def _update_object_slots(obj_ids, d_oid, d_valid):
    """Stable (J,) table of object ids seen among valid tracks: vanished ids
    free their slot; each of J rounds admits the smallest unrepresented label
    into the first free slot. Over the last axes: (..., J) and (..., N)."""
    J = obj_ids.shape[-1]
    present = (obj_ids[..., :, None] == d_oid[..., None, :]) & d_valid[..., None, :]
    keep = torch.any(present, dim=-1) & (obj_ids > 0)
    ids = torch.where(keep, obj_ids, -1).to(torch.int32)
    slot = torch.arange(J, device=obj_ids.device)
    for _ in range(J):
        known = torch.any(ids[..., :, None] == d_oid[..., None, :], dim=-2)
        cand = torch.where(d_valid & (d_oid > 0) & ~known, d_oid, _INT32_MAX)
        new_id = torch.amin(cand, dim=-1)
        has_new = new_id != _INT32_MAX
        free = ids < 0
        first_free = first_true(free, -1)
        can = has_new & torch.any(free, dim=-1)
        ids = torch.where((slot == first_free[..., None]) & can[..., None], new_id[..., None], ids).to(torch.int32)
    return ids


def propagate_mask(prev_mask, flow):
    """Advect the previous instance mask to the current frame with dense
    flow: label(p) = prev_mask(p - flow(p)), the flow taken as locally
    constant (a gather; an exact inverse warp would need backward flow)."""
    H, W = prev_mask.shape
    u = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=flow.dtype, device=flow.device)[:, None].expand(H, W)
    src = torch.stack([u, v], dim=-1) - flow
    return interp.sample_nearest(prev_mask, src)
