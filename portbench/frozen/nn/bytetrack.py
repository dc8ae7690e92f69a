"""Batched ByteTrack: Kalman-filtered multi-object tracking over a
fixed-capacity track table (port of dynosam_tpu/nn/bytetrack.py).

Constant-velocity Kalman filters in [cx, cy, aspect, h], IoU association in
ByteTrack's two stages (high-score, then low-score detections) and a greedy
global max-IoU assignment in place of lapjv. The frontend uses it when
instance masks arrive without persistent ids
(prefer_provided_object_detection=False).

Every function also takes a leading batch axis of sequences (the batched
step, parallel/batched.py): a ByteTrackState of (B, ...) tensors with a (B,)
`next_id`, (B, D, ...) detections and (B, H, W) masks. Each sequence keeps
its own tracks and ids; every operation runs once for the batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ByteTrackParams:
    high_thresh: float = 0.6       # score above -> first association stage
    low_thresh: float = 0.1        # score above -> second stage
    match_iou: float = 0.3         # min IoU to accept a match
    new_track_thresh: float = 0.7  # min score to spawn a track
    max_time_lost: int = 30


@dataclass
class ByteTrackState:
    mean: torch.Tensor        # (T, 8) KF mean [cx, cy, a, h, vx, vy, va, vh]
    cov: torch.Tensor         # (T, 8, 8)
    track_id: torch.Tensor    # (T,) int32, -1 = free
    time_lost: torch.Tensor   # (T,) int32 frames since last match
    active: torch.Tensor      # (T,) bool
    next_id: torch.Tensor     # () int32


def empty_state(capacity: int = 32, device="cuda") -> ByteTrackState:
    return ByteTrackState(
        mean=torch.zeros((capacity, 8), device=device),
        cov=torch.eye(8, device=device).expand(capacity, 8, 8).clone(),
        track_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        time_lost=torch.zeros((capacity,), dtype=torch.int32, device=device),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        next_id=torch.ones((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Kalman filter
# ---------------------------------------------------------------------------

_STD_W_POS = 1.0 / 20
_STD_W_VEL = 1.0 / 160


def _motion_mats(dtype, device):
    F = torch.eye(8, dtype=dtype, device=device)
    F[:4, 4:] = torch.eye(4, dtype=dtype, device=device)
    Hm = torch.eye(8, dtype=dtype, device=device)[:4]
    return F, Hm


def _diag(std):
    """(..., n) standard deviations -> (..., n, n) diagonal covariance."""
    return torch.diag_embed(std * std)


def kf_initiate(xyah):
    mean = torch.cat([xyah, torch.zeros_like(xyah)], dim=-1)
    h = xyah[..., 3]
    c = torch.ones_like(h)
    std = torch.stack(
        [2 * _STD_W_POS * h, 2 * _STD_W_POS * h, 1e-2 * c,
         2 * _STD_W_POS * h, 10 * _STD_W_VEL * h, 10 * _STD_W_VEL * h,
         1e-5 * c, 10 * _STD_W_VEL * h],
        dim=-1,
    )
    return mean, _diag(std)


def kf_predict(mean, cov):
    F, _ = _motion_mats(mean.dtype, mean.device)
    h = mean[..., 3]
    c = torch.ones_like(h)
    q = torch.stack(
        [_STD_W_POS * h, _STD_W_POS * h, 1e-2 * c, _STD_W_POS * h,
         _STD_W_VEL * h, _STD_W_VEL * h, 1e-5 * c, _STD_W_VEL * h],
        dim=-1,
    )
    mean = torch.einsum("ij,...j->...i", F, mean)
    cov = torch.einsum("ij,...jk,lk->...il", F, cov, F) + _diag(q)
    return mean, cov


def kf_update(mean, cov, z_xyah):
    _, Hm = _motion_mats(mean.dtype, mean.device)
    h = mean[..., 3]
    r = torch.stack(
        [_STD_W_POS * h, _STD_W_POS * h, 1e-1 * torch.ones_like(h), _STD_W_POS * h],
        dim=-1,
    )
    S = torch.einsum("ij,...jk,lk->...il", Hm, cov, Hm) + _diag(r)
    # inv_ex: linalg.inv's error check would read the status on the host
    # every frame; S is positive definite by construction
    K = torch.einsum("...ij,kj,...kl->...il", cov, Hm, torch.linalg.inv_ex(S)[0])
    innov = z_xyah - torch.einsum("ij,...j->...i", Hm, mean)
    mean = mean + torch.einsum("...ij,...j->...i", K, innov)
    cov = cov - torch.einsum("...ij,jk,...kl->...il", K, Hm, cov)
    return mean, cov


# ---------------------------------------------------------------------------
# Boxes + IoU
# ---------------------------------------------------------------------------

def tlbr_to_xyah(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return torch.stack(
        [b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h, w / torch.clamp(h, min=1e-6), h], dim=-1
    )


def xyah_to_tlbr(s):
    w = s[..., 2] * s[..., 3]
    h = s[..., 3]
    return torch.stack(
        [s[..., 0] - 0.5 * w, s[..., 1] - 0.5 * h, s[..., 0] + 0.5 * w, s[..., 1] + 0.5 * h],
        dim=-1,
    )


def iou_matrix(a, b):
    """a: (..., T, 4) tlbr, b: (..., D, 4) tlbr -> (..., T, D)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=1e-9)


def greedy_assign(cost, row_ok, col_ok, min_iou: float, iters: int):
    """Greedy max-IoU assignment -> (row_to_col (..., T), col_to_row (..., D)).
    Each of `iters` rounds takes, per sequence, the argmax over the (T, D)
    entries (first index on ties, as jnp.argmax); a pair at or above
    `min_iou` is matched and its row and column closed, otherwise only that
    entry is closed."""
    T, D = cost.shape[-2:]
    lead = cost.shape[:-2]
    c = torch.where(row_ok[..., :, None] & col_ok[..., None, :], cost, -torch.inf)
    r2c = torch.full(lead + (T,), -1, dtype=torch.int32, device=cost.device)
    c2r = torch.full(lead + (D,), -1, dtype=torch.int32, device=cost.device)
    rows = torch.arange(T, device=cost.device)
    cols = torch.arange(D, device=cost.device)
    for _ in range(iters):
        flat_c = c.reshape(lead + (T * D,))
        flat = torch.argmax(flat_c, dim=-1, keepdim=True)
        i, j = flat // D, flat % D                                  # (..., 1)
        ok = torch.take_along_dim(flat_c, flat, dim=-1) >= min_iou
        r2c = torch.where((rows == i) & ok, j.to(torch.int32), r2c)
        c2r = torch.where((cols == j) & ok, i.to(torch.int32), c2r)
        hit_r, hit_c = (rows == i)[..., :, None], (cols == j)[..., None, :]
        c = torch.where(torch.where(ok[..., None], hit_r | hit_c, hit_r & hit_c), -torch.inf, c)
    return r2c, c2r


# ---------------------------------------------------------------------------
# Main step
# ---------------------------------------------------------------------------

def bytetrack_step(
    state: ByteTrackState,
    det_tlbr,          # (..., D, 4)
    det_score,         # (..., D)
    det_valid,         # (..., D) bool
    params: ByteTrackParams = ByteTrackParams(),
):
    """One tracking step -> (state, det_track_ids (..., D) int32, -1 = none)."""
    T = state.track_id.shape[-1]
    D = det_tlbr.shape[-2]
    dev = det_tlbr.device

    def take(x, idx):
        # per sequence, entries idx (..., K) of x along its last axis
        return torch.take_along_dim(x, idx.long(), dim=-1)

    def take_boxes(idx):
        return torch.take_along_dim(det_tlbr, idx.long()[..., None], dim=-2)

    mean, cov = kf_predict(state.mean, state.cov)
    iou = iou_matrix(xyah_to_tlbr(mean), det_tlbr)

    # stage 1: high-score detections vs all tracks
    high = det_valid & (det_score >= params.high_thresh)
    r2c1, c2r1 = greedy_assign(iou, state.active, high, params.match_iou, iters=min(T, D))
    matched_row1 = r2c1 >= 0
    # stage 2: low-score detections vs the remaining tracks
    low = det_valid & (det_score >= params.low_thresh) & (det_score < params.high_thresh)
    r2c2, c2r2 = greedy_assign(
        iou, state.active & ~matched_row1, low, params.match_iou, iters=min(T, D)
    )
    r2c = torch.where(matched_row1, r2c1, r2c2)
    matched_row = r2c >= 0
    det_of_row = torch.clamp(r2c, 0, D - 1)

    # KF update of matched tracks
    mean_u, cov_u = kf_update(mean, cov, tlbr_to_xyah(take_boxes(det_of_row)))
    mean = torch.where(matched_row[..., None], mean_u, mean)
    cov = torch.where(matched_row[..., None, None], cov_u, cov)
    time_lost = torch.where(matched_row, 0, state.time_lost + 1).to(torch.int32)
    active = state.active & (time_lost <= params.max_time_lost)

    # spawn tracks for unmatched high-score detections
    det_matched = (c2r1 >= 0) | (c2r2 >= 0)
    spawn = high & ~det_matched & (det_score >= params.new_track_thresh)
    free = ~active
    free_rank = torch.cumsum(free, -1) - 1
    spawn_rank = torch.cumsum(spawn, -1) - 1
    n_spawn = torch.sum(spawn, dim=-1, keepdim=True)
    # spawn_det_by_rank[..., q] = the q-th spawning detection of each
    # sequence; column D is the dump slot of the reference's dropped scatter
    spawn_det_by_rank = torch.full(spawn.shape[:-1] + (D + 1,), -1, dtype=torch.int64, device=dev)
    spawn_det_by_rank.scatter_(-1, torch.where(spawn, spawn_rank, D),
                               torch.arange(D, device=dev).expand(spawn.shape))
    take_row = free & (free_rank < n_spawn)
    det_idx = take(spawn_det_by_rank[..., :D], torch.clamp(free_rank, 0, D - 1))
    det_idx = torch.where(take_row, det_idx, 0)
    m0, c0 = kf_initiate(tlbr_to_xyah(take_boxes(det_idx)))
    mean = torch.where(take_row[..., None], m0, mean)
    cov = torch.where(take_row[..., None, None], c0, cov)
    next_id = state.next_id[..., None]
    new_ids = next_id + take(spawn_rank, torch.clamp(det_idx, 0, D - 1))
    track_id = torch.where(take_row, new_ids, state.track_id).to(torch.int32)
    active = active | take_row
    time_lost = torch.where(take_row, 0, time_lost).to(torch.int32)

    # per-detection ids; newly spawned detections get their fresh ids
    det_row = torch.where(c2r1 >= 0, c2r1, c2r2)
    det_ids = torch.where(det_row >= 0, take(track_id, torch.clamp(det_row, 0, T - 1)), -1)
    det_ids = torch.where(spawn, next_id + spawn_rank, det_ids).to(torch.int32)

    new_state = ByteTrackState(
        mean=mean, cov=cov, track_id=track_id, time_lost=time_lost, active=active,
        next_id=(state.next_id + n_spawn[..., 0]).to(torch.int32),
    )
    return new_state, det_ids


def masks_to_detections(mask, max_dets: int = 32):
    """Instance mask (..., H, W) -> padded (boxes tlbr (..., L, 4), scores,
    valid, labels (..., L)): label l = 1..max_dets becomes detection l-1
    with score 1.0. All labels are compared with the mask in one batched
    pass."""
    H, W = mask.shape[-2:]
    lead = mask.shape[:-2]
    dev = mask.device
    labels = torch.arange(1, max_dets + 1, dtype=torch.int32, device=dev)
    m = mask[..., None, :, :] == labels[:, None, None]          # (..., L, H, W)
    cols = torch.any(m, dim=-2)                                 # (..., L, W)
    rows = torch.any(m, dim=-1)                                 # (..., L, H)
    valid = torch.any(rows, dim=-1)
    u = torch.arange(W, dtype=torch.float32, device=dev)
    v = torch.arange(H, dtype=torch.float32, device=dev)
    big = 1e9
    x1 = torch.amin(torch.where(cols, u, big), dim=-1)
    y1 = torch.amin(torch.where(rows, v, big), dim=-1)
    x2 = torch.amax(torch.where(cols, u, -big), dim=-1)
    y2 = torch.amax(torch.where(rows, v, -big), dim=-1)
    boxes = torch.stack([x1, y1, x2 + 1, y2 + 1], dim=-1)
    boxes = torch.where(valid[..., None], boxes, 0.0)
    return (boxes, torch.ones(lead + (max_dets,), device=dev), valid,
            labels.expand(lead + (max_dets,)))
