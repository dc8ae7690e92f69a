"""Windowed factor-graph state: fixed-capacity device tables + bookkeeping
(port of the hybrid path of dynosam_tpu/backend/graph.py).

Landmark slots are 1:1 with frontend track-table rows, frame slots
0..F-1 hold a contiguous window, object slots are allocated by first
appearance. `num_frames` is a host integer: the window fill level decides
which slot a packet goes to and when the window must advance, and keeping
it on the host turns every per-slot update into a static slice.

Scatters that the reference drops for out-of-range indices write into an
extra dump row here, which is sliced off.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from dynosam_tpu.config import BackendParams
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.frontend.types import VisionPacket, first_true
from dynosam_tpu_torch.utils import lie


@dataclass
class GraphState:
    # ---- variables (estimates) -------------------------------------------
    X: torch.Tensor           # (F, 4, 4) camera poses, world_from_cam
    H: torch.Tensor           # (J, F, 4, 4) keyframed world motions ^W_eH_f
    ms: torch.Tensor          # (Ls, 3) static landmarks, world
    md: torch.Tensor          # (Ld, F, 3) dynamic landmark positions per frame
    # ---- structure --------------------------------------------------------
    frame_ids: torch.Tensor   # (F,) int32 global frame id per slot, -1 unused
    num_frames: int           # filled frame slots (host)
    obj_ids: torch.Tensor     # (J,) int32 object id per slot, -1 unused
    H_valid: torch.Tensor     # (J, F) bool — motion variable exists at slot
    s_tid: torch.Tensor       # (Ls,) int32
    s_z: torch.Tensor         # (F, Ls, 3) camera-frame measurements
    s_valid: torch.Tensor     # (F, Ls) bool
    d_tid: torch.Tensor       # (Ld,) int32
    d_obj: torch.Tensor       # (Ld,) int32 object slot per tracklet, -1 unused
    d_z: torch.Tensor         # (Ld, F, 3)
    d_valid: torch.Tensor     # (Ld, F) bool
    s_sig: torch.Tensor       # (F, Ls, 3) noise sigmas [lat, lat, depth]
    d_sig: torch.Tensor       # (Ld, F, 3)
    odom: torch.Tensor        # (F, 4, 4) measured T_{k-1,k}
    odom_valid: torch.Tensor  # (F,) bool
    X0_prior: torch.Tensor    # (4, 4) gauge prior on the oldest pose slot
    # ---- hybrid (object-centric keyframed) formulation --------------------
    m_hyb: torch.Tensor       # (Ld, 3) point in the embedded object frame
    L_e: torch.Tensor         # (J, 4, 4) embedded object frames
    kf_valid: torch.Tensor    # (J,) bool
    kf_slot: torch.Tensor     # (J,) int32 window slot of the keyframe
    slot_open: torch.Tensor   # (J,) bool — slot accepts matches
    # ---- linear marginal prior from slid-out frames -----------------------
    prior_L: torch.Tensor     # (D, D)
    prior_b: torch.Tensor     # (D,)
    prior_lin_X: torch.Tensor # (F, 4, 4)
    prior_lin_H: torch.Tensor # (J, F, 4, 4)
    prior_valid: torch.Tensor # () bool

    @property
    def F(self):
        return self.X.shape[0]

    @property
    def J(self):
        return self.H.shape[0]

    @property
    def Ls(self):
        return self.ms.shape[0]

    @property
    def Ld(self):
        return self.md.shape[0]

    @property
    def D(self):
        """Tangent dimension of the reduced (pose + motion) system."""
        return 6 * self.F + 6 * self.J * self.F


def empty_graph(cfg: BackendParams, device, dtype=torch.float32) -> GraphState:
    F, J = cfg.max_frames, cfg.max_objects
    Ls, Ld = cfg.max_static_landmarks, cfg.max_dynamic_landmarks
    D = 6 * F + 6 * J * F

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    def eyes(shape):
        return torch.eye(4, dtype=dtype, device=device).expand(shape + (4, 4)).clone()

    i32, b = torch.int32, torch.bool
    return GraphState(
        X=eyes((F,)),
        H=eyes((J, F)),
        ms=full((Ls, 3), 0.0),
        md=full((Ld, F, 3), 0.0),
        frame_ids=full((F,), -1, i32),
        num_frames=0,
        obj_ids=full((J,), -1, i32),
        H_valid=full((J, F), False, b),
        s_tid=full((Ls,), -1, i32),
        s_z=full((F, Ls, 3), 0.0),
        s_valid=full((F, Ls), False, b),
        d_tid=full((Ld,), -1, i32),
        d_obj=full((Ld,), -1, i32),
        d_z=full((Ld, F, 3), 0.0),
        d_valid=full((Ld, F), False, b),
        s_sig=full((F, Ls, 3), cfg.noise.static_point_noise_sigma),
        d_sig=full((Ld, F, 3), cfg.noise.dynamic_point_noise_sigma),
        odom=eyes((F,)),
        odom_valid=full((F,), False, b),
        X0_prior=eyes(()),
        m_hyb=full((Ld, 3), 0.0),
        L_e=eyes((J,)),
        kf_valid=full((J,), False, b),
        kf_slot=full((J,), -1, i32),
        slot_open=full((J,), True, b),
        prior_L=full((D, D), 0.0),
        prior_b=full((D,), 0.0),
        prior_lin_X=eyes((F,)),
        prior_lin_H=eyes((J, F)),
        prior_valid=full((), False, b),
    )


# ---------------------------------------------------------------------------
# Packet ingestion
# ---------------------------------------------------------------------------

def _match_or_allocate_objects(obj_ids, packet_obj_ids, packet_obj_valid,
                               slot_open=None):
    """Map packet object ids onto graph object slots, allocating free slots
    in order. Returns (new_obj_ids (J,), packet_slot (Jp,) int32). Closed
    slots (slot_open False) never match."""
    J = obj_ids.shape[0]
    dev = obj_ids.device
    present = packet_obj_valid & (packet_obj_ids > 0)
    eq = obj_ids[:, None] == packet_obj_ids[None, :]          # (J, Jp)
    if slot_open is not None:
        eq = eq & slot_open[:, None]
    has_match = torch.any(eq & present[None, :], dim=0)
    match_slot = first_true(eq, 0)

    free = obj_ids < 0
    free_rank = torch.cumsum(free, 0) - 1
    need = present & ~has_match
    need_rank = torch.cumsum(need, 0) - 1
    slot_idx = torch.arange(J, device=dev)
    # free_slot_by_rank[r] = index of the r-th free slot; row J is the dump
    free_slot_by_rank = torch.full((J + 1,), -1, dtype=torch.int64, device=dev)
    free_slot_by_rank[torch.where(free, free_rank, J)] = slot_idx
    alloc_slot = free_slot_by_rank[:J][torch.clamp(need_rank, 0, J - 1)]
    alloc_ok = need & (alloc_slot >= 0)

    packet_slot = torch.where(has_match, match_slot, torch.where(alloc_ok, alloc_slot, -1))
    packet_slot = torch.where(present, packet_slot, -1)

    new_obj_ids = torch.cat([obj_ids, obj_ids.new_zeros(1)])
    new_obj_ids[torch.where(alloc_ok, alloc_slot, J)] = packet_obj_ids
    return new_obj_ids[:J], packet_slot.to(torch.int32)


def _measurement_sigma(depth, base_sigma, pixel_sigma, intr, cfg):
    """Per-observation sigmas [lat, lat, z] in the camera frame (stereo /
    RGB-D range model). Returns (..., 3)."""
    if not cfg.noise.use_range_dependent_noise:
        return torch.full(depth.shape + (3,), base_sigma, dtype=depth.dtype, device=depth.device)
    z = torch.clamp(depth, min=0.0)
    cap = base_sigma * cfg.noise.max_range_sigma_scale
    lat = torch.clamp(pixel_sigma * z / intr.fx, base_sigma, cap)
    rng = torch.clamp(
        pixel_sigma * z * z / (intr.fx * max(intr.baseline, 1e-3)), base_sigma, cap
    )
    return torch.stack([lat, lat, rng], dim=-1)


def _set_row(t, index, value):
    """Copy of `t` with t[index] = value (the reference's .at[].set)."""
    out = t.clone()
    out[index] = value
    return out


def update_from_packet(
    state: GraphState,
    packet: VisionPacket,
    intr: cam.CameraIntrinsics,
    cfg: BackendParams,
) -> GraphState:
    """Ingest one frontend packet into frame slot `state.num_frames`, which
    the caller has made free."""
    f = state.num_frames
    if f >= state.F:
        raise ValueError(f"window full ({f} of {state.F} slots): advance it first")
    dtype = state.X.dtype
    dev = state.X.device
    J = state.J

    # ---- frame & pose initialisation -----------------------------------
    if f > 0:
        X_init = lie.compose(state.X[f - 1], packet.odom_prev_curr)
    else:
        X_init = packet.X_world_cam
    X_init = X_init.to(dtype)
    X = _set_row(state.X, f, X_init)
    frame_ids = _set_row(state.frame_ids, f, packet.frame_id)
    odom = _set_row(state.odom, f, packet.odom_prev_curr.to(dtype))
    odom_valid = _set_row(state.odom_valid, f, packet.pose_valid & (f > 0))
    X0_prior = packet.X_world_cam.to(dtype) if f == 0 else state.X0_prior

    # ---- static landmarks ------------------------------------------------
    st = packet.static_tracks
    obs_valid = st.valid & (st.depth > 0)
    z_local = cam.backproject(st.uv, st.depth, intr).to(dtype)
    changed = st.tracklet_id != state.s_tid
    s_valid = torch.where(changed[None, :], False, state.s_valid)
    s_tid = torch.where(obs_valid, st.tracklet_id, state.s_tid)
    s_valid[f] = obs_valid
    s_z = _set_row(state.s_z, f, z_local)
    s_sig = _set_row(
        state.s_sig, f,
        _measurement_sigma(
            st.depth, cfg.noise.static_point_noise_sigma,
            cfg.noise.static_pixel_noise_sigma, intr, cfg,
        ),
    )
    z_world = lie.transform_points(X_init, z_local)
    first_obs = obs_valid & (changed | ~torch.any(state.s_valid, dim=0))
    ms = torch.where(first_obs[:, None], z_world, state.ms)

    # ---- objects ----------------------------------------------------------
    obj_ids, packet_slot = _match_or_allocate_objects(
        state.obj_ids, packet.object_ids, packet.object_valid,
        slot_open=state.slot_open,
    )
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    if cfg.init_H_with_identity:
        H_pkt = eye4.expand(packet.object_motions.shape)
    else:
        H_pkt = packet.object_motions.to(dtype)
    H_new_col = eye4.expand(J + 1, 4, 4).clone()
    ok = packet_slot >= 0
    H_new_col[torch.where(ok, packet_slot.long(), J)] = H_pkt
    H = state.H.clone()
    H[:, f] = H_new_col[:J]

    # ---- dynamic landmarks -----------------------------------------------
    dt = packet.dynamic_tracks
    d_obs_valid = dt.valid & (dt.depth > 0) & (dt.object_id > 0)
    zd_local = cam.backproject(dt.uv, dt.depth, intr).to(dtype)
    d_changed = dt.tracklet_id != state.d_tid
    d_valid = torch.where(d_changed[:, None], False, state.d_valid)
    d_tid = torch.where(d_obs_valid, dt.tracklet_id, state.d_tid)
    d_valid[:, f] = d_obs_valid
    d_z = state.d_z.clone()
    d_z[:, f] = zd_local
    d_sig = state.d_sig.clone()
    d_sig[:, f] = _measurement_sigma(
        dt.depth, cfg.noise.dynamic_point_noise_sigma,
        cfg.noise.dynamic_pixel_noise_sigma, intr, cfg,
    )
    # object slot per tracklet, over open slots only
    eq = (dt.object_id[:, None] == obj_ids[None, :]) & state.slot_open[None, :]
    d_slot_new = torch.where(torch.any(eq, dim=1), first_true(eq, 1), -1)
    d_obj = torch.where(
        d_obs_valid, d_slot_new, torch.where(d_changed, -1, state.d_obj)
    ).to(torch.int32)
    zd_world = lie.transform_points(X_init, zd_local)
    md = state.md.clone()
    md[:, f] = zd_world

    # H_{j,f} exists if object j has enough tracklets observed at f-1 and f
    H_valid = state.H_valid.clone()
    if f > 0:
        obs_pair = d_valid[:, f - 1] & d_valid[:, f]
        per_obj = (d_obj[:, None] == torch.arange(J, device=dev)[None, :]) & obs_pair[:, None]
        pair_per_obj = torch.sum(per_obj, dim=0)
        min_pairs = max(cfg.min_dynamic_observations, 1)
        H_valid[:, f] = (pair_per_obj >= min_pairs) & (obj_ids >= 0)
    else:
        H_valid[:, f] = False

    return dataclasses.replace(
        state,
        X=X, H=H, ms=ms, md=md,
        frame_ids=frame_ids,
        num_frames=f + 1,
        obj_ids=obj_ids,
        H_valid=H_valid,
        s_tid=s_tid, s_z=s_z, s_valid=s_valid,
        d_tid=d_tid, d_obj=d_obj, d_z=d_z, d_valid=d_valid,
        s_sig=s_sig, d_sig=d_sig,
        odom=odom, odom_valid=odom_valid,
        X0_prior=X0_prior,
    )


# ---------------------------------------------------------------------------
# Hybrid (object-centric keyframed) ingestion
# ---------------------------------------------------------------------------

def update_from_packet_hybrid(
    state: GraphState,
    packet: VisionPacket,
    intr: cam.CameraIntrinsics,
    cfg: BackendParams,
) -> GraphState:
    """Ingest a packet under the hybrid formulation: H[j, f] is the keyframed
    motion ^W_eH_f; new objects anchor L_e = [I | centroid] with H_{e,e} = I;
    existing objects chain H_{e,f} = H_f2f H_{e,f-1}; a tracklet's first
    observation sets m_L = L_e^{-1} H_{e,f}^{-1} m_f^W; re-entry or a
    mask-IoU collapse closes the slot and re-anchors a fresh epoch (see the
    reference docstring)."""
    f = state.num_frames
    fprev = max(f - 1, 0)
    dev = state.X.device
    pkt_present = packet.object_valid & (packet.object_ids > 0)
    neg2 = torch.full_like(packet.object_ids, -2)
    id_in_pkt = torch.any(
        state.obj_ids[:, None] == torch.where(pkt_present, packet.object_ids, neg2)[None, :],
        dim=1,
    )
    can_chain = state.H_valid[:, fprev] | (state.kf_slot == fprev)
    live = (state.obj_ids > 0) & state.slot_open & state.kf_valid
    broken = live & ~can_chain & id_in_pkt
    if cfg.reanchor_on_resample:
        pkt_res = pkt_present & packet.object_resampled
        res_hit = torch.any(
            state.obj_ids[:, None] == torch.where(pkt_res, packet.object_ids, neg2)[None, :],
            dim=1,
        )
        epoch_young = (state.kf_slot >= 0) & (f - state.kf_slot < cfg.reanchor_min_epoch_len)
        broken = broken | (live & res_hit & ~epoch_young)
    if f < 2:
        broken = torch.zeros_like(broken)
    state = dataclasses.replace(state, slot_open=state.slot_open & ~broken)

    prev_obj_ids = torch.where(state.slot_open, state.obj_ids, -2)
    base = update_from_packet(state, packet, intr, cfg)
    dtype = base.X.dtype
    J = base.J

    newly = (prev_obj_ids < 0) & (base.obj_ids > 0)
    existed = (prev_obj_ids > 0) & (base.obj_ids > 0)

    # ---- world points of this frame's dynamic observations ---------------
    dt = packet.dynamic_tracks
    d_obs_valid = base.d_valid[:, f]
    zd_local = cam.backproject(dt.uv, dt.depth, intr).to(dtype)
    zd_world = lie.transform_points(base.X[f], zd_local)

    onehot = (
        (base.d_obj[:, None] == torch.arange(J, device=dev)[None, :]) & d_obs_valid[:, None]
    ).to(dtype)                                              # (Ld, J)
    counts = torch.sum(onehot, dim=0)
    centroid = lie.einsum("lj,lc->jc", onehot, zd_world) / torch.clamp(counts[:, None], min=1.0)

    # ---- anchor new objects ----------------------------------------------
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    L_e_new = lie.make_pose(eye3, centroid)
    anchor = newly & (counts > 0)
    L_e = torch.where(anchor[:, None, None], L_e_new, state.L_e)
    kf_valid = state.kf_valid | anchor
    kf_slot = torch.where(anchor, f, state.kf_slot).to(torch.int32)

    # ---- keyframed motion init --------------------------------------------
    pkt_ok = packet.object_valid & (packet.object_ids > 0)
    eq = (base.obj_ids[:, None] == packet.object_ids[None, :]) & pkt_ok[None, :]
    hit = torch.any(eq, dim=1)
    idx = first_true(eq, 1)
    H_f2f = torch.where(
        (hit & existed)[:, None, None], packet.object_motions[idx].to(dtype), eye4
    )
    if f > 0:
        H_init = torch.where(
            existed[:, None, None], lie.compose(H_f2f, base.H[:, f - 1]), eye4
        )
    else:
        H_init = eye4.expand(J, 4, 4)
    H = base.H.clone()
    H[:, f] = H_init

    # H variable exists where the object has enough obs this frame and this
    # frame is not its keyframe (H_{e,e} = I is a constant)
    min_obs = max(cfg.min_dynamic_observations, 1)
    H_valid = base.H_valid.clone()
    H_valid[:, f] = (counts >= min_obs) & (base.obj_ids > 0) & kf_valid & (kf_slot != f)

    # ---- object-frame point init for first observations -------------------
    slot_switched = d_obs_valid & (base.d_obj != state.d_obj) & (state.d_obj >= 0)
    first_obs = slot_switched | (
        d_obs_valid
        & ((dt.tracklet_id != state.d_tid) | ~torch.any(state.d_valid, dim=1))
    )
    Hj = lie.einsum("lj,jab->lab", onehot, H_init)
    Lj = lie.einsum("lj,jab->lab", onehot, L_e)
    assigned = torch.sum(onehot, dim=1) > 0.5
    Hj = torch.where(assigned[:, None, None], Hj, eye4)
    Lj = torch.where(assigned[:, None, None], Lj, eye4)
    m_e_world = lie.transform_points(lie.inverse(Hj), zd_world)
    m_L_init = lie.transform_points(lie.inverse(Lj), m_e_world)
    m_hyb = torch.where((first_obs & assigned)[:, None], m_L_init, state.m_hyb)

    return dataclasses.replace(
        base,
        H=H, H_valid=H_valid, m_hyb=m_hyb, L_e=L_e,
        kf_valid=kf_valid, kf_slot=kf_slot,
    )
