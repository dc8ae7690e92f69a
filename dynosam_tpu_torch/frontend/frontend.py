"""RGB-D instance frontend: one step per frame (port of
dynosam_tpu/frontend/frontend.py).

mask propagation -> track (provided flow or KLT) -> in-loop stereo depth ->
IMU preintegration -> camera RANSAC + GN (IMU or constant-velocity prior and
fallback, optional IMU rotation prior) -> joint optical-flow + pose
refinement (and stereo again) -> per-object motion solves (one batch over
the object-slot axis) -> per-object joint refinement -> output packet.

Every branch of the reference runs here. Mask propagation runs when
`use_propogate_mask` is set and the state was built with an image shape (it
then carries the previous mask). KLT mode needs the image shape too: the
state carries the previous frame, CLAHE-equalized when use_clahe is on
(each frame is equalized once; detection stays on the raw gray). Stereo runs
when the frames carry a right image and use_stereo_track is on; the IMU when
they carry an IMU window and use_imu is on.

`frontend_step` also steps B sequences at once: a FrontendState of (B, ...)
tensors (a (B,) frame_idx) with (B, ...) FrameInputs (the batched step's,
parallel/batched.py), in the provided-flow mode, with ByteTrack, the IMU
and stereo as above. Every operation then runs once for the batch; whether
the frames carry a right image or an IMU window is decided for the whole
batch, as under the reference's vmap. KLT and mask propagation do not run
batched, as in the reference, whose batch is built without an image shape.

While `utils/stats.py::tracing` is on, a step records the span `frontend`
and inside it `frontend.track`, `frontend.stereo` (each stereo match),
`frontend.imu` (the preintegration), `frontend.camera` (the camera solve
and its joint refinement) and `frontend.objects` (the object motions and
theirs).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from dynosam_tpu_torch.config import FrontendParams
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.cv import stereo as stereo_mod
from dynosam_tpu_torch.frontend import imu as imu_mod
from dynosam_tpu_torch.frontend import motion
from dynosam_tpu_torch.frontend import tracker as tracker_mod
from dynosam_tpu_torch.frontend.tracker import TrackerState, empty_tracker_state, track_frame
from dynosam_tpu_torch.frontend.types import (
    FrameInputs,
    TrackTable,
    VisionPacket,
    first_true,
    rows,
)
from dynosam_tpu_torch.ops import interp
from dynosam_tpu_torch.utils import lie
from dynosam_tpu_torch.utils.stats import span


@dataclass
class FrontendState:
    tracker: TrackerState
    X_prev: torch.Tensor       # (4, 4) pose at k-1
    X_prev_prev: torch.Tensor  # (4, 4) pose at k-2 (constant-velocity prior)
    frame_idx: torch.Tensor    # () int32
    # previous grayscale frame, carried in KLT mode (CLAHE-equalized when
    # use_clahe is on); (0, 0) otherwise
    prev_gray: torch.Tensor
    # previous instance mask, carried when mask propagation runs; (0, 0)
    # otherwise
    prev_mask: torch.Tensor
    # world-frame linear velocity for the IMU nav-state propagation (zeros
    # and untouched when the IMU is off)
    v_world: torch.Tensor


def empty_frontend_state(params: FrontendParams, device, dtype=torch.float32,
                         image_shape=None) -> FrontendState:
    """The state before frame 0. `image_shape` (H, W) is required in KLT
    mode; with use_propogate_mask it makes the state carry the previous
    mask."""
    klt_mode = not params.tracker.prefer_provided_optical_flow
    if klt_mode and image_shape is None:
        raise ValueError(
            "prefer_provided_optical_flow=False: pass "
            "image_shape=(height, width) so the state can carry prev_gray"
        )
    eye = torch.eye(4, dtype=dtype, device=device)
    pm_shape = image_shape if (params.use_propogate_mask and image_shape is not None) else (0, 0)
    return FrontendState(
        tracker=empty_tracker_state(params, device, dtype),
        X_prev=eye,
        X_prev_prev=eye.clone(),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        prev_gray=torch.zeros(tuple(image_shape) if klt_mode else (0, 0), dtype=dtype, device=device),
        prev_mask=torch.zeros(tuple(pm_shape), dtype=torch.int32, device=device),
        v_world=torch.zeros((3,), dtype=dtype, device=device),
    )


@functools.lru_cache(maxsize=8)
def _imu_params(gravity, accel_bias, gyro_bias, device) -> imu_mod.ImuParams:
    """The IMU constants on `device`, made once: a host-to-device copy each
    frame would wait on the card."""
    return imu_mod.ImuParams.create(gravity=gravity, accel_bias=accel_bias, gyro_bias=gyro_bias,
                                    device=device)


def _to_gray(rgb):
    if rgb.ndim == 2:
        return rgb.to(torch.float32)
    rgb = rgb.to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _propogate_mask_repair(tracker: TrackerState, prev_mask, flow, mask, params: FrontendParams):
    """Recover objects the detector lost this frame (propogateMask): for
    each object tracked at k-1, poll the current mask at the flow-predicted
    keypoints; where the majority vote is background, fill the background
    pixels that the previous mask, advected by the flow, gives to that
    object."""
    H, W = mask.shape
    pred_uv = tracker.d_uv + interp.sample_flow(flow, tracker.d_uv)
    in_img = (
        (pred_uv[:, 0] >= 0)
        & (pred_uv[:, 0] <= W - 1)
        & (pred_uv[:, 1] >= 0)
        & (pred_uv[:, 1] <= H - 1)
    )
    cur_lab = interp.sample_label(mask, pred_uv)
    votes = tracker.d_valid & (tracker.d_oid > 0) & in_img

    obj = tracker.obj_ids                                              # (J,)
    sel = (tracker.d_oid[None, :] == obj[:, None]) & votes[None, :]
    n = torch.sum(sel, dim=1)
    n_zero = torch.sum(sel & (cur_lab == 0)[None, :], dim=1)
    lost = (obj > 0) & (n >= params.tracker.min_dynamic_tracks) & (n_zero * 2 > n)

    adv = tracker_mod.propagate_mask(prev_mask, flow)                  # (H, W)
    recov = torch.any((adv[..., None] == obj) & lost, dim=-1)
    return torch.where((mask == 0) & recov, adv, mask)


def frontend_step(
    state: FrontendState,
    inputs: FrameInputs,
    intr: cam.CameraIntrinsics,
    params: FrontendParams,
    generator: Optional[torch.Generator] = None,
):
    """Process one frame -> (new FrontendState, VisionPacket). RANSAC
    samples come from `generator` (on the frame's device)."""
    with span("frontend"):
        return _frontend_step(state, inputs, intr, params, generator)


def _frontend_step(state, inputs, intr, params, generator):
    nb = state.frame_idx.ndim
    first = state.frame_idx == 0
    not_first = ~first
    old = state.tracker
    tp = params.tracker
    gray = _to_gray(inputs.rgb).contiguous()
    klt_mode = not tp.prefer_provided_optical_flow
    if nb and klt_mode:
        raise ValueError(
            "frontend_step with a batch axis tracks by the provided flow: KLT needs the previous "
            "frame in the state, and the reference's batch is built without an image_shape "
            "(_init_batch), so its empty_frontend_state raises in KLT mode"
        )
    if nb and state.prev_mask.numel() > 0:
        raise NotImplementedError(
            "frontend_step with a batch axis does not propagate masks: the previous mask is carried "
            "only by a state built with an image_shape, and the reference's batch is built without "
            "one (_init_batch), so mask propagation never runs batched there"
        )
    # KLT mode: equalize the new frame once and carry it as prev_gray; the
    # LK pair is equalized, detection stays on the raw gray
    if klt_mode and tp.use_clahe:
        gray_t = tracker_mod._clahe_padded(gray, tp.clahe_grid, tp.clahe_clip_limit)
    else:
        gray_t = gray

    # ---- mask propagation ---------------------------------------------------
    pm_on = params.use_propogate_mask and state.prev_mask.numel() > 0
    mask_k = inputs.mask
    if pm_on:
        repaired = _propogate_mask_repair(old, state.prev_mask, inputs.flow, inputs.mask, params)
        mask_k = torch.where(first, inputs.mask, repaired)

    with span("frontend.track"):
        tracker = track_frame(
            old, gray, inputs.depth, inputs.flow, mask_k, params, first_frame=first,
            prev_gray=state.prev_gray if klt_mode else None,
            gray_lk=gray_t if klt_mode else None,
        )
    dtype = tracker.s_uv.dtype
    eye4 = torch.eye(4, dtype=dtype, device=gray.device)

    # ---- in-loop stereo depth (stereoTrack #1) ----------------------------
    # KLT-match the static features into the rectified right image and take
    # their triangulated depths before the camera solve
    has_right = params.use_stereo_track and inputs.right is not None
    if has_right:
        right_gray = _to_gray(inputs.right).contiguous()

        def _stereo_refresh(trk):
            with span("frontend.stereo"):
                depth_st, _, ok = stereo_mod.stereo_track(
                    gray, right_gray, trk.s_uv, trk.s_valid, intr.fx, intr.baseline,
                    levels=tp.klt_levels, half=max(tp.klt_window_half, 3), iters=tp.klt_iterations,
                    min_eig=tp.klt_min_eig, fb_threshold=tp.klt_fb_threshold,
                )
                return dataclasses.replace(trk, s_depth=torch.where(ok & trk.s_valid, depth_st, trk.s_depth))

        tracker = _stereo_refresh(tracker)

    # ---- camera ego-motion ------------------------------------------------
    # correspondence: same slot, same tracklet, valid at both frames
    s_match = old.s_valid & tracker.s_valid & (old.s_tid == tracker.s_tid) & not_first[..., None]
    pts_cam_prev = cam.backproject(old.s_uv, old.s_depth, intr)
    pts_world_prev = lie.transform_points(state.X_prev[..., None, :, :], pts_cam_prev)
    pts_cam_k = cam.backproject(tracker.s_uv, tracker.s_depth, intr)

    # constant-velocity prior (and fallback)
    vel = lie.compose(lie.inverse(state.X_prev_prev), state.X_prev)
    X_prior = lie.compose(state.X_prev, vel)

    # ---- IMU preintegration ------------------------------------------------
    # the preintegrated nav-state gives the prior/fallback pose and, with
    # use_rotation_prior, the rotation of the known-rotation RANSAC
    use_imu = params.use_imu and inputs.imu_samples is not None
    R_known = None
    pim_dt = None
    if use_imu:
        imu_params = _imu_params(tuple(params.imu.gravity), tuple(params.imu.accel_bias),
                                 tuple(params.imu.gyro_bias), gray.device)
        with span("frontend.imu"):
            pim = imu_mod.preintegrate(inputs.imu_samples, inputs.imu_valid, imu_params)
        pim_dt = pim.dt
        X_imu, _ = imu_mod.predict(state.X_prev, state.v_world, pim, imu_params)
        has_imu = (pim.dt > 0) & not_first
        X_prior = torch.where(has_imu[..., None, None], X_imu, X_prior)
        if params.imu.use_rotation_prior:
            # RANSAC solves T_cam_world: pin its rotation to the IMU's
            R_known = torch.where(
                has_imu[..., None, None], lie.rotation(X_imu).transpose(-1, -2),
                lie.rotation(X_prior).transpose(-1, -2),
            )

    ms = params.motion_solver
    H_img, W_img = gray.shape[-2], gray.shape[-1]

    def _uv_in_bounds(uv):
        return (
            (uv[..., 0] >= 1.0)
            & (uv[..., 0] <= W_img - 2.0)
            & (uv[..., 1] >= 1.0)
            & (uv[..., 1] <= H_img - 2.0)
        )

    with span("frontend.camera"):
        cam_res = motion.solve_camera_pose(
            generator, pts_world_prev, tracker.s_uv, pts_cam_k, s_match,
            intr, ms, X_prior, R_known=R_known,
        )
        X_k = torch.where(first[..., None, None], eye4, cam_res.pose)

        # ---- joint optical-flow + camera-pose refinement ----------------------
        if ms.refine_camera_pose_with_joint_of:
            ref_mask = s_match & cam_res.valid[..., None]
            T_ref, f_s, _ = motion.joint_flow_pose_refine(
                lie.inverse(X_k), pts_world_prev, old.s_uv,
                tracker.s_uv - old.s_uv, ref_mask, intr, ms,
            )
            X_k = torch.where((cam_res.valid & not_first)[..., None, None], lie.inverse(T_ref), X_k)
            uv_ref = old.s_uv + f_s
            depth_ref = interp.sample_depth(inputs.depth, uv_ref, nb).to(dtype)
            upd = ref_mask & (depth_ref > 0) & _uv_in_bounds(uv_ref)
            tracker = dataclasses.replace(
                tracker,
                s_uv=torch.where(upd[..., None], uv_ref, tracker.s_uv),
                s_depth=torch.where(upd, depth_ref, tracker.s_depth),
            )
    # stereoTrack #2: the refinement moved the keypoints, so match them
    # into the right image again
    if ms.refine_camera_pose_with_joint_of and has_right:
        tracker = _stereo_refresh(tracker)

    # ---- object motions -----------------------------------------------------
    d_match = old.d_valid & tracker.d_valid & (old.d_tid == tracker.d_tid) & not_first[..., None]
    in_slot = tracker.d_oid[..., None, :] == tracker.obj_ids[..., :, None]       # (J, Nd)
    obj_match_count = torch.sum(d_match[..., None, :] & in_slot, dim=-1)
    pts_cam_prev_d = cam.backproject(old.d_uv, old.d_depth, intr)
    pts_world_prev_d = lie.transform_points(state.X_prev[..., None, :, :], pts_cam_prev_d)
    pts_cam_k_d = cam.backproject(tracker.d_uv, tracker.d_depth, intr)
    pts_world_k_d = lie.transform_points(X_k[..., None, :, :], pts_cam_k_d)

    # scene-flow stationarity test: an object where most matched points
    # barely move in the world this frame is not moving
    sf_mag = torch.linalg.norm(pts_world_k_d - pts_world_prev_d, dim=-1)
    low_sf = d_match & (sf_mag < params.scene_flow_magnitude)
    obj_low_count = torch.sum(low_sf[..., None, :] & in_slot, dim=-1)
    obj_stationary = (obj_match_count > 0) & (
        obj_low_count > params.scene_flow_percentage * obj_match_count
    )

    with span("frontend.objects"):
        obj_res = motion.solve_all_object_motions(
            generator, tracker.obj_ids, tracker.d_oid, pts_world_prev_d,
            tracker.d_uv, pts_world_k_d, d_match, X_k, intr, ms,
        )

        # ---- joint optical-flow + object-motion refinement (batched over J) --
        obj_motions = obj_res.pose
        if ms.refine_motion_with_joint_of:
            T_cw_k = lie.inverse(X_k)
            flow_d = tracker.d_uv - old.d_uv
            oid = tracker.obj_ids
            mask_j = (
                d_match[..., None, :] & in_slot & (oid > 0)[..., :, None] & obj_res.valid[..., :, None]
            )                                                               # (J, Nd)
            T0 = lie.compose(T_cw_k[..., None, :, :], obj_res.pose)        # (J, 4, 4)
            # a batch's per-sequence tracks broadcast over its object slots
            lift = (lambda x: x[:, None]) if nb else (lambda x: x)
            T_r, f_d_all, _ = motion.joint_flow_pose_refine(
                T0, lift(pts_world_prev_d), lift(old.d_uv), lift(flow_d), mask_j, intr, ms
            )
            # trust-region acceptance: a large departure from the RANSAC+GN
            # answer signals an ill-conditioned solve
            depart = torch.linalg.norm(
                lie.se3_log(lie.compose(lie.inverse(T0), T_r)), dim=-1
            )
            H_ref = lie.compose(X_k[..., None, :, :], T_r)
            n_support = torch.sum(mask_j, dim=-1)
            ref_ok = (
                obj_res.valid
                & (oid > 0)
                & (n_support >= ms.object.min_inliers)
                & (depart <= ms.joint_of_max_step)
            )
            obj_motions = torch.where(ref_ok[..., None, None], H_ref, obj_res.pose)
            # each dynamic feature takes the flow of its own object's slot
            slot_hit = in_slot & ref_ok[..., :, None]                       # (J, Nd)
            slot_idx = first_true(slot_hit, -2)
            has_slot = torch.any(slot_hit, dim=-2)
            nd = slot_idx.shape[-1]
            f_d = f_d_all[rows(slot_idx, nb) + (torch.arange(nd, device=slot_idx.device),)]
            uv_ref_d = old.d_uv + f_d
            depth_ref_d = interp.sample_depth(inputs.depth, uv_ref_d, nb).to(dtype)
            upd_d = d_match & has_slot & (depth_ref_d > 0) & _uv_in_bounds(uv_ref_d)
            tracker = dataclasses.replace(
                tracker,
                d_uv=torch.where(upd_d[..., None], uv_ref_d, tracker.d_uv),
                d_depth=torch.where(upd_d, depth_ref_d, tracker.d_depth),
            )

    # ---- packet --------------------------------------------------------------
    # observability floor: objects with too little detection-mask support
    # have their dynamic observations withheld
    if params.tracker.min_observable_mask_area > 0:
        a = params.tracker.min_observable_mask_area
        Hm, Wm = inputs.mask.shape[-2:]
        floor = a if a >= 1.0 else a * float(Hm * Wm)
        obj_unobs = (tracker.obj_ids > 0) & (tracker.obj_det_area < floor)
        neg2 = torch.full_like(tracker.obj_ids, -2)
        d_emit = tracker.d_valid & ~torch.any(
            tracker.d_oid[..., :, None] == torch.where(obj_unobs, tracker.obj_ids, neg2)[..., None, :],
            dim=-1,
        )
        obj_emit = ~obj_unobs
    else:
        d_emit = tracker.d_valid
        obj_emit = torch.ones_like(tracker.obj_ids, dtype=torch.bool)
    packet = VisionPacket(
        frame_id=inputs.frame_id,
        X_world_cam=X_k,
        odom_prev_curr=lie.compose(lie.inverse(state.X_prev), X_k),
        static_tracks=TrackTable(
            uv=tracker.s_uv,
            depth=tracker.s_depth,
            tracklet_id=tracker.s_tid,
            object_id=torch.zeros_like(tracker.s_tid),
            age=tracker.s_age,
            valid=tracker.s_valid,
        ),
        dynamic_tracks=TrackTable(
            uv=tracker.d_uv,
            depth=tracker.d_depth,
            tracklet_id=tracker.d_tid,
            object_id=tracker.d_oid,
            age=tracker.d_age,
            valid=d_emit,
        ),
        object_ids=tracker.obj_ids,
        object_motions=obj_motions,
        object_valid=obj_res.valid
        & (tracker.obj_ids > 0)
        & (obj_match_count >= params.min_object_points)
        & ~obj_stationary
        & obj_emit,
        object_resampled=tracker.obj_resampled,
        pose_valid=cam_res.valid | first,
    )

    # velocity for the next IMU propagation: finite difference of the solved
    # poses over the preintegration span
    v_new = state.v_world
    if use_imu:
        v_new = torch.where(
            (pim_dt > 1e-6)[..., None],
            (lie.translation(X_k) - lie.translation(state.X_prev)) / torch.clamp(pim_dt, min=1e-6)[..., None],
            state.v_world,
        )

    new_state = FrontendState(
        tracker=tracker,
        X_prev=X_k,
        X_prev_prev=torch.where(first[..., None, None], X_k, state.X_prev),
        frame_idx=state.frame_idx + 1,
        prev_gray=gray_t.to(state.prev_gray.dtype) if klt_mode else state.prev_gray,
        prev_mask=mask_k.to(torch.int32) if pm_on else state.prev_mask,
        v_world=v_new,
    )
    return new_state, packet
