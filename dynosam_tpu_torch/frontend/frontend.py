"""RGB-D instance frontend: one step per frame (port of
dynosam_tpu/frontend/frontend.py, provided-flow path).

track -> camera RANSAC + GN (constant-velocity fallback) -> joint
optical-flow + pose refinement -> per-object motion solves (one batch over
the object-slot axis) -> per-object joint refinement -> output packet.

Not ported: IMU preintegration, in-loop stereo depth, mask propagation and
KLT tracking. A config or state that would run one of them raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from dynosam_tpu.config import FrontendParams
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.frontend import motion
from dynosam_tpu_torch.frontend import tracker as tracker_mod
from dynosam_tpu_torch.frontend.tracker import TrackerState, empty_tracker_state, track_frame
from dynosam_tpu_torch.frontend.types import (
    FrameInputs,
    TrackTable,
    VisionPacket,
    first_true,
)
from dynosam_tpu_torch.ops import interp
from dynosam_tpu_torch.utils import lie


@dataclass
class FrontendState:
    tracker: TrackerState
    X_prev: torch.Tensor       # (4, 4) pose at k-1
    X_prev_prev: torch.Tensor  # (4, 4) pose at k-2 (constant-velocity prior)
    frame_idx: torch.Tensor    # () int32


def check_supported(params: FrontendParams, image_shape=None):
    """Raise NotImplementedError for the frontend branches this port lacks.

    As in the reference, mask propagation runs only when the state is built
    with an image shape, and stereo only when frames carry a right image
    (the port's FrameInputs have none), so their default-on flags alone do
    not ask for them."""
    tracker_mod.check_supported(params.tracker)
    if params.use_imu:
        raise NotImplementedError("IMU preintegration (use_imu=True) is not ported")
    if params.use_propogate_mask and image_shape is not None:
        raise NotImplementedError("mask propagation (use_propogate_mask with an image_shape) is not ported")


def empty_frontend_state(params: FrontendParams, device, dtype=torch.float32,
                         image_shape=None) -> FrontendState:
    check_supported(params, image_shape)
    eye = torch.eye(4, dtype=dtype, device=device)
    return FrontendState(
        tracker=empty_tracker_state(params, device, dtype),
        X_prev=eye,
        X_prev_prev=eye.clone(),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def _to_gray(rgb):
    if rgb.ndim == 2:
        return rgb.to(torch.float32)
    rgb = rgb.to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def frontend_step(
    state: FrontendState,
    inputs: FrameInputs,
    intr: cam.CameraIntrinsics,
    params: FrontendParams,
    generator: Optional[torch.Generator] = None,
):
    """Process one frame -> (new FrontendState, VisionPacket). RANSAC
    samples come from `generator` (on the frame's device)."""
    check_supported(params)
    first = state.frame_idx == 0
    not_first = ~first
    old = state.tracker
    gray = _to_gray(inputs.rgb).contiguous()

    tracker = track_frame(
        old, gray, inputs.depth, inputs.flow, inputs.mask, params, first_frame=first
    )
    dtype = tracker.s_uv.dtype
    eye4 = torch.eye(4, dtype=dtype, device=gray.device)

    # ---- camera ego-motion ------------------------------------------------
    # correspondence: same slot, same tracklet, valid at both frames
    s_match = old.s_valid & tracker.s_valid & (old.s_tid == tracker.s_tid) & not_first
    pts_cam_prev = cam.backproject(old.s_uv, old.s_depth, intr)
    pts_world_prev = lie.transform_points(state.X_prev, pts_cam_prev)
    pts_cam_k = cam.backproject(tracker.s_uv, tracker.s_depth, intr)

    # constant-velocity prior (and fallback)
    vel = lie.compose(lie.inverse(state.X_prev_prev), state.X_prev)
    X_prior = lie.compose(state.X_prev, vel)

    cam_res = motion.solve_camera_pose(
        generator, pts_world_prev, tracker.s_uv, pts_cam_k, s_match,
        intr, params.motion_solver, X_prior,
    )
    X_k = torch.where(first, eye4, cam_res.pose)

    ms = params.motion_solver
    H_img, W_img = gray.shape[-2], gray.shape[-1]

    def _uv_in_bounds(uv):
        return (
            (uv[..., 0] >= 1.0)
            & (uv[..., 0] <= W_img - 2.0)
            & (uv[..., 1] >= 1.0)
            & (uv[..., 1] <= H_img - 2.0)
        )

    # ---- joint optical-flow + camera-pose refinement ----------------------
    if ms.refine_camera_pose_with_joint_of:
        ref_mask = s_match & cam_res.valid
        T_ref, f_s, _ = motion.joint_flow_pose_refine(
            lie.inverse(X_k), pts_world_prev, old.s_uv,
            tracker.s_uv - old.s_uv, ref_mask, intr, ms,
        )
        X_k = torch.where(cam_res.valid & not_first, lie.inverse(T_ref), X_k)
        uv_ref = old.s_uv + f_s
        depth_ref = interp.sample_depth(inputs.depth, uv_ref).to(dtype)
        upd = ref_mask & (depth_ref > 0) & _uv_in_bounds(uv_ref)
        tracker = dataclasses.replace(
            tracker,
            s_uv=torch.where(upd[:, None], uv_ref, tracker.s_uv),
            s_depth=torch.where(upd, depth_ref, tracker.s_depth),
        )

    # ---- object motions -----------------------------------------------------
    d_match = old.d_valid & tracker.d_valid & (old.d_tid == tracker.d_tid) & not_first
    in_slot = tracker.d_oid[None, :] == tracker.obj_ids[:, None]       # (J, Nd)
    obj_match_count = torch.sum(d_match[None, :] & in_slot, dim=1)
    pts_cam_prev_d = cam.backproject(old.d_uv, old.d_depth, intr)
    pts_world_prev_d = lie.transform_points(state.X_prev, pts_cam_prev_d)
    pts_cam_k_d = cam.backproject(tracker.d_uv, tracker.d_depth, intr)
    pts_world_k_d = lie.transform_points(X_k, pts_cam_k_d)

    # scene-flow stationarity test: an object where most matched points
    # barely move in the world this frame is not moving
    sf_mag = torch.linalg.norm(pts_world_k_d - pts_world_prev_d, dim=-1)
    low_sf = d_match & (sf_mag < params.scene_flow_magnitude)
    obj_low_count = torch.sum(low_sf[None, :] & in_slot, dim=1)
    obj_stationary = (obj_match_count > 0) & (
        obj_low_count > params.scene_flow_percentage * obj_match_count
    )

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
            d_match[None, :] & in_slot & (oid > 0)[:, None] & obj_res.valid[:, None]
        )                                                               # (J, Nd)
        T0 = lie.compose(T_cw_k, obj_res.pose)                          # (J, 4, 4)
        T_r, f_d_all, _ = motion.joint_flow_pose_refine(
            T0, pts_world_prev_d, old.d_uv, flow_d, mask_j, intr, ms
        )
        # trust-region acceptance: a large departure from the RANSAC+GN
        # answer signals an ill-conditioned solve
        depart = torch.linalg.norm(
            lie.se3_log(lie.compose(lie.inverse(T0), T_r)), dim=-1
        )
        H_ref = lie.compose(X_k, T_r)
        n_support = torch.sum(mask_j, dim=1)
        ref_ok = (
            obj_res.valid
            & (oid > 0)
            & (n_support >= ms.object.min_inliers)
            & (depart <= ms.joint_of_max_step)
        )
        obj_motions = torch.where(ref_ok[:, None, None], H_ref, obj_res.pose)
        # each dynamic feature takes the flow of its own object's slot
        slot_hit = in_slot & ref_ok[:, None]                            # (J, Nd)
        slot_idx = first_true(slot_hit, 0)
        has_slot = torch.any(slot_hit, dim=0)
        nd = slot_idx.shape[0]
        f_d = f_d_all[slot_idx, torch.arange(nd, device=slot_idx.device)]
        uv_ref_d = old.d_uv + f_d
        depth_ref_d = interp.sample_depth(inputs.depth, uv_ref_d).to(dtype)
        upd_d = d_match & has_slot & (depth_ref_d > 0) & _uv_in_bounds(uv_ref_d)
        tracker = dataclasses.replace(
            tracker,
            d_uv=torch.where(upd_d[:, None], uv_ref_d, tracker.d_uv),
            d_depth=torch.where(upd_d, depth_ref_d, tracker.d_depth),
        )

    # ---- packet --------------------------------------------------------------
    # observability floor: objects with too little detection-mask support
    # have their dynamic observations withheld
    if params.tracker.min_observable_mask_area > 0:
        a = params.tracker.min_observable_mask_area
        Hm, Wm = inputs.mask.shape
        floor = a if a >= 1.0 else a * float(Hm * Wm)
        obj_unobs = (tracker.obj_ids > 0) & (tracker.obj_det_area < floor)
        neg2 = torch.full_like(tracker.obj_ids, -2)
        d_emit = tracker.d_valid & ~torch.any(
            tracker.d_oid[:, None] == torch.where(obj_unobs, tracker.obj_ids, neg2)[None, :],
            dim=1,
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

    new_state = FrontendState(
        tracker=tracker,
        X_prev=X_k,
        X_prev_prev=torch.where(first, X_k, state.X_prev),
        frame_idx=state.frame_idx + 1,
    )
    return new_state, packet
