"""Camera ego-motion and per-object motion solvers: batched RANSAC + GN
(port of dynosam_tpu/frontend/motion.py).

The per-object solves run as one batch over the object-slot axis J (the
reference vmaps), and `joint_flow_pose_refine` takes any leading batch of
transforms and masks. RANSAC samples from an explicit `torch.Generator`; an
optional `uniforms` tensor replaces the draw (the tests inject the
reference's draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dynosam_tpu.config import MotionSolverParams
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.ops import gauss_newton, kabsch, ransac
from dynosam_tpu_torch.utils import lie


class MotionSolveResult(NamedTuple):
    pose: torch.Tensor         # (*B, 4, 4) X_world_cam for ego; H_w for objects
    inliers: torch.Tensor      # (*B, N) bool
    num_inliers: torch.Tensor  # (*B,)
    valid: torch.Tensor        # (*B,) bool


def _project_sq_err(T, pts, uv_obs, intr, eps=1e-6):
    """Squared reprojection error of T @ pts vs uv_obs, elementwise.

    T: (*B, 4, 4), pts (N, 3) / uv_obs (N, 2) shared over *B.
    Returns (sq (*B, N), mz (*B, N))."""
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]

    def row(i):
        return (
            T[..., i, 0, None] * px + T[..., i, 1, None] * py
            + T[..., i, 2, None] * pz + T[..., i, 3, None]
        )

    mx, my, mz = row(0), row(1), row(2)
    safe_z = torch.where(torch.abs(mz) < eps, eps, mz)
    du = intr.fx * mx / safe_z + intr.cx - uv_obs[..., 0]
    dv = intr.fy * my / safe_z + intr.cy - uv_obs[..., 1]
    return du * du + dv * dv, mz


def _pose_at_points(T):
    """(*B, 4, 4) -> (*B, 1, 4, 4) so transform_points broadcasts over N."""
    return T[..., None, :, :]


# ---------------------------------------------------------------------------
# Ego-motion
# ---------------------------------------------------------------------------

def solve_camera_pose(
    generator: Optional[torch.Generator],
    pts_world,          # (N, 3) landmarks in world (backprojected at k-1)
    uv_k,               # (N, 2) observed pixels at frame k
    pts_cam_k,          # (N, 3) camera-frame 3D at frame k
    valid,              # (N,) bool
    intr: cam.CameraIntrinsics,
    params: MotionSolverParams,
    X_prior,            # (4, 4)
    uniforms: Optional[torch.Tensor] = None,   # (M, N) injected RANSAC draws
) -> MotionSolveResult:
    """Estimate X_world_cam at frame k; falls back to X_prior on failure.

    The IMU known-rotation mode of the reference (R_known) is not ported."""
    rp = params.camera
    data = {"p_w": pts_world, "uv": uv_k, "p_c": pts_cam_k}

    def solve_fn(s):
        return kabsch.solve_rigid_3pt(s["p_w"], s["p_c"])

    use_pnp = params.use_ego_motion_pnp
    if use_pnp:
        def residual_fn(T_cw, d):
            sq, _ = _project_sq_err(T_cw, d["p_w"], d["uv"], intr)
            return sq
        threshold = rp.ransac_threshold_pnp ** 2
    else:
        def residual_fn(T_cw, d):
            diff = lie.transform_points(_pose_at_points(T_cw), d["p_w"]) - d["p_c"]
            return torch.sum(diff * diff, dim=-1)
        threshold = rp.ransac_threshold_3d ** 2

    def refit_fn(d, w, model):
        return kabsch.solve_rigid_quat(d["p_w"], d["p_c"], w, R0=model[..., :3, :3])

    res = ransac.ransac(
        generator, solve_fn, residual_fn, data, valid,
        num_hypotheses=rp.num_hypotheses(),
        sample_size=3,
        threshold=threshold,
        min_inliers=rp.min_inliers,
        refit_fn=refit_fn,
        refit_rounds=params.refit_rounds if rp.optimize_pose_from_inliers else 0,
        uniforms=uniforms,
    )

    if use_pnp:
        def gn_residual(T):
            uv_pred = cam.project(lie.transform_points(_pose_at_points(T), pts_world), intr)
            return uv_pred - uv_k
        k_huber = params.joint_of_k_huber * intr.fx
    else:
        def gn_residual(T):
            return lie.transform_points(_pose_at_points(T), pts_world) - pts_cam_k
        k_huber = rp.ransac_threshold_3d

    w0 = res.inliers.to(pts_world.dtype)
    T_cw, _ = gauss_newton.refine_pose(
        gn_residual, res.model, w0,
        iterations=params.refinement_iterations if rp.optimize_pose_from_inliers else 0,
        k_huber=k_huber,
    )
    X = torch.where(res.valid, lie.inverse(T_cw), X_prior)
    return MotionSolveResult(
        pose=X, inliers=res.inliers, num_inliers=res.num_inliers, valid=res.valid
    )


# ---------------------------------------------------------------------------
# Object motions: one padded slot per object, batched
# ---------------------------------------------------------------------------

def solve_object_motion(
    generator: Optional[torch.Generator],
    pts_world_prev,     # (N, 3) object points in world at k-1
    uv_k,               # (N, 2) observations at k
    pts_world_k,        # (N, 3) object points in world at k
    valid,              # (*B, N) bool: correspondences of each slot's object
    X_k,                # (4, 4) solved camera pose at k
    intr: cam.CameraIntrinsics,
    params: MotionSolverParams,
    uniforms: Optional[torch.Tensor] = None,   # (*B, M, N)
) -> MotionSolveResult:
    """World-frame motion H with m_k^w = H m_{k-1}^w, for each leading slot."""
    rp = params.object
    T_cam_world = lie.inverse(X_k)
    data = {"p_prev": pts_world_prev, "uv": uv_k, "p_k": pts_world_k}
    z_k = lie.transform_points(T_cam_world, pts_world_k)[..., 2]

    def solve_fn(s):
        return kabsch.solve_rigid_3pt(s["p_prev"], s["p_k"])

    def _uv_z_residual(H, p_prev, uv_obs, z_obs):
        m_c = lie.transform_points(_pose_at_points(lie.compose(T_cam_world, H)), p_prev)
        uv_pred = cam.project(m_c, intr)
        z_pred = m_c[..., 2]
        dz = (z_pred - z_obs) * intr.fx / torch.clamp(z_obs, min=1e-3)
        return torch.cat([uv_pred - uv_obs, dz[..., None]], dim=-1)

    if params.use_object_motion_pnp:
        def residual_fn(H, d):
            T = lie.compose(T_cam_world, H)
            sq, mz = _project_sq_err(T, d["p_prev"], d["uv"], intr)
            zk = d["z_k"]
            dz = (mz - zk) * intr.fx / torch.clamp(zk, min=1e-3)
            return sq + dz * dz
        threshold = rp.ransac_threshold_pnp ** 2
    else:
        def residual_fn(H, d):
            diff = lie.transform_points(_pose_at_points(H), d["p_prev"]) - d["p_k"]
            return torch.sum(diff * diff, dim=-1)
        threshold = rp.ransac_threshold_3d ** 2

    def refit_fn(d, w, model):
        return kabsch.solve_rigid_quat(d["p_prev"], d["p_k"], w, R0=model[..., :3, :3])

    data["z_k"] = z_k
    res = ransac.ransac(
        generator, solve_fn, residual_fn, data, valid,
        num_hypotheses=rp.num_hypotheses(),
        sample_size=3,
        threshold=threshold,
        min_inliers=rp.min_inliers,
        refit_fn=refit_fn,
        refit_rounds=params.refit_rounds if rp.optimize_pose_from_inliers else 0,
        uniforms=uniforms,
    )

    inlier_w = res.inliers.to(pts_world_prev.dtype)
    if params.use_object_motion_pnp:
        def gn_residual(Hx):
            return _uv_z_residual(Hx, pts_world_prev, uv_k, z_k)
        k_huber = params.joint_of_k_huber * intr.fx
    else:
        def gn_residual(Hx):
            return lie.transform_points(_pose_at_points(Hx), pts_world_prev) - pts_world_k
        k_huber = rp.ransac_threshold_3d

    H, _ = gauss_newton.refine_pose(
        gn_residual, res.model, inlier_w,
        iterations=params.object_refinement_iterations if rp.optimize_pose_from_inliers else 0,
        k_huber=k_huber,
    )

    if params.refine_motion_with_3d:
        def residual_3d(Hx):
            return lie.transform_points(_pose_at_points(Hx), pts_world_prev) - pts_world_k

        H, _ = gauss_newton.refine_pose(
            residual_3d, H, inlier_w,
            iterations=params.object_refinement_iterations,
            k_huber=params.motion_3d_k_huber,
        )

    eye = torch.eye(4, dtype=H.dtype, device=H.device)
    H = torch.where(res.valid[..., None, None], H, eye)
    return MotionSolveResult(
        pose=H, inliers=res.inliers, num_inliers=res.num_inliers, valid=res.valid
    )


def solve_all_object_motions(
    generator: Optional[torch.Generator],
    object_ids,         # (J,) int32 slot -> object id, -1 pad
    track_object_ids,   # (N,) int32
    pts_world_prev,     # (N, 3)
    uv_k,               # (N, 2)
    pts_world_k,        # (N, 3)
    track_valid,        # (N,) bool
    X_k,
    intr: cam.CameraIntrinsics,
    params: MotionSolverParams,
    uniforms: Optional[torch.Tensor] = None,   # (J, M, N)
) -> MotionSolveResult:
    """Every object slot solved in one batch over J; each slot sees the full
    correspondence table masked to its own object id."""
    valid = (
        track_valid[None, :]
        & (track_object_ids[None, :] == object_ids[:, None])
        & (object_ids > 0)[:, None]
    )
    return solve_object_motion(
        generator, pts_world_prev, uv_k, pts_world_k, valid, X_k, intr, params,
        uniforms=uniforms,
    )


# ---------------------------------------------------------------------------
# Joint optical-flow + pose refinement (OpticalFlowAndPoseOptimizer)
# ---------------------------------------------------------------------------

def joint_flow_pose_refine(
    T_eff0,             # (*B, 4, 4) world -> camera-side map
    pts_world,          # (N, 3) anchored 3D points from k-1 (held fixed)
    kp_prev,            # (N, 2) keypoints at k-1
    flow_meas,          # (N, 2) measured flow (kp_k - kp_prev)
    valid,              # (*B, N) bool
    intr: cam.CameraIntrinsics,
    params: MotionSolverParams,
):
    """Jointly refine a pose-like transform and the per-feature flows, with
    the flows Schur-eliminated in closed form (see the reference docstring).

    Returns (T_eff_refined (*B,4,4), flow_refined (*B,N,2), weights (*B,N))."""
    dtype, device = T_eff0.dtype, T_eff0.device
    v = valid.to(dtype)
    w_meas = v / params.flow_sigma**2
    w_prior = v / params.flow_prior_sigma**2
    k_px = params.joint_of_k_huber * intr.fx
    damping = 1e-6
    max_step = params.joint_of_max_step
    eye6 = torch.eye(6, dtype=dtype, device=device)

    def pred_fn(T):
        return cam.project(lie.transform_points(_pose_at_points(T), pts_world), intr)

    T, f = T_eff0, flow_meas
    for _ in range(params.joint_of_iterations):
        pred, Jt = gauss_newton.residual_and_jacobian(pred_fn, T)
        r1 = (kp_prev + f) - pred
        r2 = f - flow_meas
        w1 = w_meas * gauss_newton.huber_weights(torch.linalg.norm(r1, dim=-1), k_px)

        A = lie.einsum("...nai,...n,...naj->...ij", Jt, w1, Jt)
        g_x = -lie.einsum("...nai,...na->...i", Jt, w1[..., None] * r1)
        c = torch.clamp(w1 + w_prior, min=1e-12)
        g_f = w1[..., None] * r1 + w_prior[..., None] * r2
        Hs = A - lie.einsum("...nai,...n,...naj->...ij", Jt, w1 * w1 / c, Jt)
        gs = g_x + lie.einsum("...nai,...n,...na->...i", Jt, w1 / c, g_f)
        diag_max = torch.amax(torch.abs(torch.diagonal(Hs, dim1=-2, dim2=-1)), dim=-1)
        Hs = Hs + (damping + 1e-6 * diag_max)[..., None, None] * eye6
        xi = -gauss_newton.solve6(Hs, gs)
        nrm = torch.linalg.norm(xi, dim=-1, keepdim=True)
        xi = xi * torch.clamp(max_step / torch.clamp(nrm, min=1e-12), max=1.0)
        xi = torch.where(torch.isfinite(xi), xi, 0.0)
        H_fx_xi = -w1[..., None] * lie.einsum("...nai,...i->...na", Jt, xi)
        df = -(g_f + H_fx_xi) / c[..., None]
        T = lie.retract(T, xi)
        f = f + v[..., None] * df

    r1 = (kp_prev + f) - pred_fn(T)
    w_final = v * gauss_newton.huber_weights(torch.linalg.norm(r1, dim=-1), k_px)
    return T, f, w_final
