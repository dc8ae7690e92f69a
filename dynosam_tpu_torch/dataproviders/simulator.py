"""Kinematic scenario: ground-truth camera and object pose chains, the
exact IMU measurements of the camera's trajectory, and per-frame
`VisionPacket`s projected from static and object landmark clouds (port of
dynosam_tpu/dataproviders/simulator.py).

The packets emulate a perfect frontend (the camera pose, odometry and
object motions are ground truth; only the tracks carry noise), so they feed
the backend alone. The dense renderer (synthetic_dense.py) needs only the
pose chains; the landmark clouds are drawn on the first `measurements`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.frontend.types import GroundTruthFrame, TrackTable, VisionPacket
from dynosam_tpu_torch.utils import lie


@dataclass
class ObjectSpec:
    object_id: int
    initial_pose_xi: np.ndarray          # (6,) se(3) body pose in world at k=0
    motion_xi: np.ndarray                # (6,) body motion: L_k = L_{k-1} exp(xi)
    num_points: int = 64
    extent: float = 1.5                  # half-size of the point cloud box


@dataclass
class ScenarioSpec:
    num_frames: int = 20
    # per-frame camera twist: (6,) constant or (num_frames-1, 6)
    camera_motion_xi: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.01, 0.0, 0.0, 0.0, 0.4])
    )
    objects: List[ObjectSpec] = field(default_factory=list)
    frame_dt: float = 0.1                # seconds between frames (IMU timing)
    num_static: int = 256
    static_extent: float = 25.0
    static_depth_range: tuple = (4.0, 40.0)
    pixel_noise_sigma: float = 0.0
    depth_noise_sigma: float = 0.0
    seed: int = 0

    @staticmethod
    def default_two_objects(num_frames=20, pixel_noise=0.0, depth_noise=0.0, seed=0):
        return ScenarioSpec(
            num_frames=num_frames,
            pixel_noise_sigma=pixel_noise,
            depth_noise_sigma=depth_noise,
            seed=seed,
            objects=[
                ObjectSpec(
                    object_id=1,
                    initial_pose_xi=np.array([0.0, 0.0, 0.3, -4.0, 0.5, 12.0]),
                    motion_xi=np.array([0.0, 0.03, 0.0, 0.45, 0.0, 0.02]),
                    num_points=48,
                ),
                ObjectSpec(
                    object_id=2,
                    initial_pose_xi=np.array([0.0, 0.0, -0.2, 5.0, -0.5, 18.0]),
                    motion_xi=np.array([0.0, -0.02, 0.01, -0.35, 0.0, -0.1]),
                    num_points=48,
                ),
            ],
        )


class Scenario:
    """Ground-truth chains, f32 on `device`:
    X_gt (K, 4, 4) world_from_cam; per object L_gt (K, 4, 4) body poses and
    H_gt (K, 4, 4) world-frame motions H_k = L_k L_{k-1}^{-1} (identity at 0).

    The landmark clouds come from uniforms in [0, 1): `uniforms` =
    {"static": (num_static, 3), "objects": [(num_points, 3) per object]}
    when given (parity tests pass the reference's draws), otherwise drawn
    from a generator seeded with spec.seed.

    The measurement noise comes from standard normals: `normals` =
    {"static": (pixel (K, num_static, 2), depth (K, num_static)),
    "objects": [(pixel (K, num_points, 2), depth (K, num_points)) per
    object]} when given, frame k's rows scaled by the spec's sigmas and
    added to the projections as `measurements(k)` makes them; otherwise
    drawn per frame from a generator seeded with spec.seed and k."""

    def __init__(self, spec: ScenarioSpec, intr: Optional[cam.CameraIntrinsics] = None, device="cuda",
                 uniforms: Optional[dict] = None, normals: Optional[dict] = None):
        self.spec = spec
        self.device = torch.device(device)
        self.intr = intr or cam.CameraIntrinsics.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
        self._uniforms = uniforms
        self._normals = normals
        self._clouds = None
        K = spec.num_frames

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        xi = np.asarray(spec.camera_motion_xi, np.float32)
        if xi.ndim == 1:
            xi = np.tile(xi[None, :], (max(K - 1, 1), 1))
        self.camera_twists = t(xi)                        # (K-1, 6)
        poses = [lie.identity(device=device)]
        for k in range(K - 1):
            poses.append(lie.compose(poses[-1], lie.se3_exp(self.camera_twists[k])))
        self.X_gt = torch.stack(poses)

        self.object_ids = [o.object_id for o in spec.objects]
        self.L_gt, self.H_gt = [], []
        for o in spec.objects:
            dL = lie.se3_exp(t(o.motion_xi))
            Ls = [lie.se3_exp(t(o.initial_pose_xi))]
            for _ in range(K - 1):
                Ls.append(lie.compose(Ls[-1], dL))
            Ls = torch.stack(Ls)
            self.L_gt.append(Ls)
            self.H_gt.append(
                torch.cat(
                    [lie.identity((1,), device=device), lie.compose(Ls[1:], lie.inverse(Ls[:-1]))],
                    dim=0,
                )
            )

    def camera_velocity(self, k: int):
        """World-frame linear velocity at the start of interval (k, k+1]: a
        piecewise-constant twist keeps the body velocity constant within an
        interval, v_w(t) = R(t) v_b."""
        kk = min(k, self.camera_twists.shape[0] - 1)
        v_b = self.camera_twists[kk, 3:] / self.spec.frame_dt
        return lie.rotate_points(lie.rotation(self.X_gt[k]), v_b)

    def imu_window(self, k: int, n_samples: int = 32, gravity=(0.0, 9.81, 0.0)):
        """Exact IMU measurements over the interval (k-1, k] -> ((S, 7) rows
        [dt ax ay az gx gy gz], (S,) mask), the FrameInputs.imu_samples
        contract. Within an interval the twist is constant: gyro = w_b and
        the specific force at local time t is f(t) = w_b x v_b - R(t)^T g
        with R(t) = R_{k-1} exp(hat(w_b) t). k = 0 gives an all-invalid
        window."""
        S = n_samples
        dev = self.X_gt.device
        if k <= 0:
            return (torch.zeros((S, 7), dtype=torch.float32, device=dev),
                    torch.zeros((S,), dtype=torch.bool, device=dev))
        dt_f = self.spec.frame_dt
        xi = self.camera_twists[k - 1]
        w_b = xi[:3] / dt_f
        v_b = xi[3:] / dt_f
        g = torch.tensor(gravity, dtype=torch.float32, device=dev)
        R_prev = lie.rotation(self.X_gt[k - 1])
        dt_s = dt_f / S
        t_mid = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) * dt_s
        R_t = lie.mm(R_prev, lie.so3_exp(w_b[None, :] * t_mid[:, None]))        # (S, 3, 3)
        f = torch.linalg.cross(w_b, v_b)[None, :] - lie.einsum("sba,b->sa", R_t, g)
        rows = torch.cat([torch.full((S, 1), dt_s, dtype=torch.float32, device=dev), f,
                          w_b.expand(S, 3)], dim=-1)
        return rows, torch.ones((S,), dtype=torch.bool, device=dev)

    def ground_truth(self, k: int, max_objects: int = 16) -> GroundTruthFrame:
        """Frame k's ground truth over `max_objects` slots, on the host."""
        J = len(self.object_ids)
        ids = np.full((max_objects,), -1, np.int32)
        poses = np.tile(np.eye(4, dtype=np.float32), (max_objects, 1, 1))
        motions = poses.copy()
        if J:
            ids[:J] = self.object_ids
            poses[:J] = torch.stack([L[k] for L in self.L_gt]).cpu().numpy()
            motions[:J] = torch.stack([H[k] for H in self.H_gt]).cpu().numpy()
        return GroundTruthFrame(
            X_world_cam=self.X_gt[k].cpu().numpy(),
            object_ids=ids,
            object_poses=poses,
            object_motions=motions,
            object_valid=np.arange(max_objects) < J,
        )

    # ------------------------------------------------------------------
    def _landmarks(self):
        """(static points (Ns, 3), [object world points (K, P, 3)]), drawn
        once."""
        if self._clouds is None:
            spec, dev = self.spec, self.device
            u = self._uniforms
            if u is None:
                gen = torch.Generator().manual_seed(spec.seed)
                u = {"static": torch.rand((spec.num_static, 3), generator=gen),
                     "objects": [torch.rand((o.num_points, 3), generator=gen) for o in spec.objects]}

            def t(x):
                return torch.as_tensor(np.asarray(x, np.float32), device=dev)

            us = t(u["static"])
            zmin, zmax = spec.static_depth_range
            static = torch.stack([
                (us[:, 0] - 0.5) * 2 * spec.static_extent,
                (us[:, 1] - 0.5) * 2 * spec.static_extent * 0.3,
                zmin + us[:, 2] * (zmax - zmin),
            ], dim=-1)
            world = [lie.transform_points(Ls[:, None, :, :], ((t(uo) - 0.5) * 2 * o.extent)[None, :, :])
                     for o, uo, Ls in zip(spec.objects, u["objects"], self.L_gt)]
            self._clouds = (static, world)
        return self._clouds

    def num_dynamic_points(self) -> int:
        return sum(o.num_points for o in self.spec.objects)

    def measurements(self, k: int, max_objects: int = 16) -> VisionPacket:
        """Projected measurements of frame k as a VisionPacket: the camera
        pose, odometry and object motions are ground truth; the tracks carry
        the spec's pixel and depth noise."""
        spec, dev = self.spec, self.device
        static_w, objects_w = self._landmarks()
        X = self.X_gt[k]
        X_inv = lie.inverse(X)
        gen = torch.Generator().manual_seed(spec.seed * 1_000_003 + k)

        def noise(shape, given):
            if given is None:
                return torch.randn(shape, generator=gen).to(dev)
            return torch.as_tensor(np.asarray(given[k], np.float32), device=dev)

        def observe(points_w, given):
            pc = lie.transform_points(X_inv, points_w)    # camera frame
            uv = cam.project(pc, self.intr)
            if spec.pixel_noise_sigma > 0:
                uv = uv + spec.pixel_noise_sigma * noise(uv.shape, given[0])
            depth = pc[..., 2]
            if spec.depth_noise_sigma > 0:
                depth = depth + spec.depth_noise_sigma * noise(depth.shape, given[1])
            visible = (pc[..., 2] > 0.3) & cam.in_image(uv, self.intr)
            return uv, depth, visible

        normals = self._normals or {"static": (None, None), "objects": [(None, None)] * len(objects_w)}

        def i32(x):
            return torch.as_tensor(x, dtype=torch.int32, device=dev)

        uv_s, d_s, vis_s = observe(static_w, normals["static"])
        n_s = spec.num_static
        static = TrackTable(uv=uv_s, depth=d_s, tracklet_id=torch.arange(n_s, dtype=torch.int32, device=dev),
                            object_id=torch.zeros((n_s,), dtype=torch.int32, device=dev),
                            age=torch.full((n_s,), k, dtype=torch.int32, device=dev), valid=vis_s)

        # dynamic: the objects' points in order, tracklet ids from 10 000
        parts, offset = [], 10_000
        for oid, pts_w, given in zip(self.object_ids, objects_w, normals["objects"]):
            p = pts_w.shape[1]
            parts.append(observe(pts_w[k], given) + (torch.arange(p, dtype=torch.int32, device=dev) + offset,
                                              torch.full((p,), oid, dtype=torch.int32, device=dev)))
            offset += p
        if parts:
            uv, d, vis, tid, oid = (torch.cat(x) for x in zip(*parts))
            dynamic = TrackTable(uv=uv, depth=d, tracklet_id=tid, object_id=oid,
                                 age=torch.full((self.num_dynamic_points(),), k, dtype=torch.int32,
                                                device=dev), valid=vis)
        else:
            dynamic = TrackTable(uv=torch.zeros((1, 2), device=dev), depth=torch.zeros((1,), device=dev),
                                 tracklet_id=i32([-1]), object_id=i32([0]), age=i32([0]),
                                 valid=torch.zeros((1,), dtype=torch.bool, device=dev))

        J = len(self.object_ids)
        obj_ids = torch.full((max_objects,), -1, dtype=torch.int32, device=dev)
        motions = torch.eye(4, device=dev).expand(max_objects, 4, 4).clone()
        if J:
            obj_ids[:J] = i32(self.object_ids)
            motions[:J] = torch.stack([H[k] for H in self.H_gt])
        odom = lie.compose(lie.inverse(self.X_gt[k - 1]), X) if k > 0 else torch.eye(4, device=dev)
        slots = torch.arange(max_objects, device=dev)
        return VisionPacket(
            frame_id=i32(k),
            X_world_cam=X,
            odom_prev_curr=odom,
            static_tracks=static,
            dynamic_tracks=dynamic,
            object_ids=obj_ids,
            object_motions=motions,
            object_valid=(slots < J) & (k > 0),
            object_resampled=torch.zeros((max_objects,), dtype=torch.bool, device=dev),
            pose_valid=torch.ones((), dtype=torch.bool, device=dev),
        )

    def packets(self, max_objects: int = 16) -> List[VisionPacket]:
        return [self.measurements(k, max_objects) for k in range(self.spec.num_frames)]
