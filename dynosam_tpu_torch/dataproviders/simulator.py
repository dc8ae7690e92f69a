"""Kinematic scenario: ground-truth camera and object pose chains and the
exact IMU measurements of the camera's trajectory (port of the trajectory
and IMU parts of dynosam_tpu/dataproviders/simulator.py).

The reference's static landmark clouds, packet synthesis and their spec
fields are not ported; the dense renderer (synthetic_dense.py) needs only
the pose chains, `ground_truth` gives the evaluator its per-frame view and
`imu_window` the frontend its IMU input.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from dynosam_tpu_torch.frontend.types import GroundTruthFrame
from dynosam_tpu_torch.utils import lie


@dataclass
class ObjectSpec:
    object_id: int
    initial_pose_xi: np.ndarray          # (6,) se(3) body pose in world at k=0
    motion_xi: np.ndarray                # (6,) body motion: L_k = L_{k-1} exp(xi)


@dataclass
class ScenarioSpec:
    num_frames: int = 20
    # per-frame camera twist: (6,) constant or (num_frames-1, 6)
    camera_motion_xi: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.01, 0.0, 0.0, 0.0, 0.4])
    )
    objects: List[ObjectSpec] = field(default_factory=list)
    frame_dt: float = 0.1                # seconds between frames (IMU timing)


class Scenario:
    """Ground-truth chains, f32 on `device`:
    X_gt (K, 4, 4) world_from_cam; per object L_gt (K, 4, 4) body poses and
    H_gt (K, 4, 4) world-frame motions H_k = L_k L_{k-1}^{-1} (identity at 0)."""

    def __init__(self, spec: ScenarioSpec, device="cuda"):
        self.spec = spec
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
