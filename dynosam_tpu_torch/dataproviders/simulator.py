"""Kinematic scenario: ground-truth camera and object pose chains
(port of the trajectory part of dynosam_tpu/dataproviders/simulator.py).

The reference's static landmark clouds, packet synthesis and their spec
fields are not ported; the dense renderer (synthetic_dense.py) needs only
the pose chains.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

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


class Scenario:
    """Ground-truth chains, f32 on `device`:
    X_gt (K, 4, 4) world_from_cam; per object L_gt (K, 4, 4) body poses and
    H_gt (K, 4, 4) world-frame motions H_k = L_k L_{k-1}^{-1} (identity at 0)."""

    def __init__(self, spec: ScenarioSpec, device="cpu"):
        self.spec = spec
        K = spec.num_frames

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        xi = np.asarray(spec.camera_motion_xi, np.float32)
        if xi.ndim == 1:
            xi = np.tile(xi[None, :], (max(K - 1, 1), 1))
        twists = t(xi)
        poses = [lie.identity(device=device)]
        for k in range(K - 1):
            poses.append(lie.compose(poses[-1], lie.se3_exp(twists[k])))
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
