"""Dense synthetic RGB-D scene renderer (port of
dynosam_tpu/dataproviders/synthetic_dense.py).

Ground plane (y = ground_y) and far wall (z = far_depth) as the background,
objects as rectangles rigidly attached to their body frames (ray-plane
intersection); per-pixel depth, instance mask and flow (frame k-1 pixels
mapped by the GT motion into frame k) come from the same rigid model, so a
correct frontend recovers the GT camera pose and object motions. Rendering
runs with torch on the scenario's device.

The image is a constant screen-space texture by default. `world_texture`
makes it a function of the 3D surface point instead, so it moves with the
geometry; `object_texture` adds a per-class appearance to object pixels, the
cue the committed detector checkpoint was trained on, and like the
reference's it acts only on the world texture.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.dataproviders.simulator import ObjectSpec, Scenario, ScenarioSpec
from dynosam_tpu_torch.frontend.types import FrameInputs
from dynosam_tpu_torch.utils import lie


class DenseScenario:
    """Wraps a Scenario and renders FrameInputs per frame on `device`."""

    def __init__(
        self,
        spec: ScenarioSpec,
        intr: cam.CameraIntrinsics,
        ground_y: float = 1.5,
        far_depth: float = 40.0,
        world_texture: bool = False,
        object_texture: bool = False,
        object_half_extents=None,   # per-object (ex, ey); default 1.2 x 1.2 m
        object_classes=None,        # optional per-object class ids
        device="cuda",
    ):
        assert intr.width > 0 and intr.height > 0
        self.device = torch.device(device)
        self.scn = Scenario(spec, self.device)
        self.intr = intr
        self.world_texture = world_texture
        self.object_texture = object_texture
        self.ground_y = ground_y
        self.far_depth = far_depth
        J = len(self.scn.object_ids)
        self.obj_extents = (
            [(float(ex), float(ey)) for ex, ey in object_half_extents]
            if object_half_extents is not None
            else [(1.2, 1.2)] * J
        )
        self.object_classes = (
            [int(c) for c in object_classes] if object_classes is not None else [0] * J
        )
        H, W = intr.height, intr.width
        self._u = torch.arange(W, dtype=torch.float32, device=self.device)[None, :].expand(H, W)
        self._v = torch.arange(H, dtype=torch.float32, device=self.device)[:, None].expand(H, W)
        self._rgb_const = self._make_rgb()

    # ------------------------------------------------------------------
    def _pixel_rays(self, X):
        """World-frame ray directions (z-normalised in camera), (H, W, 3)."""
        intr = self.intr
        dx = (self._u - intr.cx) / intr.fx
        dy = (self._v - intr.cy) / intr.fy
        R = lie.rotation(X)
        return (
            R[:, 0][None, None, :] * dx[..., None]
            + R[:, 1][None, None, :] * dy[..., None]
            + R[:, 2][None, None, :]
        )

    def _background_depth(self, X, d_world):
        """Ground plane + world-fixed far wall, both true world surfaces."""
        t = lie.translation(X)
        dy = d_world[..., 1]
        lam_ground = (self.ground_y - t[1]) / torch.where(torch.abs(dy) < 1e-6, 1e-6, dy)
        dz = d_world[..., 2]
        lam_wall = (self.far_depth - t[2]) / torch.where(torch.abs(dz) < 1e-6, 1e-6, dz)
        big = 4.0 * self.far_depth
        lam_ground = torch.where(lam_ground > 0.1, lam_ground, big)
        lam_wall = torch.where(lam_wall > 0.1, lam_wall, big)
        return torch.clamp(torch.minimum(lam_ground, lam_wall), 0.1, big)

    def _depth_mask(self, X, L_list):
        """Depth + instance mask at camera pose X with object poses L_list."""
        d_world = self._pixel_rays(X)
        t = lie.translation(X)
        depth = self._background_depth(X, d_world)
        mask = torch.zeros(depth.shape, dtype=torch.int32, device=self.device)
        for (oid, L), (ex, ey) in zip(zip(self.scn.object_ids, L_list), self.obj_extents):
            RL = lie.rotation(L)
            p0 = lie.translation(L)
            n = RL[:, 2]
            denom = torch.einsum("hwc,c->hw", d_world, n)
            safe = torch.where(torch.abs(denom) < 1e-4, 1e-4, denom)
            lam = torch.dot(n, p0 - t) / safe
            hit_w = t[None, None, :] + d_world * lam[..., None]
            hit_body = torch.einsum("ci,hwc->hwi", RL, hit_w - p0[None, None, :])
            inside = (
                (lam > 0.5)
                & (torch.abs(denom) > 1e-3)
                & (torch.abs(hit_body[..., 0]) < ex)
                & (torch.abs(hit_body[..., 1]) < ey)
            )
            occludes = inside & (lam < depth)
            depth = torch.where(occludes, lam, depth)
            mask = torch.where(occludes, oid, mask)
        return depth, mask

    def _flow(self, X_prev, X_k, depth_prev, mask_prev, H_list):
        uv = torch.stack([self._u, self._v], dim=-1)
        pts_cam = cam.backproject(uv, depth_prev, self.intr)
        pts_w = lie.transform_points(X_prev, pts_cam)
        pts_w_moved = pts_w
        for oid, Hj in zip(self.scn.object_ids, H_list):
            moved = lie.transform_points(Hj, pts_w)
            pts_w_moved = torch.where((mask_prev == oid)[..., None], moved, pts_w_moved)
        pts_cam_k = lie.transform_points(lie.inverse(X_k), pts_w_moved)
        return cam.project(pts_cam_k, self.intr) - uv

    def _make_rgb(self):
        u, v = self._u, self._v
        g = torch.sin(u * 0.7) * torch.sin(v * 0.9) + 0.5 * torch.sin(u * 0.23 + v * 0.31)
        g = (g - g.min()) / (g.max() - g.min())
        return torch.stack([g, g, g], dim=-1)

    def _world_rgb(self, X_k, L_list, depth, mask):
        """Photo-consistent texture: a fixed function of the surface point in
        its anchor frame (world for the background, the body frame for
        object pixels), band-limited by each octave's pixel footprint."""
        uv = torch.stack([self._u, self._v], dim=-1)
        pts_w = lie.transform_points(X_k, cam.backproject(uv, depth, self.intr))
        anchor = pts_w
        body = []
        for oid, L in zip(self.scn.object_ids, L_list):
            p_L = lie.transform_points(lie.inverse(L), pts_w)
            body.append(p_L)
            anchor = torch.where((mask == oid)[..., None], p_L, anchor)
        x, y, z = anchor[..., 0], anchor[..., 1], anchor[..., 2]
        foot = depth / self.intr.fx                     # metres per pixel

        def att(freq):
            return torch.exp(-0.5 * (freq * foot) ** 2)

        g = (
            att(5.5) * torch.sin(4.1 * x) * torch.sin(3.7 * y + 0.9 * z)
            + 0.6 * att(12.1) * torch.sin(9.3 * x + 7.7 * y) * torch.sin(8.1 * z)
            + 0.5 * att(1.9) * torch.sin(1.1 * x + 1.3 * y + 0.7 * z)
            + 0.45 * att(0.8) * torch.sin(0.55 * x + 0.62 * y) * torch.sin(0.48 * z + 1.1)
        )
        g = torch.clamp(0.5 + 0.24 * g, 0.0, 1.0)
        if self.object_texture:
            # class 0: fine body-frame check pattern, brighter; class 1:
            # coarse horizontal stripes, darker
            for j, (oid, p_L) in enumerate(zip(self.scn.object_ids, body)):
                if self.object_classes[j] == 0:
                    chk = 0.20 * torch.sin(17.0 * p_L[..., 0] + 2.1 * j) * torch.sin(
                        15.0 * p_L[..., 1] + 1.3 * j
                    )
                    bias = 0.14
                else:
                    chk = 0.22 * torch.sin(6.0 * p_L[..., 1] + 0.7 * j)
                    bias = -0.14
                g = torch.where(mask == oid, torch.clamp(g + bias + chk, 0.0, 1.0), g)
        return torch.stack([g, g, g], dim=-1)

    # public API -----------------------------------------------------------
    def frame(self, k: int) -> FrameInputs:
        k_prev = max(k - 1, 0)
        scn = self.scn
        L_k = [L[k] for L in scn.L_gt]
        depth, mask = self._depth_mask(scn.X_gt[k], L_k)
        if k > 0:
            depth_prev, mask_prev = self._depth_mask(
                scn.X_gt[k_prev], [L[k_prev] for L in scn.L_gt]
            )
            flow = self._flow(
                scn.X_gt[k_prev], scn.X_gt[k], depth_prev, mask_prev,
                [Hs[k] for Hs in scn.H_gt],
            )
        else:
            flow = torch.zeros(depth.shape + (2,), dtype=torch.float32, device=self.device)
        return FrameInputs(
            frame_id=torch.tensor(k, dtype=torch.int32, device=self.device),
            rgb=self._world_rgb(scn.X_gt[k], L_k, depth, mask) if self.world_texture else self._rgb_const,
            depth=depth,
            flow=flow,
            mask=mask,
        )

    def frames(self) -> List[FrameInputs]:
        return [self.frame(k) for k in range(self.scn.spec.num_frames)]


def default_dense_scenario(
    num_frames=10, width=160, height=120, fov_scale=0.5, world_texture=False, device="cuda"
) -> DenseScenario:
    """The small dense test scene of the reference: camera driving forward,
    two objects."""
    intr = cam.CameraIntrinsics.create(
        fx=width * fov_scale, fy=width * fov_scale, cx=width / 2, cy=height / 2,
        width=width, height=height, baseline=0.54,
    )
    spec = ScenarioSpec(
        num_frames=num_frames,
        camera_motion_xi=np.array([0.0, 0.004, 0.0, 0.0, 0.0, 0.25]),
        objects=[
            ObjectSpec(
                object_id=1,
                initial_pose_xi=np.array([0.0, 0.0, 0.0, -2.5, 0.2, 10.0]),
                motion_xi=np.array([0.0, 0.01, 0.0, 0.3, 0.0, 0.05]),
            ),
            ObjectSpec(
                object_id=2,
                initial_pose_xi=np.array([0.0, 0.0, 0.0, 3.0, 0.0, 14.0]),
                motion_xi=np.array([0.0, -0.008, 0.0, -0.25, 0.0, 0.1]),
            ),
        ],
    )
    return DenseScenario(spec, intr, world_texture=world_texture, device=device)
