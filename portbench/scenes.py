"""The traffic generator: a bank of synthetic KITTI-scale sequences rendered
on the card from the seed, and the lanes' inputs gathered from it.

The renderer is a frozen copy of the port's scene code
(`dataproviders/synthetic_dense.py::DenseScenario`, the pose chains and
`imu_window` of `dataproviders/simulator.py`, `bench_config.py::
render_right`), written over a leading axis of frames so that a scene
renders in a few large calls. A scene is a camera on a constant twist over
a ground plane and a far wall, and 3-5 planar cars ahead of it, each on
the camera's twist plus a small offset drawn from the seed, so that they
stay in view for the whole sequence. Per frame it gives what the port's
`FrameInputs` carries: rgb, depth, flow (k-1 -> k on frame k-1's pixels),
the instance mask and, as the configuration asks, the rectified right
image, the IMU window of (k-1, k] and the provided depth scaled by a
corruption factor.

Every parameter comes from the traffic file (geometry, objects, S, K) and
the configuration's `inputs` and `camera`; nothing here names a cell.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.frozen.utils import lie

FIELDS = ("rgb", "depth", "flow", "mask", "right", "imu_samples", "imu_valid")


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *salt])


def _chain(xi: np.ndarray, K: int, start: np.ndarray) -> np.ndarray:
    """(K, 4, 4) float64 poses T_k = T_{k-1} exp(xi), T_0 = start."""
    step = lie.se3_exp(torch.as_tensor(xi, dtype=torch.float64)).numpy()
    out = np.empty((K, 4, 4))
    out[0] = start
    for k in range(1, K):
        out[k] = out[k - 1] @ step
    return out


def _box_uv(X: np.ndarray, L: np.ndarray, ext, cam: dict):
    """Projected corners of each frame's object rectangle -> (u_min, u_max,
    v_min, v_max, nearest corner depth, centre depth) per frame, float64."""
    ex, ey = ext
    corners = np.array([[sx * ex, sy * ey, 0.0, 1.0] for sx in (-1, 1) for sy in (-1, 1)])
    rel = np.linalg.inv(X) @ L                                    # (K, 4, 4) cam_from_body
    pc = np.einsum("kij,cj->kci", rel, corners)[..., :3]
    z = pc[..., 2]
    u = cam["fx"] * pc[..., 0] / np.maximum(z, 1e-6) + cam["cx"]
    v = cam["fy"] * pc[..., 1] / np.maximum(z, 1e-6) + cam["cy"]
    return u.min(1), u.max(1), v.min(1), v.max(1), z.min(1), rel[:, 2, 3]


def _visible_cells(boxes, cam: dict, cell: int = 32, every: int = 4):
    """(cars, frames) how many `cell`-pixel cells of each car's box are
    nearer than every other car's, and how many it covers, in every
    `every`-th frame: the cars' boxes rastered coarsely with their centre
    depths (the rendered check after it is exact)."""
    boxes = [tuple(x[::every] for x in b) for b in boxes]
    gw, gh = cam["width"] // cell, cam["height"] // cell
    cx = (np.arange(gw) + 0.5) * cell
    cy = (np.arange(gh) + 0.5) * cell
    z = np.stack([b[4] for b in boxes])                                            # (C, K)
    cover = np.stack([(b[0][:, None, None] <= cx[None, None, :]) & (cx[None, None, :] <= b[1][:, None, None])
                      & (b[2][:, None, None] <= cy[None, :, None]) & (cy[None, :, None] <= b[3][:, None, None])
                      for b in boxes])                                             # (C, K, gh, gw)
    depth = np.where(cover, z[:, :, None, None], np.inf)
    front = (depth == depth.min(0, keepdims=True)) & cover
    return front.sum((-2, -1)), cover.sum((-2, -1))


def draw_objects(seed: int, scene: int, n_obj: int, X: np.ndarray, traffic: dict, cam: dict, attempt: int = 0):
    """The scene's cars, from the seed: each an initial pose ahead of the
    camera and a twist near the camera's, redrawn until its rectangle stays
    inside the image and its centre depth inside the traffic's range, and
    until, with the cars placed before it, no car has more than
    `max_hidden_share` of its box behind nearer cars in any frame.
    -> [(L (K,4,4), motion xi (6,))] float64, or None if `max_draws` draws
    placed fewer than `n_obj`."""
    rng = _rng(seed, 1, scene, attempt)
    o = traffic["objects"]
    K = X.shape[0]
    W, H = cam["width"], cam["height"]
    margin = o["margin_px"]
    cam_xi = np.asarray(traffic["camera_twist"], np.float64)
    placed, boxes = [], []
    for _ in range(o["max_draws"]):
        if len(placed) == n_obj:
            break
        t0 = np.array([rng.uniform(*o["x_m"]), rng.uniform(*o["y_m"]), rng.uniform(*o["z_m"])])
        d = np.array([0.0, rng.uniform(-1, 1) * o["yaw_rate_offset"], 0.0,
                      rng.uniform(-1, 1) * o["lateral_offset_m"], 0.0, rng.uniform(-1, 1) * o["forward_offset_m"]])
        xi = cam_xi + d
        start = np.eye(4)
        start[:3, 3] = t0
        L = _chain(xi, K, X[0] @ start)
        u0, u1, v0, v1, zmin, zc = _box_uv(X, L, o["half_extent_m"], cam)
        if zmin.min() < 1.0 or zc.min() < o["depth_m"][0] or zc.max() > o["depth_m"][1]:
            continue
        if u0.min() < margin or u1.max() > W - 1 - margin or v0.min() < margin or v1.max() > H - 1 - margin:
            continue
        box = (u0, u1, v0, v1, zc)
        front, whole = _visible_cells(boxes + [box], cam)
        if (front < (1.0 - o["max_hidden_share"]) * whole).any():
            continue
        placed.append((L, xi))
        boxes.append(box)
    return placed if len(placed) == n_obj else None


class SceneBank:
    """S sequences of K frames each, every field (S, K, ...) on `device`.

    `gather(lane_scene, k)` gives the batch of lanes' frame k as one
    gather per field. `visible_px` (S, K, J) counts each car's mask pixels.
    The ground truth stays on the host in float64: `X_gt` (K, 4, 4) the
    camera's world pose (every scene's), `L_gt[s]` (n_s, K, 4, 4) scene s's
    cars, car j carrying the mask label and object id j + 1."""

    def __init__(self, seed: int, traffic: dict, config: dict, device, frames=None):
        self.device = torch.device(device)
        cam = config["camera"]
        inputs = config.get("inputs", {})
        self.cam, self.traffic, self.inputs = cam, traffic, inputs
        S = traffic["scenes"]
        K = frames or traffic["frames"]
        self.S, self.K = S, K
        H, W = cam["height"], cam["width"]
        counts = list(traffic["objects"]["per_scene"])
        if len(counts) != S:
            raise ValueError(f"objects.per_scene lists {len(counts)} scenes, the traffic has {S}")
        counts = [counts[i] for i in _rng(seed, 0).permutation(S)]
        cam_xi = np.asarray(traffic["camera_twist"], np.float64)
        X = _chain(cam_xi, K, np.eye(4))
        self.object_counts = counts
        self.X_gt = X
        self.L_gt = [None] * S
        right = bool(inputs.get("right_image"))
        n_imu = int(inputs.get("imu_samples", 0))
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.rgb = torch.empty((S, K, H, W, 3), **f32)
        self.depth = torch.empty((S, K, H, W), **f32)
        self.flow = torch.empty((S, K, H, W, 2), **f32)
        self.mask = torch.empty((S, K, H, W), dtype=torch.int32, device=dev)
        self.right = torch.empty((S, K, H, W, 3), **f32) if right else None
        self.imu_samples = torch.empty((S, K, n_imu, 7), **f32) if n_imu else None
        self.imu_valid = torch.empty((S, K, n_imu), dtype=torch.bool, device=dev) if n_imu else None
        self.visible_px = torch.zeros((S, K, max(counts)), dtype=torch.int64, device=dev)
        self._u = torch.arange(W, **f32)[None, :].expand(H, W)
        self._v = torch.arange(H, **f32)[:, None].expand(H, W)
        self._rgb_const = self._screen_rgb()
        X_t = torch.as_tensor(X, dtype=torch.float32).to(dev)
        min_px = traffic["objects"]["min_visible_px"]
        self.redraws = [0] * S
        for s in range(S):
            # a scene whose rendered cars fall under min_px in some frame
            # (the ground or a car nearer hides one) is drawn again
            for attempt in range(traffic["objects"]["max_scene_draws"]):
                objs = draw_objects(seed, s, counts[s], X, traffic, cam, attempt)
                if objs is not None:
                    self.L_gt[s] = np.stack([o[0] for o in objs])                                       # (J, K, 4, 4)
                    L = torch.as_tensor(self.L_gt[s], dtype=torch.float32).to(dev)
                    self._render(s, X_t, L, cam_xi, n_imu)
                    if int(self.visible_px[s, :, :counts[s]].min()) >= min_px:
                        break
                self.redraws[s] += 1
            else:
                raise RuntimeError(f"scene {s}: no draw of {counts[s]} cars kept them all in view")

    # ------------------------------------------------------------------
    def _screen_rgb(self):
        u, v = self._u, self._v
        g = torch.sin(u * 0.7) * torch.sin(v * 0.9) + 0.5 * torch.sin(u * 0.23 + v * 0.31)
        g = (g - g.min()) / (g.max() - g.min())
        return torch.stack([g, g, g], dim=-1)

    def _rays(self, X):
        """World-frame ray directions (z-normalised in camera), (C, H, W, 3)."""
        cam = self.cam
        dx = (self._u - cam["cx"]) / cam["fx"]
        dy = (self._v - cam["cy"]) / cam["fy"]
        R = lie.rotation(X)                                           # (C, 3, 3)
        return (R[:, None, None, :, 0] * dx[None, ..., None] + R[:, None, None, :, 1] * dy[None, ..., None]
                + R[:, None, None, :, 2])

    def _depth_mask(self, X, L):
        """Depth and instance mask at camera poses X (C, 4, 4) with the cars
        at L (J, C, 4, 4): ground plane, far wall, then each car's
        rectangle where it is nearer."""
        tr = self.traffic
        d = self._rays(X)
        t = lie.translation(X)[:, None, None, :]                      # (C, 1, 1, 3)
        dy, dz = d[..., 1], d[..., 2]
        lam_ground = (tr["ground_y_m"] - t[..., 1]) / torch.where(torch.abs(dy) < 1e-6, 1e-6, dy)
        lam_wall = (tr["far_depth_m"] - t[..., 2]) / torch.where(torch.abs(dz) < 1e-6, 1e-6, dz)
        big = 4.0 * tr["far_depth_m"]
        lam_ground = torch.where(lam_ground > 0.1, lam_ground, big)
        lam_wall = torch.where(lam_wall > 0.1, lam_wall, big)
        depth = torch.clamp(torch.minimum(lam_ground, lam_wall), 0.1, big)
        mask = torch.zeros(depth.shape, dtype=torch.int32, device=self.device)
        ex, ey = tr["objects"]["half_extent_m"]
        for j in range(L.shape[0]):
            RL = lie.rotation(L[j])                                   # (C, 3, 3)
            p0 = lie.translation(L[j])                                # (C, 3)
            n = RL[..., :, 2]
            denom = torch.einsum("chwk,ck->chw", d, n)
            safe = torch.where(torch.abs(denom) < 1e-4, 1e-4, denom)
            lam = torch.einsum("ck,ck->c", n, p0 - t[:, 0, 0])[:, None, None] / safe
            hit = t + d * lam[..., None] - p0[:, None, None, :]
            body = torch.einsum("cki,chwk->chwi", RL, hit)
            inside = ((lam > 0.5) & (torch.abs(denom) > 1e-3) & (torch.abs(body[..., 0]) < ex)
                      & (torch.abs(body[..., 1]) < ey))
            occludes = inside & (lam < depth)
            depth = torch.where(occludes, lam, depth)
            mask = torch.where(occludes, j + 1, mask)
        return depth, mask

    def _backproject(self, depth):
        cam = self.cam
        x = (self._u - cam["cx"]) / cam["fx"] * depth
        y = (self._v - cam["cy"]) / cam["fy"] * depth
        return torch.stack([x, y, depth], dim=-1)

    def _project(self, p):
        cam = self.cam
        z = p[..., 2]
        safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        return torch.stack([cam["fx"] * p[..., 0] / safe + cam["cx"], cam["fy"] * p[..., 1] / safe + cam["cy"]], -1)

    def _world_rgb(self, X, L, depth, mask):
        """The photo-consistent texture: a fixed function of the surface
        point in its anchor frame (world, or the car's body frame), band
        limited by each octave's pixel footprint."""
        pts = lie.transform_points(X[:, None, None], self._backproject(depth))
        anchor = pts
        for j in range(L.shape[0]):
            p_L = lie.transform_points(lie.inverse(L[j])[:, None, None], pts)
            anchor = torch.where((mask == j + 1)[..., None], p_L, anchor)
        x, y, z = anchor[..., 0], anchor[..., 1], anchor[..., 2]
        foot = depth / self.cam["fx"]

        def att(freq):
            return torch.exp(-0.5 * (freq * foot) ** 2)

        g = (att(5.5) * torch.sin(4.1 * x) * torch.sin(3.7 * y + 0.9 * z)
             + 0.6 * att(12.1) * torch.sin(9.3 * x + 7.7 * y) * torch.sin(8.1 * z)
             + 0.5 * att(1.9) * torch.sin(1.1 * x + 1.3 * y + 0.7 * z)
             + 0.45 * att(0.8) * torch.sin(0.55 * x + 0.62 * y) * torch.sin(0.48 * z + 1.1))
        g = torch.clamp(0.5 + 0.24 * g, 0.0, 1.0)
        return torch.stack([g, g, g], dim=-1)

    def _render(self, s, X, L, cam_xi, n_imu):
        tr, inputs = self.traffic, self.inputs
        C, K = tr["render_chunk"], self.K
        world = bool(tr.get("world_texture"))
        scale = float(inputs.get("depth_scale", 1.0))
        uv = torch.stack([self._u, self._v], dim=-1)
        prev = None                       # (depth, mask) of the frame before the chunk
        for k0 in range(0, K, C):
            ks = slice(k0, min(k0 + C, K))
            depth, mask = self._depth_mask(X[ks], L[:, ks])
            self.depth[s, ks] = depth * scale if scale != 1.0 else depth
            self.mask[s, ks] = mask
            for j in range(L.shape[0]):
                self.visible_px[s, ks, j] = (mask == j + 1).sum((-2, -1))
            self.rgb[s, ks] = self._world_rgb(X[ks], L[:, ks], depth, mask) if world else self._rgb_const
            if self.right is not None:
                T_lr = torch.eye(4, dtype=torch.float32, device=self.device)
                T_lr[0, 3] = float(self.cam["baseline"])
                X_r = lie.compose(X[ks], T_lr)
                d_r, m_r = self._depth_mask(X_r, L[:, ks])
                self.right[s, ks] = self._world_rgb(X_r, L[:, ks], d_r, m_r)
            # flow of frame k on frame k-1's pixels, from the true depth
            if prev is None:
                self.flow[s, 0] = 0.0
                d_prev, m_prev, kf = depth[:-1], mask[:-1], slice(1, ks.stop)
            else:
                d_prev = torch.cat([prev[0], depth[:-1]])
                m_prev = torch.cat([prev[1], mask[:-1]])
                kf = ks
            if kf.stop > kf.start:
                kp = slice(kf.start - 1, kf.stop - 1)
                pts_w = lie.transform_points(X[kp][:, None, None], self._backproject(d_prev))
                moved = pts_w
                for j in range(L.shape[0]):
                    Hj = lie.compose(L[j, kf], lie.inverse(L[j, kp]))
                    moved = torch.where((m_prev == j + 1)[..., None],
                                        lie.transform_points(Hj[:, None, None], pts_w), moved)
                pts_k = lie.transform_points(lie.inverse(X[kf])[:, None, None], moved)
                self.flow[s, kf] = self._project(pts_k) - uv
            prev = (depth[-1:], mask[-1:])
        if n_imu:
            self.imu_samples[s], self.imu_valid[s] = self._imu(X, cam_xi, n_imu, tr["frame_dt_s"])

    def _imu(self, X, cam_xi, n, dt_f):
        """The exact IMU windows of every frame: (K, n, 7) rows [dt ax ay az
        gx gy gz] and (K, n) masks; frame 0's window is all invalid.
        Within an interval the twist is constant: gyro = w_b, specific force
        f(t) = w_b x v_b - R(t)^T g, R(t) = R_{k-1} exp(hat(w_b) t)."""
        dev, K = self.device, self.K
        xi = torch.as_tensor(cam_xi, dtype=torch.float32, device=dev)
        w_b, v_b = xi[:3] / dt_f, xi[3:] / dt_f
        g = torch.tensor(self.traffic["gravity"], dtype=torch.float32, device=dev)
        dt_s = dt_f / n
        t_mid = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) * dt_s
        R_prev = lie.rotation(X[:-1])                                              # (K-1, 3, 3)
        R_t = lie.mm(R_prev[:, None], lie.so3_exp(w_b[None, :] * t_mid[:, None])[None])  # (K-1, n, 3, 3)
        f = torch.linalg.cross(w_b, v_b)[None, None, :] - torch.einsum("ksba,b->ksa", R_t, g)
        rows = torch.cat([torch.full((K - 1, n, 1), dt_s, dtype=torch.float32, device=dev), f,
                          w_b.expand(K - 1, n, 3)], dim=-1)
        samples = torch.cat([torch.zeros((1, n, 7), dtype=torch.float32, device=dev), rows])
        valid = torch.ones((K, n), dtype=torch.bool, device=dev)
        valid[0] = False
        return samples, valid

    # ------------------------------------------------------------------
    def gather(self, lane_scene: torch.Tensor, k: int) -> dict:
        """{field: (B, ...)} of frame k of each lane's scene, one gather per
        field, and frame_id (B,) int32."""
        out = {"frame_id": torch.full(lane_scene.shape, k, dtype=torch.int32, device=self.device)}
        for name in FIELDS:
            bank = getattr(self, name)
            if bank is not None:
                out[name] = bank[:, k][lane_scene]
        return out

    def check_visible(self, min_px: int) -> list:
        """Each car's fewest and most mask pixels over the frames, per scene;
        RuntimeError if a car falls under `min_px` in any frame."""
        px = self.visible_px.cpu().numpy()
        lines = []
        for s, n in enumerate(self.object_counts):
            low, high = px[s, :, :n].min(0), px[s, :, :n].max(0)
            lines.append(f"scene {s}: {n} cars, drawn {self.redraws[s] + 1} time(s), visible px per frame "
                         f"min {low.tolist()} max {high.tolist()}")
            if (low < min_px).any():
                raise RuntimeError(f"scene {s}: a car shows {int(low.min())} px in some frame, under {min_px}")
        return lines


def lane_scenes(B: int, S: int, sequence: int, device) -> torch.Tensor:
    """(B,) the scene lane b plays in the sweep's `sequence`-th round:
    (b + sequence) mod S."""
    return (torch.arange(B, device=device) + sequence) % S

