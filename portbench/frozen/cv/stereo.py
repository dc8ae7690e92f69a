"""Stereo camera: rectification geometry, undistort-rectify maps, sparse
stereo (L->R KLT) depth and dense block-matching disparity (port of
dynosam_tpu/cv/stereo.py).

The rectification parameters (R1, R2, the shared pinhole, the baseline) and
the per-pixel source maps depend only on the calibration: they are computed
once on the host in numpy, as in the reference (whose host code this file
copies). Applying the maps, the stereo KLT matching and the dense matcher
run on the images' device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.frozen.cv import camera as cam
from portbench.frozen.ops import lk


# ---------------------------------------------------------------------------
# Calibration (host, numpy)
# ---------------------------------------------------------------------------

@dataclass
class MonoCalibration:
    """One physical camera: pinhole + distortion."""

    K: np.ndarray                        # (3, 3) intrinsics
    dist: np.ndarray = field(default_factory=lambda: np.zeros(4))
    model: str = "radtan"                # "radtan" (k1 k2 p1 p2) | "equidistant"
    width: int = 0
    height: int = 0

    @classmethod
    def create(cls, fx, fy, cx, cy, width, height, dist=None, model="radtan"):
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        d = np.zeros(4) if dist is None else np.asarray(dist, np.float64)
        return cls(K=K, dist=d, model=model, width=int(width), height=int(height))


def _distort_normalized(x, y, dist, model):
    """The forward distortion model on normalized coordinates."""
    if model == "radtan":
        k1, k2, p1, p2 = dist[:4]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return xd, yd
    if model == "equidistant":
        k1, k2, k3, k4 = dist[:4]
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        t2 = theta * theta
        theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
        scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
        return x * scale, y * scale
    raise ValueError(f"unknown distortion model {model!r}")


def _rodrigues(r):
    """Axis-angle (3,) -> rotation matrix."""
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _log_so3(R):
    """Rotation matrix -> axis-angle."""
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (2 * np.sin(theta))
    return w * theta


def stereo_rectify(left: MonoCalibration, right: MonoCalibration, T_left_right: np.ndarray) -> dict:
    """Rectification rotations + the shared rectified pinhole.

    T_left_right: (4, 4) pose of the right camera in the left camera frame.
    Returns dict(R1, R2, fx, fy, cx, cy, baseline): R1/R2 rotate each camera
    frame into the common rectified frame whose x-axis is the baseline (the
    relative rotation split evenly between the cameras, then x aligned with
    the translation, as cv::stereoRectify)."""
    R_lr = T_left_right[:3, :3]
    t = T_left_right[:3, 3]
    r = _log_so3(R_lr)
    R_half_l = _rodrigues(0.5 * r)
    R_half_r = _rodrigues(-0.5 * r)
    t_mid = R_half_r @ t

    e1 = t_mid / np.linalg.norm(t_mid)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = e2 / n2 if n2 > 1e-9 else np.array([0.0, 1.0, 0.0])
    e3 = np.cross(e1, e2)
    R_rect = np.stack([e1, e2, e3])

    R1 = R_rect @ R_half_l.T
    R2 = R_rect @ R_half_r.T
    fx = 0.5 * (left.K[0, 0] + right.K[0, 0])
    fy = 0.5 * (left.K[1, 1] + right.K[1, 1])
    cx = 0.5 * (left.K[0, 2] + right.K[0, 2])
    cy = 0.5 * (left.K[1, 2] + right.K[1, 2])
    baseline = float(np.linalg.norm(t))
    return dict(R1=R1, R2=R2, fx=fx, fy=fy, cx=cx, cy=cy, baseline=baseline)


def undistort_rectify_map(calib: MonoCalibration, R: np.ndarray, fx: float, fy: float,
                          cx: float, cy: float) -> np.ndarray:
    """(H, W, 2) float32 source-pixel coordinates of each rectified target
    pixel (cv::initUndistortRectifyMap): target pixel -> rectified ray ->
    rotated back by R^T -> distorted -> original pixel."""
    H, W = calib.height, calib.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x = (u - cx) / fx
    y = (v - cy) / fy
    ray = np.stack([x, y, np.ones_like(x)], axis=-1)
    src = ray @ R
    xs = src[..., 0] / src[..., 2]
    ys = src[..., 1] / src[..., 2]
    xd, yd = _distort_normalized(xs, ys, calib.dist, calib.model)
    K = calib.K
    map_u = K[0, 0] * xd + K[0, 2]
    map_v = K[1, 1] * yd + K[1, 2]
    return np.stack([map_u, map_v], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def remap_bilinear(img, src_map):
    """Sample img (H, W[, C]) at src_map (H', W', 2) pixel coordinates;
    sources outside clamp to the border (cv::BORDER_REPLICATE)."""
    H, W = img.shape[:2]
    u = torch.clamp(src_map[..., 0], 0.0, W - 1.001)
    v = torch.clamp(src_map[..., 1], 0.0, H - 1.001)
    u0f, v0f = torch.floor(u), torch.floor(v)
    u0, v0 = u0f.to(torch.int64), v0f.to(torch.int64)
    du, dv = u - u0f, v - v0f
    if img.ndim == 3:
        du, dv = du[..., None], dv[..., None]

    def g(dv_, du_):
        return img[v0 + dv_, u0 + du_]

    top = g(0, 0) * (1 - du) + g(0, 1) * du
    bot = g(1, 0) * (1 - du) + g(1, 1) * du
    return top * (1 - dv) + bot * dv


class StereoCamera:
    """Rectified stereo rig (StereoCamera + UndistortRectifier roles): the
    rectification and the remap grids are computed on the host at
    construction, the grids kept as tensors on `device`; `rectify` runs
    there. `intrinsics()` is the rectified pinhole the pipeline uses."""

    def __init__(self, left: MonoCalibration, right: MonoCalibration, T_left_right: np.ndarray,
                 device="cuda"):
        p = stereo_rectify(left, right, T_left_right)
        self.baseline = p["baseline"]
        self.fx, self.fy = float(p["fx"]), float(p["fy"])
        self.cx, self.cy = float(p["cx"]), float(p["cy"])
        self.R1, self.R2 = p["R1"], p["R2"]
        self.map_left = torch.as_tensor(
            undistort_rectify_map(left, p["R1"], self.fx, self.fy, self.cx, self.cy), device=device)
        self.map_right = torch.as_tensor(
            undistort_rectify_map(right, p["R2"], self.fx, self.fy, self.cx, self.cy), device=device)
        self.width, self.height = left.width, left.height

    def intrinsics(self) -> cam.CameraIntrinsics:
        return cam.CameraIntrinsics.create(
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
            width=self.width, height=self.height, baseline=self.baseline,
        )

    def rectify(self, left_img, right_img):
        return remap_bilinear(left_img, self.map_left), remap_bilinear(right_img, self.map_right)

    def depth_from_disparity(self, disparity):
        """Rectified disparity (pixels) -> metric depth."""
        return self.fx * self.baseline / torch.clamp(disparity, min=1e-6)


# ---------------------------------------------------------------------------
# Sparse stereo matching (stereoTrack)
# ---------------------------------------------------------------------------

def stereo_track(left_gray, right_gray, uv_left, valid, fx: float, baseline: float, *,
                 levels: int = 3, half: int = 4, iters: int = 12, min_eig: float = 1e-4,
                 fb_threshold: float = 1.0, epipolar_tolerance: float = 1.0,
                 min_disparity: float = 0.1, max_disparity: float = 256.0):
    """Match left keypoints (..., N, 2) into the rectified right image
    (..., H, W) with KLT and its flow-back check, gate on the epipolar row
    (|dv|) and the disparity range, and triangulate -> (depth (..., N),
    uv_right (..., N, 2), ok (..., N)); leading axes are sequences."""
    uv_right, ok = lk.lk_track(left_gray, right_gray, uv_left, valid, levels=levels, half=half,
                               iters=iters, min_eig=min_eig, fb_check=True,
                               fb_threshold=fb_threshold)
    dv = uv_right[..., 1] - uv_left[..., 1]
    disparity = uv_left[..., 0] - uv_right[..., 0]
    ok = (ok & (torch.abs(dv) <= epipolar_tolerance) & (disparity > min_disparity)
          & (disparity < max_disparity))
    depth = fx * baseline / torch.clamp(disparity, min=min_disparity)
    return depth, uv_right, ok


# ---------------------------------------------------------------------------
# Dense stereo matching
# ---------------------------------------------------------------------------

def _box_filter(x, half: int):
    """Mean over a (2*half+1)^2 window of the last two axes, outside pixels
    counting as 0 (the reference's reduce_window pads with its init value);
    the window is summed row by row, left to right. The divisor is a tensor
    on x's device: CUDA divides by a host scalar as a multiply by its
    reciprocal, one ulp off the CPU's (and the reference's) quotient."""
    k = 2 * half + 1
    H, W = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (half, half, half, half))
    s = torch.zeros_like(x)
    for i in range(k):
        for j in range(k):
            s = s + xp[..., i:i + H, j:j + W]
    return s / torch.tensor(float(k * k), dtype=s.dtype, device=s.device)


def dense_disparity(left_gray, right_gray, *, num_disparities: int = 64, block_size: int = 5,
                    uniqueness_ratio: float = 0.15, lr_threshold: float = 1.25,
                    subpixel: bool = True):
    """Block-matching dense disparity in the left image's frame: the full
    (D, H, W) SAD cost volume (box-filtered), winner-take-all with parabolic
    sub-pixel refinement, a uniqueness gate against the best cost outside
    +-1 disparity and a left-right consistency check on the same volume
    (cost_R[d, y, x] = cost_L[d, y, x + d]). Returns (disparity (H, W)
    float32, valid (H, W) bool); invalid pixels have disparity 0."""
    L = left_gray.to(torch.float32)
    R = right_gray.to(torch.float32)
    H, W = L.shape
    D = num_disparities
    dev = L.device
    big = 1e9

    # R shifted right by d, wrapping around as jnp.roll: R_d[:, x] = R[:, x - d]
    d_idx = torch.arange(D, device=dev)
    xs = torch.arange(W, device=dev)
    src = (xs[None, :] - d_idx[:, None]) % W                      # (D, W)
    Rd = R[:, src].permute(1, 0, 2)                               # (D, H, W)
    cost = _box_filter(torch.abs(L[None] - Rd), block_size // 2)
    cost = torch.where(xs[None, None, :] >= d_idx[:, None, None], cost, big)

    best = torch.argmin(cost, dim=0)                              # first index on ties
    cmin = torch.amin(cost, dim=0)

    near = torch.abs(d_idx[:, None, None] - best[None]) <= 1
    second = torch.amin(torch.where(near, big, cost), dim=0)
    unique_ok = cmin * (1.0 + uniqueness_ratio) <= second

    cm = torch.gather(cost, 0, torch.clamp(best - 1, 0, D - 1)[None])[0]
    cp = torch.gather(cost, 0, torch.clamp(best + 1, 0, D - 1)[None])[0]
    denom = cm - 2.0 * cmin + cp
    delta = torch.where(denom > 1e-9, 0.5 * (cm - cp) / torch.clamp(denom, min=1e-9), 0.0)
    disp = best.to(torch.float32) + (torch.clamp(delta, -0.5, 0.5) if subpixel else 0.0)

    # left-right check: the right image's winner at x_R = x - d must agree
    xr_src = torch.clamp(xs[None, :] + d_idx[:, None], 0, W - 1)  # (D, W)
    cost_r = torch.gather(cost, 2, xr_src[:, None, :].expand(D, H, W))
    best_r = torch.argmin(cost_r, dim=0)
    xr = torch.clamp(xs[None, :] - best, 0, W - 1)
    lr = torch.gather(best_r, 1, xr)
    lr_ok = torch.abs(lr - best) <= lr_threshold

    valid = unique_ok & lr_ok & (best > 0) & (best < D - 1) & (xs[None, :] >= best) & (cmin < big)
    return torch.where(valid, disp, 0.0), valid


def dense_stereo_depth(left_gray, right_gray, fx: float, baseline: float, **kwargs):
    """Dense metric depth from a rectified pair; 0 where invalid."""
    disp, valid = dense_disparity(left_gray, right_gray, **kwargs)
    depth = fx * baseline / torch.clamp(disp, min=1e-3)
    return torch.where(valid, depth, 0.0)
