"""IMU preintegration on the manifold (port of dynosam_tpu/frontend/imu.py).

A host buffer hands each frame a padded (S, 7) window of rows
[dt, ax, ay, az, gx, gy, gz] with a validity mask; preintegration runs on
the window's device:

    dR_{i+1} = dR_i * exp((w_i - bg) dt)
    dv_{i+1} = dv_i + dR_i (a_i - ba) dt
    dp_{i+1} = dp_i + dv_i dt + 0.5 dR_i (a_i - ba) dt^2

The reference's scan becomes a loop over the S samples; the S rotation
increments exp((w_i - bg) dt_i) are computed in one batch first. The result
feeds the ego-motion solver's rotation prior and the IMU prediction of the
prior/fallback pose. Windows, poses and velocities may carry leading axes
of sequences (the batched step): (B, S, 7) windows give a (B,) `Pim.dt`.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

from portbench.frozen.utils import lie


@dataclass
class ImuParams:
    gravity: torch.Tensor       # (3,) world gravity
    accel_bias: torch.Tensor    # (3,)
    gyro_bias: torch.Tensor     # (3,)

    @classmethod
    def create(cls, gravity=(0.0, 0.0, -9.81), accel_bias=(0.0, 0.0, 0.0),
               gyro_bias=(0.0, 0.0, 0.0), device="cuda"):
        def vec(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return cls(gravity=vec(gravity), accel_bias=vec(accel_bias), gyro_bias=vec(gyro_bias))


@dataclass
class Pim:
    """Preintegrated IMU measurement between two frames (body frame i)."""

    dR: torch.Tensor    # (..., 3, 3)
    dv: torch.Tensor    # (..., 3)
    dp: torch.Tensor    # (..., 3)
    dt: torch.Tensor    # (...,)

    @classmethod
    def identity(cls, dtype=torch.float32, device="cuda"):
        return cls(
            dR=torch.eye(3, dtype=dtype, device=device),
            dv=torch.zeros(3, dtype=dtype, device=device),
            dp=torch.zeros(3, dtype=dtype, device=device),
            dt=torch.zeros((), dtype=dtype, device=device),
        )


def preintegrate(samples, valid, params: ImuParams) -> Pim:
    """Integrate a padded window: samples (..., S, 7), valid (..., S) bool;
    invalid rows count with dt = 0. Leading axes are sequences."""
    dt = torch.where(valid, samples[..., 0], 0.0)
    acc = samples[..., 1:4] - params.accel_bias
    exp_w = lie.so3_exp((samples[..., 4:7] - params.gyro_bias) * dt[..., None])    # (..., S, 3, 3)
    lead = samples.shape[:-2]
    dR = torch.eye(3, dtype=samples.dtype, device=samples.device).expand(lead + (3, 3))
    dv = samples.new_zeros(lead + (3,))
    dp = samples.new_zeros(lead + (3,))
    T = samples.new_zeros(lead)
    for i in range(samples.shape[-2]):
        dt_i = dt[..., i]
        a_rot = lie.rotate_points(dR, acc[..., i, :])
        dp = dp + dv * dt_i[..., None] + 0.5 * a_rot * dt_i[..., None] * dt_i[..., None]
        dv = dv + a_rot * dt_i[..., None]
        dR = lie.mm(dR, exp_w[..., i, :, :])
        T = T + dt_i
    return Pim(dR=dR, dv=dv, dp=dp, dt=T)


def predict(X_prev, v_prev, pim: Pim, params: ImuParams):
    """Nav-state propagation: X_prev (..., 4, 4) world_from_body at k-1 and
    v_prev (..., 3) world velocity -> (X_pred (..., 4, 4), v_pred (..., 3))
    at k."""
    R_prev = lie.rotation(X_prev)
    t_prev = lie.translation(X_prev)
    g = params.gravity
    dt = pim.dt[..., None]
    t_new = t_prev + v_prev * dt + 0.5 * g * dt * dt + lie.rotate_points(R_prev, pim.dp)
    v_new = v_prev + g * dt + lie.rotate_points(R_prev, pim.dv)
    R_new = lie.mm(R_prev, pim.dR)
    return lie.make_pose(R_new, t_new), v_new


def rotation_prior(pim: Pim):
    """Relative rotation R_{k-1,k} (..., 3, 3) for the rotation-prior RANSAC."""
    return pim.dR


class ImuBuffer:
    """Host-side timestamp-indexed buffer (ThreadSafeImuBuffer analogue):
    collects (t, accel, gyro) samples and emits fixed-size padded windows
    [t0, t1) for preintegration."""

    def __init__(self, window_capacity: int = 64):
        self.capacity = window_capacity
        self._samples = collections.deque(maxlen=100_000)

    def add(self, t: float, accel, gyro):
        self._samples.append((float(t), tuple(accel), tuple(gyro)))

    def window(self, t0: float, t1: float):
        """Padded (S, 7) float32 rows + (S,) bool mask of the samples in
        [t0, t1), numpy; sample i spans [t_i, t_{i+1}), the last one to t1."""
        rows = [(t, a, g) for (t, a, g) in self._samples if t0 <= t < t1][: self.capacity]
        out = np.zeros((self.capacity, 7), np.float32)
        mask = np.zeros((self.capacity,), bool)
        times = [t for (t, _, _) in rows] + [t1]
        for i, (t, a, g) in enumerate(rows):
            out[i, 0] = times[i + 1] - times[i]
            out[i, 1:4] = a
            out[i, 4:7] = g
            mask[i] = True
        return out, mask
