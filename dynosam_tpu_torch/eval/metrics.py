"""Trajectory & object-motion metrics: ATE, RPE, AME, RME (port of
dynosam_tpu/eval/metrics.py), on (K, 4, 4) numpy pose arrays:

  ATE: absolute pose error after optional SE(3) (Umeyama, no scale) alignment;
  RPE: relative pose error over consecutive frames;
  AME: absolute motion error E_k = inv(H_gt_k) @ H_est_k (world frame, 'W');
  RME: motion error in the object body frame ('L'):
       E_k = inv(L_gt_k) @ H_est_k @ L_gt_{k-1}  (identity when perfect).

Each returns translation RMSE (meters) and rotation RMSE (radians).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MetricResult(NamedTuple):
    trans_rmse: float
    rot_rmse: float
    trans_errors: np.ndarray
    rot_errors: np.ndarray

    @staticmethod
    def from_error_mats(E: np.ndarray) -> "MetricResult":
        t_err = np.linalg.norm(E[:, :3, 3], axis=-1)
        cos = np.clip((np.trace(E[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
        r_err = np.arccos(cos)
        return MetricResult(
            trans_rmse=float(np.sqrt(np.mean(t_err**2))) if len(t_err) else 0.0,
            rot_rmse=float(np.sqrt(np.mean(r_err**2))) if len(r_err) else 0.0,
            trans_errors=t_err,
            rot_errors=r_err,
        )


def _inv(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    out = np.tile(np.eye(4, dtype=T.dtype), T.shape[:-2] + (1, 1))
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    return out


def umeyama_alignment(est_t: np.ndarray, gt_t: np.ndarray) -> np.ndarray:
    """SE(3) (no scale) aligning est onto gt: (4,4) T with gt ~= T @ est."""
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    E, G = est_t - mu_e, gt_t - mu_g
    H = G.T @ E
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_g - R @ mu_e
    return T


def ate(est: np.ndarray, gt: np.ndarray, align: bool = True) -> MetricResult:
    """Absolute trajectory error. est/gt: (K, 4, 4) world_from_cam."""
    est, gt = np.asarray(est), np.asarray(gt)
    if align and len(est) >= 3:
        T = umeyama_alignment(est[:, :3, 3], gt[:, :3, 3])
        est = np.einsum("ij,kjl->kil", T, est)
    E = _inv(gt) @ est
    return MetricResult.from_error_mats(E)


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> MetricResult:
    est, gt = np.asarray(est), np.asarray(gt)
    rel_est = _inv(est[:-delta]) @ est[delta:]
    rel_gt = _inv(gt[:-delta]) @ gt[delta:]
    E = _inv(rel_gt) @ rel_est
    return MetricResult.from_error_mats(E)


def ame(H_est: np.ndarray, H_gt: np.ndarray) -> MetricResult:
    """Absolute motion error in the world frame (the paper's AME)."""
    E = _inv(np.asarray(H_gt)) @ np.asarray(H_est)
    return MetricResult.from_error_mats(E)


def rme(H_est: np.ndarray, L_gt_prev: np.ndarray, L_gt_curr: np.ndarray) -> MetricResult:
    """Motion error in the object body frame:
    E_k = inv(L_gt_k) @ H_est_k @ L_gt_{k-1}; identity when perfect."""
    E = _inv(np.asarray(L_gt_curr)) @ np.asarray(H_est) @ np.asarray(L_gt_prev)
    return MetricResult.from_error_mats(E)
