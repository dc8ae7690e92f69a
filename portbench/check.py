"""The lanes' per-step outputs as one packed row each, and the numbers that
decide `correct`: how far the program's outputs lie from the reference's
on the same frames and draws (`numbers`), and how far they lie from the
scenes' ground truth (`truth_numbers`), which holds the program and the
reference's frozen copy of it alike.

A lane's row holds what a sweep writes out per frame: the backend's camera
pose `X_world_cam`, the object motions with their validity and slot ids,
and the frontend's camera pose.
"""

from __future__ import annotations

import numpy as np
import torch


def width(J: int) -> int:
    """A packed row's length with J object slots."""
    return 16 + 16 * J + J + J + 16


def pack(out: dict) -> torch.Tensor:
    """A step's outputs -> (B, 16 + 16 J + J + J + 16) float32 on the device."""
    B = out["X_world_cam"].shape[0]
    return torch.cat([
        out["X_world_cam"].reshape(B, -1),
        out["object_motions"].reshape(B, -1),
        out["object_motion_valid"].reshape(B, -1).to(torch.float32),
        out["object_ids"].reshape(B, -1).to(torch.float32),
        out["frontend_pose"].reshape(B, -1),
    ], dim=1)


def unpack(rows: np.ndarray, J: int) -> dict:
    """(..., P) packed rows -> {X, motions, valid, ids, frontend} float64."""
    r = np.asarray(rows, np.float64)
    lead = r.shape[:-1]
    o = 16 + 16 * J
    return {
        "X": r[..., :16].reshape(lead + (4, 4)),
        "motions": r[..., 16:o].reshape(lead + (J, 4, 4)),
        "valid": r[..., o:o + J] > 0.5,
        "ids": np.rint(r[..., o + J:o + 2 * J]).astype(np.int64),
        "frontend": r[..., o + 2 * J:].reshape(lead + (4, 4)),
    }


def finite_lanes(rows: np.ndarray, J: int) -> np.ndarray:
    """(...,) True where a lane-step's poses and its valid motions are finite."""
    u = unpack(rows, J)
    ok = np.isfinite(u["X"]).all((-2, -1)) & np.isfinite(u["frontend"]).all((-2, -1))
    bad_motion = u["valid"] & ~np.isfinite(u["motions"]).all((-2, -1))
    return ok & ~bad_motion.any(-1)


def _t_gap(a, b):
    return np.linalg.norm(a[..., :3, 3] - b[..., :3, 3], axis=-1)


def _r_gap(a, b):
    """The angle between two rotations, from ||Ra - Rb||_F = 2 sqrt(2)
    sin(angle / 2), which keeps its digits at small angles."""
    d = np.linalg.norm(a[..., :3, :3] - b[..., :3, :3], axis=(-2, -1))
    return 2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def gaps(prog: np.ndarray, ref: np.ndarray, J: int) -> dict:
    """Per (step, lane) gaps of two (m, n, P) packs: the backend camera
    pose's translation and rotation, the frontend camera pose's
    translation, the largest translation gap of an object motion valid on
    both sides in the same slot with the same id, and whether any slot's
    validity or id differs. A non-finite gap reads as infinity."""
    p, r = unpack(prog, J), unpack(ref, J)
    both = p["valid"] & r["valid"] & (p["ids"] == r["ids"])

    def fin(x):
        return np.where(np.isfinite(x), x, np.inf)

    return {
        "cam_t_m": fin(_t_gap(p["X"], r["X"])),
        "cam_r_rad": fin(_r_gap(p["X"], r["X"])),
        "frontend_t_m": fin(_t_gap(p["frontend"], r["frontend"])),
        "motion_t_m": fin(np.where(both, _t_gap(p["motions"], r["motions"]), 0.0)).max(-1),
        "motion_flags": ((p["valid"] != r["valid"]) | (p["ids"] != r["ids"])).any(-1),
    }


def numbers(prog: np.ndarray, ref: np.ndarray, J: int) -> dict:
    """The compared numbers over two (m, n, P) packs (steps x lanes):
    - `<gap>`: the widest gap over every step and lane (`gaps`);
    - `<gap>.lane_q75`: the 75th percentile over the lanes of each lane's
      widest gap over the steps, which the few lanes whose discrete choices
      (a track kept or dropped, a hypothesis chosen) flip on rounding do
      not move, while an error in a quarter of the lanes or more does;
    - motion_flags: the share of lane-steps where a slot's validity or id
      differs."""
    g = gaps(prog, ref, J)
    out = {}
    for k in ("cam_t_m", "cam_r_rad", "frontend_t_m", "motion_t_m"):
        x = g[k]
        out[k] = float(x.max()) if x.size else 0.0
        out[k + ".lane_q75"] = float(np.quantile(x.max(0), 0.75)) if x.size else 0.0
    out["motion_flags"] = float(g["motion_flags"].mean()) if g["motion_flags"].size else 0.0
    return out


def _q75(x: np.ndarray) -> float:
    """The 75th percentile, infinite where it falls between infinite values."""
    with np.errstate(invalid="ignore"):
        q = float(np.quantile(x, 0.75))
    return np.inf if np.isnan(q) else q


def truth_gaps(prog: np.ndarray, scene_of: np.ndarray, frame_of: np.ndarray, bank, J: int) -> dict:
    """Per (step, lane) gaps of an (m, n, P) pack from the ground truth of
    the frames it was given (lane l of step i played frame `frame_of[i]` of
    scene `scene_of[i, l]`): the camera pose's translation and rotation, the
    frontend camera pose's translation, each
    slot's motion translation gap where the slot is valid and its id names
    one of the scene's cars at a frame past the first (NaN elsewhere), and
    which of the scene's cars no valid slot holds (False for a car the scene
    does not have), and whether none of them has one."""
    u = unpack(prog, J)
    S, K = len(bank.L_gt), bank.X_gt.shape[0]
    n_max = max(len(L) for L in bank.L_gt)
    H_gt = np.tile(np.eye(4), (S, n_max, K, 1, 1))
    has = np.zeros((S, n_max), bool)
    for s, L in enumerate(bank.L_gt):
        H_gt[s, :len(L), 1:] = L[:, 1:] @ np.linalg.inv(L[:, :-1])      # H_k = L_k L_{k-1}^-1, world frame
        has[s, :len(L)] = True
    frames = np.asarray(frame_of)[:, None]
    X = bank.X_gt[frames]                                                  # (m, 1, 4, 4)
    car = np.clip(u["ids"] - 1, 0, n_max - 1)                               # (m, n, J)
    sc = np.asarray(scene_of)[..., None]
    named = (u["ids"] >= 1) & (u["ids"] <= n_max) & has[sc, car]
    use = u["valid"] & named & (frames[..., None] >= 1)
    motion = np.where(use, _t_gap(u["motions"], H_gt[sc, car, frames[..., None]]), np.nan)
    held = np.stack([(u["valid"] & (u["ids"] == j + 1)).any(-1) for j in range(n_max)], -1)

    def fin(x):
        return np.where(np.isfinite(x) | np.isnan(x), x, np.inf)

    return {
        "cam_t_m": fin(_t_gap(u["X"], X)),
        "cam_r_rad": fin(_r_gap(u["X"], X)),
        "frontend_t_m": fin(_t_gap(u["frontend"], X)),
        "motion_t_m": fin(motion),
        "missed": has[np.asarray(scene_of)] & ~held,
        "none": ~(has[np.asarray(scene_of)] & held).any(-1),
    }


def truth_numbers(prog: np.ndarray, scene_of: np.ndarray, frame_of: np.ndarray, bank, J: int,
                  from_frame: int) -> dict:
    """The numbers held against the ground truth over (m, n) lane-steps:
    - gt_cam_t_m / gt_cam_r_rad / gt_frontend_t_m.lane_q75: the 75th
      percentile over lanes of each lane's widest camera pose gap;
    - gt_motion_t_m.lane_q75: the 75th percentile over lanes of each lane's
      median motion translation gap over its valid motions (infinite for a
      lane with none);
    - gt_motion_missed: the share of the scenes' car-frames from frame
      `from_frame` on that no valid slot holds (a car too small for the
      tracker's dynamic tracks never gets one, so this swings with the
      scenes drawn);
    - gt_motion_none: the share of lane-frames from frame `from_frame` on
      in which none of the scene's cars has a valid motion."""
    g = truth_gaps(prog, scene_of, frame_of, bank, J)
    out = {}
    for k in ("cam_t_m", "cam_r_rad", "frontend_t_m"):
        out[f"gt_{k}.lane_q75"] = _q75(g[k].max(0))
    m = g["motion_t_m"].transpose(1, 0, 2).reshape(g["motion_t_m"].shape[1], -1)
    per_lane = np.array([np.median(r[~np.isnan(r)]) if (~np.isnan(r)).any() else np.inf for r in m])
    out["gt_motion_t_m.lane_q75"] = _q75(per_lane)
    late = np.asarray(frame_of) >= from_frame
    n_due = sum(len(bank.L_gt[s]) for s in np.asarray(scene_of)[late].ravel())
    out["gt_motion_missed"] = float(g["missed"][late].sum() / n_due) if n_due else 0.0
    none = g["none"][late]
    out["gt_motion_none"] = float(none.mean()) if none.size else 0.0
    return out


def sample_lanes(seed: int, B: int, S: int, n: int) -> list:
    """`n` lanes drawn from the seed, n / S of each scene's B / S lanes (n a
    multiple of S), or of n scenes' where n < S; all lanes when n >= B."""
    if n >= B:
        return list(range(B))
    rng = np.random.default_rng([int(seed) % 2**63, 2])
    if n < S:
        return sorted(int(s + S * rng.integers(0, B // S)) for s in rng.permutation(S)[:n])
    return sorted(int(s + S * r) for s in range(S) for r in rng.choice(B // S, n // S, replace=False))
