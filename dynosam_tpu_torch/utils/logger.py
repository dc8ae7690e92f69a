"""Estimation CSV loggers (port of dynosam_tpu/utils/logger.py), with the
reference's schemas and file names:

  <module>_camera_pose_log.csv   frame_id,tx,ty,tz,qx,qy,qz,qw,gt_* (7)
  <module>_object_pose_log.csv   frame_id,object_id,pose(7),gt(7)
  <module>_object_motion_log.csv frame_id,object_id,motion(7),gt(7)
  <module>_map_points_log.csv    frame_id,object_id,tracklet_id,x,y,z (world)
  <module>_object_bbx_log.csv    frame_id,object_id,min(3),max(3),px,py,pz,qw,qx,qy,qz

Rows are host numpy: the callers hand over arrays already on the host, so a
log row never reads the device.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation -> quaternion (xyzw), Shepperd's method, in float64."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def _pose_to_row(T) -> list:
    T = np.asarray(T)
    q = _rot_to_quat_np(T[:3, :3])
    t = T[:3, 3]
    return [t[0], t[1], t[2], q[0], q[1], q[2], q[3]]  # tx ty tz qx qy qz qw


_POSE_COLS = ["tx", "ty", "tz", "qx", "qy", "qz", "qw",
              "gt_tx", "gt_ty", "gt_tz", "gt_qx", "gt_qy", "gt_qz", "gt_qw"]
_HEADERS = {
    "camera_pose": ["frame_id"] + _POSE_COLS,
    "object_pose": ["frame_id", "object_id"] + _POSE_COLS,
    "object_motion": ["frame_id", "object_id"] + _POSE_COLS,
    "map_points": ["frame_id", "object_id", "tracklet_id", "x_world", "y_world", "z_world"],
    "object_bbx": ["frame_id", "object_id", "min_bbx_x", "min_bbx_y", "min_bbx_z",
                   "max_bbx_x", "max_bbx_y", "max_bbx_z",
                   "px", "py", "pz", "qw", "qx", "qy", "qz"],
}


class EstimationModuleLogger:
    def __init__(self, module_name: str, output_path: str):
        self.module = module_name
        self.path = output_path
        os.makedirs(output_path, exist_ok=True)
        self._files = {}
        self._writers = {}
        for kind in _HEADERS:
            self._open(kind)

    def _open(self, kind: str):
        fname = os.path.join(self.path, f"{self.module}_{kind}_log.csv")
        f = open(fname, "w", newline="")
        w = csv.writer(f)
        w.writerow(_HEADERS[kind])
        self._files[kind] = f
        self._writers[kind] = w

    def reset(self, kinds):
        """Truncate and reopen the given logs (the final re-log rewrites the
        streamed rows)."""
        for kind in kinds:
            self._files[kind].close()
            self._open(kind)

    # ------------------------------------------------------------------
    def log_camera_pose(self, frame_id: int, T, T_gt=None):
        gt = _pose_to_row(T_gt) if T_gt is not None else [""] * 7
        self._writers["camera_pose"].writerow([frame_id] + _pose_to_row(T) + gt)

    def log_object_pose(self, frame_id: int, object_id: int, L, L_gt=None):
        gt = _pose_to_row(L_gt) if L_gt is not None else [""] * 7
        self._writers["object_pose"].writerow(
            [frame_id, object_id] + _pose_to_row(L) + gt
        )

    def log_object_motion(self, frame_id: int, object_id: int, H, H_gt=None):
        gt = _pose_to_row(H_gt) if H_gt is not None else [""] * 7
        self._writers["object_motion"].writerow(
            [frame_id, object_id] + _pose_to_row(H) + gt
        )

    def log_object_bbx(self, frame_id: int, object_id: int, min_xyz, max_xyz, L):
        """3D bounding box of an object's landmarks in the object frame, and
        the object pose (reference column order px py pz qw qx qy qz)."""
        row = _pose_to_row(L)
        pose_cols = [row[0], row[1], row[2], row[6], row[3], row[4], row[5]]
        self._writers["object_bbx"].writerow(
            [frame_id, object_id]
            + [float(v) for v in np.asarray(min_xyz)]
            + [float(v) for v in np.asarray(max_xyz)]
            + pose_cols
        )

    def log_map_points(self, frame_id: int, object_ids, tracklet_ids, points):
        w = self._writers["map_points"]
        for oid, tid, p in zip(
            np.asarray(object_ids), np.asarray(tracklet_ids), np.asarray(points)
        ):
            w.writerow([frame_id, int(oid), int(tid), p[0], p[1], p[2]])

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}
