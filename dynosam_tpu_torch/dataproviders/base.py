"""Dataset types, the provider factory and what the readers share (port of
dynosam_tpu/dataproviders/base.py).

A provider is an iterator of (FrameInputs, GroundTruthFrame) with random
access through `frame(k)` / `ground_truth(k)`. Every provider decodes on the
host: `frame_host(k)` returns frame k as CPU tensors (the pipeline's
prefetch worker calls it), `frame(k)` the same frame on the provider's
device. The stereo readers (VIODE, ClusterSlam) also compute their dense
depth inside `frame_host`, on the provider's device and on the caller's
current stream. Ground truth stays host numpy.
"""

from __future__ import annotations

import enum
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame


class DatasetType(enum.IntEnum):
    KITTI = 0
    VIRTUAL_KITTI = 1
    CLUSTER = 2
    OMD = 3
    ARIA = 4
    TARTAN_AIR_SHIBUYA = 5
    VIODE = 6
    SYNTHETIC = 100  # dense synthetic scenario (dataproviders/synthetic_dense.py)


def create_dataset(dataset_type: int, path: str, device="cuda", **kwargs):
    """Provider of an on-disk dataset, its frames on `device`
    (DataProviderFactory.cc:54-110)."""
    t = DatasetType(dataset_type)
    kwargs["device"] = device
    if t == DatasetType.KITTI:
        from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider

        return KittiDataProvider(path, **kwargs)
    if t == DatasetType.VIRTUAL_KITTI:
        # the native VKITTI-2 layout when the versioned folders exist, else
        # the dyno-KITTI repack with png masks
        if any(d.startswith("vkitti_") for d in os.listdir(path)):
            from dynosam_tpu_torch.dataproviders.vkitti import VirtualKittiDataProvider

            return VirtualKittiDataProvider(path, **kwargs)
        from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider

        kwargs.setdefault("mask_format", "png")
        return KittiDataProvider(path, **kwargs)
    if t == DatasetType.OMD:
        from dynosam_tpu_torch.dataproviders.omd import OmdDataProvider

        return OmdDataProvider(path, **kwargs)
    if t == DatasetType.CLUSTER:
        from dynosam_tpu_torch.dataproviders.clusterslam import ClusterSlamDataProvider

        return ClusterSlamDataProvider(path, **kwargs)
    if t == DatasetType.TARTAN_AIR_SHIBUYA:
        from dynosam_tpu_torch.dataproviders.tartanair import TartanAirShibuyaDataProvider

        return TartanAirShibuyaDataProvider(path, **kwargs)
    if t == DatasetType.VIODE:
        from dynosam_tpu_torch.dataproviders.viode import ViodeDataProvider

        return ViodeDataProvider(path, **kwargs)
    if t == DatasetType.ARIA:
        from dynosam_tpu_torch.dataproviders.aria import ProjectAriaDataProvider

        return ProjectAriaDataProvider(path, **kwargs)
    raise NotImplementedError(
        "the synthetic scenario is rendered, not read: use "
        "dataproviders.synthetic_dense.default_dense_scenario"
    )


def sorted_files(folder: str, ext: str = "") -> List[str]:
    """The files of `folder` ending in `ext`, sorted by name ([] if it is
    missing)."""
    if not os.path.isdir(folder):
        return []
    return [os.path.join(folder, f) for f in sorted(os.listdir(folder)) if f.endswith(ext)]


def object_ground_truth(X: np.ndarray, objs: Dict[int, np.ndarray], prev: Dict[int, np.ndarray],
                        X_prev: Optional[np.ndarray], max_objects: int) -> GroundTruthFrame:
    """GroundTruthFrame of camera pose X and camera-frame object poses
    `objs` (oid -> L_cam), motions against `prev` at X_prev."""
    J = max_objects
    ids = np.full((J,), -1, np.int32)
    poses = np.tile(np.eye(4), (J, 1, 1))
    motions = np.tile(np.eye(4), (J, 1, 1))
    valid = np.zeros((J,), bool)
    for j, (oid, L_cam) in enumerate(sorted(objs.items())[:J]):
        ids[j] = oid
        L_w = X @ L_cam
        poses[j] = L_w
        valid[j] = True
        if oid in prev and X_prev is not None:
            motions[j] = L_w @ np.linalg.inv(X_prev @ prev[oid])
    return GroundTruthFrame(
        X_world_cam=np.asarray(X, np.float32),
        object_ids=ids,
        object_poses=np.asarray(poses, np.float32),
        object_motions=np.asarray(motions, np.float32),
        object_valid=valid,
    )


def padded(x: int, m: int) -> int:
    """x rounded up to a multiple of m (m <= 0: x)."""
    return x if m <= 0 else ((x + m - 1) // m) * m


def pad_image(img: np.ndarray, h: int, w: int, m: int, value=0.0) -> np.ndarray:
    """An (h, w, ...) image padded with `value` to multiples of m."""
    H, W = padded(h, m), padded(w, m)
    if img.shape[0] == H and img.shape[1] == W:
        return img
    pad = [(0, H - img.shape[0]), (0, W - img.shape[1])] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, constant_values=value)


def host_frame(k: int, rgb, depth, flow, mask, imu: Optional[tuple] = None) -> FrameInputs:
    """FrameInputs of host arrays (depth may already be a tensor)."""
    def t(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))

    extra = {}
    if imu is not None:
        extra = dict(imu_samples=t(imu[0]), imu_valid=t(imu[1]))
    return FrameInputs(frame_id=torch.tensor(k, dtype=torch.int32), rgb=t(rgb), depth=t(depth),
                       flow=t(flow), mask=t(mask), **extra)


def imu_window(imu: np.ndarray, t0: float, t1: float, S: int):
    """Padded (S, 7) [dt a g] rows + mask for the samples in [t0, t1): sample
    i covers [t_i, t_{i+1}), the last one up to t1."""
    sel = imu[(imu[:, 0] >= t0) & (imu[:, 0] < t1)]
    out = np.zeros((S, 7), np.float32)
    mask = np.zeros((S,), bool)
    times = list(sel[:S, 0]) + [t1]
    for i, row in enumerate(sel[:S]):
        out[i, 0] = times[i + 1] - times[i]
        out[i, 1:7] = row[1:7]
        mask[i] = True
    return out, mask


def stereo_depth(left_gray: np.ndarray, right_gray: np.ndarray, device, pad_hw, m: int, **kwargs):
    """Dense stereo depth of a grey uint8 pair, computed on `device` (on its
    current stream), padded with zeros to multiples of m -> (H, W) tensor on
    `device`."""
    from dynosam_tpu_torch.cv.stereo import dense_stereo_depth

    def g(a):
        return (torch.from_numpy(a.astype(np.float32) / np.float32(255.0))).to(device, non_blocking=True)

    depth = dense_stereo_depth(g(left_gray), g(right_gray), **kwargs)
    h, w = pad_hw
    return torch.nn.functional.pad(depth, (0, padded(w, m) - w, 0, padded(h, m) - h))
