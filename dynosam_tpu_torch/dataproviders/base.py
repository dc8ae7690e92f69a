"""Dataset types and the provider factory (port of
dynosam_tpu/dataproviders/base.py).

A provider is an iterator of (FrameInputs, GroundTruthFrame) with random
access through `frame(k)` / `ground_truth(k)`. The port reads the
dyno-KITTI layout; every other dataset type raises NotImplementedError
that names the ROADMAP item porting it.
"""

from __future__ import annotations

import enum


class DatasetType(enum.IntEnum):
    KITTI = 0
    VIRTUAL_KITTI = 1
    CLUSTER = 2
    OMD = 3
    ARIA = 4
    TARTAN_AIR_SHIBUYA = 5
    VIODE = 6
    SYNTHETIC = 100  # dense synthetic scenario (dataproviders/synthetic_dense.py)


_UNPORTED = "is not ported yet (ROADMAP.md queue 1, item 19: the other dataset providers)"


def create_dataset(dataset_type: int, path: str, device="cuda", **kwargs):
    """Provider of an on-disk dataset, its frames on `device`."""
    t = DatasetType(dataset_type)
    if t == DatasetType.KITTI:
        from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider

        return KittiDataProvider(path, device=device, **kwargs)
    if t == DatasetType.SYNTHETIC:
        raise NotImplementedError(
            "the synthetic scenario is rendered, not read: use "
            "dataproviders.synthetic_dense.default_dense_scenario"
        )
    raise NotImplementedError(f"dataset type {t.name} ({int(t)}) {_UNPORTED}")
