"""The system under test and its stand-ins, behind one interface.

`load("port")` is the PyTorch and CUDA port, `dynosam_tpu_torch`, the one
program the benchmark measures; `load("frozen")` is the benchmark's own
frozen copy of its step (`portbench/frozen`), which the reference replays
and which, in a lower precision, stands in for the program as the control.
Both expose the same modules at the same relative paths.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

PACKAGES = {"port": "dynosam_tpu_torch", "frozen": "portbench.frozen"}


def load(name: str) -> SimpleNamespace:
    pkg = PACKAGES[name]

    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    batched = mod("parallel.batched")
    return SimpleNamespace(
        name=name,
        batched=batched,
        stereo=mod("cv.stereo"),
        imu=mod("frontend.imu"),
        DynoConfig=mod("config").DynoConfig,
        CameraIntrinsics=mod("cv.camera").CameraIntrinsics,
        FrameInputs=mod("frontend.types").FrameInputs,
        k1=mod("ops.cuda.shi_tomasi").shi_tomasi_cell_max,
    )


def _tuples(x):
    """JSON's lists back to the tuples the configuration's fields hold."""
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def build(api, config: dict):
    """(cfg, intr) of a configuration file for `api`."""
    return (api.DynoConfig.from_dict(_tuples(config["settings"])),
            api.CameraIntrinsics.create(**config["camera"]))


def launches(api) -> int | None:
    """K1's launch count as the program's own wrapper counts it (None where
    there is no kernel)."""
    return getattr(api.k1, "launches", None)
