"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/*.cu` file with a plain C interface. It is compiled
with `nvcc` for `sm_90a` into a shared library under `dynosam_tpu_torch/build/`
(listed in `.gitignore`) at first use, named by a hash of its source and
flags so an edited source rebuilds, and loaded with `ctypes`. Nothing here
runs at import time: the CPU tests import every module on machines without
`nvcc` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> tuple[Path, float]:
    """Compile csrc/<source> if its hashed library is missing.

    Returns (library path, seconds spent compiling; 0.0 when cached)."""
    out = library_path(source)
    if out.exists():
        return out, 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a temporary name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (rc {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>; cached per process."""
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
    return lib
