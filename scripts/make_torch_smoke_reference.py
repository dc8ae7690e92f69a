"""Write the JAX reference outputs that chip_smoke.py holds the port to.

Runs the JAX package's fused step (parallel/batched.py::make_fused_step) on
the CPU at bench.bench_config() over the first 10 bench frames — exactly one
filled window, no advance — and stores per-frame X_world_cam, object_ids,
object_motions and object_motion_valid in
dynosam_tpu_torch/testdata/bench_ref_10f.npz.

Usage: JAX_PLATFORMS=cpu python scripts/make_torch_smoke_reference.py
"""

from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NUM_FRAMES = 10
OUT = os.path.join(ROOT, "dynosam_tpu_torch", "testdata", "bench_ref_10f.npz")
KEYS = ("X_world_cam", "object_ids", "object_motions", "object_motion_valid")


def main():
    import jax
    import numpy as np

    import bench
    from dynosam_tpu.parallel.batched import init_pipeline_state, make_fused_step

    t0 = time.time()
    cfg, intr = bench.bench_config()
    frames = bench.make_frames(intr, num_frames=NUM_FRAMES)
    step = jax.jit(make_fused_step(cfg, intr))
    state = init_pipeline_state(cfg)
    outs = {k: [] for k in KEYS}
    for k in range(NUM_FRAMES):
        state, out = step(state, frames[k])
        for key in KEYS:
            outs[key].append(np.asarray(out[key]))
    np.savez_compressed(OUT, **{k: np.stack(v) for k, v in outs.items()})
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in {time.time() - t0:.1f} s "
          f"on {jax.devices()[0].platform}")


if __name__ == "__main__":
    main()
