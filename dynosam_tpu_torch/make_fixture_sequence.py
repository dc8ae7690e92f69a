"""Render the dyno-KITTI fixture sequence and write it to disk (the port of
scripts/make_fixture_sequence.py).

The scene is `bench_config.fixture_scenario`: KITTI tracking's camera
(fx 721.5377, cx 609.5593, cy 172.854 at 1242x375) scaled to the frame
size, the camera driving forward with a slow yaw, three cars with yaw-only
motions, and with --rich a fourth car crossing behind the lead car (the
1242x375, 100-frame preset of scripts/accuracy_rich.py). The files are the
reference's dataset layout (dataproviders/kitti_writer.py): uint16
disparity at base_line = fx * 0.537 m and depth scale 256, and ground-truth
camera poses behind a non-identity world offset (fixture_world_offset), so
the reader's align-to-identity path has work to do. The scene renders on
--device; the files are written on the host.

The default --out is results/torch/kitti_fixture/, never the committed
tests/fixtures/kitti_fixture/ that the tests and chip_smoke.py read.

Usage: python -m dynosam_tpu_torch.make_fixture_sequence [--out results/torch/kitti_fixture]
    [--frames 60] [--width 320] [--height 96] [--rich] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

DEFAULT_OUT = os.path.join("results", "torch", "kitti_fixture")
MIN_VISIBLE_PX = 25


def write_fixture(out: str, frames: int = 60, width: int = 320, height: int = 96, rich: bool = False,
                  device="cuda"):
    """Render fixture_scenario(frames, width, height, rich) on `device` and
    write it to `out` in dyno-KITTI layout -> the scene."""
    from dynosam_tpu_torch.bench_config import KITTI_BASELINE_M, fixture_scenario, fixture_world_offset
    from dynosam_tpu_torch.dataproviders.kitti_writer import write_kitti_sequence

    dense = fixture_scenario(frames, width, height, rich=rich, device=device)
    # fx * KITTI_BASELINE_M in float32, as the reference computes it from
    # its float32 intrinsics
    base_line = float(np.float32(dense.intr.fx) * np.float32(KITTI_BASELINE_M))
    write_kitti_sequence(dense, out, base_line=base_line, depth_scale_factor=256.0,
                         world_offset=fixture_world_offset())
    return dense


def visibility(dense) -> dict:
    """{object id: frames in which its mask covers at least 25 px}."""
    vis = {oid: 0 for oid in dense.scn.object_ids}
    for k in range(dense.scn.spec.num_frames):
        mask = dense.frame(k).mask
        for oid in vis:
            vis[oid] += int(int((mask == oid).sum()) >= MIN_VISIBLE_PX)
    return vis


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--rich", action="store_true",
                    help="add the occluded, re-entering crossing car (the real-resolution preset: "
                         "--width 1242 --height 375 --frames 100 --rich)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dynosam_tpu_torch.bench_config import fixture_scenario

    # visibility report (objects must stay in frame for useful ground truth)
    vis = visibility(fixture_scenario(args.frames, args.width, args.height, rich=args.rich, device=args.device))
    print("frames visible (>=25 px):", vis, "of", args.frames)
    write_fixture(args.out, args.frames, args.width, args.height, args.rich, args.device)
    files = [os.path.join(r, f) for r, _, fs in os.walk(args.out) for f in fs]
    print(f"wrote {args.out}: {len(files)} files, {sum(os.path.getsize(f) for f in files) / 1e6:.1f} MB")
    return vis


if __name__ == "__main__":
    main()
