"""Routes of the YOLO mask combination (K2) timed in turns on one CUDA card.

K2's kernel source before its Hopper redesign (v3, kept verbatim in
scripts/ab_torch_k2_v3.cu, C entry `dyno_mask_combine_f32` on contiguous
NHWC prototypes) is built beside this tree's `csrc/mask_combine.cu`, and
chip_smoke.py's phase 4 runs in this process alone: both entries held to
their plain versions, then, in turns, loop-timed (an event pair around 200
back-to-back calls), per launch and under torch.profiler:

  entry A  v4 (NHWC and the network's NCHW view), v3, plain, and the cuBLAS
           product coef @ proto^T alone, at (32, 96x160, 32)
  entry B  this tree's label entry, the unfused route (v3 after a copy to
           NHWC, then torch's upsample, box crop, threshold and label
           argmax) and the plain version, at the detector scene's frame 0
           (96x160 -> 384x640), and both routes at 32 random detections
  floor    an empty launch, a 0.98 MB label write, a 1.97 MB copy (entry A's
           bytes) and entry B with no valid detection, timed the same way

Usage: python scripts/ab_torch_k2.py [--seed N] [--out PATH.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def floor_ms(torch):
    """What the card takes for the least work of the same shape, timed as
    the kernels are: an empty launch, writing the 384x640 int32 label image
    (zero_), copying (32, 96x160) f32 masks (entry A's bytes, read and
    written once), and entry B with no valid detection (its loads, the cull
    and the zero label)."""
    from chip_smoke import _ms, kernel_times
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc

    gen = torch.Generator(device="cuda").manual_seed(0)
    proto = torch.randn((96, 160, 32), generator=gen, device="cuda")
    coef = torch.randn((32, 32), generator=gen, device="cuda")
    tiny = torch.zeros(1, device="cuda")
    label = torch.empty((384, 640), dtype=torch.int32, device="cuda")
    masks = torch.empty((32, 96, 160), device="cuda")
    boxes = torch.tensor([[10.0, 10.0, 300.0, 200.0]] * 32, device="cuda")
    scores = torch.rand((32,), generator=gen, device="cuda")
    none = torch.zeros(32, dtype=torch.bool, device="cuda")
    fns = {"empty launch": lambda: tiny.fill_(0.0),
           "label zero_": lambda: label.zero_(),
           "masks copy_": lambda: masks.copy_(proto.view(32, 96, 160)),
           "entry B, no valid detection": lambda: mc.mask_label(proto, coef, boxes, scores, none, (384, 640))}
    t = kernel_times(torch, fns)
    for k in fns:
        print(f"floor {k}: loop {t['loop'][k]:.5f} ms, one launch {t['single'][k]:.5f} ms, "
              f"torch.profiler {_ms(t['profiler'][k])}", flush=True)
    return {k: {"loop_ms": t["loop"][k], "single_launch_ms": t["single"][k], "profiler_ms": t["profiler"][k]}
            for k in fns}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import K2_V3_SOURCE, check_k2
    from dynosam_tpu_torch.ops.cuda import _build
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.build(mc.SOURCE)
    lib, _ = _build.build(K2_V3_SOURCE)
    result = {"card": card, **check_k2(torch, args.seed, lib), "floor": floor_ms(torch)}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
