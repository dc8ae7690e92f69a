"""How far the KLT path's tracks land from the scene's true flow.

On the world-textured bench scene (`bench_config.bench_scene(...,
world_texture=True, forward_m=...)`) at `bench_klt_config()`'s tracker
settings, tracks a grid of static pixels (every 6 px) of frame 0 into frame
1 with `ops/lk.py::lk_track` (forward-backward check as configured), on the
CLAHE-equalized pair and on the raw gray pair, and compares each track that
passes with the renderer's own flow (frame 0's pixel moved by the ground
truth). Per forward step it prints the passing share, the median and 90th
percentile of |LK - true| in px, the shares off by more than 1 and 5 px,
and the same by depth band (the near ground, the ground towards the
horizon, the far wall). A track off by more than the forward-backward
threshold that still passes is a wrong correspondence the camera solve
takes as right.

Usage: python scripts/probe_torch_klt_bias.py [--steps 0.8,0.2,0.05] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GRID_PX = 6
BANDS_M = ((0.0, 10.0), (10.0, 30.0), (30.0, 61.0))


def probe(forward_m: float, device):
    """-> [(pair, passing, total, {statistic: value}, [(band, n, median, share > 1 px)])]."""
    import torch

    from dynosam_tpu_torch import bench_config as bc
    from dynosam_tpu_torch.frontend import tracker as trk
    from dynosam_tpu_torch.frontend.frontend import _to_gray
    from dynosam_tpu_torch.ops import interp, lk

    cfg, intr = bc.bench_klt_config()
    tp = cfg.frontend.tracker
    scene = bc.bench_scene(intr, 2, device=device, world_texture=True, forward_m=forward_m)
    f0, f1 = scene.frame(0), scene.frame(1)
    g0, g1 = _to_gray(f0.rgb), _to_gray(f1.rgb)
    H, W = g0.shape
    vv, uu = torch.meshgrid(torch.arange(8, H - 8, float(GRID_PX), device=device),
                            torch.arange(8, W - 8, float(GRID_PX), device=device), indexing="ij")
    uv0 = torch.stack([uu.flatten(), vv.flatten()], -1)
    uv0 = uv0[interp.sample_label(f0.mask, uv0) == 0]
    true = uv0 + interp.sample_flow(f1.flow, uv0, 0)
    depth = interp.sample_bilinear(f0.depth, uv0)
    valid = torch.ones(uv0.shape[0], dtype=torch.bool, device=device)
    pairs = {"clahe": tuple(trk._clahe_padded(g, tp.clahe_grid, tp.clahe_clip_limit) for g in (g0, g1)),
             "raw": (g0, g1)}
    out = []
    for name, (a, b) in pairs.items():
        uv1, ok = lk.lk_track(a, b, uv0, valid, levels=tp.klt_levels, half=tp.klt_window_half,
                              iters=tp.klt_iterations, min_eig=tp.klt_min_eig, fb_threshold=tp.klt_fb_threshold)
        err = torch.linalg.norm(uv1 - true, dim=-1)[ok]
        d = depth[ok]
        stats = {"median_px": float(err.median()), "p90_px": float(err.quantile(0.9)),
                 "over_1px": float((err > 1).float().mean()), "over_5px": float((err > 5).float().mean())}
        bands = []
        for lo, hi in BANDS_M:
            sel = (d >= lo) & (d < hi)
            if bool(sel.any()):
                e = err[sel]
                bands.append(((lo, hi), int(sel.sum()), float(e.median()), float((e > 1).float().mean())))
        out.append((name, int(ok.sum()), int(ok.numel()), stats, bands))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", default="0.8,0.2,0.05", help="forward steps, m per frame")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for forward_m in (float(x) for x in args.steps.split(",")):
        for name, n_ok, n, s, bands in probe(forward_m, args.device):
            print(f"step {forward_m} m, {name}: {n_ok} of {n} pass; |LK - true| median {s['median_px']:.3f} px, "
                  f"p90 {s['p90_px']:.3f}, share > 1 px {s['over_1px']:.3f}, > 5 px {s['over_5px']:.3f}; "
                  + "; ".join(f"depth {lo:g}-{hi:g} m: {k} tracks, median {m:.3f} px, > 1 px {o:.3f}"
                              for (lo, hi), k, m, o in bands), flush=True)


if __name__ == "__main__":
    main()
