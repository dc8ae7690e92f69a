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

Two mechanisms show in one run. The share off by more than 5 px in each
third of the image's width finds one-period locks on the far wall's
periodic texture (the forward-backward check passes them). Each depth
band's ground footprint, 8.1 d^2 / (fx h) rad per pixel (the phase of the
texture's second octave, sin(8.1 z), that one pixel spans along the view
on ground at depth d seen from height h; the renderer band-limits each
octave by the isotropic depth / fx only), finds the ground that aliases:
past pi rad per pixel it is above the octave's Nyquist rate. `--ground_y`
raises the camera (bench_config.bench_scene's ground_y; the bench's 1.6 m
by default, bench_config.TRACKED_GROUND_Y is the tracked scene's).

Usage: python scripts/probe_torch_klt_bias.py [--steps 0.8,0.2,0.05] [--ground_y 1.6,6.4] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GRID_PX = 6
BANDS_M = ((0.0, 10.0), (10.0, 30.0), (30.0, 61.0))
OCTAVE2_RAD_PER_M = 8.1       # the world texture's second octave, sin(8.1 z)


def footprint(d, fx, ground_y):
    """Phase of the second octave spanned by one pixel along the view on the
    ground at depth d, rad: 8.1 d^2 / (fx h)."""
    return OCTAVE2_RAD_PER_M * d * d / (fx * ground_y)


def probe(forward_m: float, device, ground_y=None):
    """-> [(pair, passing, total, {statistic: value}, [(band, n, median,
    share > 1 px)], [share > 5 px in each third of the width])]."""
    import torch

    from dynosam_tpu_torch import bench_config as bc
    from dynosam_tpu_torch.frontend import tracker as trk
    from dynosam_tpu_torch.frontend.frontend import _to_gray
    from dynosam_tpu_torch.ops import interp, lk

    cfg, intr = bc.bench_klt_config()
    tp = cfg.frontend.tracker
    scene = bc.bench_scene(intr, 2, device=device, world_texture=True, forward_m=forward_m,
                           ground_y=bc.BENCH_GROUND_Y if ground_y is None else ground_y)
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
        u = uv0[ok, 0]
        stats = {"median_px": float(err.median()), "p90_px": float(err.quantile(0.9)),
                 "over_1px": float((err > 1).float().mean()), "over_5px": float((err > 5).float().mean())}
        bands = []
        for lo, hi in BANDS_M:
            sel = (d >= lo) & (d < hi)
            if bool(sel.any()):
                e = err[sel]
                bands.append(((lo, hi), int(sel.sum()), float(e.median()), float((e > 1).float().mean())))
        thirds = []
        for t in range(3):
            sel = (u >= t * W / 3) & (u < (t + 1) * W / 3)
            thirds.append(float((err[sel] > 5).float().mean()) if bool(sel.any()) else float("nan"))
        out.append((name, int(ok.sum()), int(ok.numel()), stats, bands, thirds))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", default="0.8,0.2,0.05", help="forward steps, m per frame")
    ap.add_argument("--ground_y", default=None, help="camera heights over the ground, m (default: the bench's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from dynosam_tpu_torch import bench_config as bc

    fx = bc.bench_klt_config()[1].fx
    heights = [float(x) for x in args.ground_y.split(",")] if args.ground_y else [bc.BENCH_GROUND_Y]
    for ground_y in heights:
        print(f"camera {ground_y} m up: ground footprint of the second octave "
              + ", ".join(f"{footprint(d, fx, ground_y):.3f} rad/px at {d:g} m" for d in sorted({x for b in BANDS_M for x in b}))
              + " (pi is its Nyquist limit)", flush=True)
        for forward_m in (float(x) for x in args.steps.split(",")):
            for name, n_ok, n, s, bands, thirds in probe(forward_m, args.device, ground_y):
                print(f"camera {ground_y} m up, step {forward_m} m, {name}: {n_ok} of {n} pass; |LK - true| median "
                      f"{s['median_px']:.3f} px, p90 {s['p90_px']:.3f}, share > 1 px {s['over_1px']:.3f}, > 5 px "
                      f"{s['over_5px']:.3f} (by third of the width, left to right: "
                      f"{', '.join(f'{x:.3f}' for x in thirds)}); "
                      + "; ".join(f"depth {lo:g}-{hi:g} m: {k} tracks, median {m:.3f} px, > 1 px {o:.3f}, ground "
                                  f"footprint {footprint(lo, fx, ground_y):.3f}-{footprint(hi, fx, ground_y):.3f} rad/px"
                                  for (lo, hi), k, m, o in bands), flush=True)


if __name__ == "__main__":
    main()
