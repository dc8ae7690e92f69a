"""Each feature's cost in the fused step at bench scale (the port of
scripts/bisect_perf.py): the bench configuration with one feature (or all
of them) switched off, each variant's step timed as bench.py times it.

Suspects: per-object joint-OF refinement, camera joint-OF refinement,
mask propagation (propogateMask), the scene-flow stationarity test, the
decoupled two-phase hybrid solve, the incremental iteration budget and the
marginal point uncertainty of the window advance.

`no_propogate_mask` runs the same program as `shipped` here: the state is
built without an image shape (as bench.py builds it), so mask propagation
never runs; its row is kept and says so.

Usage: python -m dynosam_tpu_torch.bisect_perf [--variants name,name,...]
       [-n 30] [--device cuda|cpu] [--small] [--seed 0]
"""

from __future__ import annotations

import argparse

from dynosam_tpu_torch import bench as B
from dynosam_tpu_torch import timing

VARIANTS = {
    "shipped": {},
    "no_obj_joint_of": {"refine_motion_with_joint_of": False},
    "no_cam_joint_of": {"refine_camera_pose_with_joint_of": False},
    "no_propogate_mask": {"use_propogate_mask": False},
    "no_scene_flow": {"scene_flow_percentage": 2.0},  # test never fires
    "joint_solve": {"decoupled_object_solve": False},
    "opt_iters_1": {"max_iterations": 1},
    "no_marg_uncert": {"marginal_point_uncertainty": False},
    "all_off": {
        "refine_motion_with_joint_of": False,
        "refine_camera_pose_with_joint_of": False,
        "use_propogate_mask": False,
        "scene_flow_percentage": 2.0,
        "decoupled_object_solve": False,
    },
}
WARMUP = 8
# variants whose program equals shipped's on this path, and why
SAME_AS_SHIPPED = {"no_propogate_mask": "same program as shipped: the state has no image shape, so mask "
                                        "propagation never runs"}


def variant_config(name, small=False):
    """(cfg, intr) of variant `name`: the bench configuration (or the
    graft's, with `small`) with its overrides."""
    from dynosam_tpu_torch import bench_config as bc

    cfg, intr = (bc.small_config(), bc.small_intr()) if small else bc.bench_config()
    overrides = VARIANTS[name]
    return (cfg.with_overrides(overrides) if overrides else cfg), intr


def measure(cfg, intr, frames, n=30, warmup=WARMUP, device="cuda", seed=0):
    """-> (ms per frame over `n` measured steps, first step s, K1 launches)
    for the fused step under `cfg`, timed as bench.py times it."""
    step, state = B.build(cfg, intr, device, seed)
    before = timing.counts()
    _, _, first_s, dt = timing.time_steps(step, state, frames, warmup, n, device=device)
    return dt * 1e3, first_s, timing.since(before)["K1"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None, help="comma-separated names of VARIANTS (default: all)")
    ap.add_argument("-n", type=int, default=30, help="measured steps per variant")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true", help="the graft's quick configuration, 128 x 96")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}: {list(VARIANTS)}")
    card = timing.prepare(args.device)
    _, _, frames = B.bench_setup(args.device, args.small)
    print(f"device: {card}", flush=True)
    print(f"{'variant':24s} {'ms/frame':>9s} {'FPS':>7s} {'first':>8s}", flush=True)
    rows, base = {}, None
    for name in names:
        cfg, intr = variant_config(name, args.small)
        dt, first_s, k1 = measure(cfg, intr, frames, args.n, device=args.device, seed=args.seed)
        rows[name] = {"ms": dt, "first_s": first_s, "K1": k1}
        if name == "shipped":
            base = dt
        delta = f"  ({dt - base:+.2f} ms vs shipped)" if base is not None and name != "shipped" else ""
        note = f"  [{SAME_AS_SHIPPED[name]}]" if name in SAME_AS_SHIPPED else ""
        print(f"{name:24s} {dt:9.3f} {1e3 / dt:7.1f} {first_s:7.1f}s{delta}{note}", flush=True)
    return rows


if __name__ == "__main__":
    main()
