"""Backend timing at reference object counts (KITTI 0020 carries more than
30 object ids): J=32 objects, an F=16 window, 2048 dynamic landmarks. The
port of scripts/scale_check.py.

For WCME and the hybrid formulation in sliding-window mode, `time_config`
fills the graph from F frames of a synthetic scene's exact measurements
(`Scenario.measurements(k, J)`), optimizes, then advances the window once.
Eager torch compiles nothing, so the reference's `*_compile_s` columns are
the first call's time here (set-up: allocation, cuSOLVER handles, the
first launches) and `*_step_ms` the next call's. Every timing ends in
`torch.cuda.synchronize()`. No hand-written kernel runs on this path: it is
the backend alone, as in the reference.

Writes --out (default results/torch/SCALE.md: never a committed file, the
repository's SCALE.md, which the reference writes, or the port's
dynosam_tpu_torch/SCALE.md, which a card run refreshes with --out), headed
by the card's name and power limit.

Usage: python -m dynosam_tpu_torch.scale_check [--J 32] [--F 16] [--dyn 2048] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

DEFAULT_OUT = os.path.join("results", "torch", "SCALE.md")
COLUMNS = ("update_compile_s", "update_step_ms", "optimize_compile_s", "optimize_step_ms",
           "advance_compile_s", "advance_step_ms")
N_STATIC = 256


def scale_config(J: int, F: int, n_dyn: int, formulation: int, mode: int):
    """-> (BackendParams, points per object): landmark capacities equal the
    packet tables' sizes (tracker rows map one to one onto landmark slots)."""
    from dynosam_tpu_torch.config import BackendParams, OptimizerParams

    pts_per_obj = max(8, n_dyn // max(J, 1))
    cfg = BackendParams(
        max_frames=F,
        max_objects=J,
        max_static_landmarks=N_STATIC,
        max_dynamic_landmarks=pts_per_obj * J,
        optimization_mode=mode,
        backend_updater_enum=formulation,
        optimizer=OptimizerParams(max_iterations=5),
    )
    return cfg, pts_per_obj


def scale_scenario(J: int, F: int, pts_per_obj: int, device="cuda", uniforms=None):
    """The reference's synthetic stream: J objects on a grid of 8 columns
    ahead of a camera driving forward, F + 2 frames. `uniforms` (Scenario's
    argument) replaces the port's draw of the landmark clouds, as parity
    checks give it the reference's."""
    from dynosam_tpu_torch.dataproviders.simulator import ObjectSpec, Scenario, ScenarioSpec

    objects = [
        ObjectSpec(
            object_id=j + 1,
            initial_pose_xi=np.array([0.0, 0.0, 0.0, (j % 8 - 4) * 2.0, 0.0, 8.0 + (j // 8) * 6.0]),
            motion_xi=np.array([0.0, 0.002 * (j % 3), 0.0, 0.05, 0.0, 0.2]),
            num_points=pts_per_obj,
        )
        for j in range(J)
    ]
    spec = ScenarioSpec(num_frames=F + 2, num_static=N_STATIC,
                        camera_motion_xi=np.array([0.0, 0.003, 0.0, 0.0, 0.0, 0.5]), objects=objects)
    return Scenario(spec, device=device, uniforms=uniforms)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_config(J, F, n_dyn, formulation, mode, device="cuda", uniforms=None):
    """-> ({column: value}, the graph after the optimize, the graph after
    the advance) of one formulation (0 WCME, 1 WCPE, 3 hybrid). `uniforms`:
    the landmark clouds' draws (scale_scenario)."""
    from dynosam_tpu_torch.backend import graph, hybrid, solver, wcpe, window

    cfg, pts_per_obj = scale_config(J, F, n_dyn, formulation, mode)
    mod = {0: solver, 1: wcpe, 3: hybrid}[formulation]
    upd = graph.update_from_packet_hybrid if formulation == 3 else graph.update_from_packet
    adv = window.advance_hybrid if formulation == 3 else window.advance
    scn = scale_scenario(J, F, pts_per_obj, device, uniforms)
    packets = [scn.measurements(k, J) for k in range(F + 2)]
    _sync(device)
    res = {}

    def timed(fn, arg):
        t0 = time.perf_counter()
        out = fn(arg)
        _sync(device)
        return out, time.perf_counter() - t0

    st = graph.empty_graph(cfg, device)
    st, res["update_compile_s"] = timed(lambda s: upd(s, packets[0], scn.intr, cfg), st)
    t0 = time.perf_counter()
    for k in range(1, F):
        st = upd(st, packets[k], scn.intr, cfg)
    _sync(device)
    res["update_step_ms"] = (time.perf_counter() - t0) / (F - 1) * 1e3

    st, res["optimize_compile_s"] = timed(lambda s: mod.optimize(s, cfg), st)
    st, dt = timed(lambda s: mod.optimize(s, cfg), st)
    res["optimize_step_ms"] = dt * 1e3

    st2, res["advance_compile_s"] = timed(lambda s: adv(s, cfg), st)
    st2, dt = timed(lambda s: adv(s, cfg), st)
    res["advance_step_ms"] = dt * 1e3
    return res, st, st2


def device_label(device="cuda") -> str:
    """The card's name and power limit as nvidia-smi gives them (the
    reference prints jax's device_kind); the torch device name elsewhere."""
    if torch.device(device).type != "cuda":
        return f"{device} (not a card)"
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30, check=True)
        return q.stdout.strip().splitlines()[torch.cuda.current_device()]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def write_scale_md(path: str, rows, J: int, F: int, n_dyn: int, label: str) -> None:
    with open(path, "w") as f:
        f.write(
            f"# SCALE (port) — J={J} objects, F={F} window, {n_dyn} dynamic landmarks ({label})\n\n"
            "Reference workloads carry >30 object ids (KITTI 0020). The backend alone in\n"
            "sliding-window mode, eager PyTorch: the compile columns are the first call's\n"
            "time (set-up), the step columns the next call's (one call each, as the\n"
            "reference times them; the update step is the mean of F - 1); every time ends in\n"
            "torch.cuda.synchronize(). Generated by python -m dynosam_tpu_torch.scale_check.\n\n"
            "| Formulation | update compile (s) | update step (ms) | optimize compile (s) | optimize step (ms) | "
            "advance compile (s) | advance step (ms) |\n"
            "|---|---|---|---|---|---|---|\n"
        )
        for r in rows:
            f.write(f"| {r['formulation']} | " + " | ".join(
                f"{r[c]:.3f}" if c.endswith("_s") else f"{r[c]:.2f}" for c in COLUMNS) + " |\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--J", type=int, default=32)
    ap.add_argument("--F", type=int, default=16)
    ap.add_argument("--dyn", type=int, default=2048)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rows = []
    for name, formulation in [("WCME", 0), ("Hybrid", 3)]:
        r, _, _ = time_config(args.J, args.F, args.dyn, formulation, mode=1, device=args.device)
        r["formulation"] = name
        rows.append(r)
        print(json.dumps(r), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_scale_md(args.out, rows, args.J, args.F, args.dyn, device_label(args.device))
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
