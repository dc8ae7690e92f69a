"""Streamed-vs-batch hybrid accuracy experiment: the backend alone (the port
of scripts/exp_streaming.py).

Feeds the simulator's noisy packets (`Scenario.measurements`) straight into
`RegularBackend`, with no frontend and no renderer, in full-batch (0),
sliding-window (1) and incremental (2) modes, and scores each frame's
object motion: full-batch from its final solve, the windowed modes from
their mature estimates (the ones taken when a frame leaves the window, the
fixed-lag output contract). The packets' initial camera poses, odometry and
object motions are the ground truth perturbed by `lie.retract` with numpy
normals (default_rng(11)), drawn in the reference's order, so that a value
the backend never updates cannot score a flattering zero. Frame 0's pose
and odometry stay exact (the gauge anchor).

No hand-written kernel runs on this path: it is the backend alone, as in
the reference. The scores are computed on the host in numpy, as the
reference does.

Usage: python -m dynosam_tpu_torch.exp_streaming [--frames 20] [--window 8] [--modes 0,1,2]
    [--pixel_noise 0.4] [--depth_noise 0.02] [--iters 10] [--init_rot_noise 0.01]
    [--init_trans_noise 0.05] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

MAX_OBJ = 4
SCENE_SEED = 5
PERTURB_SEED = 11
# the script's flags and defaults
DEFAULTS = {"frames": 20, "window": 8, "modes": "0,1,2", "pixel_noise": 0.4, "depth_noise": 0.02, "iters": 10,
            "init_rot_noise": 0.01, "init_trans_noise": 0.05}


def scenario(n: int, pixel_noise: float, depth_noise: float, device="cuda", uniforms=None, normals=None):
    """The experiment's scene: default_two_objects over n frames with the
    given measurement noise, seed 5. `uniforms` / `normals` (Scenario's
    arguments) replace the port's draws of the landmark clouds and of the
    noise, as parity checks give it the reference's."""
    from dynosam_tpu_torch.dataproviders.simulator import Scenario, ScenarioSpec

    spec = ScenarioSpec.default_two_objects(num_frames=n, pixel_noise=pixel_noise, depth_noise=depth_noise,
                                            seed=SCENE_SEED)
    return Scenario(spec, device=device, uniforms=uniforms, normals=normals)


def noisy_packets(scn, init_rot_noise: float, init_trans_noise: float):
    """Every frame's packet over MAX_OBJ object slots, its initial values
    perturbed: per frame the four motion slots in order, then (k > 0) the
    camera pose and the odometry, each by xi = (3 rotation, 3 translation)
    normals of numpy's default_rng(11)."""
    from dynosam_tpu_torch.utils import lie

    rng = np.random.default_rng(PERTURB_SEED)

    def perturb(T):
        xi = np.concatenate([rng.normal(0, init_rot_noise, 3), rng.normal(0, init_trans_noise, 3)])
        return lie.retract(T, torch.as_tensor(xi.astype(np.float32), device=T.device))

    packets = []
    for k in range(scn.spec.num_frames):
        pk = scn.measurements(k, MAX_OBJ)
        om = torch.stack([perturb(pk.object_motions[j]) for j in range(pk.object_motions.shape[0])])
        if k == 0:
            pk = dataclasses.replace(pk, object_motions=om)
        else:
            X = perturb(pk.X_world_cam)
            odom = perturb(pk.odom_prev_curr)
            pk = dataclasses.replace(pk, X_world_cam=X, odom_prev_curr=odom, object_motions=om)
        packets.append(pk)
    return packets


def backend_config(mode: int, n: int, window: int, iters: int):
    """The script's BackendParams: hybrid, the whole sequence as the window
    in full-batch, 256 static and 96 dynamic landmark slots,
    range-independent noise, `iters` LM iterations."""
    from dynosam_tpu_torch.config import BackendParams, NoiseParams, OptimizerParams

    return BackendParams(
        optimization_mode=mode,
        backend_updater_enum=3,
        max_frames=n if mode == 0 else window,
        max_objects=MAX_OBJ,
        max_static_landmarks=256,
        max_dynamic_landmarks=96,
        noise=NoiseParams(use_range_dependent_noise=False),
        optimizer=OptimizerParams(max_iterations=iters),
    )


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_mode(mode: int, scn, packets, window: int, iters: int, device="cuda"):
    """One mode's run: RegularBackend over every packet, finish() in
    full-batch, then the mature estimates of the frames left in the window
    -> (backend, wall seconds of each step, wall seconds of finish and
    finalize_matured)."""
    from dynosam_tpu_torch.backend.backend import RegularBackend

    be = RegularBackend(backend_config(mode, len(packets), window, iters), scn.intr, device)
    step_s = []
    for pk in packets:
        t0 = time.perf_counter()
        be.step(pk)
        _sync(device)
        step_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    if mode == 0:
        be.finish()
    be.finalize_matured()
    _sync(device)
    return be, step_s, time.perf_counter() - t0


def motion_errors(be, scn):
    """{(k, object id): (translation error m, rotation error rad)} of the
    backend's (mature) motions against the ground truth, k >= 1."""
    out = {}
    for k in range(1, scn.spec.num_frames):
        for j, ob in enumerate(scn.spec.objects):
            H = be.motion_at(k, object_id=ob.object_id)
            if H is None:
                continue
            E = np.linalg.inv(scn.H_gt[j][k].cpu().numpy()) @ H
            cos = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            out[(k, ob.object_id)] = (float(np.linalg.norm(E[:3, 3])), float(np.arccos(cos)))
    return out


def pose_errors(be, scn):
    """{k: camera translation error m} of the backend's (mature) poses."""
    out = {}
    for k in range(scn.spec.num_frames):
        X = be.pose_at(k)
        if X is None:
            continue
        E = np.linalg.inv(scn.X_gt[k].cpu().numpy()) @ X
        out[k] = float(np.linalg.norm(E[:3, 3]))
    return out


def summary(me, pe):
    """-> {ate, ame_rms, ame_med, rot_rms (m, rad), n_motions} over a
    mode's errors."""
    te = np.array([v[0] for v in me.values()])
    re = np.array([v[1] for v in me.values()])
    return {"ate": float(np.sqrt(np.mean(np.square(list(pe.values()))))),
            "ame_rms": float(np.sqrt(np.mean(te ** 2))), "ame_med": float(np.median(te)),
            "rot_rms": float(np.sqrt(np.mean(re ** 2))), "n_motions": len(me)}


def summary_line(mode: int, s) -> str:
    """The reference's line of one mode."""
    return (f"mode={mode} ATE {s['ate']*100:7.3f} cm | AME rms "
            f"{s['ame_rms']*100:7.3f} cm med {s['ame_med']*100:7.3f} cm "
            f"rot {s['rot_rms']:.5f} [{s['n_motions']} motions]")


def per_frame_lines(results, n: int):
    """The reference's per-frame table of object 1's translation error,
    full-batch against each windowed mode (needs mode 0)."""
    lines = []
    if 0 not in results:
        return lines
    for mode in results:
        if mode == 0:
            continue
        lines.append(f"\nper-frame trans err (cm), batch vs mode {mode}, object 1:")
        for k in range(1, n):
            a = results[0].get((k, 1))
            b = results[mode].get((k, 1))
            fa = f"{a[0]*100:6.2f}" if a else " ----"
            fb = f"{b[0]*100:6.2f}" if b else " ----"
            lines.append(f"  k={k:2d}  batch {fa}  streamed {fb}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, default in DEFAULTS.items():
        ap.add_argument(f"--{name}", type=type(default), default=default)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = args.frames
    scn = scenario(n, args.pixel_noise, args.depth_noise, args.device)
    packets = noisy_packets(scn, args.init_rot_noise, args.init_trans_noise)
    results = {}
    for mode in [int(m) for m in args.modes.split(",")]:
        be, _, _ = run_mode(mode, scn, packets, args.window, args.iters, args.device)
        me = motion_errors(be, scn)
        print(summary_line(mode, summary(me, pose_errors(be, scn))), flush=True)
        results[mode] = me
    for line in per_frame_lines(results, n):
        print(line)
    return results


if __name__ == "__main__":
    main()
