"""Where the port's KLT path parts from the JAX reference on the tracked scene.

On `bench_config.tracked_scene` at full width (`bench_klt_config()`, or
`stereo_imu_config()` with --stereo_imu), runs the fused step of the JAX
package and of the port on the CPU over the same frames, and prints, per
frame, how far each run's camera lands from a JAX run on the port's render:

  * the two renders: the port's (`bench_config.tracked_scene`) against the
    JAX package's (`DenseScenario` of the same spec), RGB, depth, flow and
    masks;
  * JAX (its default RANSAC key) on its own render, on the port's render,
    and on the port's render moved by one f32 ulp: every RGB value up, every
    one down, and a seeded half of them up (twice);
  * the port with its own draws (seed 0) on its render at 1 and 4 threads,
    and on JAX's render; the port with JAX's draws on JAX's render;
  * where JAX on its own render and JAX on the port's render part, frame by
    frame: the valid static tracks matched as point sets (their positions
    after LK, max and median difference, px), the valid counts, and the
    first frame whose counts differ.

With identical frames the port follows JAX; the render's last bits move
JAX itself as far as they move the port. Writes nothing.

Usage: JAX_PLATFORMS=cpu python scripts/probe_torch_klt_parting.py [--stereo_imu] [--frames N]
(~5 min for KLT's 20 frames on a CPU)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

FIELDS = ("rgb", "depth", "flow", "mask", "right", "imu_samples", "imu_valid")
IMU_SAMPLES = 32


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stereo_imu", action="store_true", help="the stereo + IMU path (12 frames)")
    ap.add_argument("--frames", type=int, default=None, help="frames (default 20 KLT, 12 stereo + IMU)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu.parallel import batched as jb
    from dynosam_tpu_torch import bench_config as bc
    from dynosam_tpu_torch.ops import ransac
    from dynosam_tpu_torch.parallel import batched as tb
    from torch_port_util import jax_dense, np_tree, reference_draws

    si = args.stereo_imu
    n = args.frames or (12 if si else 20)
    tcfg, intr = bc.stereo_imu_config() if si else bc.bench_klt_config()
    cfg = DynoConfig.from_dict(dataclasses.asdict(tcfg))
    hw = (intr.height, intr.width)
    torch.set_num_threads(4)
    td = bc.tracked_scene(intr, n, device="cpu")
    jd = jax_dense(td)
    port_frames = [bc.stereo_imu_frame(td, k, IMU_SAMPLES) if si else td.frame(k) for k in range(n)]
    if si:
        T_lr = jnp.eye(4).at[0, 3].set(float(intr.baseline))

        def jax_frame(k):
            fr = jd.frame(k)
            X_r = jd.scn.X_gt[k] @ T_lr
            L_k = jd._L_all[:, k]
            depth_r, mask_r = jd._depth_mask(X_r, L_k)
            imu, imu_valid = jd.scn.imu_window(k, IMU_SAMPLES)
            return fr.replace(depth=fr.depth * 1.15, right=jd._world_rgb(X_r, L_k, depth_r, mask_r),
                              imu_samples=imu, imu_valid=imu_valid)
    else:
        jax_frame = jd.frame
    jax_frames = [jax_frame(k) for k in range(n)]

    # ---- the two renders ------------------------------------------------------
    rgb_max = mask_px = 0
    for jf, pf in zip(jax_frames, port_frames):
        same = pf.mask.numpy() == np.asarray(jf.mask)
        mask_px += int((~same).sum())
        rgb_max = max(rgb_max, float(np.abs(pf.rgb.numpy() - np.asarray(jf.rgb))[same].max()))
    print(f"renders over {n} frames: RGB max |port - JAX| {rgb_max:.3e} where the masks agree; mask pixels "
          f"that differ {mask_px}", flush=True)

    def port_as_jax(k, rgb=None):
        kw = {f: jnp.asarray(v.numpy()) for f, v in port_frames[k].tensors().items() if f in FIELDS}
        if rgb is not None:
            kw["rgb"] = jnp.asarray(rgb)
        return jax_frames[k].replace(**kw)

    rng = np.random.default_rng(0)
    up = lambda a: np.nextafter(a, np.float32(np.inf))           # noqa: E731
    down = lambda a: np.nextafter(a, np.float32(-np.inf))        # noqa: E731

    def half_up(a):
        return np.where(rng.random(a.shape) < 0.5, up(a), a)

    inputs = {
        "JAX render": jax_frames,
        "port render": [port_as_jax(k) for k in range(n)],
        "port render, every RGB value +1 ulp": [port_as_jax(k, up(port_frames[k].rgb.numpy())) for k in range(n)],
        "port render, every RGB value -1 ulp": [port_as_jax(k, down(port_frames[k].rgb.numpy())) for k in range(n)],
        "port render, a half of the RGB values +1 ulp (a)": [port_as_jax(k, half_up(port_frames[k].rgb.numpy()))
                                                           for k in range(n)],
        "port render, a half of the RGB values +1 ulp (b)": [port_as_jax(k, half_up(port_frames[k].rgb.numpy()))
                                                           for k in range(n)],
    }
    jstep = jax.jit(jb.make_fused_step(cfg, jd.intr))
    js0 = jb.init_pipeline_state(cfg, image_shape=hw)
    poses, trackers = {}, {}
    for name, frames in inputs.items():
        js, X, trk = js0, [], []
        for fr in frames:
            js, out = jstep(js, fr)
            X.append(np.asarray(out["X_world_cam"]))
            t = np_tree(js)["frontend"]["tracker"]
            trk.append({key: t[key] for key in ("s_uv", "s_valid", "s_age")})
        poses[f"JAX on the {name}"] = np.stack(X)
        trackers[name] = trk

    def port_run(frames, threads, draws=None):
        torch.set_num_threads(threads)
        orig = ransac._sample_indices
        if draws is not None:
            queue = list(draws)
            ransac._sample_indices = (lambda g, v, m, s, uniforms=None:
                                      orig(g, v, m, s, uniforms=torch.from_numpy(np.array(queue.pop(0)))))
        try:
            step = tb.make_fused_step(tcfg, intr, torch.Generator().manual_seed(0))
            state = tb.init_pipeline_state(tcfg, "cpu", image_shape=hw)
            X = []
            for fr in frames:
                state, out = step(state, fr)
                X.append(out["X_world_cam"].numpy())
        finally:
            ransac._sample_indices = orig
        torch.set_num_threads(4)
        return np.stack(X)

    def on_jax_render(k):
        jf = jax_frames[k]
        return dataclasses.replace(port_frames[k], **{f: torch.from_numpy(np.array(getattr(jf, f)))
                                                      for f in FIELDS if getattr(jf, f) is not None})

    jax_render_port = [on_jax_render(k) for k in range(n)]
    poses["the port (seed 0, 1 thread) on the port render"] = port_run(port_frames, 1)
    poses["the port (seed 0, 4 threads) on the port render"] = port_run(port_frames, 4)
    poses["the port (seed 0, 4 threads) on the JAX render"] = port_run(jax_render_port, 4)
    poses["the port with JAX's draws on the JAX render"] = port_run(
        jax_render_port, 4, reference_draws(js0.frontend.key, cfg.frontend, n))

    # ---- camera gaps ------------------------------------------------------------
    X_gt = td.scn.X_gt.numpy().astype(np.float64)

    def rot_gap(X, ref):
        # the angle from the skew part: f32 rotations are orthonormal only
        # to ~1e-7, which the trace's arccos cannot resolve at 1e-5 rad
        dR = np.einsum("fji,fjk->fik", X[:, :3, :3].astype(np.float64), ref[:, :3, :3])
        w = np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0], dR[:, 1, 0] - dR[:, 0, 1]], -1) / 2
        return np.arcsin(np.clip(np.linalg.norm(w, axis=-1), 0.0, 1.0))

    for ref_name in ("JAX on the port render", "JAX on the JAX render"):
        ref = poses[ref_name].astype(np.float64)
        print(f"\ncamera gap to {ref_name}, m and rad (max; translation per frame):", flush=True)
        for name, X in poses.items():
            if name == ref_name:
                continue
            gap = np.linalg.norm(X[:, :3, 3].astype(np.float64) - ref[:, :3, 3], axis=-1)
            print(f"  {name}: {gap.max():.3e} m, {rot_gap(X, ref).max():.2e} rad; "
                  + " ".join(f"{x:.1e}" for x in gap), flush=True)
    print("\nagainst the ground truth, m (max):", flush=True)
    for name, X in poses.items():
        e = np.linalg.norm(X[:, :3, 3].astype(np.float64) - X_gt[:, :3, 3], axis=-1)
        print(f"  {name}: {e.max():.4f} at frame {int(e.argmax())}", flush=True)

    # ---- where JAX's two runs part, in the tracker --------------------------------
    print("\nJAX on the JAX render against JAX on the port render, static tracks as point sets:", flush=True)
    for other in ("port render", "port render, every RGB value +1 ulp"):
        print(f"  vs the {other}:", flush=True)
        for k in range(n):
            a, b = trackers["JAX render"][k], trackers[other][k]
            A, B = a["s_uv"][a["s_valid"]], b["s_uv"][b["s_valid"]]
            d, _ = cKDTree(B).query(A)
            tracked = a["s_age"][a["s_valid"]] > 0
            near = tracked & (d <= 0.5)
            print(f"    frame {k}: valid {len(A)} / {len(B)}; tracked positions max "
                  f"{d[near].max() if near.any() else 0.0:.3e} px, median {np.median(d[near]) if near.any() else 0.0:.3e} "
                  f"px; tracks with no partner within 0.5 px {int((d > 0.5).sum())}", flush=True)


if __name__ == "__main__":
    main()
