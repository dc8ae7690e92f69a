"""Frame-by-frame look at a formulation's fused step on the bench scene.

Runs the fused step's stages by hand (frontend, advance, graph update,
optimizer) at bench_config() with the WCME (`wcme`) or WCPE (`wcpe`)
backend over the 20 bench frames, and per frame prints: the graph error
before and after the optimizer, on the device and on the CPU from the
device's own inputs (the graph state and packet copied over, so the two
backends are compared on equal footing), the largest difference of their
optimized camera poses and object variables, and the error of the latest
object motions (WCME's graph motions; for WCPE the graph holds poses, so
only the packet's are read) and of the frontend packet's motions against
dynosam_tpu_torch/testdata/bench_<name>_ref_20f.npz. At frame 1 it also
prints the eigenvalue range of the reduced system S of the first LM
iteration as the optimizer builds it (f32) and of the same linearisation
made in float64 (on the CPU).

Usage: python scripts/probe_torch_forms.py wcme|wcpe [--device cuda] [--seed 0]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("name", choices=["wcme", "wcpe"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the RANSAC generator")
    args = ap.parse_args()

    import numpy as np
    import torch

    from dynosam_tpu_torch.backend import graph, solver, wcpe, window
    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.frontend.frontend import frontend_step
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state

    advance, update, optimize, error, linearize = {
        "wcme": (window.advance, graph.update_from_packet, solver.optimize, solver.total_error, solver.linearize),
        "wcpe": (window.advance_wcpe, wcpe.update_from_packet_wcpe, wcpe.optimize, wcpe.total_error,
                 wcpe.linearize),
    }[args.name]
    cfg, intr = bench_config()
    cfg = cfg.with_overrides({"backend.backend_updater_enum": 0 if args.name == "wcme" else 1}).normalized()
    # the fused step's incremental settings (parallel/batched.py)
    b = dataclasses.replace(cfg.backend, optimizer=dataclasses.replace(
        cfg.backend.optimizer, accept_reject=True, max_iterations=min(3, cfg.backend.optimizer.max_iterations)))
    ref = np.load(os.path.join(ROOT, "dynosam_tpu_torch", "testdata", f"bench_{args.name}_ref_20f.npz"))
    scene = bench_scene(intr, 20, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    state = init_pipeline_state(cfg, args.device)
    fe, g = state.frontend, state.graph

    def cpu(x):
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: cpu(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x.cpu() if torch.is_tensor(x) else x

    def diff(a, c):
        return float((a.cpu() - c).abs().max())

    def motion_err(H, k):
        return np.round(np.linalg.norm(H[:, :3, 3] - ref["object_motions"][k][:, :3, 3], axis=-1), 5)

    for k in range(20):
        fe, pk = frontend_step(fe, scene.frame(k), intr, cfg.frontend, gen)
        if g.num_frames >= b.max_frames:
            g = advance(g, b)
        g = update(g, pk, intr, b)
        g_cpu = cpu(g)
        if k == 1:
            lam = b.optimizer.lm_initial_lambda
            S32 = linearize(g, b, torch.tensor(lam, device=args.device)).S.cpu().double()
            g64 = dataclasses.replace(g_cpu, **{
                f.name: getattr(g_cpu, f.name).double() for f in dataclasses.fields(g_cpu)
                if torch.is_tensor(getattr(g_cpu, f.name)) and getattr(g_cpu, f.name).is_floating_point()})
            S64 = linearize(g64, b, torch.tensor(lam, dtype=torch.float64)).S
            e32, e64 = torch.linalg.eigvalsh(S32), torch.linalg.eigvalsh(S64)
            print(f"frame 1, lambda {lam}: S eigenvalues f32 [{float(e32.min()):.4g}, {float(e32.max()):.4g}], "
                  f"float64 [{float(e64.min()):.4g}, {float(e64.max()):.4g}]; largest |S32 - S64| "
                  f"{float((S32 - S64).abs().max()):.4g} of {float(S64.abs().max()):.4g}", flush=True)
        before = float(error(g, b))
        g = optimize(g, b)
        o_cpu = optimize(g_cpu, b)
        f = g.num_frames - 1
        ids = g.obj_ids.cpu().numpy()
        line = (f"frame {k}: error before {before:.6g}, after {float(error(g, b)):.6g} ({args.device}) / "
                f"{float(error(o_cpu, b)):.6g} (cpu); optimized X, H {args.device} vs cpu "
                f"{diff(g.X, o_cpu.X):.2e}, {diff(g.H, o_cpu.H):.2e}; object ids {ids.tolist()}")
        if args.name == "wcme":
            valid = g.H_valid[:, f].cpu().numpy()
            line += f"; graph motions vs ref {(motion_err(g.H[:, f].cpu().numpy(), k) * valid).tolist()}"
        line += f"; packet motions vs ref {motion_err(pk.object_motions.cpu().numpy(), k).tolist()}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
