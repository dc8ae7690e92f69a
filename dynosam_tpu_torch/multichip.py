"""The multi-device path end to end, at full width: the port of the
reference's `__graft_entry__.dryrun_multichip` and its worker,
scripts/dryrun_multichip_worker.py. One process per rank
(`parallel/group.py`), each on its own card (`rank % device_count`), or on
the CPU.

  (a) `make_batched_pipeline` over the group (the reference's `mesh=`):
      `--sequences` sequences of the bench scene at `bench_config()`
      (384x1280, 800 + 1024 track slots, 8 objects, 128 hypotheses, hybrid
      incremental, a 10-frame window), sequence b on scene frames
      b..b+frames-1, each rank stepping its sequences/ranks of them with
      the whole batch's RANSAC draws (`--seed`). The outputs, gathered to
      rank 0 in sequence order, are held to an unsharded run of the same
      program in rank 0 (SHARD_BOUNDS; ids, validity flags and the
      finite entries equal).
  (b) `sharded_optimize` over the group (the reference's landmark-sharded
      backend): scale_check's hybrid graph (J objects, an F-frame window,
      the dynamic landmarks, 256 static), filled by rank 0 and broadcast,
      five Gauss-Newton iterations, held in rank 0 to the single-process
      `chunked_optimize` at the same P (poses within 2e-4, motions within
      2e-3: tests/test_sharded.py's sharded-vs-unsharded bounds), its
      `sharded_linearize` to `chunked_linearize` within 1e-5 of the largest
      entry, and every rank's step equal to rank 0's in every iteration.

No failure is caught: a rank that raises ends the run with a non-zero exit.
Prints the reference's OK line, the largest differences, each rank's wall
seconds, the ms of a steady step and torch's intra-op thread count per
rank, and K1b's launches per rank.

Usage: python -m dynosam_tpu_torch.multichip [--ranks N] [--backend nccl|gloo]
       [--device cuda|cpu] [--sequences 8] [--frames 12] [--seed 0]
       [--J 32] [--F 16] [--dyn 2048] [--small]
`--small` runs (a) on the reference's small dense scene (160x120) with a
few-slot configuration and a 4-frame window, for a quick CPU run.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import statistics
import time

import numpy as np
import torch

from dynosam_tpu_torch.parallel import group as grp

# sharded against unsharded outputs, largest |difference| (ids and flags
# equal). The reference holds its mesh run to rtol = atol = 2e-4
# (dryrun_multichip_worker.py). On the CPU every output of the port reads 0
# (bench_config, 8 sequences over 2 ranks, 12 frames). On the H100 (gloo, 2
# ranks) camera poses read 7.6e-6 and object motions 5.5695e-4; the
# unsharded B=8 run repeats bit for bit. The cause is torch's CUDA sum over
# a batch, not rows mixing (scripts/bisect_torch_batch.py): the camera
# refit's weighted point sum over (B, 800, 3) (ops/kabsch.py::
# solve_rigid_quat) rounds a row of a batch of 4 otherwise than the same
# row of a batch of 8 from frame 1 (one ulp), and the motion solvers carry
# it to 5.5695e-4 m at the first window advance. Bounds: poses at the
# reference's 2e-4, motions ~3x the card's reading.
SHARD_BOUNDS = {"X_world_cam": 2e-4, "frontend_pose": 2e-4, "object_motions": 1.7e-3}
# sharded_optimize against chunked_optimize (tests/test_sharded.py's
# sharded-vs-unsharded bounds) and sharded_linearize against
# chunked_linearize (relative to the largest entry)
OPT_POSE, OPT_MOTION, LIN_REL = 2e-4, 2e-3, 1e-5
ITERATIONS = 5
LAM = 1e-4


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _zero_counts():
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    for fn in (st.shi_tomasi_cell_max, st.shi_tomasi_response, mc.mask_combine, mc.mask_label):
        fn.launches = 0


def _counts():
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    return {"K1": st.shi_tomasi_cell_max.launches, "K1 map": st.shi_tomasi_response.launches,
            "K2": mc.mask_combine.launches, "K2 label": mc.mask_label.launches}


# ---------------------------------------------------------------------------
# configurations and inputs

def small_config():
    """(cfg, intr) of the quick run: bench_config's settings with 128
    track slots, 4 objects and a 4-frame window, on the reference's small
    dense scene's camera (160x120)."""
    from dynosam_tpu_torch.bench_config import bench_config
    from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario

    cfg, _ = bench_config()
    cfg = cfg.with_overrides({
        "frontend.max_objects": 4, "frontend.tracker.max_features_per_frame": 128,
        "frontend.tracker.min_features_per_frame": 64, "frontend.tracker.max_dynamic_features_per_frame": 128,
        "frontend.tracker.detection_cell_size": 8, "backend.max_frames": 4, "backend.max_objects": 4,
        "backend.max_static_landmarks": 128, "backend.max_dynamic_landmarks": 128,
    })
    return cfg, default_dense_scenario(num_frames=1, device="cpu").intr


def scene_frames(device, B: int, n_frames: int, small: bool = False):
    """n_frames batched FrameInputs (B, ...) on `device`: sequence b on
    scene frames b..b+n_frames-1 of the bench scene (or the small dense
    scene)."""
    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario

    n_scene = n_frames + B - 1
    if small:
        scene = default_dense_scenario(num_frames=n_scene, device=device)
    else:
        scene = bench_scene(bench_config()[1], n_scene, device=device)
    frames = scene.frames()
    return [stack_frames(frames[k:k + B]) for k in range(n_frames)]


def stack_frames(frames):
    """One FrameInputs with a leading batch axis from per-sequence frames."""
    f0 = frames[0]
    return dataclasses.replace(f0, **{k: torch.stack([getattr(f, k) for f in frames]).contiguous()
                                      for k in f0.tensors()})


def scale_graph(device, J: int, F: int, n_dyn: int):
    """scale_check's hybrid window (J objects, F frames, n_dyn dynamic and
    256 static landmarks, exact measurements) filled frame by frame ->
    (GraphState, BackendParams)."""
    from dynosam_tpu_torch import scale_check as sc
    from dynosam_tpu_torch.backend import graph

    cfg, pts = sc.scale_config(J, F, n_dyn, 3, 1)
    scn = sc.scale_scenario(J, F, pts, device)
    st = graph.empty_graph(cfg, device)
    for k in range(F):
        st = graph.update_from_packet_hybrid(st, scn.measurements(k, J), scn.intr, cfg)
    return st, cfg


# ---------------------------------------------------------------------------
# the ranks' programs (module-level, so that spawned ranks import them)

def _run_batched(step, state, frames, device, group=None):
    from dynosam_tpu_torch.parallel.batched import shard_rows

    outs, times = [], []
    for fr in frames:
        t0 = time.perf_counter()
        state, out = step(state, shard_rows(fr, group))
        _sync(device)
        times.append(time.perf_counter() - t0)
        outs.append(out)
    return outs, times


def _stack_outputs(outs):
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _steady_ms(times, window):
    steady = times[window:] if len(times) > window else times[1:] or times
    return statistics.median(steady) * 1e3


def output_diffs(got: dict, ref: dict) -> dict:
    """{output: largest |difference|} for float outputs, the count of
    unequal entries for ids and flags."""
    out = {}
    for k, r in ref.items():
        g = got[k]
        if r.dtype.is_floating_point:
            out[k] = float((g - r).abs().max())
        else:
            out[k] = int((g != r).sum())
    return out


def shard_over(got: dict, ref: dict) -> dict:
    """The outputs whose sharded and unsharded values part beyond
    SHARD_BOUNDS (floats, where both are finite), or whose shapes, finite
    entries, ids or flags differ -> {output: reading}."""
    over = {}
    for k, r in ref.items():
        g = got[k]
        if g.shape != r.shape:
            over[k] = ("shape", tuple(g.shape), tuple(r.shape))
        elif r.dtype.is_floating_point:
            fin = torch.isfinite(r)
            if not torch.equal(torch.isfinite(g), fin):
                over[k] = "finite entries differ"
            elif fin.any() and not float((g[fin] - r[fin]).abs().max()) <= SHARD_BOUNDS[k]:
                over[k] = float((g[fin] - r[fin]).abs().max())
        elif not torch.equal(g, r):
            over[k] = int((g != r).sum())
    return over


def batched_rank(group, cfg, intr, frames, seed=0, draws=None, reference=True):
    """One rank of (a). `frames`: the batch's FrameInputs (B, ...) for each
    frame, on the CPU, or a callable `frames(device)` that makes them
    there; `draws`: the whole batch's RANSAC uniforms per call (a
    reference's), else a generator seeded with `seed`. Returns this rank's
    launches, per-frame seconds and steady step ms; on rank 0 also the
    gathered outputs (frames, B, ...), and with `reference` the unsharded
    run's outputs and the differences."""
    from dynosam_tpu_torch.ops.ransac import ReplayDraws
    from dynosam_tpu_torch.parallel.batched import gather_outputs, make_batched_pipeline

    device = group.device
    t0 = time.perf_counter()
    full = frames(device) if callable(frames) else [f.to(device) for f in frames]
    B = full[0].rgb.shape[0]
    setup = time.perf_counter() - t0

    def source():
        return ReplayDraws(draws) if draws is not None else torch.Generator(device=device).manual_seed(seed)

    step, init = make_batched_pipeline(cfg, intr, source(), group=group)
    state = init(B, device)
    _sync(device)
    _zero_counts()
    t0 = time.perf_counter()
    outs, times = _run_batched(step, state, full, device, group)
    wall = time.perf_counter() - t0
    launches = _counts()
    res = {"rank": group.rank, "device": str(device), "backend": group.backend, "launches": launches,
           "threads": torch.get_num_threads(), "rows": B // group.world, "setup_s": setup, "wall_s": wall,
           "times": times,
           "step_ms": _steady_ms(times, cfg.backend.max_frames)}
    gathered = [gather_outputs(o, group) for o in outs]
    if group.rank == 0:
        res["outputs"] = _stack_outputs(gathered)
        if reference:
            t0 = time.perf_counter()
            ustep, uinit = make_batched_pipeline(cfg, intr, source())
            uouts, utimes = _run_batched(ustep, uinit(B, device), full, device)
            ref = _stack_outputs(uouts)
            res["reference"] = ref
            res["diffs"] = output_diffs(res["outputs"], ref)
            res["over"] = shard_over(res["outputs"], ref)
            res["reference_step_ms"] = _steady_ms(utimes, cfg.backend.max_frames)
            res["reference_s"] = time.perf_counter() - t0
    return res


def _broadcast_state(state, group):
    from dynosam_tpu_torch.parallel.batched import _map_tensors

    return _map_tensors(lambda t: grp.broadcast(t.contiguous(), group, 0), state)


def sharded_rank(group, state, cfg, iterations=ITERATIONS, reference=True, lam=LAM):
    """One rank of (b). `state`: the whole GraphState on the CPU (the same
    on every rank), or a callable `state(device)` -> (GraphState, cfg),
    which rank 0's result is broadcast from. Returns this rank's largest
    step and system spread from rank 0's, wall seconds and ms per
    iteration; on rank 0 the sharded_linearize system and the optimized
    state gathered, and with `reference` chunked_optimize's and the
    differences."""
    from dynosam_tpu_torch.parallel import sharded

    device = group.device
    t0 = time.perf_counter()
    if callable(state):
        state, cfg = state(device)
        state = _broadcast_state(state, group)
    else:
        from dynosam_tpu_torch.parallel.batched import _map_tensors

        state = _map_tensors(lambda t: t.to(device), state)
    _sync(device)
    build = time.perf_counter() - t0
    lam_t = torch.tensor(lam, dtype=state.X.dtype, device=device)
    chunk = sharded.shard_state(state, group)
    S, rhs = sharded.sharded_linearize(chunk, cfg, lam_t, group)
    spread = {"S": grp.max_diff_from_rank0(S, group), "rhs": grp.max_diff_from_rank0(rhs, group), "dx": 0.0}

    def on_step(dx):
        spread["dx"] = max(spread["dx"], grp.max_diff_from_rank0(dx, group))

    _sync(device)
    t0 = time.perf_counter()
    out = sharded.sharded_optimize(chunk, cfg, group, iterations=iterations, on_step=on_step)
    _sync(device)
    wall = time.perf_counter() - t0
    merged = sharded.gather_state(out, group)
    res = {"rank": group.rank, "device": str(device), "backend": group.backend, "spread": spread,
           "threads": torch.get_num_threads(), "build_s": build, "optimize_s": wall,
           "iteration_ms": wall / iterations * 1e3, "landmarks": (out.Ls, out.Ld)}
    if group.rank == 0:
        res.update(S=S, rhs=rhs, X=merged.X, H=merged.H, ms=merged.ms, m_hyb=merged.m_hyb,
                   finite=bool(torch.isfinite(merged.X).all() and torch.isfinite(merged.ms).all()
                               and torch.isfinite(merged.m_hyb).all()))
        if reference:
            t0 = time.perf_counter()
            P = group.world
            S_c, rhs_c = sharded.chunked_linearize(state, cfg, lam_t, P)
            ref = sharded.chunked_optimize(state, cfg, P, iterations=iterations)
            res["diffs"] = {
                "S_rel": float((S - S_c).abs().max()) / max(float(S_c.abs().max()), 1e-30),
                "rhs_rel": float((rhs - rhs_c).abs().max()) / max(float(rhs_c.abs().max()), 1e-30),
                "X": float((merged.X - ref.X).abs().max()),
                "H": float((merged.H - ref.H).abs().max()),
                "ms": float((merged.ms - ref.ms).abs().max()),
                "m_hyb": float((merged.m_hyb - ref.m_hyb).abs().max()),
            }
            res["reference_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# the two checks, and the entry point

def check_failures(batched: list, sharded: list) -> list:
    """What of the two checks failed, as readable lines (empty: all held)."""
    bad = []
    r0 = batched[0]
    if r0.get("over"):
        bad.append(f"batched: sharded vs unsharded outputs beyond {SHARD_BOUNDS}: {r0['over']}")
    s0 = sharded[0]
    if not s0["finite"]:
        bad.append("sharded_optimize: non-finite state")
    spread = {r["rank"]: r["spread"] for r in sharded if any(v != 0 for v in r["spread"].values())}
    if spread:
        bad.append(f"sharded: ranks' systems or steps differ from rank 0's: {spread}")
    d = s0.get("diffs")
    if d is not None:
        over = {k: v for k, v, b in (("S_rel", d["S_rel"], LIN_REL), ("rhs_rel", d["rhs_rel"], LIN_REL),
                                     ("X", d["X"], OPT_POSE), ("H", d["H"], OPT_MOTION)) if not v <= b}
        if over:
            bad.append(f"sharded vs chunked over bounds: {over}")
    return bad


def both_rank(group, cfg, intr, frames, seed, state, reference=True):
    """One rank of (a), then of (b), in one process."""
    return {"batched": batched_rank(group, cfg, intr, frames, seed, None, reference),
            "sharded": sharded_rank(group, state, None, ITERATIONS, reference)}


def run(ranks: int, backend: str, device: str = "cuda", sequences: int = 8, frames: int = 12, seed: int = 0,
        J: int = 32, F: int = 16, dyn: int = 2048, small: bool = False, threads=None, reference=True):
    """Both checks over `ranks` processes (one spawn) -> (batched results,
    sharded results), each a list in rank order."""
    if small:
        cfg, intr = small_config()
    else:
        from dynosam_tpu_torch.bench_config import bench_config

        cfg, intr = bench_config()
    make = functools.partial(scene_frames, B=sequences, n_frames=frames, small=small)
    state = functools.partial(scale_graph, J=J, F=F, n_dyn=dyn)
    res = grp.spawn(both_rank, ranks, device, backend, args=(cfg, intr, make, seed, state, reference),
                    threads=threads)
    return [r["batched"] for r in res], [r["sharded"] for r in res]


def report(batched: list, sharded: list, ranks: int, frames: int) -> list:
    """The run's lines: the OK line first (when both checks held)."""
    r0, s0 = batched[0], sharded[0]
    n_out = len(r0["outputs"])
    lines = []
    if not check_failures(batched, sharded):
        lines.append(f"multichip OK: {ranks} rank(s) ({r0['backend']} on {r0['device'].split(':')[0]}), {frames} steps, "
                     f"shard-equivalence verified on {n_out} outputs; landmark-sharded assembly (points axis) "
                     f"matches unsharded")
    if "diffs" in r0:
        lines.append(f"batched: sharded vs unsharded max diffs {r0['diffs']} (bounds {SHARD_BOUNDS}); "
                     f"unsharded step {r0['reference_step_ms']:.2f} ms")
    for r in batched:
        lines.append(f"  rank {r['rank']} ({r['device']}, {r['rows']} sequences, {r['threads']} threads): set-up "
                     f"{r['setup_s']:.2f} s, wall "
                     f"{r['wall_s']:.2f} s, steady step {r['step_ms']:.2f} ms, launches {r['launches']}"
                     + (f", unsharded run {r['reference_s']:.2f} s" if "reference_s" in r else ""))
    lines.append(f"sharded_optimize ({ITERATIONS} iterations, landmarks {s0['landmarks']} per rank)"
                 + (f": vs chunked {s0['diffs']}" if "diffs" in s0 else ""))
    for r in sharded:
        lines.append(f"  rank {r['rank']} ({r['device']}, {r['threads']} threads): spread from rank 0 {r['spread']}, "
                     f"graph "
                     f"{r['build_s']:.2f} s, wall {r['optimize_s']:.2f} s, {r['iteration_ms']:.2f} ms per iteration"
                     + (f", chunked run {r['reference_s']:.2f} s" if "reference_s" in r else ""))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes, one per rank (default: the card count on cuda, 2 on cpu)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default nccl on cuda, gloo on cpu")
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--J", type=int, default=32)
    ap.add_argument("--F", type=int, default=16)
    ap.add_argument("--dyn", type=int, default=2048)
    ap.add_argument("--small", action="store_true", help="check (a) on the small dense scene")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to run on the CPU)")
    ranks = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    backend = args.backend or grp.default_backend(args.device)
    if args.device == "cuda":
        from dynosam_tpu_torch.ops.cuda import _build
        from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

        _build.build(st.SOURCE)
    batched, sharded = run(ranks, backend, args.device, args.sequences, args.frames, args.seed, args.J, args.F,
                           args.dyn, args.small, threads=1 if args.device == "cpu" else None)
    for line in report(batched, sharded, ranks, args.frames):
        print(line, flush=True)
    bad = check_failures(batched, sharded)
    if bad:
        raise SystemExit("multichip FAILED: " + "; ".join(bad))


if __name__ == "__main__":
    main()
