"""Scaling evidence for the batched multi-sequence path over ranks (the port
of scripts/bench_mesh_scaling.py).

`make_batched_pipeline(group=)` splits the sequence axis over a process
group (`parallel/group.py`, one process per rank). Linear scaling over
cards rests on two structural facts, which this checks on the running
program rather than asserts:

  1. the steady batched step issues no collective: during the steady steps
     every call through group.py's `all_reduce_sum`, `broadcast`,
     `gather_to_rank0` and `max_diff_from_rank0` and through
     torch.distributed's collectives and point-to-point operations is
     counted (all must be 0), and torch.profiler over the same number of
     steps must show no NCCL, gloo or c10d operation;
  2. each rank runs the unsharded program at B/P: its state's and inputs'
     tensor shapes equal those of the unsharded batch of B/P sequences.

It also times the B=1 program (in this process) and each rank's steady
step at the graft's quick configuration (bench_config.small_config, one
random 128 x 96 frame per sequence), B = --ranks sequences, one per rank,
as the reference does on its mesh. Where ranks share a card (gloo: NCCL
refuses two ranks on one GPU) or the CPU, the timed ratio measures their
contention for it, not scaling over cards; the caveat is printed.

Prints one JSON line and exits non-zero unless both checks hold; splices a
section into `--out` (default dynosam_tpu_torch/BENCH_TABLE.md) between
the mesh markers when that file exists.

Usage: python -m dynosam_tpu_torch.bench_mesh_scaling [--ranks 8] [--steps 5]
       [--backend nccl|gloo] [--device cuda|cpu] [--out PATH] [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from dynosam_tpu_torch import timing
from dynosam_tpu_torch.bench_table import DEFAULT_OUT, MESH_BEGIN, MESH_END, splice
from dynosam_tpu_torch.parallel import group as grp

WARM_STEPS = 2
GROUP_FNS = ("all_reduce_sum", "broadcast", "gather_to_rank0", "max_diff_from_rank0")
DIST_FNS = ("all_reduce", "broadcast", "gather", "all_gather", "all_gather_into_tensor", "all_gather_object",
            "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "scatter",
            "send", "recv", "isend", "irecv", "barrier", "monitored_barrier", "broadcast_object_list",
            "gather_object", "scatter_object_list", "batch_isend_irecv")
COMM_MARKS = ("nccl", "gloo", "c10d")


@contextlib.contextmanager
def count_collectives():
    """{name: calls} of the group helpers and torch.distributed operations
    made inside the block, wherever the port's modules hold them by name."""
    calls = {}
    patched = []

    def counting(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    targets = {getattr(grp, n): f"group.{n}" for n in GROUP_FNS}
    targets.update({getattr(dist, n): f"dist.{n}" for n in DIST_FNS if hasattr(dist, n)})
    modules = [dist] + [m for name, m in list(sys.modules.items())
                        if name.startswith("dynosam_tpu_torch") and m is not None]
    wrappers = {fn: counting(name, fn) for fn, name in targets.items()}
    for mod in modules:
        for attr, val in list(vars(mod).items()):
            if callable(val) and val in wrappers:
                patched.append((mod, attr, val))
                setattr(mod, attr, wrappers[val])
    try:
        yield calls
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def shapes(obj) -> list:
    """The sorted shapes of every tensor in `obj` (nested dataclasses)."""
    from dynosam_tpu_torch.parallel.batched import _map_tensors

    out = []
    _map_tensors(lambda t: out.append(tuple(t.shape)), obj)
    return sorted(out)


def program(device, sequences, seed=0, group=None):
    """(step, states, inputs) of the batched step over `sequences` random
    graft frames (this rank's rows of them under `group`)."""
    from dynosam_tpu_torch import bench_config as bc
    from dynosam_tpu_torch.parallel.batched import make_batched_pipeline, shard_rows

    step, init = make_batched_pipeline(bc.small_config(), bc.small_intr(),
                                       torch.Generator(device=device).manual_seed(seed), group=group)
    inputs = shard_rows(bc.small_frame_inputs(batch=sequences, device=device), group)
    return step, init(sequences, device), inputs


def steady(step, states, inputs, n, device):
    """`n` steps -> (states, seconds per step, the last outputs)."""
    out = None
    t0 = time.perf_counter()
    for _ in range(n):
        states, out = step(states, inputs)
    timing.sync(device)
    return states, (time.perf_counter() - t0) / max(n, 1), out


def rank_main(group, steps, seed):
    """One rank: its shapes, then WARM_STEPS steps, `steps` timed steady
    steps with the collectives counted, and as many again under the
    profiler (counted too)."""
    device = group.device
    step, states, inputs = program(device, group.world, seed, group)
    rank_shapes = shapes((states, inputs))
    states, _, _ = steady(step, states, inputs, WARM_STEPS, device)
    before = timing.counts()
    with count_collectives() as calls:
        states, t, _ = steady(step, states, inputs, steps, device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            states, _, out = steady(step, states, inputs, steps, device)
    comm = sorted({e.name() for e in prof.profiler.kineto_results.events()
                   if any(m in e.name().lower() for m in COMM_MARKS)})
    return {"rank": group.rank, "device": str(device), "shapes": rank_shapes, "calls": dict(calls),
            "profiler_comm_ops": comm, "t_step_s": t, "launches": timing.since(before),
            "finite": bool(torch.isfinite(out["X_world_cam"]).all())}


def run(ranks=8, steps=5, backend=None, device="cuda", seed=0) -> dict:
    """Both checks and the times -> the result dict (the JSON line's)."""
    count = torch.cuda.device_count() if device == "cuda" else 0
    backend = backend or ("nccl" if device == "cuda" and ranks <= count else "gloo")
    # the unsharded program at B/P = 1 sequence per rank, in this process
    step1, s1, in1 = program(device, 1, seed)
    shapes1 = shapes((s1, in1))
    s1, _, _ = steady(step1, s1, in1, WARM_STEPS, device)
    _, t1, _ = steady(step1, s1, in1, steps, device)
    res = grp.spawn(rank_main, ranks, device, backend, args=(steps, seed), threads=1 if device == "cpu" else None)
    calls = {}
    for r in res:
        for k, v in r["calls"].items():
            calls[k] = calls.get(k, 0) + v
    comm = sorted({op for r in res for op in r["profiler_comm_ops"]})
    tn = max(r["t_step_s"] for r in res)
    shared = device == "cpu" or ranks > count
    return {
        "metric": "mesh_scaling_structural",
        "ranks": ranks, "backend": backend, "device": device,
        "collective_calls_in_steady_steps": calls,
        "profiler_comm_ops_in_steady_steps": comm,
        "zero_collectives": not calls and not comm,
        "per_rank_shapes_equal_b_over_p": all(r["shapes"] == shapes1 for r in res),
        "finite": all(r["finite"] for r in res),
        "t_step_b1_s": t1,
        "t_step_sharded_s": tn,
        "rank_t_step_s": [r["t_step_s"] for r in res],
        "timed_aggregate_ratio": (ranks / tn) / (1 / t1),
        "launches_per_rank": [r["launches"] for r in res],
        "timed_caveat": (f"{ranks} ranks share {'the CPU' if device == 'cpu' else f'{count} card(s)'}: the ratio "
                         "measures their contention, not scaling over cards") if shared else None,
    }


def section(r, card) -> str:
    return (
        f"\n## Scaling over ranks (structural; {r['ranks']} ranks, {r['backend']} on {card})\n\n"
        "Generated by `python -m dynosam_tpu_torch.bench_mesh_scaling` on the running program:\n\n"
        f"- collective calls in the steady steps: **{r['collective_calls_in_steady_steps'] or 'none'}**; "
        f"NCCL / gloo / c10d operations in torch.profiler over them: "
        f"**{r['profiler_comm_ops_in_steady_steps'] or 'none'}**\n"
        f"- each rank's state and input shapes equal the unsharded B/P program's: "
        f"**{r['per_rank_shapes_equal_b_over_p']}**\n"
        f"- steady step: B=1 program {r['t_step_b1_s'] * 1e3:.3f} ms, slowest rank {r['t_step_sharded_s'] * 1e3:.3f} "
        f"ms (aggregate ratio {r['timed_aggregate_ratio']:.3f})"
        + (f"; {r['timed_caveat']}" if r["timed_caveat"] else "") + "\n\n"
        "No communication and a per-rank program equal to the unsharded one mean that aggregate throughput\n"
        "over cards is the number of ranks times one card's; the sharded outputs are held to the unsharded\n"
        "ones by `python -m dynosam_tpu_torch.multichip`.\n\n"
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=8, help="processes, one per rank (the reference's --devices)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default nccl where each rank has a card of its own, else gloo")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    card = timing.prepare(args.device)
    r = run(args.ranks, args.steps, args.backend, args.device, args.seed)
    if r["timed_caveat"]:
        print(f"caveat: {r['timed_caveat']}", file=sys.stderr, flush=True)
    print(json.dumps(r), flush=True)
    if os.path.exists(args.out):
        splice(args.out, MESH_BEGIN, MESH_END, section(r, card))
        print(f"wrote mesh section -> {args.out}", flush=True)
    if not (r["zero_collectives"] and r["per_rank_shapes_equal_b_over_p"] and r["finite"]):
        raise SystemExit(f"bench_mesh_scaling: a structural check failed: {json.dumps(r)}")
    return r


if __name__ == "__main__":
    main()
