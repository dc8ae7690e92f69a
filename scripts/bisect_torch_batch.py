"""Find the first operation whose rows part between a batch of B and a batch
of B/2 of the batched step.

Steps `make_batched_pipeline` at `bench_config()` over the frames of
`multichip.scene_frames` (sequence b on bench frames b..b+frames-1) three
times in lockstep, one frame at a time, in one process and without a group:

  * at B (default 8), recording every dispatched operation's output;
  * at B again (the control: any operation that parts here is not
    deterministic from run to run, and is reported as such);
  * at B/2 on sequences 0..B/2-1, with the same draws (the first B/2 rows
    of each of the B run's uniforms, replayed through
    `ops/ransac.py::ReplayDraws`, as `BatchRows` gives a rank its rows).

Every operation is compared, in dispatch order, with the recorded one: an
output whose shape differs from the recorded one along one axis on the
rows 0..B/2-1 of that axis (a batch axis, or a flattened one with the
batch as any of its factors), any other output whole. The first
operation that differs is named with its source lines in the port, its
input and output shapes and the size of the first difference; then the
same operation alone is run on its B/2 inputs and on those inputs grown
to the recorded shapes (repeated along the batch axis), which shows
whether a library routine gives other bits for the same row at the two
batch sizes (the inputs being equal by construction: every operation
before it agreed). A host decision that
takes another branch shows as the two runs dispatching different
operations at the same index, and is reported with both source lines.
Each frame's outputs (camera poses, object motions) are compared too, to
show how the step's solvers carry the first difference to the last frame.

Prints one line per frame and, with `--out`, writes the findings as JSON.
Uninitialised outputs (`empty*`) and views are not compared; a hand kernel
launched outside the dispatcher shows in the operations that read its
output.

Usage: python scripts/bisect_torch_batch.py [--device cuda] [--batch 8]
       [--frames 12] [--seed 0] [--small] [--out results/torch/bisect.json]
`--small` runs the multichip module's quick configuration on the small
dense scene, for a quick CPU run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SKIP = ("aten::empty", "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided",
        "aten::empty_like", "aten::set_")
# differing operations listed per frame
LISTED = 12


def _chain(depth=6):
    """The port's lines on the Python stack, innermost first (at most
    `depth`), as 'dynosam_tpu_torch/module.py:line (function)'."""
    out, f = [], sys._getframe(1)
    while f is not None and len(out) < depth:
        name = f.f_code.co_filename
        if "dynosam_tpu_torch" in name:
            out.append(f"{name[name.index('dynosam_tpu_torch'):]}:{f.f_lineno} ({f.f_code.co_name})")
        f = f.f_back
    return out


def _site():
    """The innermost line of the port on the Python stack, '?' outside it."""
    return (_chain(1) or ["?"])[0]


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _batch_dim(big_shape, small_shape):
    """The one axis where a batch-B shape and the batch-B/2 one differ
    (the batch axis, or a flattened one), None if the shapes agree, -1 if
    they differ otherwise."""
    if len(big_shape) != len(small_shape):
        return -1
    dims = [d for d, (a, b) in enumerate(zip(big_shape, small_shape)) if a != b]
    if not dims:
        return None
    return dims[0] if len(dims) == 1 and small_shape[dims[0]] < big_shape[dims[0]] else -1


def _candidates(big, small, batch, half):
    """The parts of a batch-`batch` output `big` that may correspond to the
    batch-`half` run's `small`: the whole of it when the shapes agree;
    along the one axis where they differ, rows 0..half-1 of the batch
    factor of that axis, for each way it can be flattened (outer, batch,
    inner); none when the shapes differ otherwise."""
    d = _batch_dim(tuple(big.shape), tuple(small.shape))
    if d is None:
        return [big]
    ns = small.shape[d] if d != -1 else 0
    if d == -1 or ns % half or big.shape[d] * half != ns * batch:
        return []
    out = []
    for outer in range(1, ns // half + 1):
        if (ns // half) % outer:
            continue
        inner = ns // (half * outer)
        v = big.reshape(big.shape[:d] + (outer, batch, inner) + big.shape[d + 1:])
        out.append(v.narrow(d + 1, 0, half).reshape(small.shape))
    return out


def _compare(big, small, batch, half):
    """(max |difference|, unequal entries) of `small` against the closest of
    `big`'s candidate parts; (inf, 1) when none has its shape."""
    best = None
    for c in _candidates(big, small, batch, half):
        d, n = _diff(c, small)
        if best is None or (n, d) < (best[1], best[0]):
            best = (d, n)
        if not n:
            break
    return best or (float("inf"), 1)


def _shapes(xs):
    return [tuple(t.shape) for t in _tensors(xs)]


def _diff(a, b):
    """(max |a - b| where both are finite, count of unequal entries) of two
    tensors of one shape; non-finite entries count when they differ."""
    import torch

    if a.shape != b.shape:
        return float("inf"), 1
    if a.is_meta or b.is_meta:          # shape-only tensors carry no values
        return 0.0, 0
    if a.dtype.is_floating_point or a.dtype.is_complex:
        fin = torch.isfinite(a) & torch.isfinite(b)
        neq = ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
        d = (a[fin] - b[fin]).abs().max() if bool(fin.any()) else torch.tensor(0.0)
        return float(d), int(neq.sum())
    neq = a != b
    return float(neq.sum() > 0), int(neq.sum())


def _clone_args(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_args(v) for v in x)
    return x


def make_mode(record, batch, half):
    """A TorchDispatchMode: with `record` None it records every operation's
    outputs (cloned); else it compares each operation with record[i] and
    collects the differences; at the first one it runs the operation alone
    at both batch sizes (`alone`)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []            # recording: (name, site, outputs, input shapes)
            self.diffs = []          # comparing: dicts of the differing operations
            self.parted = None       # where the two runs dispatch other operations
            self.i = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func._schema.name
            if name in SKIP or getattr(func, "is_view", False):
                return func(*args, **kwargs)
            before = (_clone_args(args), _clone_args(kwargs)) \
                if record is not None and not self.diffs and func._schema.is_mutable else (args, kwargs)
            out = func(*args, **kwargs)
            outs = [t.detach().clone() for t in _tensors(out)]
            if record is None:
                self.ops.append((name, _site(), outs, _shapes(args)))
                return out
            if self.parted is not None:
                return out
            i, self.i = self.i, self.i + 1
            if i >= len(record) or record[i][0] != name:
                other = record[i][:2] if i < len(record) else ("(none)", "")
                self.parted = {"index": i, "recorded": list(other), "this": [name, _site()]}
                return out
            worst, neq = 0.0, 0
            for a, b in zip(record[i][2], outs):
                d, n = _compare(a, b, batch, half)
                worst, neq = max(worst, d), neq + n
            if neq or len(record[i][2]) != len(outs):
                dd = {"index": i, "op": name, "site": _site(), "stack": _chain(), "in_shapes": _shapes(args),
                      "recorded_in_shapes": record[i][3], "out_shapes": _shapes(outs), "max_abs": worst,
                      "unequal": neq}
                if not self.diffs and batch != half:
                    try:
                        dd["alone"] = alone(func, before[0], before[1], record[i][3], batch, half)
                    except Exception as e:          # an argument that only looks batched
                        dd["alone"] = f"not run: {type(e).__name__}: {e}"
                self.diffs.append(dd)
            return out

    return Mode()


def alone(func, args, kwargs, big_shapes, batch, half):
    """Run `func` on its batch-B/2 inputs, and on those inputs grown to the
    batch-B run's shapes `big_shapes` (each tensor repeated along the axis
    where its shape differs) -> {max |difference| of the rows the two share,
    unequal entries, shapes}: whether the routine's rows depend on the batch
    size."""
    import torch

    shapes = list(big_shapes)

    def grow(x):
        if isinstance(x, torch.Tensor):
            big = tuple(shapes.pop(0))
            d = _batch_dim(big, tuple(x.shape))
            if d is None:
                return x
            if d == -1 or big[d] % x.shape[d]:
                raise ValueError(f"cannot grow {tuple(x.shape)} to {big}")
            reps = [1] * x.dim()
            reps[d] = big[d] // x.shape[d]
            return x.repeat(reps)
        if isinstance(x, (list, tuple)):
            return type(x)(grow(v) for v in x)
        return x

    small = [t.clone() for t in _tensors(func(*_clone_args(args), **_clone_args(kwargs)))]
    big = [t.clone() for t in _tensors(func(*grow(_clone_args(list(args))), **_clone_args(kwargs)))]
    worst, neq = 0.0, 0
    for b, a in zip(big, small):
        d, n = _compare(b, a, batch, half)
        worst, neq = max(worst, d), neq + n
    return {"max_abs": worst, "unequal": neq, "shapes": [tuple(t.shape) for t in small],
            "grown_shapes": [tuple(t.shape) for t in big]}


class Recorder:
    """A draw source that draws from a generator and keeps every draw."""

    def __init__(self, generator):
        self.generator, self.draws = generator, []

    def rand(self, shape, device):
        import torch

        u = torch.rand(shape, generator=self.generator, device=device)
        self.draws.append(u.clone())
        return u


def output_diffs(o_big, o_small, batch_ref):
    """{output: max |difference|} of rows 0..batch_ref-1 (floats), unequal
    entries (ids, flags)."""
    import torch

    res = {}
    for k, v in o_small.items():
        if not torch.is_tensor(v):
            continue
        d, n = _diff(o_big[k][:batch_ref], v)
        res[k] = d if v.dtype.is_floating_point else n
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from dynosam_tpu_torch import multichip
    from dynosam_tpu_torch.bench_config import bench_config
    from dynosam_tpu_torch.ops.ransac import ReplayDraws
    from dynosam_tpu_torch.parallel.batched import make_batched_pipeline

    dev, B, half = args.device, args.batch, args.batch // 2
    if dev == "cuda":
        from dynosam_tpu_torch.ops.cuda import _build
        from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

        _build.build(st.SOURCE)
    cfg, intr = multichip.small_config() if args.small else bench_config()
    frames = multichip.scene_frames(dev, B, args.frames, small=args.small)
    t0 = time.perf_counter()

    # the whole batch's draws, recorded from a seeded generator
    rec = Recorder(torch.Generator(device=dev).manual_seed(args.seed))
    step, init = make_batched_pipeline(cfg, intr, rec)
    state = init(B, dev)
    for fr in frames:
        state, _ = step(state, fr)
    draws = rec.draws

    runs = {}
    for name, b, d in (("big", B, draws), ("control", B, draws), ("small", half, [u[:half] for u in draws])):
        step, init = make_batched_pipeline(cfg, intr, ReplayDraws(d))
        runs[name] = [step, init(b, dev), b]

    report = {"batch": B, "half": half, "frames": args.frames, "device": dev,
              "device_name": torch.cuda.get_device_name(0) if dev == "cuda" else "cpu",
              "per_frame": [], "first": None, "nondeterministic": None, "parted": None}
    for k, fr in enumerate(frames):
        rows = dataclasses.replace(fr, **{n: getattr(fr, n)[:half].contiguous() for n in fr.tensors()})
        rec_mode = make_mode(None, B, half)
        step, st_big, _ = runs["big"]
        with rec_mode:
            st_big, o_big = step(st_big, fr)
        runs["big"][1] = st_big
        line = {"frame": k, "ops": len(rec_mode.ops)}
        for name, inputs in (("control", fr), ("small", rows)):
            step, st_x, b = runs[name]
            mode = make_mode(rec_mode.ops, B, b)
            with mode:
                st_x, o_x = step(st_x, inputs)
            runs[name][1] = st_x
            line[name] = {"differing_ops": len(mode.diffs), "parted": mode.parted,
                          "outputs": output_diffs(o_big, o_x, half)}
            if mode.diffs:
                line[name]["listed"] = mode.diffs[:LISTED]
                by_site = {}
                for dd in mode.diffs:
                    by_site.setdefault(dd["site"].split(" (")[0].rsplit(":", 1)[0], 0)
                    by_site[dd["site"].split(" (")[0].rsplit(":", 1)[0]] += 1
                line[name]["by_module"] = by_site
            key = "nondeterministic" if name == "control" else "first"
            if mode.diffs and report[key] is None:
                report[key] = dict(mode.diffs[0], frame=k)
            if name == "small" and mode.parted and report["parted"] is None:
                report["parted"] = dict(mode.parted, frame=k)
        report["per_frame"].append(line)
        s = line["small"]
        print(f"frame {k}: {line['ops']} ops; control: {line['control']['differing_ops']} differing; "
              f"B={half} vs rows of B={B}: {s['differing_ops']} differing"
              + (f" (first: {s['listed'][0]['op']} at {s['listed'][0]['site']}, "
                 f"max |diff| {s['listed'][0]['max_abs']:.3e})" if s.get("listed") else "")
              + (f"; dispatch parted {s['parted']}" if s["parted"] else "")
              + f"; outputs X_world_cam {s['outputs'].get('X_world_cam', 0):.3e}, object_motions "
              f"{s['outputs'].get('object_motions', 0):.3e}", flush=True)
    report["seconds"] = time.perf_counter() - t0
    print("first differing operation (B vs B/2):", json.dumps(report["first"], default=str), flush=True)
    print("run-to-run (control):", json.dumps(report["nondeterministic"], default=str), flush=True)
    print("dispatch parted:", json.dumps(report["parted"], default=str), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(f"{report['seconds']:.1f} s", flush=True)


if __name__ == "__main__":
    main()
