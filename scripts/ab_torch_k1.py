"""Routes of the Shi-Tomasi detection (K1) timed in turns on one CUDA card.

In one process, at 384x1280 with cell 16, at B=1 and B=8, the median device
time (a spin kernel hides the enqueue) and the median time with the launch
from Python of:

  fused      this tree's `shi_tomasi_cell_max` (the main path's route)
  map_route  this tree's map entry `shi_tomasi_response` + torch `cell_reduce`
  plain      the plain PyTorch pair
  fused:SRC  an earlier fused kernel source (C entry `dyno_shi_tomasi_f32`)
  map:SRC    an earlier map-only kernel source (C entry
             `dyno_shi_tomasi_response_f32`) + torch `cell_reduce`

Every route's cells are held to the plain pair's: a fused kernel must give
them bit for bit; for a map route the cells whose (u, v) differ are counted.

Usage: python scripts/ab_torch_k1.py [--fused SRC ...] [--map SRC ...]
                                     [--runs N] [--out PATH.json]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
H, W, CELL = 384, 1280, 16


def build(src, out_dir):
    """nvcc `src` with the port's flags into `out_dir`; -> loaded library."""
    from dynosam_tpu_torch.ops.cuda import _build

    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib_ab_{digest}.so")
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src], check=True)
    return ctypes.CDLL(out)


def fused_route(torch, lib):
    fn = lib.dyno_shi_tomasi_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(img):
        B = 1 if img.ndim == 2 else img.shape[0]
        out = [torch.empty((*img.shape[:-2], (H // CELL) * (W // CELL)), device=img.device) for _ in range(3)]
        err = fn(img.data_ptr(), None, *(o.data_ptr() for o in out), B, H, W, CELL,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out
    return run


def map_route(torch, st, lib):
    fn = lib.dyno_shi_tomasi_response_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(img):
        B = 1 if img.ndim == 2 else img.shape[0]
        out = torch.empty_like(img)
        err = fn(img.data_ptr(), out.data_ptr(), B, H, W, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return st.cell_reduce(out, CELL)
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fused", action="append", default=[], help="an earlier fused kernel source")
    ap.add_argument("--map", action="append", default=[], help="an earlier map-only kernel source")
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    from chip_smoke import k1_bound, median_ms
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    build_dir = os.path.join(ROOT, "dynosam_tpu_torch", "build", "ab")
    routes = {
        "fused": lambda img: st.shi_tomasi_cell_max(img, CELL),
        "map_route": lambda img: st.cell_reduce(st.shi_tomasi_response(img), CELL),
        "plain": lambda img: st.shi_tomasi_cell_max_reference(img, CELL),
    }
    for src in args.fused:
        routes[f"fused:{src}"] = fused_route(torch, build(src, build_dir))
    for src in args.map:
        routes[f"map:{src}"] = map_route(torch, st, build(src, build_dir))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": card, "shape": [H, W], "cell": CELL, "runs": args.runs, "batches": {}}
    for B in (1, 8):
        img = torch.rand((H, W) if B == 1 else (B, H, W), generator=gen, device="cuda")
        ref = routes["plain"](img)
        cells_differ = {}
        for name, fn in routes.items():
            got = fn(img)
            differ = int(((got[1] != ref[1]) | (got[2] != ref[2])).sum())
            if name.startswith("fused") and not (differ == 0 and torch.equal(got[0], ref[0])):
                raise AssertionError(f"{name} differs from the plain pair at B={B}")
            cells_differ[name] = differ
        fns = {n: (lambda fn=fn: fn(img)) for n, fn in routes.items()}
        dev = median_ms(torch, fns, spin=True, runs=args.runs)
        call = median_ms(torch, fns, spin=False, runs=args.runs)
        bound = k1_bound(tuple(img.shape), CELL)
        result["batches"][B] = {"device_ms": dev, "call_ms": call, "bound_ms": bound[0],
                                "bound_by": bound[1], "cells_differing_from_plain": cells_differ}
        for n in routes:
            print(f"B={B} {n}: device {dev[n]:.5f} ms, with the launch {call[n]:.5f} ms, "
                  f"cells differing from plain {cells_differ[n]}", flush=True)
        print(f"B={B} bound {bound[0]:.5f} ms ({bound[1]})", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
