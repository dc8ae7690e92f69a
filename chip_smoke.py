#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynosam_tpu_torch) on one CUDA card.

Phases, each printing one line; any failure raises and exits non-zero:
  1. require a CUDA card; print torch/CUDA versions and the card's name and
     power limit (nvidia-smi);
  2. build the Shi-Tomasi kernel (csrc/shi_tomasi.cu, nvcc, sm_90a);
  3. hold the kernel against its plain PyTorch version on the card: random
     and constant 384x1280 frames (the constant one ties every cell of the
     per-cell argmax) and a (3, 384, 1280) batch, each image of which must
     equal its single-image result; median times of both versions;
  4. run the fused SLAM step (frontend -> graph update -> decoupled hybrid
     LM) at bench_config() over the 10 bench frames rendered on the card,
     count the kernel's launches, and hold the camera poses to the
     renderer's ground truth and poses + object motions to the JAX
     reference outputs in dynosam_tpu_torch/testdata/bench_ref_10f.npz;
  5. print the kernel table and the contract line.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

NUM_FRAMES = 10
KERNEL_RTOL = 1e-5            # max |kernel - plain| <= KERNEL_RTOL * max |response|
GT_TRANS_M, GT_ROT_RAD = 0.05, 0.01        # tests/test_pipeline.py bounds
REF_TRANS_M, REF_ROT_RAD = 0.01, 1e-3      # against the JAX reference
REF_MOTION_TRANS_M = 0.05
TIMING_RUNS = 50
SPIN_CYCLES = 10_000_000      # ~5 ms of GPU clock, longer than any enqueue here


def say(msg):
    print(f"[smoke] {msg}", flush=True)


def median_ms(torch, fn, x, spin, runs=TIMING_RUNS):
    """Median time of one call over `runs` runs, each bracketed by CUDA
    events. With `spin`, a spin kernel queued first keeps the card busy
    while the host enqueues the call, so the events time the call's kernels
    alone; without it they also time its launch from Python."""
    for _ in range(5):
        fn(x)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel(torch, seed):
    from dynosam_tpu_torch.frontend.tracker import _cell_reduce
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, W = 384, 1280

    def compare(img):
        out = st.shi_tomasi_response(img)
        ref = st.shi_tomasi_response_reference(img)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= KERNEL_RTOL * max(scale, 1e-30):
            raise AssertionError(f"kernel vs plain: max abs err {err} at max |response| {scale}")
        return out, ref, err

    _, _, err_rand = compare(torch.rand((H, W), generator=gen, device="cuda"))

    const = torch.full((H, W), 0.5, device="cuda")
    out, ref, err_const = compare(const)
    ko, ro = _cell_reduce(out, 16), _cell_reduce(ref, 16)
    for a, b in zip(ko, ro):
        if not torch.equal(a, b):
            raise AssertionError("per-cell argmax on a constant frame differs from the plain version")

    batch = torch.rand((3, H, W), generator=gen, device="cuda")
    out_b, _, err_batch = compare(batch)
    for b in range(3):
        if not torch.equal(out_b[b], st.shi_tomasi_response(batch[b].contiguous())):
            raise AssertionError(f"batched kernel image {b} differs from its single-image result")

    img = torch.rand((H, W), generator=gen, device="cuda")
    ms = median_ms(torch, st.shi_tomasi_response, img, spin=True)
    plain_ms = median_ms(torch, st.shi_tomasi_response_reference, img, spin=True)
    call_ms = median_ms(torch, st.shi_tomasi_response, img, spin=False)
    plain_call_ms = median_ms(torch, st.shi_tomasi_response_reference, img, spin=False)
    max_err = max(err_rand, err_const, err_batch)
    say(f"K1 matches plain: max abs err random {err_rand:.3e}, constant {err_const:.3e}, "
        f"batch {err_batch:.3e}; ties equal; batch images equal single-image results; "
        f"median device time {ms:.4f} ms kernel vs {plain_ms:.4f} ms plain at {H}x{W}; "
        f"with the launch from Python {call_ms:.4f} ms vs {plain_call_ms:.4f} ms")
    return max_err, ms, plain_ms


def rot_trans_err(torch, lie, A, B):
    """(rotation angle, translation distance) between poses A and B."""
    dR = lie.mm(A[..., :3, :3].transpose(-1, -2), B[..., :3, :3])
    rot = torch.linalg.norm(lie.so3_log(dR), dim=-1)
    trans = torch.linalg.norm(A[..., :3, 3] - B[..., :3, 3], dim=-1)
    return rot, trans


def run_main_path(torch, seed, ref_path, device="cuda"):
    import numpy as np

    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step
    from dynosam_tpu_torch.utils import lie

    cfg, intr = bench_config()
    scene = bench_scene(intr, NUM_FRAMES, device=device)
    frames = scene.frames()
    gen = torch.Generator(device=device).manual_seed(seed)
    step = make_fused_step(cfg, intr, gen)
    state = init_pipeline_state(cfg, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()

    st.shi_tomasi_response.launches = 0
    outs, times = [], []
    for k in range(NUM_FRAMES):
        t0 = time.perf_counter()
        state, out = step(state, frames[k])
        sync()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = st.shi_tomasi_response.launches
    if launches != NUM_FRAMES:
        raise AssertionError(f"K1 launched {launches} times over {NUM_FRAMES} frames")

    for k, out in enumerate(outs):
        for name, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"frame {k}: non-finite {name}")
        if out["X_world_cam"].device.type != device:
            raise AssertionError("main path left the card")

    X = torch.stack([o["X_world_cam"] for o in outs])
    rot, trans = rot_trans_err(torch, lie, X, scene.scn.X_gt)
    if float(trans.max()) > GT_TRANS_M or float(rot.max()) > GT_ROT_RAD:
        raise AssertionError(f"camera vs ground truth: {float(trans.max())} m, {float(rot.max())} rad")

    ref = np.load(ref_path)
    X_ref = torch.as_tensor(ref["X_world_cam"], device=device)
    rot_r, trans_r = rot_trans_err(torch, lie, X, X_ref)
    if float(trans_r.max()) > REF_TRANS_M or float(rot_r.max()) > REF_ROT_RAD:
        raise AssertionError(f"camera vs JAX reference: {float(trans_r.max())} m, {float(rot_r.max())} rad")

    ids = torch.stack([o["object_ids"] for o in outs]).cpu().numpy()
    valid = torch.stack([o["object_motion_valid"] for o in outs]).cpu().numpy()
    H = torch.stack([o["object_motions"] for o in outs]).cpu().numpy()
    both = valid & ref["object_motion_valid"] & (ids == ref["object_ids"])
    n_motions = int(both.sum())
    if n_motions == 0:
        raise AssertionError("no object motion valid in both the port and the JAX reference")
    mot_err = np.linalg.norm(H[..., :3, 3] - ref["object_motions"][..., :3, 3], axis=-1)[both]
    if float(mot_err.max()) > REF_MOTION_TRANS_M:
        raise AssertionError(f"object motion vs JAX reference: {float(mot_err.max())} m")

    first_ms = times[0] * 1e3
    steady_ms = statistics.median(times[1:]) * 1e3
    say(f"main path: {NUM_FRAMES} frames of bench_config on {frames[0].depth.device}, "
        f"K1 launches {launches}; camera vs GT max {float(trans.max()):.2e} m / "
        f"{float(rot.max()):.2e} rad; vs JAX ref max {float(trans_r.max()):.2e} m / "
        f"{float(rot_r.max()):.2e} rad; {n_motions} object motions vs JAX ref max "
        f"{float(mot_err.max()):.2e} m; first frame {first_ms:.1f} ms, "
        f"median frames 2-{NUM_FRAMES} {steady_ms:.2f} ms")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the RANSAC and test-image generators")
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))

    import torch

    # ---- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); device 0 {torch.cuda.get_device_name(0)}")
    print(smi, flush=True)

    sys.path.insert(0, root)
    from dynosam_tpu_torch.ops.cuda import _build, shi_tomasi as st

    # ---- 2. build ---------------------------------------------------------------
    lib, build_s = _build.build(st.SOURCE)
    say(f"built {os.path.relpath(_build.CSRC / st.SOURCE, root)} -> "
        f"{os.path.relpath(lib, root)} with nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"in {build_s:.2f} s" + (" (cached)" if build_s == 0.0 else ""))

    # ---- 3. kernel against its plain version -------------------------------
    max_err, ms, plain_ms = check_kernel(torch, args.seed)

    # ---- 4. main path -----------------------------------------------------------
    launches = run_main_path(
        torch, args.seed,
        os.path.join(root, "dynosam_tpu_torch", "testdata", "bench_ref_10f.npz"),
    )

    # ---- 5. results -------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "shi_tomasi_response",
        "route": "cuda",
        "source": "dynosam_tpu_torch/csrc/shi_tomasi.cu",
        "replaces": "dynosam_tpu/ops/pallas/shi_tomasi.py:31",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
