#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynosam_tpu_torch) on one CUDA card.

Phases, each printing one line; any failure raises and exits non-zero:
  1. require a CUDA card; print torch/CUDA versions and the card's name and
     power limit (nvidia-smi);
  2. build both kernels (csrc/shi_tomasi.cu = K1, csrc/mask_combine.cu = K2;
     one nvcc per source, started together, sm_90a);
  3. hold K1 against its plain PyTorch version on the card. The fused entry
     (response + per-cell argmax, the main path's): random and constant
     frames at 384x1280 and 384x640 with cell 16 (on the constant frame
     every cell ties, so each must take its top-left pixel), 384x1280 with
     cell 8, and an (8, 384, 1280) batch whose images each equal their
     single-image result; `best` bit for bit or within KERNEL_RTOL, with
     the near-tie cells counted, and (u, v) equal in every cell. The map
     entry: random, constant and a (3, 384, 1280) batch. Then, in one
     process and in turns, at B=1 and B=8, median device times (a spin
     kernel hides the enqueue) and times with the launch from Python of
     the fused kernel, the map route (the map entry + torch `cell_reduce`)
     and the plain pair (scripts/ab_torch_k1.py also times earlier kernel
     sources beside them);
  4. hold K2 against its plain version: random (32, 96x160, 32) inputs, a
     ragged K=5 over 37x61 prototype pixels, and the real prototypes and
     coefficients of the detector scene's frame 0; median device times;
  5. bench path: the fused SLAM step (frontend -> window advance -> graph
     update -> decoupled hybrid LM) at bench_config() over 20 bench frames
     rendered on the card (the 10-frame window advances 10 times); the fused
     K1 must launch once per frame and the map entry never; camera poses
     held to the renderer's ground truth
     and poses + object motions to the JAX reference
     dynosam_tpu_torch/testdata/bench_ref_20f.npz;
  6. detector path: 24 frames of detector_scene() through YOLOv8-seg (K2)
     -> ByteTrack relabelling -> fused step at detector_config(); the fused
     K1 and K2 must each launch once per frame, the map entry never;
     detections, label images, object ids,
     camera poses and object motions held to
     dynosam_tpu_torch/testdata/det_ref_24f.npz;
  7. print the kernel table (with each kernel's bound: the larger of its
     bytes over 3.35 TB/s and its operations over 67 TFLOP/s f32, the H100
     SXM's published rates) and the contract line.

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
from concurrent.futures import ThreadPoolExecutor

BENCH_FRAMES = 20
DET_FRAMES = 24
KERNEL_RTOL = 1e-5            # K1: max |kernel - plain| <= KERNEL_RTOL * max |response|
K2_ATOL = 1e-5                # K2: max |kernel - plain| on sigmoid outputs in (0, 1)
GT_TRANS_M, GT_ROT_RAD = 0.05, 0.01        # tests/test_pipeline.py bounds
REF_TRANS_M, REF_ROT_RAD = 0.01, 1e-3      # against the JAX reference
REF_MOTION_TRANS_M = 0.05
# detector path against the JAX reference. Largest over the 24 frames, torch
# on the CPU against JAX on the CPU read boxes 3.97e-4 px, scores 3.02e-5 and
# every label pixel equal; the H100 read 7.93e-4 px, 6.65e-5 and every pixel
# equal. The card's sums (cuDNN convolutions, cuBLAS) already double the CPU
# error, and another cuDNN algorithm reorders every convolution's sum again,
# so each bound sits well above the card's reading: boxes 63x the card's
# (126x the CPU's), scores 15x (33x), labels allow 1 pixel in 1000.
DET_BOX_PX = 0.05             # box corners of matched valid detections
DET_SCORE = 1e-3              # their scores
DET_LABEL_AGREE = 0.999       # share of label-image pixels equal, per frame
TIMING_RUNS = 50
SPIN_CYCLES = 10_000_000      # ~5 ms of GPU clock, longer than any enqueue here
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
K1_OPS_PER_PIXEL = 29         # 28 flops of the response + 1 comparison of the argmax


def say(msg):
    print(f"[smoke] {msg}", flush=True)


def median_ms(torch, fns, spin, runs=TIMING_RUNS):
    """{name: median time of one call} of the no-argument callables `fns`,
    measured in turns (the order reversed every other run), each call
    bracketed by CUDA events. With `spin`, a spin kernel queued first keeps
    the card busy while the host enqueues the call, so the events time the
    call's kernels alone; without it they also time its launch from Python."""
    for fn in fns.values():
        for _ in range(5):
            fn()
    names = list(fns)
    times = {n: [] for n in names}
    for k in range(runs):
        for n in names if k % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fns[n]()
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end))
    return {n: statistics.median(v) for n, v in times.items()}


def bound_ms(nbytes, nops):
    """(least time in ms, what bounds it): bytes over the memory rate or
    operations over the f32 rate, whichever takes longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(shape, cell):
    """K1 fused: each pixel read once, 3 floats written per full cell."""
    H, W = shape[-2:]
    n_img = 1 if len(shape) == 2 else shape[0]
    cells = n_img * (H // cell) * (W // cell)
    return bound_ms(4 * n_img * H * W + 12 * cells, K1_OPS_PER_PIXEL * n_img * H * W)


def compare_cells(torch, st, img, cell):
    """The fused K1 against its plain pair on `img` -> (max |best - plain|,
    whether best is bit for bit equal, near-tie cells). (u, v) must be equal
    in every cell but those whose plain top two responses lie within
    KERNEL_RTOL * max |response| of each other (near ties, counted)."""
    got = st.shi_tomasi_cell_max(img, cell)
    resp = st.shi_tomasi_response_reference(img)
    ref = st.cell_reduce(resp, cell)
    torch.cuda.synchronize()
    tol = KERNEL_RTOL * max(float(resp.abs().max()), 1e-30)
    err = float((got[0] - ref[0]).abs().max())
    if not err <= tol:
        raise AssertionError(f"fused K1 vs plain at {tuple(img.shape)}, cell {cell}: best off by {err}")
    H, W = img.shape[-2:]
    gh, gw = H // cell, W // cell
    cells = resp[..., : gh * cell, : gw * cell].reshape(*img.shape[:-2], gh, cell, gw, cell)
    top2 = cells.transpose(-3, -2).reshape(*img.shape[:-2], gh * gw, cell * cell).topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < tol
    differ = (got[1] != ref[1]) | (got[2] != ref[2])
    if bool((differ & ~near).any()):
        raise AssertionError(f"fused K1 vs plain at {tuple(img.shape)}, cell {cell}: "
                             f"{int((differ & ~near).sum())} cells take another pixel")
    return err, torch.equal(got[0], ref[0]) and not bool(differ.any()), int(near.sum())


def check_k1(torch, seed):
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, W = 384, 1280
    B = 8

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    # the map entry (the same kernel with its map output)
    def compare_map(img):
        out = st.shi_tomasi_response(img)
        ref = st.shi_tomasi_response_reference(img)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= KERNEL_RTOL * max(float(ref.abs().max()), 1e-30):
            raise AssertionError(f"K1 map vs plain: max abs err {err}")
        return out, err

    map_errs = [compare_map(rand(H, W))[1], compare_map(torch.full((H, W), 0.5, device="cuda"))[1]]
    batch3 = rand(3, H, W)
    out_b, e = compare_map(batch3)
    map_errs.append(e)
    for b in range(3):
        if not torch.equal(out_b[b], st.shi_tomasi_response(batch3[b].contiguous())):
            raise AssertionError(f"batched map image {b} differs from its single-image result")

    # the fused entry
    cases = [((H, W), 16, "random"), ((H, W), 16, "constant"), ((H, 640), 16, "random"),
             ((H, 640), 16, "constant"), ((H, W), 8, "random"), ((H, 640), 8, "constant"),
             ((B, H, W), 16, "random")]
    errs, bitwise, near = [], True, 0
    for shape, cell, kind in cases:
        img = rand(*shape) if kind == "random" else torch.full(shape, 0.5, device="cuda")
        err, same, n_near = compare_cells(torch, st, img, cell)
        errs.append(err)
        bitwise &= same
        if kind == "random":        # on a constant frame every cell ties by design
            near += n_near
        if kind == "constant":
            _, u, v = st.shi_tomasi_cell_max(img, cell)
            gw = shape[-1] // cell
            idx = torch.arange(u.numel(), device="cuda")
            if not (torch.equal(u, (idx % gw * cell).float()) and torch.equal(v, (idx // gw * cell).float())):
                raise AssertionError(f"constant {shape} frame, cell {cell}: a cell took another pixel than its first")
        if len(shape) == 3:
            got = st.shi_tomasi_cell_max(img, cell)
            for b in range(shape[0]):
                one = st.shi_tomasi_cell_max(img[b].contiguous(), cell)
                if not all(torch.equal(g[b], o) for g, o in zip(got, one)):
                    raise AssertionError(f"fused batch image {b} differs from its single-image result")

    # times, in turns in this process, at B=1 and B=8
    times = {}
    for label, img in (("b1", rand(H, W)), ("b8", rand(B, H, W))):
        fns = {
            "fused": lambda img=img: st.shi_tomasi_cell_max(img, 16),
            "map_route": lambda img=img: st.cell_reduce(st.shi_tomasi_response(img), 16),
            "plain": lambda img=img: st.shi_tomasi_cell_max_reference(img, 16),
        }
        times[label] = {"device": median_ms(torch, fns, spin=True),
                        "call": median_ms(torch, fns, spin=False),
                        "bound": k1_bound(tuple(img.shape), 16)}
    t1, t8 = times["b1"], times["b8"]
    say(f"K1 fused matches plain: best {'bit for bit' if bitwise else 'within KERNEL_RTOL'} "
        f"(max abs err {max(errs):.3e}), (u, v) equal in every cell, {near} near-tie cells, over "
        f"{len(cases)} cases (384x1280 and 384x640, cells 16 and 8, constant frames take each "
        f"cell's first pixel, an (8, 384, 1280) batch equal to its single images); map entry max "
        f"abs err {max(map_errs):.3e}, batch images equal")
    for label, t in times.items():
        d, c = t["device"], t["call"]
        say(f"K1 at {label.upper()} 384x1280 cell 16, median device time: fused {d['fused']:.4f} ms, "
            f"map route (map entry + torch cell_reduce) {d['map_route']:.4f} ms, plain pair "
            f"{d['plain']:.4f} ms, bound {t['bound'][0]:.5f} ms ({t['bound'][1]}); with the launch "
            f"from Python: fused {c['fused']:.4f}, map route {c['map_route']:.4f}, plain {c['plain']:.4f} ms")
    return {
        "max_abs_err": max(errs + map_errs), "ms": t1["device"]["fused"], "plain_ms": t1["device"]["plain"],
        "bound": t1["bound"], "map_route_ms": t1["device"]["map_route"],
        "call_ms": t1["call"]["fused"], "near_tie_cells": near, "best_bitwise": bitwise,
        "b8": {"ms": t8["device"]["fused"], "plain_ms": t8["device"]["plain"],
               "map_route_ms": t8["device"]["map_route"], "bound_ms": t8["bound"][0]},
    }


def check_k2(torch, seed):
    from dynosam_tpu_torch.bench_config import detector_config, detector_scene
    from dynosam_tpu_torch.nn import postprocess as pp
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def compare(proto, coef):
        out = mc.mask_combine(proto, coef)
        ref = mc.mask_combine_reference(proto, coef)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= K2_ATOL:
            raise AssertionError(f"K2 vs plain at {tuple(coef.shape)} x {tuple(proto.shape)}: "
                                 f"max abs err {err}")
        return err

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    proto, coef = randn(96, 160, 32), randn(32, 32)
    err_rand = compare(proto, coef)
    err_ragged = compare(randn(37, 61, 32), randn(5, 32))

    # the real inputs: prototypes and the NMS survivors' coefficients of the
    # detector scene's frame 0
    _, intr = detector_config()
    rgb = detector_scene(intr, 1, device="cuda").frame(0).rgb
    engine = YoloV8DetectorEngine(device="cuda")
    with torch.no_grad():
        out = engine.model(rgb[None])
        single = {k: [a[0] for a in v] if isinstance(v, list) else v[0] for k, v in out.items()}
        det = pp.nms(*pp.decode_all(single), max_detections=engine.max_detections,
                     score_threshold=engine.score_threshold, iou_threshold=engine.iou_threshold,
                     class_ids=engine.class_ids)
    real_proto, real_coef = single["proto"].contiguous(), det.mcoef.contiguous()
    err_real = compare(real_proto, real_coef)

    fns = {"kernel": lambda: mc.mask_combine(proto, coef),
           "plain": lambda: mc.mask_combine_reference(proto, coef)}
    dev, call = median_ms(torch, fns, spin=True), median_ms(torch, fns, spin=False)
    # coef, proto read once and the masks written once; 2 K nm flops per
    # mask pixel for the product and 4 for the sigmoid
    K, nm = coef.shape
    P = proto.shape[0] * proto.shape[1]
    bound = bound_ms(4 * (K * nm + P * nm + K * P), 2 * K * nm * P + 4 * K * P)
    say(f"K2 matches plain: max abs err random (32, 96x160, 32) {err_rand:.3e}, ragged "
        f"(5, 37x61, 32) {err_ragged:.3e}, detector frame 0 {tuple(real_coef.shape)} x "
        f"{tuple(real_proto.shape)} {err_real:.3e} (bound {K2_ATOL}); median device time "
        f"{dev['kernel']:.4f} ms kernel vs {dev['plain']:.4f} ms plain at (32, 96x160, 32), "
        f"bound {bound[0]:.5f} ms ({bound[1]}); with the launch from Python {call['kernel']:.4f} "
        f"ms vs {call['plain']:.4f} ms")
    return {"max_abs_err": max(err_rand, err_ragged, err_real), "ms": dev["kernel"],
            "plain_ms": dev["plain"], "bound": bound, "call_ms": call["kernel"]}


def rot_trans_err(torch, lie, A, B):
    """(rotation angle, translation distance) between poses A and B."""
    dR = lie.mm(A[..., :3, :3].transpose(-1, -2), B[..., :3, :3])
    rot = torch.linalg.norm(lie.so3_log(dR), dim=-1)
    trans = torch.linalg.norm(A[..., :3, 3] - B[..., :3, 3], dim=-1)
    return rot, trans


def _drive(torch, step, state, frames, device, per_frame=None):
    """Run the step over the frames; -> (outputs, host seconds per frame)."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    outs, times = [], []
    for fr in frames:
        sync()
        t0 = time.perf_counter()
        if per_frame is not None:
            fr = per_frame(fr)
        state, out = step(state, fr)
        sync()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    for k, out in enumerate(outs):
        for name, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"frame {k}: non-finite {name}")
        if out["X_world_cam"].device.type != device:
            raise AssertionError("main path left the card")
    return outs, times


def compare_to_reference(torch, lie, outs, ref, device):
    """Camera poses and object motions against a JAX reference file ->
    (pose trans, pose rot, motions compared, motion err) maxima."""
    import numpy as np

    X = torch.stack([o["X_world_cam"] for o in outs])
    X_ref = torch.as_tensor(ref["X_world_cam"], device=device)
    rot, trans = rot_trans_err(torch, lie, X, X_ref)
    if float(trans.max()) > REF_TRANS_M or float(rot.max()) > REF_ROT_RAD:
        raise AssertionError(f"camera vs JAX reference: {float(trans.max())} m, {float(rot.max())} rad")
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
    return float(trans.max()), float(rot.max()), n_motions, float(mot_err.max())


def run_bench_path(torch, seed, ref_path, device="cuda"):
    import numpy as np

    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step
    from dynosam_tpu_torch.utils import lie

    cfg, intr = bench_config()
    scene = bench_scene(intr, BENCH_FRAMES, device=device)
    frames = scene.frames()
    step = make_fused_step(cfg, intr, torch.Generator(device=device).manual_seed(seed))
    state = init_pipeline_state(cfg, device)

    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    outs, times = _drive(torch, step, state, frames, device)
    launches, map_launches = st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches
    if device == "cuda" and (launches, map_launches) != (BENCH_FRAMES, 0):
        raise AssertionError(f"fused K1 launched {launches} times and the map entry {map_launches} "
                             f"times over {BENCH_FRAMES} frames")

    X = torch.stack([o["X_world_cam"] for o in outs])
    rot, trans = rot_trans_err(torch, lie, X, scene.scn.X_gt)
    if float(trans.max()) > GT_TRANS_M or float(rot.max()) > GT_ROT_RAD:
        raise AssertionError(f"camera vs ground truth: {float(trans.max())} m, {float(rot.max())} rad")
    tr, rr, n_mot, mot = compare_to_reference(torch, lie, outs, np.load(ref_path), device)
    say(f"bench path: {BENCH_FRAMES} frames of bench_config on {frames[0].depth.device} "
        f"(window of 10 advanced {BENCH_FRAMES - 10} times), fused K1 launches {launches}, map "
        f"entry {map_launches}; camera vs "
        f"GT max {float(trans.max()):.2e} m / {float(rot.max()):.2e} rad; vs JAX ref max "
        f"{tr:.2e} m / {rr:.2e} rad; {n_mot} object motions vs JAX ref max {mot:.2e} m; first "
        f"frame {times[0] * 1e3:.1f} ms, median frames 2-10 {statistics.median(times[1:10]) * 1e3:.2f} "
        f"ms, median frames 11-{BENCH_FRAMES} (advancing) {statistics.median(times[10:]) * 1e3:.2f} ms")
    return {"K1": launches, "K1 map": map_launches}


def run_detector_path(torch, seed, ref_path, device="cuda"):
    import dataclasses

    import numpy as np

    from dynosam_tpu_torch.bench_config import detector_config, detector_scene
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step
    from dynosam_tpu_torch.utils import lie

    cfg, intr = detector_config()
    frames = detector_scene(intr, DET_FRAMES, device=device).frames()
    engine = YoloV8DetectorEngine(device=device)
    step = make_fused_step(cfg, intr, torch.Generator(device=device).manual_seed(seed))
    state = init_pipeline_state(cfg, device)
    dets, labels = [], []

    def detect(fr):
        label, det = engine.detect(fr.rgb)
        dets.append(det)
        labels.append(label)
        return dataclasses.replace(fr, mask=label)

    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    mc.mask_combine.launches = 0
    outs, times = _drive(torch, step, state, frames, device, per_frame=detect)
    launches = {"K1": st.shi_tomasi_cell_max.launches, "K2": mc.mask_combine.launches,
                "K1 map": st.shi_tomasi_response.launches}
    if device == "cuda" and launches != {"K1": DET_FRAMES, "K2": DET_FRAMES, "K1 map": 0}:
        raise AssertionError(f"kernel launches {launches} over {DET_FRAMES} frames")

    ref = np.load(ref_path)
    n_det, box_err, score_err, agree = 0, 0.0, 0.0, 1.0
    for k, (det, label) in enumerate(zip(dets, labels)):
        v = det.valid.cpu().numpy()
        v_ref = ref["det_valid"][k]
        if v.sum() != v_ref.sum() or not (v == v_ref).all():
            raise AssertionError(f"frame {k}: {int(v.sum())} valid detections, reference {int(v_ref.sum())}")
        n_det += int(v.sum())
        box_err = max(box_err, float(np.abs(det.boxes.cpu().numpy()[v] - ref["det_boxes"][k][v]).max(initial=0)))
        score_err = max(score_err, float(np.abs(det.scores.cpu().numpy()[v] - ref["det_scores"][k][v]).max(initial=0)))
        agree = min(agree, float((label.cpu().numpy() == ref["labels"][k]).mean()))
    if box_err > DET_BOX_PX or score_err > DET_SCORE or agree < DET_LABEL_AGREE:
        raise AssertionError(f"detections vs JAX reference: box err {box_err} px, score err "
                             f"{score_err}, label agreement {agree}")
    ids = torch.stack([o["object_ids"] for o in outs]).cpu().numpy()
    if not (ids == ref["object_ids"]).all():
        raise AssertionError(f"object ids differ from the JAX reference in frames "
                             f"{np.nonzero((ids != ref['object_ids']).any(1))[0].tolist()}")
    tr, rr, n_mot, mot = compare_to_reference(torch, lie, outs, ref, device)
    say(f"detector path: {DET_FRAMES} frames of detector_scene at detector_config on "
        f"{frames[0].depth.device}, fused K1 launches {launches['K1']}, K2 launches "
        f"{launches['K2']}, K1 map entry {launches['K1 map']}; "
        f"{n_det} valid detections as in the JAX ref, boxes within {box_err:.2e} px, scores "
        f"{score_err:.2e}; label images agree on >= {agree:.6f} of pixels; object ids equal; "
        f"camera vs JAX ref max {tr:.2e} m / {rr:.2e} rad; {n_mot} object motions vs JAX ref max "
        f"{mot:.2e} m; first frame {times[0] * 1e3:.1f} ms, median frames 2-{DET_FRAMES} "
        f"{statistics.median(times[1:]) * 1e3:.2f} ms")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the RANSAC and test-input generators")
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    testdata = os.path.join(root, "dynosam_tpu_torch", "testdata")

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
    from dynosam_tpu_torch.ops.cuda import _build
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    # ---- 2. build, one nvcc per source, in parallel --------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        built = list(pool.map(_build.build, [st.SOURCE, mc.SOURCE]))
    for src, (lib, build_s) in zip([st.SOURCE, mc.SOURCE], built):
        say(f"built {os.path.relpath(_build.CSRC / src, root)} -> {os.path.relpath(lib, root)} "
            f"with nvcc {' '.join(_build.NVCC_FLAGS)} in {build_s:.2f} s"
            + (" (cached)" if build_s == 0.0 else ""))
    say(f"both builds done in {time.perf_counter() - t0:.2f} s wall")

    # ---- 3, 4. kernels against their plain versions --------------------------
    k1 = check_k1(torch, args.seed)
    k2 = check_k2(torch, args.seed)

    # ---- 5, 6. the main paths, counts zeroed just before each ----------------
    bench_launches = run_bench_path(torch, args.seed, os.path.join(testdata, "bench_ref_20f.npz"))
    det_launches = run_detector_path(torch, args.seed, os.path.join(testdata, "det_ref_24f.npz"))

    # ---- 7. results -------------------------------------------------------------
    def row(name, kid, source, replaces, check, **extra):
        by_path = {"bench": bench_launches.get(kid, 0), "detector": det_launches.get(kid, 0)}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": check["max_abs_err"], "ms": check["ms"], "plain_ms": check["plain_ms"],
                "bound_ms": check["bound"][0], "bound_by": check["bound"][1],
                # no single PyTorch call computes either kernel's function
                "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        row("shi_tomasi_cell_max", "K1", "dynosam_tpu_torch/csrc/shi_tomasi.cu",
            "dynosam_tpu/ops/pallas/shi_tomasi.py:31", k1,
            map_launches_by_path={"bench": bench_launches["K1 map"], "detector": det_launches["K1 map"]},
            map_route_ms=k1["map_route_ms"], call_ms=k1["call_ms"], best_bitwise=k1["best_bitwise"],
            near_tie_cells=k1["near_tie_cells"], batched_b8=k1["b8"]),
        row("mask_combine", "K2", "dynosam_tpu_torch/csrc/mask_combine.cu",
            "dynosam_tpu/ops/pallas/mask_combine.py:23", k2, call_ms=k2["call_ms"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
