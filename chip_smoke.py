#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynosam_tpu_torch) on one CUDA card.

Phases, each printing one line; any failure raises and exits non-zero:
  1. require a CUDA card; print torch/CUDA versions and the card's name and
     power limit (nvidia-smi);
  2. build the kernels (csrc/shi_tomasi.cu = K1, csrc/mask_combine.cu = K2,
     and K2 v3, scripts/ab_torch_k2_v3.cu, for phase 4's times only; one
     nvcc per source, started together, sm_90a);
  3. hold K1 against its plain PyTorch version on the card. The fused entry
     (response + per-cell argmax, the main path's): random and constant
     frames at 384x1280 and 384x640 with cell 16 (on the constant frame
     every cell ties, so each must take its top-left pixel), 384x1280 with
     cell 8, random and constant 375x1242 frames with cell 8 (the rich
     fixture's and KITTI's unpadded frames, partial cells at the right and
     bottom edges), random and constant 384x1248 and 96x320 frames with
     cell 8 (phase 15's padded rich frames and the fixture's: a last column
     tile narrower than the kernel's, loaded 16 bytes at a time), a random
     384x640 frame with cell 8 (phase 16), and an (8, 384, 1280) batch whose images each equal their
     single-image result; `best` bit for bit or within KERNEL_RTOL, with
     the near-tie cells counted, and (u, v) equal in every cell. The map
     entry: random, constant and a (3, 384, 1280) batch. Then, in one
     process and in turns, at B=1 and B=8, of the fused kernel, the map
     entry, the map route (the map entry + torch `cell_reduce`) and the
     plain pair and map: loop-timed device times (one event pair around 200
     back-to-back calls, a spin kernel in front), median device times of
     one launch (a spin kernel hides the enqueue), torch.profiler's device
     time per call (the kernels only) and times with the launch from Python
     (scripts/ab_torch_k1.py also times earlier kernel sources beside them);
  4. hold K2's two entries against their plain versions. Entry A
     (mask_combine, K2_ATOL): random (32, 96x160, 32) inputs, a ragged K=5
     over 37x61 prototype pixels, both also as NCHW views, and the real
     prototypes (as the network returns them) and coefficients of the
     detector scene's frame 0. Entry B (mask_label, the label image in one
     launch): random (32, 96x160 -> 384x640) inputs with boxes crossing the
     border and each other, invalid rows with NaN coefficients and two
     tied scores, a ragged K=5 (37x61 -> 148x244), the detector's frame 0
     (phase 16's shape too), and at the detected-masks accuracy run's
     shape (the committed checkpoint at the dyno-KITTI fixture's 96x320,
     24x80 prototypes) random inputs and the fixture's frame 0 (no
     detection there: an all-background label image), each
     with box_pad 0 and 2; every label pixel equal to plain but
     where a detection's plain interpolated value lies within K2_NEAR of
     the threshold (counted, at most K2_NEAR_SHARE of the pixels). Then the
     times, measured as in phase 3, in turns: entry A v4, v3 (the kernel
     before the redesign), plain and the cuBLAS product coef @ proto^T
     alone (the library yardstick) at (32, 96x160, 32); entry B, the unfused
     route (v3 + torch upsample / crop / threshold / label) and plain at
     the detector's frame 0, and both routes at 32 random detections;
  5. bench path: the fused SLAM step (frontend -> window advance -> graph
     update -> decoupled hybrid LM) at bench_config() over 20 bench frames
     rendered on the card (the 10-frame window advances 10 times); the fused
     K1 must launch once per frame and the map entry never; camera poses
     held to the renderer's ground truth
     and poses + object motions to the JAX reference
     dynosam_tpu_torch/testdata/bench_ref_20f.npz;
  5b. pipelined path: the first 12 of those frames (two advancing) through
     make_fused_step(..., pipelined=True) (the optimizer on the window
     through the previous frame before the advance and the frame's
     ingestion, the reference's pipelined order), K1 once per frame, held at
     the bench path's bounds to the ground truth and to the first 12 frames
     of bench_pipelined_ref_20f.npz; device ops, busy time and idle share per
     advancing frame (torch.profiler over two);
  6. KLT path: the fused step at bench_klt_config() (tracking by pyramidal
     KLT with the forward-backward check on CLAHE-equalized frames) over 20
     frames of the world-textured bench scene rendered on the card (the
     window advances 10 times); the fused K1 once per frame, the map entry
     never; poses + object motions held to
     dynosam_tpu_torch/testdata/bench_klt_ref_20f.npz, the per-frame counts
     of valid static and dynamic tracks to the same file, and camera poses to
     the renderer's ground truth no further than the reference's own error
     (which is metres on this scene) plus a margin;
  7. stereo + IMU path: 12 frames at stereo_imu_config() (the KLT path with
     the IMU and its rotation prior), each carrying the right image rendered
     at +baseline, its provided depth corrupted by 1.15x and a 32-sample IMU
     window; held to stereo_imu_ref_12f.npz and the ground truth as the KLT
     path is, and the valid static tracks' depths to the true depth (stereo
     repairs the corruption). Both phases print the median host time per
     frame, the first frame's and the host syncs per frame with their sites;
  6t, 7t. the KLT and stereo + IMU paths of phases 6 and 7 on
     bench_config.tracked_scene (the camera raised to 6.4 m and stepping
     0.4 m per frame, where the reference keeps the camera), rendered on the
     host and run on the card; held in every frame to
     tracked_klt_ref_20f.npz / tracked_stereo_imu_ref_12f.npz (the JAX
     reference on the port's host render) at TRACKED_REF_BOUNDS, and to the
     ground truth no further than the reference's own error plus
     GT_TRANS_M / GT_ROT_RAD; fused K1 once per frame, the map entry never;
  8. detector path: 24 frames of detector_scene() through YOLOv8-seg (the
     label image by K2's entry B) -> ByteTrack relabelling -> fused step at
     detector_config(); the fused K1 and K2's entry B must each launch once
     per frame, entry A and the K1 map entry never; detections, label
     images, object ids, camera poses and object motions held to
     dynosam_tpu_torch/testdata/det_ref_24f.npz;
  8b. held-out detector: the committed checkpoint's held-out evaluation
     (eval/detector_heldout.py: 48 random scenes from seed 10 000 through
     the engine, at most 8 detections) on the card, K2's entry B once per
     scene and entry A never; the instances, the mean mask IoU and the
     class accuracy held to the JAX run
     dynosam_tpu_torch/testdata/det_heldout_ref_48.npz (HELDOUT_*), the
     largest instance's IoU difference printed;
  9. pipeline path: the port's entry-point code (run_dynosam.open_dataset,
     build_pipeline, DynoPipeline.run with prefetch) over
     tests/fixtures/kitti_fixture read from disk, (a) in the hybrid
     incremental, sliding-window and full-batch modes at ACCURACY.md's
     configuration over its first 30 frames, eager, each run writing its
     CSV logs and evaluated by DatasetEvaluator: mature camera poses and
     matured object motions held to the nearest of the JAX runs (seeds
     0-5) in dynosam_tpu_torch/testdata/kitti_ref_30f.npz, the evaluator's
     numbers to the JAX seeds' range; (b) incremental again with deferred outputs
     (a mid-run drain), its logs equal to (a)'s byte for byte; (c) the
     real-io configuration over all 60 frames, timed after a warm-up (frames/s and the
     per-layer host times). Every run: the fused K1 once per frame, the map
     entry never; the first frame's inputs and graph state on the card;
     host syncs counted with torch's sync debug mode;
  10. formulations: the fused step at bench_config() with the WCME
     (backend_updater_enum 0) and WCPE (1) backends and the joint hybrid
     solve (decoupled_object_solve off) over the 20 bench frames (10
     advances each), camera poses held to the ground truth at the bench's
     bounds and poses + object motions to
     dynosam_tpu_torch/testdata/bench_{wcme,wcpe,joint}_ref_20f.npz, the
     joint run's marginal covariances of its final window to the
     reference's; then the pipeline path's entry-point code over the first
     30 fixture frames (cut from 60 to pay for phases 15 and 16) in
     incremental mode with WCME and WCPE, held to kitti_forms_ref_30f.npz
     as phase 9 holds hybrid. Every run: the fused
     K1 once per frame, the map entry never, host syncs counted with their
     sites;
  11. batched path: make_batched_pipeline at bench_config() over B=1 and
     B=8 sequences of one 27-frame bench scene, sequence b taking frames
     b .. b+19 (20 frames, 10 window advances, each frame one program for
     the whole batch; B=1 runs the first 12, two advances, against the
     reference's first 12); the fused K1 must launch once per frame at both B
     (its blockIdx.z entry takes all B images) and the map entry never; each
     sequence's camera poses held to the ground truth and poses + object
     motions to dynosam_tpu_torch/testdata/bench_batched_ref_b8_20f.npz at
     the bench path's bounds; the device operations per advancing frame
     (torch.profiler over the last frame) at B=8 at most 1.5x those at B=1;
     aggregate and per-sequence frames/s and host syncs per frame; and on
     the B=1 run's final window the landmark-chunked assembly
     (parallel/sharded.py, P=4) held to hybrid.linearize; then WCME, WCPE
     and the joint hybrid solve at B=8 on the first 12 of those frames
     (two advances), K1b once per frame, each held at phase 10's bounds to
     the first 12 frames of
     bench_batched_{wcme,wcpe,joint}_ref_b8_20f.npz (WCME's and WCPE's
     motions where settled; WCPE's sequences 5 and 6 to the ground truth
     only, BATCHED_REF_EXCLUDED), with ms per advancing frame, aggregate
     frames/s and host syncs per frame with their sites (not profiled);
  11c. batched stereo + IMU on the tracked scene: phase 14's stereo + IMU
     mode (B=8, 14 frames per sequence) on bench_config.tracked_scene,
     rendered on the host, held to tracked_batched_stereo_imu_ref_b8_14f.npz
     at BATCHED_MODE_BOUNDS["stereo_imu_tracked"]; K1b once per frame for
     all 8 sequences, the map entry never;
  12. datasets: each of the seven on-disk formats (dyno-KITTI with png
     masks, Virtual KITTI 2, OMD, TartanAir-Shibuya, VIODE, ClusterSlam,
     Aria; bench_config.DATASET_FORMATS) written by the port's writers at
     its dataset's frame size (12 frames; VIODE and Aria 10), frame 5 read
     back against what the writer was given within the format's
     quantisation, then run from disk through run_dynosam.run at the
     real-io configuration on the card (VIODE's and ClusterSlam's depth by
     dense stereo inside the reader, on the card); camera ATE and matured
     object motions held to the scene's ground truth and to the JAX run of
     dynosam_tpu_torch/testdata/datasets_ref_12f.npz (DATASET_BOUNDS); the
     first frame's inputs and graph state on the card; the fused K1 once per
     frame, the map entry never; frames/s and decode ms per frame; then the
     committed progressive JPEG (testdata/progressive_1242x375.jpg, written
     by cv2 with IMWRITE_JPEG_PROGRESSIVE) decoded by jpeg.py equal to
     cv2's decode committed beside it, with the ms per frame;
  13. tooling: python -m dynosam_tpu_torch.run_dynosam's main() with --viz
     over 12 fixture frames (tracking PNGs, the trajectory plot and the
     Motion-JPEG AVI decoded and checked), the same frames' packets saved
     and replayed through PacketReplayProvider into a fresh RegularBackend
     (the same camera poses), graph_tools on its final window, and one
     frame through --use_detector --detector_weights with a state dict the
     phase writes from the port's own scale-n, 80-class network under
     ultralytics' names (K2's entry B once, detections equal to the same
     network held directly);
  14. batched modes: make_batched_pipeline at B=8 over 14 frames per
     sequence (sequence b on scene frames b .. b+13, the window advancing 4
     times) in the two frontend modes that the reference's vmapped step
     runs besides the provided ids: (a) bench_config.batched_bytetrack_config()
     on the bench frames whose mask labels are permuted per frame and per
     sequence (bench_config.label_permutations, seed 0), ByteTrack
     restoring identity: object ids equal to
     bench_batched_bytetrack_ref_b8_14f.npz's in every sequence and frame
     and each ground-truth object keeping one id; (b)
     batched_stereo_imu_config() (in-loop stereo, the IMU rotation prior, on
     the provided flow) on stereo_imu_frame()'s world-textured frames:
     camera poses and settled motions held to
     bench_batched_stereo_imu_ref_b8_14f.npz and the static tracks' median
     relative depth error to the uncorrupted depth. Both: K1b once per frame
     for all 8 sequences, the map entry never, camera poses to the ground
     truth, valid track counts to the reference, and ms per advancing
     frame, aggregate frames/s, device ops, busy time and idle share per
     advancing frame (torch.profiler over the last frame), K1b's device ms
     and host syncs with their sites;
  15. rich fixture: bench_config.fixture_scenario(50, 1242, 375, rich=True)
     (scripts/accuracy_rich.py's scene: four cars, the fourth crossing
     behind the lead car) rendered on the host, written by the port's
     dyno-KITTI writer to a temporary directory, read back onto the card
     through
     run_dynosam.open_dataset / build_pipeline / DynoPipeline.run and run in
     hybrid incremental at the observability floor RICH_MIN_AREA with the
     evaluator: the objects the floor withholds and the resample flags
     equal to the nearest JAX seed's in every frame, mature camera poses
     and matured motions to that seed's (RICH_REF_BOUNDS) and the
     evaluator's numbers to the seeds' range, in
     dynosam_tpu_torch/testdata/rich_ref_50f.npz; the fused K1 once per
     frame, the map entry never;
  16. detector pipeline: scripts/accuracy_detector.py run_cell
     (eval/accuracy.py) over the first 20 frames of the detector's scene
     (bench_config.detector_scene, rendered on the host and written to
     disk) with the committed YOLOv8-seg checkpoint at 384x640 and
     ByteTrack supplying the masks to DynoPipeline (hybrid
     sliding-window): the packets' object
     ids, the association of estimated ids to ground-truth ids, poses,
     matured motions and the run's result held to
     dynosam_tpu_torch/testdata/det_acc_ref_20f.npz; the fused K1 and K2's
     entry B once per frame, entry A and the K1 map entry never;
  17. train: 6 steps of train_detector (the port of
     scripts/train_detector.py) from the committed checkpoint at 384x640,
     batch 8, drawing from the one-scene pool JAX rendered, each step's
     loss and every leaf's change (parameters and batch_stats) held to
     testdata/train_ref_6steps.npz; the pool rendered again on the card and
     compared; the result written as a float16 flax checkpoint, loaded back
     through load_flax_checkpoint into YoloV8DetectorEngine and scored on
     16 held-out scenes (K2's entry B once per scene; K1 and K2's entry A
     never, counted over the steps and the evaluation) against JAX's
     eval_iou of its own 6-step parameters; ms per step and peak memory;
  18. experiments: run_experiments.main (the port of
     scripts/run_experiments.py) over the fixture, 10 frames, forms 0, 1, 3
     x modes 0, 1, 2: no cell with an error, each cell's ATE, rotation,
     RPE, AME rms and median inside the JAX sweep's seeds 0-5
     (testdata/experiments_ref_10f/) widened by EXP_MARGIN, and by
     EXP_MARGIN_CELL in WCME and WCPE sliding-window, whose float32 steps
     are rounding noise on both sides; SUMMARY.md with the reference's
     columns, pipeline.frontend / pipeline.backend in every timing
     summary; the fused K1 once per frame, the map entry and K2 never;
  19. scale: scale_check.time_config (the port of scripts/scale_check.py)
     at J=32, F=16, 2048 dynamic landmarks, WCME and hybrid sliding-window:
     every column printed, the graph after the optimize and after the
     advance held to JAX's (testdata/scale_ref_J32_F16_2048.npz), and
     the SCALE.md table printed with the card's name and power limit
     (written to a temporary directory: the committed
     dynosam_tpu_torch/SCALE.md is refreshed only by `python -m
     dynosam_tpu_torch.scale_check --out dynosam_tpu_torch/SCALE.md`);
     every count read and 0, no hand kernel on this path;
  20. streaming: exp_streaming (the port of scripts/exp_streaming.py) at
     the script's defaults (20 frames, window 8, 10 LM iterations), the
     simulator's noisy packets straight into RegularBackend in full-batch,
     sliding-window and incremental modes, the port's Scenario drawing its
     landmark clouds and measurement noise from the JAX run's uniforms and
     normals: the packets' initial values and tracks, every frame's pose
     and every scored (mature) motion of each mode held to
     testdata/streaming_ref_20f.npz, each mode's summary numbers printed
     beside JAX's with its wall seconds and steady step ms; every count
     read and 0, no hand kernel on this path;
  21. fixture writer: python -m dynosam_tpu_torch.make_fixture_sequence's
     main() at its defaults (60 frames, 320x96) rendered on the card into a
     temporary directory and held to the committed tests/fixtures/
     kitti_fixture file by file (FIXTURE_BOUNDS); every count read and 0;
  22. multichip: python -m dynosam_tpu_torch.multichip's two checks
     (dynosam_tpu_torch/multichip.py, the port of the reference's
     dryrun_multichip) on the card, one process per rank: 2 ranks over gloo
     on the one card and 1 rank over NCCL (and NCCL over min(count, 4)
     cards where there are more). (a) make_batched_pipeline at
     bench_config over the group, 8 sequences of the bench scene (sequence
     b on scene frames b .. b+11), each rank stepping its 8/P with the
     whole batch's draws, the outputs gathered to rank 0: each sequence
     held to the ground truth and the first 12 frames of
     bench_batched_ref_b8_20f.npz at phase 11's bounds, to rank 0's
     unsharded run at multichip.SHARD_BOUNDS (gloo) and to this
     process's unsharded run at MULTICHIP_UNSHARDED; K1b once per frame on
     every rank. (b) sharded_optimize at scale_check's defaults held to
     chunked_optimize at the same P, every rank's system and step equal to
     rank 0's; each rank's wall seconds and steady step ms;
  23. print the kernel table, one row per entry (K1 fused, K1 map, K1b,
     K2 entry A, K2 entry B), with each one's bound (the larger of its
     bytes over 3.35 TB/s and its operations over 67 TFLOP/s f32, the H100
     SXM's published rates), loop-timed `ms` / `plain_ms` / `library_ms`
     beside the single-launch and profiler times, and launches per path
     under launches_by_path; then the contract line.

Phases 5-22 run in two processes at once, on the one card: the phases of
SECOND_LANE in a second process (spawned after phase 4, so the kernels'
times are taken alone), every other phase in this one. The steps are
host-bound and the card ~90% idle, so the two lanes overlap; each phase
zeroes and reads the launch counts of its own process. A phase's times
are taken beside the other lane's work.

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
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

BENCH_FRAMES = 20
DET_FRAMES = 24
KERNEL_RTOL = 1e-5            # K1: max |kernel - plain| <= KERNEL_RTOL * max |response|
K2_ATOL = 1e-5                # K2 entry A: max |kernel - plain| on sigmoid outputs in (0, 1)
# K2 entry B (the label image): every pixel equal to the plain version's but
# where some valid detection, inside its padded box, has a plain
# interpolated value within K2_NEAR of the threshold (the two interpolate
# and sum in another order, so such a pixel may round either way); those
# pixels are counted, and at most K2_NEAR_SHARE of the image.
K2_NEAR = 1e-5
K2_NEAR_SHARE = 1e-4
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
# KLT and stereo + IMU paths. On this scene both lose the camera (the JAX
# reference reads 4.84 m / 0.079 rad and 5.08 m / 0.084 rad off the ground
# truth): LK locks one texture period off on the far wall and passes the
# forward-backward check, and the near ground's flow exceeds the pyramid's
# reach. So the ground truth bounds each frame at the reference's own error
# plus GT_TRANS_M / GT_ROT_RAD (plus the path's pose bound below where that
# is larger), and the port is held to the reference. Largest over the
# frames, torch on the CPU (4 threads) against JAX on the CPU / the H100:
#   klt         poses 3.0e-3 / 1.97e-3 m, 4.7e-5 / 3.5e-4 rad (equal to 1e-4
#               m through frame 10, diverging after the first window
#               advance); motions 6.2e-4 / 7.2e-4 m over 7; track counts
#               equal in every frame on both
#   stereo_imu  poses 0.145 / 0.165 m, 3.8e-3 / 3.4e-3 rad (equal to 1e-4 m
#               through frame 6; from frame 7 the ill-posed camera solve
#               amplifies a few flipped stereo matches); motions 6.8e-4 /
#               7.4e-4 m over 4; counts within 0.83% on both
# Each bound sits ~6-15x (klt) / ~3-4x (stereo_imu) above the larger reading.
KLT_FRAMES = 20
STEREO_IMU_FRAMES = 12
IMU_SAMPLES = 32
KLT_REF_BOUNDS = {
    "klt": {"ref_m": 0.03, "ref_rad": 2e-3, "motion_m": 0.01, "count_rel": 0.02},
    "stereo_imu": {"ref_m": 0.5, "ref_rad": 0.015, "motion_m": 0.01, "count_rel": 0.03},
}
# Phases 6t and 7t: the same two paths on bench_config.tracked_scene, where
# the reference keeps the camera (worst frame 0.0908 m / 1.2e-3 rad on KLT,
# 0.0426 m / 1.1e-3 rad on stereo + IMU). The KLT path follows the last bits
# of its input images, in JAX too: JAX on the port's render parts from JAX
# on its own render by 3.99e-2 m over 20 frames (the renders differ by
# ~1e-5 in RGB), as far as the port does, and one f32 ulp on every RGB value
# moves JAX by up to 1.35e-3 m / 2.1e-5 rad on KLT and 3.3e-4 m / 5.0e-6 rad
# on stereo + IMU (scripts/probe_torch_klt_parting.py). So the references
# run JAX on the port's host render, the phases render on the host too, and
# the pose bounds cover that one-ulp spread. Largest over the frames, torch
# on the CPU (4 threads) / the H100 (80GB HBM3, 700 W):
#   klt         poses 4.23e-5 / 2.06e-4 m, 2.0e-6 / 9.1e-6 rad; motions
#               3.48e-3 / 9.3e-5 m over 8 (the object RANSAC's draws decide
#               it: --seed 1 and 2 read 8.5e-5 / 4.3e-5 m on the CPU);
#               counts equal on both
#   stereo_imu  poses 6.32e-5 / 2.55e-5 m, 1.5e-6 / 5.6e-6 rad; motions
#               4.05e-3 / 3.6e-4 m over 6 (seeds 1, 2: 3.7e-4 / 2.5e-4 m);
#               counts equal; depth median relative error 0.130% on both
# Pose bounds ~1.5x the one-ulp spread (~10x / ~8x the larger reading),
# rotation and motion bounds ~5x the larger reading, counts 1%.
TRACKED_REF_BOUNDS = {
    "klt": {"ref_m": 2e-3, "ref_rad": 5e-5, "motion_m": 0.02, "count_rel": 0.01},
    "stereo_imu": {"ref_m": 5e-4, "ref_rad": 3e-5, "motion_m": 0.02, "count_rel": 0.01},
}
# stereo must repair the 1.15x corrupted depth: the median relative error of
# the valid static tracks' depths against the true depth, over frames 1..,
# within tests/test_frontend_wiring.py's 5% (CPU and H100 read 0.06%). That test
# keeps only tracks nearer than 15 m because its far wall subtends ~1 px of
# disparity; here every static point lies within 60 m, >= 6.4 px at fx 720
# and a 0.537 m baseline, so all of them count.
STEREO_DEPTH_RELERR = 0.05
TIMING_RUNS = 50
SPIN_CYCLES = 10_000_000      # ~5 ms of GPU clock, longer than any enqueue here
# loop-timed kernels: one event pair around LOOP_LAUNCHES back-to-back calls
# (fewer for a call of many device operations, see kernel_times), a spin
# kernel in front that outlasts their enqueue (checked), median of
# LOOP_ROUNDS rounds in turns; torch.profiler over PROFILED_CALLS calls, for
# the kernels only. The plain versions and unfused routes loop a fixed
# count each (the `routes` of kernel_times): 800 // their device operations
# per call as torch.profiler counted them on the H100 (run AR: K1's plain
# pair 66, plain map 50, map route 14, K2's unfused routes and entry B's
# plain 27-28, entry A's plain 2), rounded down
LOOP_LAUNCHES = 200
LOOP_ROUNDS = 3
SPIN_LOOP_CYCLES = 100_000_000  # calibrates the spin's clock rate
PROFILED_CALLS = 50
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
K1_OPS_PER_PIXEL = 29         # 28 flops of the response + 1 comparison of the argmax
K2B_OPS_PER_PIXEL = 10        # entry B per output pixel in a padded box: the lerp (9) + the test
# held-out phase: the committed checkpoint's evaluation (48 scenes of
# eval/detector_heldout.py) against testdata/det_heldout_ref_48.npz, a fresh
# JAX run (114 instances, mean IoU 0.712946, class accuracy 0.956140). The
# instances must be the same. Torch on the CPU (4 threads) read |mean IoU -
# JAX| 2.94e-7 (one label pixel flipped near the threshold: the largest
# instance moved 3.35e-5) and every class hit equal; the H100 read 0 and
# every hit equal in two runs. The mean IoU bound sits ~15x above the CPU's
# reading; class hits, equal on both, must stay equal.
HELDOUT_SCENES = 48
HELDOUT_MEAN_IOU = 4.4e-6     # |mean IoU - reference|
HELDOUT_CLASS_ACC = 0.0       # |class accuracy - reference|
# pipeline path: the committed dyno-KITTI fixture, all 60 frames
ROOT = os.path.dirname(os.path.abspath(__file__))
KITTI_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "kitti_fixture")
# the three modes and the deferred run take the first PIPE_FRAMES frames (cut
# from all 60 to keep the smoke near half its time limit), and so do phase
# 10's fixture runs (cut from 60 to pay for phases 15 and 16); the real-io
# run takes all 60
PIPE_FRAMES = 30
REAL_IO_FRAMES = 60
# phase 5b: the pipelined step over the first PIPELINED_FRAMES bench frames
# (two advancing frames), held to the first PIPELINED_FRAMES of
# bench_pipelined_ref_20f.npz
PIPELINED_FRAMES = 12
FORM_KITTI_FRAMES = 30
KITTI_MODES = ("incremental", "sliding_window", "full_batch")
DRAIN_EVERY = 16              # deferred run: drains after frames 16, 32, 48 and at the end
DEFERRED_LOGS = ("camera_pose", "object_motion", "object_pose", "object_bbx")
# ACCURACY.md's on-disk hybrid rows (camera ATE cm, ATE rot rad, AME rms cm,
# AME median cm), printed beside the port's; they predate later changes of
# the reference, so the port is held to a fresh JAX run instead
ACCURACY_ROWS = {"incremental": (1.186, 0.00396, 1.336, 1.143),
                 "sliding_window": (1.168, 0.00521, 1.251, 1.102),
                 "full_batch": (1.108, 0.00201, 0.635, 0.429)}
# Pipeline path against kitti_ref_30f.npz (JAX seeds 0-5, every run kept;
# the first 30 fixture frames), per mode: the largest pose translation (m)
# and rotation (rad), the largest and the median matured-motion
# translation (m), against the nearest JAX run (compare_kitti). The port
# samples RANSAC with its own generator, so it lands as another seed does,
# plus f32 reordering; and some LM accept/reject decisions on the fixture
# lie within f32 rounding of the total error (~7 ulps), so runs part there
# by seed, by torch's thread count or by device. Given the same input, JAX
# and the port decide alike (LM traces on saved states; float64 sides with
# the reject in the full-batch case). Full-batch parts at frame 26's warm
# start (its final solve takes no step): JAX seed 3 alone, the port on 4
# threads and the card take the accept (8.0e-4 / 2.3e-4 m from seed 0).
# Sliding-window parts twice: mid-run (seeds 1, 4 and the port sit 3.3e-4
# / 1.0e-4 m from seeds 0, 2, 3) and at frame 29, the last, where seed 5
# alone and the card flip object 3's last motion by 2.63e-2 m; the card
# takes seeds 1/4's first branch and seed 5's second. Readings against the
# nearest run, JAX (each seed vs its nearest other on its branch) / torch
# on the CPU (4 threads) / the H100:
#   incremental  pose 1.8e-5-8.8e-5 / 4.7e-5 / 9.3e-5 m, 9.2e-6-1.5e-5 /
#                2.0e-5 / 1.7e-5 rad; motions max 1.1e-5-2.0e-5 / 3.5e-5
#                / 9.5e-5 m, median 2.3e-6-6.3e-6 / 4.0e-6 / 5.6e-6 m
#   sliding      pose 2.6e-5-3.5e-5 / 5.6e-5 / 6.2e-5 m, 1.3e-5-1.8e-5 /
#                2.1e-5 / 2.5e-5 rad; motions max 1.7e-5-4.6e-5 / 3.8e-5
#                / 3.3e-4 m (against seed 5, whose mid-run branch the
#                card does not share: the gap of seeds 1 and 0), median
#                4.5e-6-5.9e-6 / 4.8e-6 / 1.2e-4 m
#   full_batch   pose 1.5e-6-3.1e-6 / 4.4e-6 / 3.6e-6 m, 9.4e-8-1.1e-7 /
#                9.0e-8 / 6.4e-8 rad; motions max 6.4e-6-1.8e-5 / 2.9e-5 /
#                2.4e-5 m, median 1.3e-6-2.7e-6 / 3.8e-6 / 4.1e-6 m
# Bounds 4-11x the larger of the port's readings.
KITTI_REF_BOUNDS = {
    "incremental": {"pose_m": 1e-3, "pose_rad": 2e-4, "motion_max_m": 1e-3, "motion_median_m": 5e-5},
    "full_batch": {"pose_m": 5e-5, "pose_rad": 1e-6, "motion_max_m": 3e-4, "motion_median_m": 4e-5},
    "sliding_window": {"pose_m": 5e-4, "pose_rad": 2e-4, "motion_max_m": 2e-3, "motion_median_m": 5e-4},
}
KITTI_MOTION_OVERLAP = 0.98   # (frame, object) keys of matured motions shared; read 1.0
# The evaluator's numbers must lie in the JAX seeds' [min, max], widened on
# both sides by margin x the range's midpoint. Over 60 frames the seeds
# spread by at most 0.4% (ATE), 7% (ATE rot), 0.3% (AME rms, median);
# beyond the seeds' range the card read at most +0.22% (ATE), +15% (ATE
# rot, sliding), -0.07% (AME rms) and -0.16% (median). Over 30 frames the
# six seeds' ranges take in both branches above (full-batch AME median
# 0.004776-0.004960 m, sliding AME RMS 0.014471-0.016735 m), and the CPU
# and the card read inside them. ATE rot is the aligned ATE's rotation:
# Umeyama on a nearly straight path is ill-conditioned about the direction
# of travel, hence its wider margin, twice the largest excess read.
KITTI_RANGE_MARGIN = {"ate_unaligned_m": 0.02, "ate_rot_rad": 0.3, "ame_rms_m": 0.02,
                      "ame_median_m": 0.02}

# formulations phase. FORM_BENCH: the fused step's configuration overrides;
# FORM_KITTI: backend_updater_enum of the fixture runs (incremental mode).
FORM_BENCH = {"wcme": {"backend.backend_updater_enum": 0}, "wcpe": {"backend.backend_updater_enum": 1},
              "joint": {"backend.decoupled_object_solve": False}}
FORM_KITTI = {"wcme": 0, "wcpe": 1}
# Bench forms against their JAX references: the bench path's bounds. At this
# width WCME's and WCPE's LM takes no step after frame 1, in the reference
# as in the port: their f32 reduced system is indefinite (eigenvalues
# [-3.5e8, 4.2e8] at frame 1 on the H100, scripts/probe_torch_forms.py; the
# same linearisation in float64 is positive definite, 1.1e-4 up), every
# Cholesky fails and every candidate is rejected. Their motions are then the frontend's RANSAC estimates, and
# where an object re-enters (object 2 at frame 12) that estimate follows
# the draws: the CPU's seeds 0-5 read 6.7e-3-1.35e-2 m there, the card's
# seed 0 4.80 m (the card's backend equal to the CPU's on the card's
# inputs). So their motions are held only where settled. Torch on the CPU
# (4 threads) read poses 1.9e-5 / 2.0e-5 / 1.9e-5 m and 2.1e-7 / 4.9e-7 /
# 3.3e-7 rad (wcme / wcpe / joint); settled motions 2.5e-4 / 2.5e-4 m (the
# frontend's draws again, object 2 at frame 8), joint's (all) 7.1e-5 m; the
# H100 read poses 1.3e-5 / 1.6e-5 / 1.7e-5 m, settled motions 1.5e-3 /
# 1.5e-3 m, joint's 4.3e-4 m. The joint marginal covariances read 2.7e-2
# (CPU) and 3.2e-2 (H100) of each block's largest entry (an f32 inverse of
# a system spanning 1e-5 to 1e8).
FORM_COV_REL = 0.1
# Fixture forms against kitti_forms_ref_30f.npz (seed 0), as phase 9. Over
# 60 frames (the runs' length before the cut) JAX seeds 1, 2 vs 0 / torch
# on the CPU (4 threads), wcme and wcpe alike: pose 1.2e-5 / 1.7e-5 m,
# 1.8e-7 / 2.5e-7 rad; motions max 5.0e-4 / 3.4e-4 m, median 7.3e-6 / 1.8e-5 (wcpe 1.1e-5
# / 1.8e-5) m; the H100 read pose 1.7e-5 / 1.6e-5 m, 1.3e-7 rad, motions
# max 5.5e-4 m, median 1.3e-5 / 2.0e-5 m (wcme / wcpe). Over 30 frames the
# H100 read pose 1.95e-6 m, 8.9e-8 / 7.9e-8 rad, motions max 1.16e-4 m,
# median 1.06e-5 / 1.29e-5 m. Bounds ~4x the largest reading, the poses'
# ~10x, kept from the 60-frame runs.
FORM_KITTI_BOUNDS = {"pose_m": 2e-4, "pose_rad": 2e-6, "motion_max_m": 2e-3, "motion_median_m": 1e-4}
# phase 15: the rich fixture (bench_config.fixture_scenario at 1242x375,
# rich=True) rendered on the host as the JAX reference's files were,
# written by the port's dyno-KITTI writer (about 3.7 MB of .flo per frame,
# to a temporary directory removed after), read back onto the card through
# run_dynosam.open_dataset (padded to 384x1248) and run in hybrid
# incremental at the observability floor RICH_MIN_AREA over its first
# RICH_FRAMES frames: object 3 falls below the floor at frames 30-32, slots
# 2 and 3 are resampled at frames 30-35 (in every JAX seed). Held to the
# nearest of the JAX seeds 0-5 in testdata/rich_ref_50f.npz: poses and
# matured motions at RICH_REF_BOUNDS, the withheld objects and the resample
# flags equal in every frame, the evaluator inside the seeds' range
# (KITTI_RANGE_MARGIN).
RICH_HW = (375, 1242)
RICH_FRAMES = 50
# The render stays on the host: the scene's f32 trajectory is
# ill-conditioned at the fixture's 0.002 rad yaw (se3_exp's (1 - cos) /
# theta^2 loses ~1.5% to one ulp of cos), so a render with the card's sin /
# cos moves the scene ~7e-6 m per frame and is another disparity
# quantisation draw (the H100 read 1.30e-3 m from the nearest seed that
# way). On the scene the CPU renders, against the nearest seed: torch on
# the CPU read pose 1.2e-5 m, 1.6e-7 rad, motions max 2.5e-4 m, median
# 8.8e-6 m; the H100 2.8e-6 m, 1.9e-7 rad, 2.2e-4 m, 6.0e-6 m (and,
# rendering itself with host-built trajectory chains, 4.4e-6 m, 1.4e-7
# rad, 3.4e-4 m, 1.1e-5 m). Bounds ~6-10x the largest reading, phase 10's.
RICH_REF_BOUNDS = {"pose_m": 1e-4, "pose_rad": 2e-6, "motion_max_m": 2e-3, "motion_median_m": 1e-4}
# phase 16: scripts/accuracy_detector.py run_cell with the detected masks
# (the committed checkpoint, score DET_ACC_SCORE, ByteTrack; hybrid
# sliding-window, window 8) over the first DET_PIPE_FRAMES frames of
# bench_config.detector_scene, the scene the checkpoint was trained on
# (it finds nothing on the dyno-KITTI fixture at 96x320), rendered on the
# host and written by the port's dyno-KITTI writer to a temporary
# directory (eval/accuracy.py write_detector_scene), read back onto the
# card at 384x640 and run through DynoPipeline. Held to the nearest (by
# camera pose) of the JAX seeds 0-5 in testdata/det_acc_ref_20f.npz: the
# packets' object ids in every frame, the association of ByteTrack's ids
# to ground-truth ids and the result's counts equal, poses and matured
# motions at DET_PIPE_BOUNDS, the result's ATE / AME within
# DET_PIPE_RESULT (m). The detected run loses the camera by 0.52 m over
# these frames (the provided masks' 2.0 cm), in the reference as in the
# port, and the JAX seeds lie within 3.4e-4 m of each other in pose and
# 3.3e-3 m in the AME median. Against the nearest seed (seed 2 on both),
# torch on the CPU read 1.56e-4 m / 1.84e-5 rad, motions max 1.48e-3 m,
# median 2.57e-5 m and a result 7.35e-4 m off; the H100 1.70e-4 m /
# 2.60e-5 rad, 2.17e-3 m, 7.71e-5 m and 7.67e-4 m, ids and association
# equal. Bounds ~4-6x the larger reading; the result's near the seeds' own
# spread.
DET_ACC_HW = (96, 320)         # the fixture's detector input (phase 4's entry-B case)
DET_ACC_SCORE = 0.35
DET_PIPE_FRAMES = 20
DET_PIPE_BOUNDS = {"pose_m": 1e-3, "pose_rad": 1e-4, "motion_max_m": 1e-2, "motion_median_m": 3e-4}
DET_PIPE_RESULT = 3e-3
# batched path: B=1 and B=8 sequences, 20 frames each, from one scene of
# 20 + 8 - 1 frames; every sequence held at the bench path's bounds (GT_*,
# REF_*) to the ground truth and to bench_batched_ref_b8_20f.npz (B=1 to
# its sequence 0). One program per frame: device operations per advancing
# frame at B=8 within BATCHED_OPS_RATIO of B=1's (a loop over sequences
# would read ~8). The chunked assembly (P=CHUNK_P) against the unchunked
# linearize: the largest entry difference of S and rhs within CHUNK_REL of
# each one's largest entry, the port's linearize parity bound
# (tests/test_torch_backend.py).
BATCHED_FRAMES = 20
# B=1 runs the window fill and two advancing frames (the last one profiled
# for the B=8 / B=1 op ratio, its window for the chunked assembly), held to
# the first 12 frames of the reference: cut from 20 to pay for phases 17-19
BATCHED_B1_FRAMES = 12
BATCHED_SIZES = (1, 8)
BATCHED_OPS_RATIO = 1.5
# WCME, WCPE and the joint hybrid solve at B=8, each held to the ground
# truth and to bench_batched_{form}_ref_b8_20f.npz (WCME's and WCPE's
# motions where settled only, as phase 10, see FORM_COV_REL). Readings,
# largest over the 8 sequences, torch on the CPU (3 threads) / the H100:
#   wcme   GT 6.3e-4 / 6.3e-4 m, 2.1e-5 / 2.1e-5 rad; JAX ref 2.7e-5 /
#          2.3e-5 m, 3.1e-7 / 3.1e-7 rad; settled motions 8.9e-4 / 1.2e-3 m
#   wcpe   GT 3.0e-3 / 3.0e-3 m, 1.0e-4 / 1.0e-4 rad; JAX ref (sequences
#          0-4 and 7) 1.7e-5 / - m, 8.4e-7 / - rad; settled motions 8.9e-4
#          / 1.2e-3 m
#   joint  GT 2.6e-2 / 2.6e-2 m, 4.8e-4 / 4.8e-4 rad; JAX ref 5.9e-5 /
#          2.5e-4 m, 1.3e-6 / 6.4e-6 rad; motions 4.5e-4 / 3.3e-4 m
# WCPE's JAX reference parts from the port in sequences 5 and 6 from frame
# 2, after the one LM step WCPE takes at frame 1 on this scene (ROADMAP
# queue 3: its object-pose gauge leaves the reduced system at the edge of
# f32 positive definiteness, where XLA's, LAPACK's and cuSOLVER's Cholesky
# pass or fail differently): JAX's sequence 5 ends 2.8e-3 rad off the
# ground truth, the port's 6.0e-5 (its sequence 6 1.4e-4 rad from JAX), so
# those two are held to the ground truth only (BATCHED_REF_EXCLUDED; their
# JAX-ref readings are printed) and the other six to the reference. The
# joint solve's 2.6 cm against the ground truth is the reference's too (the
# port sits 2.5e-4 m from it). Bounds ~4-15x the larger reading. Each form
# runs the window fill and two advancing frames, held to the first 12
# frames of its reference: cut from 20 to pay for phases 20-21, every check
# kept. Its last frame is no longer replayed under torch.profiler (14.5-16.9
# s each, a reading and no check: device ops, busy ms and idle share print
# n/a), to pay for phase 22.
BATCHED_FORMS_B = 8
BATCHED_FORMS_FRAMES = 12
BATCHED_REF_EXCLUDED = {"wcpe": (5, 6)}
BATCHED_FORM_BOUNDS = {
    "wcme": {"gt_m": 5e-3, "gt_rad": 2e-4, "ref_m": 2e-4, "ref_rad": 3e-6, "motion_m": 1e-2},
    "wcpe": {"gt_m": 2e-2, "gt_rad": 1e-3, "ref_m": 2e-4, "ref_rad": 5e-6, "motion_m": 5e-3},
    "joint": {"gt_m": 0.1, "gt_rad": 2e-3, "ref_m": 1e-3, "ref_rad": 3e-5, "motion_m": 5e-3},
}
CHUNK_P = 4
CHUNK_REL = 1e-4
# batched modes phase: make_batched_pipeline at B=8 over 14 frames (the
# window fills, then advances 4 times) in the two frontend modes of
# bench_config, each held to its JAX reference file:
# bench_batched_bytetrack_ref_b8_14f.npz (the bench frames with each mask's
# labels permuted per frame and sequence, ByteTrack restoring identity) and
# bench_batched_stereo_imu_ref_b8_14f.npz (stereo + IMU rotation prior on
# the provided flow, world-textured, right image, 1.15x depth). ByteTrack's
# object ids must equal the reference's in every sequence and frame and
# ground-truth object carry one id in each frame (an object that leaves the
# view or whose box jumps below the match IoU gets a new id, in the
# reference too: the phase prints those changes); stereo + IMU's motions
# are compared where settled. Readings, largest over the 8 sequences, torch
# on the CPU (4 threads) / the H100:
#   bytetrack   GT 3.2e-3 / 3.2e-3 m (the reference's own 3.2e-3); JAX ref
#               1.4e-5 / 2.0e-5 m, 1.7e-7 / 4.9e-7 rad; motions 2.0e-4 /
#               1.5e-4 m over 119; counts equal; ids equal
#   stereo_imu  GT 0.578 / 0.578 m (the reference's own 0.578: its 1.15x
#               depth leaves a scale drift that stereo repairs only in part),
#               the port 2.4e-3 m past it on the card; JAX ref 1.4e-2 /
#               4.2e-3 m, 1.1e-4 / 6.4e-4 rad; settled motions 9.9e-3 /
#               6.4e-3 m over 101; counts within 0 / 0.25%; depth median
#               relative error 0.077% / 0.077%
# The bytetrack bounds sit ~5x above the larger reading (the ground truth
# at the bench path's bounds); stereo_imu's ~3.5-4x, the ground truth past
# the reference's own error at GT_TRANS_M / GT_ROT_RAD as phase 7's.
BATCHED_MODES = ("bytetrack", "stereo_imu")
BATCHED_MODES_B = 8
BATCHED_MODES_FRAMES = 14
BATCHED_MODE_BOUNDS = {
    "bytetrack": {"gt_m": GT_TRANS_M, "gt_rad": GT_ROT_RAD, "ref_m": 1e-4, "ref_rad": 3e-6,
                  "motion_m": 1e-3, "count_rel": 0.01},
    "stereo_imu": {"gt_excess_m": GT_TRANS_M, "gt_excess_rad": GT_ROT_RAD, "ref_m": 0.05, "ref_rad": 2.5e-3,
                   "motion_m": 0.04, "count_rel": 0.01, "depth_relerr": STEREO_DEPTH_RELERR},
    # phase 11c, stereo_imu on bench_config.tracked_scene rendered on the
    # host (tracked_batched_stereo_imu_ref_b8_14f.npz, JAX on the port's
    # host render; the reference's own error 0.133 m / 1.9e-3 rad, the
    # 1.15x depth's scale drift): torch on the CPU (4 threads) / the H100
    # read GT 7.4e-4 / 9.9e-4 m past the reference's own; JAX ref 9.44e-4 /
    # 1.10e-3 m, 6.7e-6 / 1.5e-5 rad; settled motions 6.1e-5 / 7.7e-5 m over
    # 110; counts equal; depth median relative error 0.111% on both. The
    # bounds ~5x the larger reading, counts 1%.
    "stereo_imu_tracked": {"gt_excess_m": GT_TRANS_M, "gt_excess_rad": GT_ROT_RAD, "ref_m": 5e-3, "ref_rad": 1e-4,
                           "motion_m": 4e-4, "count_rel": 0.01, "depth_relerr": STEREO_DEPTH_RELERR},
}
# tooling phase: the entry point with --viz over the first TOOLING_FRAMES
# fixture frames; each Motion-JPEG frame is its PNG's own JPEG (quality 95)
# bit for bit, within TOOLING_JPEG_MEAN_LEVELS grey levels of the PNG on
# average (the CPU read 9.36 on these 320x96 frames dense with 5-px feature
# dots; 0.88-0.90 on the smooth frames of tests/test_torch_tooling.py); the
# replayed backend's camera poses within TOOLING_REPLAY_M (entries) of the
# pipeline's own (the same packets through the same code: the CPU read 0;
# the card's scatter-adds may order their sums differently); the detector
# built from the ultralytics-named state dict against the same network
# held directly: labels and validity equal, boxes within TOOLING_DET_BOX_PX
# (the CPU read 0 over 32 valid detections)
TOOLING_FRAMES = 12
TOOLING_JPEG_MEAN_LEVELS = 20.0
TOOLING_REPLAY_M = 1e-4
TOOLING_DET_BOX_PX = 1e-3


# Phase 12 (datasets): 12 frames per format (10 for VIODE and Aria,
# bench_config.dataset_frames); frame 5 read back against what
# the writer was given. VKITTI's 16-bit flow quantises to half a code step,
# (w - 1) / 65535 px, plus DATASET_VKITTI_FLOW_PX for the f32 decode; its
# quality-98 JPEG loses up to
# DATASET_JPEG_LEVELS grey levels against the truncated render (the codec
# itself equals OpenCV, tests/test_torch_codecs.py).
DATASET_CHECK_FRAME = 5
PROGRESSIVE_RUNS = 3          # decodes of the committed progressive file
DATASET_VKITTI_FLOW_PX = 1e-3
DATASET_JPEG_LEVELS = 12.0
DATASET_MOTION_OVERLAP = 0.9
# Bounds per format, 3-15x above the readings of torch on the CPU (4
# threads) and on the H100 (run AH): against the scene's ground truth, the
# largest mature camera translation (m) and rotation (rad) error and the
# median matured-motion translation error (m), the two readings equal to
# 3 digits; against the JAX run, the largest pose translation and rotation
# difference and the median and largest matured-motion difference on
# shared keys. Readings, CPU / card:
#   kitti_png   0.0497 0.0025 5.7e-4 | 5e-6/8.0e-6 2e-7/3.5e-7 4e-6/1.7e-5 1.2e-3/3.5e-4
#   vkitti      0.0092 6.6e-4 2.2e-3 | 5.2e-4/1.3e-5 7e-6/2.6e-7 2.0e-5/7.8e-5 7.3e-5/3.5e-4
#   omd         0.0515 8.0e-4 4.0e-3 | 3e-6/2.2e-5 1e-6/6.1e-6 1.9e-5/3.4e-5 8.2e-5/2.1e-4
#   tartanair   0.0232 1.9e-4 5.8e-4 | 2e-6/3.3e-6 2e-7/1.3e-6 1.2e-5/8.8e-6 3.7e-5/1.0e-4
#   viode       0.541  0.0120 0.449  | 0.018/3.5e-4 5.1e-4/2.0e-5 0.122/0.201 0.791/1.01
#   clusterslam 0.717  0.0088 0.259  | 0.021/0.018 5.2e-4/8.8e-5 0.018/0.012 0.761/0.802
#   aria        0.0232 1.4e-4 4.7e-3 | 2e-6/4.5e-6 6e-8/6.7e-8 8e-6/1.3e-5 3.1e-5/5.1e-5
# The two stereo formats track poorly in the reference too (the JAX run is
# within 2 cm of the port's): their depth, matched on a synthesised right
# view, is invalid on 5-11% of the pixels, and the JAX reader's jitted
# matcher flips validity gates at other pixels than the port's.
DATASET_BOUNDS = {
    "kitti_png": {"ate_max_m": 0.25, "ate_rot_rad": 0.0125, "ame_median_m": 5e-3, "ref_pose_m": 1e-4,
                  "ref_pose_rad": 5e-6, "ref_motion_median_m": 2e-4, "ref_motion_max_m": 1e-2},
    "vkitti": {"ate_max_m": 0.05, "ate_rot_rad": 5e-3, "ame_median_m": 0.01, "ref_pose_m": 5e-3,
               "ref_pose_rad": 7e-5, "ref_motion_median_m": 8e-4, "ref_motion_max_m": 4e-3},
    "omd": {"ate_max_m": 0.25, "ate_rot_rad": 5e-3, "ame_median_m": 0.02, "ref_pose_m": 2e-4,
            "ref_pose_rad": 6e-5, "ref_motion_median_m": 3e-4, "ref_motion_max_m": 2e-3},
    "tartanair": {"ate_max_m": 0.12, "ate_rot_rad": 2e-3, "ame_median_m": 5e-3, "ref_pose_m": 5e-5,
                  "ref_pose_rad": 1.5e-5, "ref_motion_median_m": 1.5e-4, "ref_motion_max_m": 1e-3},
    "viode": {"ate_max_m": 2.0, "ate_rot_rad": 0.06, "ame_median_m": 1.5, "ref_pose_m": 0.2,
              "ref_pose_rad": 5e-3, "ref_motion_median_m": 1.0, "ref_motion_max_m": 3.0},
    "clusterslam": {"ate_max_m": 2.5, "ate_rot_rad": 0.05, "ame_median_m": 1.0, "ref_pose_m": 0.2,
                    "ref_pose_rad": 5e-3, "ref_motion_median_m": 0.2, "ref_motion_max_m": 3.0},
    "aria": {"ate_max_m": 0.12, "ate_rot_rad": 2e-3, "ame_median_m": 0.025, "ref_pose_m": 5e-5,
             "ref_pose_rad": 1e-6, "ref_motion_median_m": 1.5e-4, "ref_motion_max_m": 6e-4},
}


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


def loop_ms(torch, fns, ns, rounds=LOOP_ROUNDS):
    """{name: device time of one call} of the no-argument callables `fns`:
    one event pair around `ns[name]` back-to-back calls, divided by that
    count, median over `rounds` rounds in turns. A spin kernel queued in front, sized to
    twice the calls' enqueue time, keeps the card busy while the host
    enqueues them, so they run back to back; raises if the enqueue still
    outlasted the spin."""
    # the spin's clock rate, then each callable's enqueue time for n calls,
    # which sets its spin: twice that, plus 10 ms
    s0, e0 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(SPIN_LOOP_CYCLES)
    e0.record()
    e0.synchronize()
    cycles_per_ms = SPIN_LOOP_CYCLES / s0.elapsed_time(e0)
    spin = {}
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ns[k]):
            fn()
        spin[k] = int(cycles_per_ms * (2e3 * (time.perf_counter() - t0) + 10.0))
        torch.cuda.synchronize()
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            s0, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            s0.record()
            torch.cuda._sleep(spin[k])
            e0.record()
            t0 = time.perf_counter()
            for _ in range(ns[k]):
                fns[k]()
            host_ms = (time.perf_counter() - t0) * 1e3
            e1.record()
            e1.synchronize()
            spin_ms = s0.elapsed_time(e0)
            if not host_ms < spin_ms:
                raise AssertionError(f"loop timing of {k}: enqueueing {ns[k]} calls took {host_ms:.1f} ms, "
                                     f"longer than the {spin_ms:.1f} ms spin")
            times[k].append(e0.elapsed_time(e1) / ns[k])
    return {k: statistics.median(v) for k, v in times.items()}


def profiler_ms(torch, fns, n=PROFILED_CALLS):
    """{name: (device ms per call, kernel names, device events per call)}:
    the CUDA events torch.profiler records over `n` calls, summed and
    divided by `n`; None where it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.time_range.elapsed_us() for e in ev)
        out[k] = (total / n / 1e3, sorted({e.name[:60] for e in ev}), len(ev) / n) if ev and total > 0 else None
    return out


def kernel_times(torch, fns, routes=None):
    """Every measure of `fns` in one place: single launches (device and with
    the launch from Python) and loop-timed; the kernels (the names not in
    `routes`) also under torch.profiler. A kernel's loop holds
    LOOP_LAUNCHES calls, fewer for a call of many device operations, and a
    route's loop the count `routes` gives it, so that the enqueued
    operations stay within the launch queue (~1000 deep; a full queue
    blocks the host behind the spin)."""
    routes = routes or {}
    prof = profiler_ms(torch, {k: fn for k, fn in fns.items() if k not in routes})
    ns = {k: max(10, min(LOOP_LAUNCHES, int(800 // v[2]))) if v else LOOP_LAUNCHES for k, v in prof.items()}
    return {"single": median_ms(torch, fns, spin=True), "call": median_ms(torch, fns, spin=False),
            "loop": loop_ms(torch, fns, {**ns, **routes}), "loop_calls": {**ns, **routes},
            "profiler": {k: prof[k][0] if prof.get(k) else None for k in fns},
            "profiler_kernels": {k: prof[k][1] if prof.get(k) else [] for k in fns}}


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

    # the fused entry at the shapes the paths give it. 375x1242 with cell
    # 8: the rich fixture and KITTI frames unpadded (the accuracy runs of
    # eval/accuracy.py), partial cells at the right and bottom edges and
    # W % 4 != 0 (the scalar loads). 384x1248 (phase 15, the rich fixture
    # padded to multiples of 32 by run_dynosam) and 96x320 (the fixture:
    # phases 9, 10, the sweep) with cell 8: W % 4 == 0 and a last column
    # tile narrower than the kernel's 128 (the cp.async loads of a partial
    # tile). 384x640 with cell 8: the detector scene (phase 16).
    cases = [((H, W), 16, "random"), ((H, W), 16, "constant"), ((H, 640), 16, "random"),
             ((H, 640), 16, "constant"), ((H, W), 8, "random"), ((H, 640), 8, "random"),
             ((H, 640), 8, "constant"), (RICH_HW, 8, "random"), (RICH_HW, 8, "constant"),
             ((384, 1248), 8, "random"), ((384, 1248), 8, "constant"), ((96, 320), 8, "random"),
             ((96, 320), 8, "constant"), ((B, H, W), 16, "random")]
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
            "map": lambda img=img: st.shi_tomasi_response(img),
            "map_route": lambda img=img: st.cell_reduce(st.shi_tomasi_response(img), 16),
            "plain": lambda img=img: st.shi_tomasi_cell_max_reference(img, 16),
            "map_plain": lambda img=img: st.shi_tomasi_response_reference(img),
        }
        n_px = img.numel()
        routes = {"map_route": 50, "plain": 10, "map_plain": 15}
        times[label] = {**kernel_times(torch, fns, routes), "bound": k1_bound(tuple(img.shape), 16),
                        # the map entry: the frame read once and the map written once
                        "map_bound": bound_ms(8 * n_px, (K1_OPS_PER_PIXEL - 1) * n_px)}
    t1, t8 = times["b1"], times["b8"]
    say(f"K1 fused matches plain: best {'bit for bit' if bitwise else 'within KERNEL_RTOL'} "
        f"(max abs err {max(errs):.3e}), (u, v) equal in every cell, {near} near-tie cells, over "
        f"{len(cases)} cases (384x1280, 384x640, 375x1242, 384x1248 and 96x320, cells 16 and 8, constant "
        f"frames take each "
        f"cell's first pixel, an (8, 384, 1280) batch equal to its single images); map entry max "
        f"abs err {max(map_errs):.3e}, batch images equal")
    for label, t in times.items():
        d, c, lp, pr = t["single"], t["call"], t["loop"], t["profiler"]
        say(f"K1 at {label.upper()} 384x1280 cell 16, median device time of one launch: fused "
            f"{d['fused']:.4f} ms, map entry {d['map']:.4f}, map route (map entry + torch cell_reduce) "
            f"{d['map_route']:.4f} ms, plain pair {d['plain']:.4f} ms, plain map {d['map_plain']:.4f}; "
            f"loop-timed (calls per loop {t['loop_calls']}): fused {lp['fused']:.5f} ms, map entry "
            f"{lp['map']:.5f}, map route {lp['map_route']:.5f}, plain pair {lp['plain']:.5f}, plain map "
            f"{lp['map_plain']:.5f}; torch.profiler per call: fused {_ms(pr['fused'])}, map entry "
            f"{_ms(pr['map'])}; bound {t['bound'][0]:.5f} ms ({t['bound'][1]}), map entry's "
            f"{t['map_bound'][0]:.5f} ms ({t['map_bound'][1]}); with the launch from Python: fused "
            f"{c['fused']:.4f}, map route {c['map_route']:.4f}, plain {c['plain']:.4f} ms")

    def measures(t, name, plain):
        return {"ms": t["loop"][name], "plain_ms": t["loop"][plain],
                "loop_calls": {name: t["loop_calls"][name], plain: t["loop_calls"][plain]},
                "single_launch_ms": t["single"][name],
                "plain_single_launch_ms": t["single"][plain], "profiler_ms": t["profiler"][name],
                "call_ms": t["call"][name]}

    return {
        "fused": {"max_abs_err": max(errs[:-1]), "bound": t1["bound"], **measures(t1, "fused", "plain"),
                  "map_route_ms": t1["loop"]["map_route"], "near_tie_cells": near, "best_bitwise": bitwise},
        "map": {"max_abs_err": max(map_errs), "bound": t1["map_bound"], **measures(t1, "map", "map_plain")},
        "batched": {"max_abs_err": errs[-1], "bound": t8["bound"], **measures(t8, "fused", "plain"),
                    "map_route_ms": t8["loop"]["map_route"]},
    }


def _ms(x):
    return "not recorded" if x is None else f"{x:.5f} ms"


def _random_label_inputs(torch, gen, K, hp, wp, H, W):
    """Entry B's random case: NCHW-view prototypes, boxes crossing the
    image border and each other, a fifth of the rows invalid (their
    coefficients NaN, which the kernel must never read), rows 1 and 3
    overlapping with equal scores."""
    proto = torch.randn((1, 32, hp, wp), generator=gen, device="cuda").permute(0, 2, 3, 1)[0]
    coef = torch.randn((K, 32), generator=gen, device="cuda")
    size = torch.tensor([W, H], dtype=torch.float32, device="cuda")
    c = (torch.rand((K, 2), generator=gen, device="cuda") * 1.2 - 0.1) * size
    wh = (torch.rand((K, 2), generator=gen, device="cuda") * 0.55 + 0.05) * size
    boxes = torch.cat([c - wh / 2, c + wh / 2], 1)
    boxes[3] = boxes[1] + 5.0
    scores = torch.rand((K,), generator=gen, device="cuda") * 0.7 + 0.3
    scores[3] = scores[1]
    valid = torch.rand((K,), generator=gen, device="cuda") > 0.2
    valid[[1, 3]] = True
    coef[~valid] = float("nan")
    return proto, coef, boxes.contiguous(), torch.where(valid, scores, 0.0), valid


def compare_labels(torch, mc, got, proto, coef, boxes, scores, valid, out_hw, box_pad):
    """Entry B's label image against its plain version under the K2_NEAR
    rule -> (pixels differing, pixels near the threshold, largest |label
    difference| away from it, which must be 0)."""
    import torch.nn.functional as F

    ref = mc.mask_label_reference(proto, coef, boxes, scores, valid, out_hw, box_pad=box_pad)
    low = mc.mask_combine_reference(proto, coef)
    vals = F.interpolate(low[None], size=tuple(out_hw), mode="bilinear", align_corners=False)[0]
    inside = mc.crop_threshold(torch.ones_like(low), boxes, valid, out_hw, 0.0, box_pad)
    near = (((vals - 0.5).abs() <= K2_NEAR) & inside).any(0)
    differ = got != ref
    away = int((got - ref).abs()[~near].max()) if bool((~near).any()) else 0
    n_near = int(near.sum())
    if away or n_near > K2_NEAR_SHARE * near.numel():
        raise AssertionError(f"K2 entry B vs plain at {tuple(proto.shape)} -> {tuple(out_hw)}, pad {box_pad}: "
                             f"{int((differ & ~near).sum())} pixels differ away from the threshold, "
                             f"{n_near} near it")
    return int(differ.sum()), n_near, away


def k2_label_bound(boxes, valid, proto_shape, K, out_hw, box_pad):
    """Entry B's bound for these inputs. Bytes: the detection table read
    once, the label image written once, and of the prototypes only the
    pixels the label needs: those the interpolation reads for some output
    pixel inside a valid detection's padded box (its source rows and columns
    and the one beyond them, clipped to the prototype), counted once however
    many boxes cover them. Operations only inside each valid detection's
    padded box: the product and sigmoid over the prototype pixels under it,
    the interpolation and tests over its output pixels."""
    import math

    Hp, Wp, nm = proto_shape
    H, W = out_hw

    def src(scale, d):          # F.interpolate's source index, align_corners=False
        return max((d + 0.5) * scale - 0.5, 0.0)

    needed = [[False] * Wp for _ in range(Hp)]
    n_out = 0
    for (x1, y1, x2, y2), v in zip(boxes.tolist(), valid.tolist()):
        if not v:
            continue
        ox0, ox1 = max(math.ceil(x1 - box_pad), 0), min(math.floor(x2 + box_pad), W - 1)
        oy0, oy1 = max(math.ceil(y1 - box_pad), 0), min(math.floor(y2 + box_pad), H - 1)
        if ox1 < ox0 or oy1 < oy0:
            continue
        n_out += (ox1 - ox0 + 1) * (oy1 - oy0 + 1)
        lx0, lx1 = int(src(Wp / W, ox0)), min(int(src(Wp / W, ox1)) + 1, Wp - 1)
        ly0, ly1 = int(src(Hp / H, oy0)), min(int(src(Hp / H, oy1)) + 1, Hp - 1)
        for row in needed[ly0:ly1 + 1]:
            row[lx0:lx1 + 1] = [True] * (lx1 - lx0 + 1)
    n_needed = sum(map(sum, needed))
    n_low = n_out * (Hp * Wp) / (H * W)
    nbytes = 4 * nm * n_needed + K * (4 * nm + 16 + 4 + 1) + 4 * H * W
    return bound_ms(nbytes, n_low * (2 * nm + 4) + n_out * K2B_OPS_PER_PIXEL)


K2_V3_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "ab_torch_k2_v3.cu")


def k2_v3_route(torch, lib_path):
    """K2 v3's launch (the kernel before its redesign, kept verbatim in
    scripts/ab_torch_k2_v3.cu, built by _build from its absolute path):
    contiguous (Hp, Wp, nm) prototypes, contiguous (K, nm) coefficients ->
    (K, Hp, Wp) sigmoid masks."""
    import ctypes

    fn = ctypes.CDLL(str(lib_path)).dyno_mask_combine_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(proto, coef):
        Hp, Wp, nm = proto.shape
        out = torch.empty((coef.shape[0], Hp, Wp), dtype=torch.float32, device=proto.device)
        err = fn(proto.data_ptr(), coef.data_ptr(), out.data_ptr(), Hp * Wp, coef.shape[0], nm,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"v3 launch failed: cudaError_t {err}")
        return out
    return run


def unfused_label_route(v3):
    """The detector's label image before entry B: the prototypes copied to
    NHWC, v3, then torch's upsample, crop, threshold and label argmax."""
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc

    def run(proto, coef, boxes, scores, valid, out_hw, mask_threshold=0.5, box_pad=0.0):
        low = v3(proto.contiguous(), coef)
        return mc.label_image(mc.crop_threshold(low, boxes, valid, out_hw, mask_threshold, box_pad), scores)
    return run


def fixture_label_inputs(torch, pp):
    """Entry B's inputs at the fixture detector's frame 0: the engine of the
    detected-masks accuracy run (the committed checkpoint at the fixture's
    96x320, score DET_ACC_SCORE) on the fixture's frame 0 read from disk
    -> (prototypes, coefficients, boxes, scores, valid)."""
    from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine

    rgb = KittiDataProvider(KITTI_FIXTURE, device="cuda").frame(0).rgb
    engine = YoloV8DetectorEngine(input_hw=DET_ACC_HW, score_threshold=DET_ACC_SCORE, device="cuda")
    with torch.no_grad():
        out = engine.model(rgb[None])
        single = {k: [a[0] for a in v] if isinstance(v, list) else v[0] for k, v in out.items()}
        det = pp.nms(*pp.decode_all(single), max_detections=engine.max_detections,
                     score_threshold=engine.score_threshold, iou_threshold=engine.iou_threshold,
                     class_ids=engine.class_ids)
    return single["proto"], det.mcoef, det.boxes, det.scores, det.valid


def check_k2(torch, seed, v3_lib):
    """Phase 4: both entries of K2 against their plain versions, and their
    times beside v3's (the kernel before this redesign, built from
    K2_V3_SOURCE, built at `v3_lib`), the plain versions' and the cuBLAS
    product's -> {"combine": entry A's row, "label": entry B's row}."""
    from dynosam_tpu_torch.bench_config import detector_config, detector_scene
    from dynosam_tpu_torch.nn import postprocess as pp
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc

    v3 = k2_v3_route(torch, v3_lib)
    unfused = unfused_label_route(v3)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def compare(proto, coef):
        out = mc.mask_combine(proto, coef)
        ref = mc.mask_combine_reference(proto, coef)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= K2_ATOL:
            raise AssertionError(f"K2 vs plain at {tuple(coef.shape)} x {tuple(proto.shape)} "
                                 f"(strides {proto.stride()}): max abs err {err}")
        return err

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # entry A
    proto, coef = randn(96, 160, 32), randn(32, 32)
    err_rand = compare(proto, coef)
    err_ragged = compare(randn(37, 61, 32), randn(5, 32))
    proto_nchw = randn(1, 32, 96, 160).permute(0, 2, 3, 1)[0]
    err_nchw = max(compare(proto_nchw, coef), compare(randn(1, 32, 37, 61).permute(0, 2, 3, 1)[0], randn(5, 32)))
    err_v3 = float((v3(proto, coef) - mc.mask_combine_reference(proto, coef)).abs().max())

    # the real inputs: prototypes (as the network returns them) and the NMS
    # survivors of the detector scene's frame 0
    _, intr = detector_config()
    rgb = detector_scene(intr, 1, device="cuda").frame(0).rgb
    engine = YoloV8DetectorEngine(device="cuda")
    with torch.no_grad():
        out = engine.model(rgb[None])
        single = {k: [a[0] for a in v] if isinstance(v, list) else v[0] for k, v in out.items()}
        det = pp.nms(*pp.decode_all(single), max_detections=engine.max_detections,
                     score_threshold=engine.score_threshold, iou_threshold=engine.iou_threshold,
                     class_ids=engine.class_ids)
    real_proto = single["proto"]
    err_real = compare(real_proto, det.mcoef)
    err_a = max(err_rand, err_ragged, err_nchw, err_real)

    # entry B: random, ragged, the real frame, and at the shape of the
    # detected-masks accuracy run (the engine at the fixture's 96x320, 24x80
    # prototypes) random inputs and the fixture detector's frame 0, where
    # the checkpoint finds nothing (no valid row: an all-background label
    # image); box_pad 0 and 2
    out_hw = (384, 640)
    fixture_inputs = fixture_label_inputs(torch, pp)
    cases = {"random (32, 96x160 -> 384x640)": _random_label_inputs(torch, gen, 32, 96, 160, *out_hw),
             "ragged (5, 37x61 -> 148x244)": _random_label_inputs(torch, gen, 5, 37, 61, 148, 244),
             "detector frame 0": (real_proto, det.mcoef, det.boxes, det.scores, det.valid),
             "random (32, 24x80 -> 96x320)": _random_label_inputs(torch, gen, 32, 24, 80, *DET_ACC_HW),
             f"fixture detector frame 0 ({int(fixture_inputs[4].sum())} valid, 24x80 -> 96x320)": fixture_inputs}
    hw = {"ragged (5, 37x61 -> 148x244)": (148, 244)}
    hw.update({name: DET_ACC_HW for name in cases if "96x320" in name})
    label_lines, n_differ, n_near, away = [], 0, 0, 0
    for name, args in cases.items():
        for pad in (0.0, 2.0):
            got = mc.mask_label(*args, hw.get(name, out_hw), box_pad=pad)
            d, nn_, a = compare_labels(torch, mc, got, *args, hw.get(name, out_hw), pad)
            n_differ, n_near, away = n_differ + d, n_near + nn_, max(away, a)
            label_lines.append(f"{name} pad {pad:g}: {d} differ, {nn_} near")
    rnd = cases["random (32, 96x160 -> 384x640)"]

    # times at (32, 96x160, 32) for A, at the detector's frame 0 for B
    proto2d = proto.reshape(-1, proto.shape[-1])
    ta = kernel_times(torch, {
        "v4": lambda: mc.mask_combine(proto, coef),
        "v4_nchw": lambda: mc.mask_combine(proto_nchw, coef),
        "v3": lambda: v3(proto, coef),
        "plain": lambda: mc.mask_combine_reference(proto, coef),
        # the library yardstick: the cuBLAS product alone, no sigmoid
        "library": lambda: coef @ proto2d.T}, routes={"plain": 200})
    real = (real_proto, det.mcoef, det.boxes, det.scores, det.valid, out_hw)
    tb = kernel_times(torch, {
        "entry_b": lambda: mc.mask_label(*real),
        "unfused_route": lambda: unfused(*real),
        "plain": lambda: mc.mask_label_reference(*real),
        "entry_b_random32": lambda: mc.mask_label(*rnd, out_hw),
        "unfused_route_random32": lambda: unfused(*rnd, out_hw)},
        routes={"unfused_route": 25, "plain": 25, "unfused_route_random32": 25})
    K, nm = coef.shape
    P = proto.shape[0] * proto.shape[1]
    # coef, proto read once and the masks written once; 2 K nm flops per
    # mask pixel for the product and 4 for the sigmoid
    bound_a = bound_ms(4 * (K * nm + P * nm + K * P), 2 * K * nm * P + 4 * K * P)
    bound_b = k2_label_bound(det.boxes, det.valid, tuple(real_proto.shape), det.mcoef.shape[0], out_hw, 0.0)
    bound_rnd = k2_label_bound(rnd[2], rnd[4], tuple(rnd[0].shape), rnd[1].shape[0], out_hw, 0.0)
    s1, lp, pr, c = ta["single"], ta["loop"], ta["profiler"], ta["call"]
    say(f"K2 entry A (v4) matches plain: max abs err random (32, 96x160, 32) {err_rand:.3e}, ragged "
        f"(5, 37x61, 32) {err_ragged:.3e}, NCHW views {err_nchw:.3e}, detector frame 0 "
        f"{tuple(det.mcoef.shape)} x {tuple(real_proto.shape)} strides {real_proto.stride()} "
        f"{err_real:.3e} (bound {K2_ATOL}); v3 {err_v3:.3e}")
    say(f"K2 entry A at (32, 96x160, 32), loop-timed (calls per loop {ta['loop_calls']}): v4 {lp['v4']:.5f} ms "
        f"(NCHW view {lp['v4_nchw']:.5f}), v3 {lp['v3']:.5f}, plain {lp['plain']:.5f}, cuBLAS product "
        f"coef @ proto^T alone {lp['library']:.5f}; one launch: v4 {s1['v4']:.5f} (NCHW {s1['v4_nchw']:.5f}), "
        f"v3 {s1['v3']:.5f}, plain {s1['plain']:.5f}, cuBLAS {s1['library']:.5f}; torch.profiler per call: "
        f"v4 {_ms(pr['v4'])}, v3 {_ms(pr['v3'])}, cuBLAS {_ms(pr['library'])}; bound {bound_a[0]:.5f} ms "
        f"({bound_a[1]}); with the launch from Python v4 {c['v4']:.4f} ms, v3 {c['v3']:.4f}, "
        f"plain {c['plain']:.4f}")
    s1, lp, pr, c = tb["single"], tb["loop"], tb["profiler"], tb["call"]
    say(f"K2 entry B (label image) matches plain: {n_differ} pixels differ, all within {K2_NEAR:g} of the "
        f"threshold, {n_near} such pixels over {len(label_lines)} cases ({'; '.join(label_lines)})")
    say(f"K2 entry B at the detector's frame 0 ({int(det.valid.sum())} valid of {det.valid.numel()}, "
        f"96x160 -> 384x640), loop-timed (calls per loop {tb['loop_calls']}): entry B {lp['entry_b']:.5f} ms, "
        f"unfused route (v3 + copy + torch upsample/crop/threshold + label) {lp['unfused_route']:.5f}, "
        f"plain {lp['plain']:.5f}; one launch: "
        f"entry B {s1['entry_b']:.5f}, unfused route {s1['unfused_route']:.5f}, plain {s1['plain']:.5f}; "
        f"torch.profiler per call: entry B {_ms(pr['entry_b'])}; "
        f"bound {bound_b[0]:.5f} ms ({bound_b[1]}); with the launch from Python entry B "
        f"{c['entry_b']:.4f} ms, unfused route {c['unfused_route']:.4f}; random 32 detections: entry B "
        f"{lp['entry_b_random32']:.5f} ms loop-timed, unfused route {lp['unfused_route_random32']:.5f}, "
        f"bound {bound_rnd[0]:.5f} ms ({bound_rnd[1]})")
    return {
        "combine": {"max_abs_err": err_a, "ms": ta["loop"]["v4"], "plain_ms": ta["loop"]["plain"],
                    "loop_calls": ta["loop_calls"],
                    "library_ms": ta["loop"]["library"], "bound": bound_a,
                    "single_launch_ms": ta["single"]["v4"], "plain_single_launch_ms": ta["single"]["plain"],
                    "library_single_launch_ms": ta["single"]["library"], "profiler_ms": ta["profiler"]["v4"],
                    "nchw_view_ms": ta["loop"]["v4_nchw"], "v3_ms": ta["loop"]["v3"],
                    "v3_single_launch_ms": ta["single"]["v3"], "call_ms": ta["call"]["v4"]},
        "label": {"max_abs_err": away, "max_abs_err_of": "|label - plain label| away from the K2_NEAR band",
                  "ms": tb["loop"]["entry_b"], "plain_ms": tb["loop"]["plain"], "loop_calls": tb["loop_calls"],
                  "bound": bound_b, "single_launch_ms": tb["single"]["entry_b"],
                  "plain_single_launch_ms": tb["single"]["plain"], "profiler_ms": tb["profiler"]["entry_b"],
                  "unfused_route_ms": tb["loop"]["unfused_route"],
                  "unfused_route_single_launch_ms": tb["single"]["unfused_route"],
                  "call_ms": tb["call"]["entry_b"], "pixels_differing": n_differ,
                  "pixels_near_threshold": n_near, "random32_ms": tb["loop"]["entry_b_random32"],
                  "random32_bound_ms": bound_rnd[0]},
    }


def rot_trans_err(torch, lie, A, B):
    """(rotation angle, translation distance) between poses A and B."""
    dR = lie.mm(A[..., :3, :3].transpose(-1, -2), B[..., :3, :3])
    rot = torch.linalg.norm(lie.so3_log(dR), dim=-1)
    trans = torch.linalg.norm(A[..., :3, 3] - B[..., :3, 3], dim=-1)
    return rot, trans


def _drive(torch, step, state, frames, device, per_frame=None, after=None):
    """Run the step over the frames; -> (outputs, host seconds per frame).
    `after(state)`, called untimed after each step, adds its result to the
    frame's outputs under "after"."""
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
        if after is not None:
            out = {**out, "after": after(state)}
        outs.append(out)
    for k, out in enumerate(outs):
        for name, v in out.items():
            if torch.is_tensor(v) and v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"frame {k}: non-finite {name}")
        if out["X_world_cam"].device.type != device:
            raise AssertionError("main path left the card")
    return outs, times


def compare_to_reference(torch, lie, outs, ref, device, bounds=None, settled_only=False):
    """Camera poses and object motions against a JAX reference file ->
    (pose trans, pose rot, motions compared, motion err) maxima, held to
    `bounds` (trans m, rot rad, motion m; default the bench path's). With
    `settled_only`, a motion is compared only where its object's motion was
    also valid at the frame before (on both sides)."""
    import numpy as np

    trans_b, rot_b, motion_b = bounds or (REF_TRANS_M, REF_ROT_RAD, REF_MOTION_TRANS_M)
    X = torch.stack([o["X_world_cam"] for o in outs])
    X_ref = torch.as_tensor(ref["X_world_cam"], device=device)
    rot, trans = rot_trans_err(torch, lie, X, X_ref)
    if float(trans.max()) > trans_b or float(rot.max()) > rot_b:
        raise AssertionError(f"camera vs JAX reference: {float(trans.max())} m, {float(rot.max())} rad")
    ids = torch.stack([o["object_ids"] for o in outs]).cpu().numpy()
    valid = torch.stack([o["object_motion_valid"] for o in outs]).cpu().numpy()
    H = torch.stack([o["object_motions"] for o in outs]).cpu().numpy()
    both = valid & ref["object_motion_valid"] & (ids == ref["object_ids"])
    if settled_only:
        both[1:] &= both[:-1]
        both[0] = False
    n_motions = int(both.sum())
    if n_motions == 0:
        raise AssertionError("no object motion valid in both the port and the JAX reference")
    mot_err = np.linalg.norm(H[..., :3, 3] - ref["object_motions"][..., :3, 3], axis=-1)[both]
    if float(mot_err.max()) > motion_b:
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


def pipelined_readings(torch, seed, ref_path, device="cuda"):
    """The pipelined fused step (make_fused_step(..., pipelined=True)) at
    bench_config over the first PIPELINED_FRAMES bench frames -> (launches, readings against the
    ground truth and the JAX reference, per-frame host seconds, device ops
    and busy ms per advancing frame (None off the card))."""
    import numpy as np

    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step
    from dynosam_tpu_torch.utils import lie

    cfg, intr = bench_config()
    scene = bench_scene(intr, PIPELINED_FRAMES, device=device)
    frames, X_gt = scene.frames(), scene.scn.X_gt
    step = make_fused_step(cfg, intr, torch.Generator(device=device).manual_seed(seed), pipelined=True)
    held = {"n": 0}

    def after(state):
        held["n"] += 1
        if held["n"] == PIPELINED_FRAMES - 1:
            held["before_last"] = state

    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    outs, times = _drive(torch, step, init_pipeline_state(cfg, device), frames, device, after=after)
    launches = {"K1": st.shi_tomasi_cell_max.launches, "K1 map": st.shi_tomasi_response.launches}
    if device == "cuda" and (launches["K1"], launches["K1 map"]) != (PIPELINED_FRAMES, 0):
        raise AssertionError(f"pipelined: fused K1 launched {launches['K1']} times and the map entry "
                             f"{launches['K1 map']} times over {PIPELINED_FRAMES} frames")
    rot, trans = rot_trans_err(torch, lie, torch.stack([o["X_world_cam"] for o in outs]), X_gt)
    rd = {"gt_m": float(trans.max()), "gt_rad": float(rot.max())}
    rd["ref_m"], rd["ref_rad"], rd["n_motions"], rd["motion_m"] = compare_to_reference(
        torch, lie, outs, {k: v[:PIPELINED_FRAMES] for k, v in np.load(ref_path).items()}, device,
        bounds=(np.inf,) * 3)
    ops = busy = None
    if device == "cuda":
        # the last frame again under the profiler: its event processing
        # takes ~15 s per profiled frame on the card's host (phase 14)
        ops, busy, _ = profile_frames(torch, step, held["before_last"], frames[-1:])
    return launches, rd, times, ops, busy


def run_pipelined_path(torch, seed, ref_path, device="cuda"):
    """Phase 5b: the pipelined fused step over the bench frames, held to
    the bench path's bounds -> launches."""
    launches, rd, times, ops, busy = pipelined_readings(torch, seed, ref_path, device)
    checks = {"gt_m": GT_TRANS_M, "gt_rad": GT_ROT_RAD, "ref_m": REF_TRANS_M, "ref_rad": REF_ROT_RAD,
              "motion_m": REF_MOTION_TRANS_M}
    over = {k: (rd[k], v) for k, v in checks.items() if not rd[k] <= v}
    if over:
        raise AssertionError(f"pipelined: readings over their bounds (reading, bound): {over}")
    steady = statistics.median(times[10:])
    idle = None if busy is None else 1.0 - busy / (steady * 1e3)
    say(f"pipelined path: make_fused_step(pipelined=True) over {PIPELINED_FRAMES} frames of bench_config on "
        f"{device}, fused K1 launches {launches['K1']}, map entry {launches['K1 map']}; camera vs GT max "
        f"{rd['gt_m']:.2e} m / {rd['gt_rad']:.2e} rad; vs JAX ref max {rd['ref_m']:.2e} m / "
        f"{rd['ref_rad']:.2e} rad; {rd['n_motions']} object motions vs JAX ref max {rd['motion_m']:.2e} m; "
        f"first frame {times[0] * 1e3:.1f} ms, median advancing frames 11-{PIPELINED_FRAMES} "
        f"{steady * 1e3:.2f} ms; device ops per advancing frame {ops if ops is not None else 'n/a'}, device "
        f"busy {f'{busy:.2f}' if busy is not None else 'n/a'} ms, idle "
        f"{f'{idle:.1%}' if idle is not None else 'n/a'} of the step")
    return launches


def klt_readings(torch, seed, ref_path, device="cuda", stereo_imu=False, tracked=False):
    """The fused step tracking by KLT on the world-textured bench scene; with
    stereo_imu, under stereo_imu_config() on frames that carry a right
    image, a corrupted depth and an IMU window; with `tracked` on
    bench_config.tracked_scene, rendered on the host as its reference's
    frames were -> (launches, readings against the ground truth and the JAX
    reference, the phase's line)."""
    import numpy as np

    from dynosam_tpu_torch import bench_config as bc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step
    from dynosam_tpu_torch.utils import lie

    n = STEREO_IMU_FRAMES if stereo_imu else KLT_FRAMES
    name = ("stereo_imu" if stereo_imu else "klt") + ("_tracked" if tracked else "")
    cfg, intr = bc.stereo_imu_config() if stereo_imu else bc.bench_klt_config()
    if tracked:
        scene = bc.tracked_scene(intr, n, device="cpu")
    else:
        scene = bc.bench_scene(intr, n, device=device, world_texture=True)
    frames = [(bc.stereo_imu_frame(scene, k, IMU_SAMPLES) if stereo_imu else scene.frame(k)).to(device)
              for k in range(n)]
    X_gt = scene.scn.X_gt.to(device)
    step = make_fused_step(cfg, intr, torch.Generator(device=device).manual_seed(seed))
    state = init_pipeline_state(cfg, device, image_shape=(intr.height, intr.width))

    def after(state):
        trk = state.frontend.tracker
        return trk.s_valid.sum(), trk.d_valid.sum(), trk.s_uv.clone(), trk.s_depth.clone(), trk.s_valid.clone()

    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    with SyncCounter(torch, device) as sync:
        outs, times = _drive(torch, step, state, frames, device, after=after)
    launches, map_launches = st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches
    if device == "cuda" and (launches, map_launches) != (n, 0):
        raise AssertionError(f"{name}: fused K1 launched {launches} times and the map entry "
                             f"{map_launches} times over {n} frames")
    # the driver's own per-frame synchronize() calls are not the program's
    sites = {k: v for k, v in sync.sites.items() if not k.startswith("chip_smoke.py")}
    syncs = None if sync.count is None else sum(sites.values())

    ref = np.load(ref_path)
    if tracked and (float(ref["ground_y"]), float(ref["forward_m"])) != (bc.TRACKED_GROUND_Y, bc.TRACKED_FORWARD_M):
        raise AssertionError(f"{name}: {ref_path} holds another scene ({float(ref['ground_y'])} m up, "
                             f"{float(ref['forward_m'])} m per frame)")
    X = torch.stack([o["X_world_cam"] for o in outs])
    rot, trans = rot_trans_err(torch, lie, X, X_gt)
    rot_r, trans_r = rot_trans_err(torch, lie, torch.as_tensor(ref["X_world_cam"], device=device), X_gt)
    got_counts = np.array([[int(o["after"][0]), int(o["after"][1])] for o in outs])
    ref_counts = np.stack([ref["n_static"], ref["n_dynamic"]], -1)
    rd = {"gt_m": float(trans.max()), "gt_rad": float(rot.max()),
          "ref_gt_m": float(trans_r.max()), "ref_gt_rad": float(rot_r.max()),
          # how far past the reference's own error to the ground truth
          "gt_excess_m": float((trans - trans_r).max()), "gt_excess_rad": float((rot - rot_r).max()),
          "count_rel": float((np.abs(got_counts - ref_counts) / np.maximum(ref_counts, 1)).max())}
    rd["ref_m"], rd["ref_rad"], rd["n_motions"], rd["motion_m"] = compare_to_reference(
        torch, lie, outs, ref, device, bounds=(np.inf,) * 3)
    if stereo_imu:
        # valid static tracks: median relative depth error over frames 1..,
        # against the uncorrupted depth
        errs = []
        for k, o in enumerate(outs[1:], start=1):
            _, _, uv, depth, valid = o["after"]
            true_depth, _ = scene._depth_mask(scene.scn.X_gt[k], [L[k] for L in scene.scn.L_gt])
            true_depth = true_depth.to(device)
            H, W = true_depth.shape
            iu = torch.clamp(torch.round(uv[:, 0]).long(), 0, W - 1)
            iv = torch.clamp(torch.round(uv[:, 1]).long(), 0, H - 1)
            gt = true_depth[iv, iu]
            sel = valid & (depth > 0)
            errs.append((torch.abs(depth - gt) / gt)[sel])
        errs = torch.cat(errs)
        rd["depth_tracks"] = int(errs.numel())
        rd["depth_relerr"] = float(torch.median(errs)) if errs.numel() else float("inf")
    line = (f"{name} path: {n} frames of {'stereo_imu_config' if stereo_imu else 'bench_klt_config'} "
        f"(KLT + CLAHE{', stereo, IMU rotation prior' if stereo_imu else ''}) on {frames[0].depth.device}"
        + (f", tracked_scene ({bc.TRACKED_GROUND_Y} m up, {bc.TRACKED_FORWARD_M} m per frame, rendered on the "
           f"host)" if tracked else "") + ", "
        f"fused K1 launches {launches}, map entry {map_launches}; camera vs GT max {rd['gt_m']:.2e} m / "
        f"{rd['gt_rad']:.2e} rad (the JAX ref's own {rd['ref_gt_m']:.2e} m / {rd['ref_gt_rad']:.2e} rad, "
        f"the port at most {rd['gt_excess_m']:.2e} m / {rd['gt_excess_rad']:.2e} rad past it in any frame); vs JAX ref max {rd['ref_m']:.2e} m / {rd['ref_rad']:.2e} rad; "
        f"{rd['n_motions']} object motions vs JAX ref max {rd['motion_m']:.2e} m; valid track counts "
        f"vs JAX ref within {rd['count_rel']:.2%} (static {got_counts[-1, 0]} / {ref_counts[-1, 0]}, "
        f"dynamic {got_counts[-1, 1]} / {ref_counts[-1, 1]} at the last frame)"
        + (f"; static track depths ({rd['depth_tracks']} over frames 1-{n - 1}) median relative "
           f"error {rd['depth_relerr']:.3%} against the true depth (provided depth off by 15%)"
           if stereo_imu else "")
        + f"; first frame {times[0] * 1e3:.1f} ms, median frame {statistics.median(times[1:]) * 1e3:.2f} "
        f"ms, host syncs {syncs if syncs is not None else 'n/a'} = "
        f"{syncs / n if syncs is not None else float('nan'):.1f}/frame (sites: "
        f"{', '.join(f'{k} x{v}' for k, v in sorted(sites.items(), key=lambda kv: -kv[1])) or 'n/a'})")
    return {"K1": launches, "K1 map": map_launches}, rd, line


def run_klt_path(torch, seed, ref_path, device="cuda", stereo_imu=False, tracked=False):
    """Phases 6 and 7 (and, `tracked`, 6t and 7t): klt_readings held to
    KLT_REF_BOUNDS (TRACKED_REF_BOUNDS), the ground truth (past the
    reference's own error) and, with stereo, the depth repair -> launches."""
    launches, rd, line = klt_readings(torch, seed, ref_path, device, stereo_imu, tracked)
    name = "stereo_imu" if stereo_imu else "klt"
    b = (TRACKED_REF_BOUNDS if tracked else KLT_REF_BOUNDS)[name]
    checks = {"ref_m": b["ref_m"], "ref_rad": b["ref_rad"], "motion_m": b["motion_m"],
              "count_rel": b["count_rel"], "gt_excess_m": max(GT_TRANS_M, b["ref_m"]),
              "gt_excess_rad": max(GT_ROT_RAD, b["ref_rad"])}
    if stereo_imu:
        checks["depth_relerr"] = STEREO_DEPTH_RELERR
    over = {k: (rd[k], v) for k, v in checks.items() if not rd[k] <= v}
    if over:
        raise AssertionError(f"{name}: readings over their bounds (reading, bound): {over}")
    say(line)
    return launches


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
    mc.mask_combine.launches = mc.mask_label.launches = 0
    outs, times = _drive(torch, step, state, frames, device, per_frame=detect)
    launches = {"K1": st.shi_tomasi_cell_max.launches, "K2": mc.mask_combine.launches,
                "K2 label": mc.mask_label.launches, "K1 map": st.shi_tomasi_response.launches}
    if device == "cuda" and launches != {"K1": DET_FRAMES, "K2": 0, "K2 label": DET_FRAMES, "K1 map": 0}:
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
        f"{frames[0].depth.device}, fused K1 launches {launches['K1']}, K2 label entry "
        f"{launches['K2 label']}, K2 entry A {launches['K2']}, K1 map entry {launches['K1 map']}; "
        f"{n_det} valid detections as in the JAX ref, boxes within {box_err:.2e} px, scores "
        f"{score_err:.2e}; label images agree on >= {agree:.6f} of pixels; object ids equal; "
        f"camera vs JAX ref max {tr:.2e} m / {rr:.2e} rad; {n_mot} object motions vs JAX ref max "
        f"{mot:.2e} m; first frame {times[0] * 1e3:.1f} ms, median frames 2-{DET_FRAMES} "
        f"{statistics.median(times[1:]) * 1e3:.2f} ms")
    return launches


def heldout_readings(torch, ref, device="cuda"):
    """The checkpoint's held-out evaluation on the port (48 scenes, at most
    8 detections, score 0.25) against the JAX run in `ref` -> (result of
    eval/detector_heldout.py, readings, launches, seconds)."""
    import numpy as np

    from dynosam_tpu_torch.eval import detector_heldout as dh
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc

    engine = dh.make_engine(device)
    mc.mask_combine.launches = mc.mask_label.launches = 0
    t0 = time.perf_counter()
    res = dh.evaluate(HELDOUT_SCENES, device=device, engine=engine)
    dt = time.perf_counter() - t0
    launches = {"K2": mc.mask_combine.launches, "K2 label": mc.mask_label.launches}
    same = res["instances"] == int(ref["instances"]) and (res["scene"] == ref["scene"]).all() \
        and (res["frame"] == ref["frame"]).all()
    rd = {"instances": res["instances"], "same_instances": bool(same),
          "mean_iou": res["mean_mask_iou"], "class_accuracy": res["class_accuracy"],
          "mean_iou_err": abs(res["mean_mask_iou"] - float(ref["mean_mask_iou"])),
          "class_acc_err": abs(res["class_accuracy"] - float(ref["class_accuracy"])),
          "instance_iou_err": float(np.abs(res["iou"] - ref["iou"]).max()) if same else float("inf"),
          "class_hits_differ": int((res["class_hit"] != ref["class_hit"]).sum()) if same else -1}
    return res, rd, launches, dt


def run_heldout_path(torch, ref_path, device="cuda"):
    """Phase 8b: the committed checkpoint's held-out numbers on the card,
    each frame's label image from K2's entry B, held to the JAX run
    det_heldout_ref_48.npz -> launches."""
    import numpy as np

    ref = np.load(ref_path)
    res, rd, launches, dt = heldout_readings(torch, ref, device)
    if device == "cuda" and launches != {"K2": 0, "K2 label": HELDOUT_SCENES}:
        raise AssertionError(f"held-out: kernel launches {launches} over {HELDOUT_SCENES} scenes")
    if not (rd["same_instances"] and rd["mean_iou_err"] <= HELDOUT_MEAN_IOU
            and rd["class_acc_err"] <= HELDOUT_CLASS_ACC):
        raise AssertionError(f"held-out detector numbers vs the JAX run: {rd}")
    say(f"held-out detector: {HELDOUT_SCENES} scenes through the engine on {device}, K2 label entry "
        f"{launches['K2 label']} launches, entry A {launches['K2']}; {rd['instances']} instances as in the "
        f"JAX run ({int(ref['instances'])}), mean mask IoU {rd['mean_iou']:.6f} (JAX {float(ref['mean_mask_iou']):.6f}, "
        f"checkpoint json {float(ref['json_mean_mask_iou']):.6f}; |diff| {rd['mean_iou_err']:.2e}), class "
        f"accuracy {rd['class_accuracy']:.6f} (JAX {float(ref['class_accuracy']):.6f}, json "
        f"{float(ref['json_class_accuracy']):.6f}; {rd['class_hits_differ']} hits differ), largest instance "
        f"IoU |diff| {rd['instance_iou_err']:.2e}; mean detected IoU {res['mean_detected_iou']:.6f}, missed "
        f"{res['missed_rate']:.4f}; {dt:.1f} s")
    return launches


class SyncCounter:
    """Counts the host-device synchronizations inside a `with` block:
    torch's sync debug mode warns on each one, and the warnings are
    recorded (on a CUDA device; elsewhere the count stays None)."""

    def __init__(self, torch, device):
        self.torch, self.on = torch, torch.device(device).type == "cuda"
        self.count = None
        self.sites = {}     # "file:line" of the Python call that synchronized -> count

    def __enter__(self):
        import warnings

        if self.on:
            self._catch = warnings.catch_warnings(record=True)
            self._seen = self._catch.__enter__()
            warnings.simplefilter("always")
            self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on:
            self.torch.cuda.set_sync_debug_mode("default")
            self._catch.__exit__(*exc)
            root = os.path.dirname(os.path.abspath(__file__))
            syncs = [w for w in self._seen if "synchroniz" in str(w.message)]
            self.count = len(syncs)
            for w in syncs:
                site = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
                self.sites[site] = self.sites.get(site, 0) + 1
        return False

    def top(self, n=6):
        return ", ".join(f"{k} x{v}" for k, v in sorted(self.sites.items(), key=lambda kv: -kv[1])[:n])


def _device_types(obj):
    import dataclasses

    return {f.name: getattr(obj, f.name).device.type for f in dataclasses.fields(obj)
            if hasattr(getattr(obj, f.name), "device")}


def kitti_run(torch, cfg, out_dir, device, seed, frames=PIPE_FRAMES, root=KITTI_FIXTURE, on_frame=None):
    """One run of the port's entry-point code (run_dynosam.open_dataset +
    build_pipeline + DynoPipeline.run) over the first `frames` frames of
    the dyno-KITTI sequence at `root` (the committed fixture), from disk ->
    (pipeline, frames, wall seconds, host syncs). The first frame's
    FrameInputs and the GraphState after it must lie on `device`.
    `on_frame(pipeline, inputs, packet)` is called after each frame."""
    from dynosam_tpu_torch.run_dynosam import build_pipeline, open_dataset

    intr, frame_it, gt_it, n = open_dataset(0, root, frames, cfg.backend.max_objects, device)
    pipe = build_pipeline(cfg, intr, out_dir, device=device, seed=seed)
    first = {}
    process = pipe.process_frame

    def checked(inputs, gt=None):
        out = process(inputs, gt)
        if not first:
            first.update(inputs=_device_types(inputs), state=_device_types(pipe.backend.state))
        return out

    pipe.process_frame = checked
    with SyncCounter(torch, device) as syncs:
        t0 = time.perf_counter()
        pipe.run(frame_it, gt_it, on_frame=None if on_frame is None else (lambda i, p: on_frame(pipe, i, p)))
        dt = time.perf_counter() - t0
    want = torch.device(device).type
    off = {k: v for part in first.values() for k, v in part.items() if v != want}
    if off:
        raise AssertionError(f"pipeline tensors not on {want}: {off}")
    return pipe, n, dt, syncs


def _k1_counts(st):
    return st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches


def kitti_errors(pipe, ref, mode, run=None):
    """Mature camera poses and matured object motions against the JAX
    reference's seed-0 run of `mode` (or its run `run`, a key prefix such as
    "full_batch_seed3") -> the KITTI_REF_BOUNDS readings (largest pose
    translation and rotation, largest and median matured-motion
    translation), the motions compared and the share of (frame, object)
    keys the two sides have in common."""
    import numpy as np

    run = run or mode
    X = np.stack(pipe.trajectory).astype(np.float64)
    X_ref = ref[f"{run}_X"].astype(np.float64)
    trans = np.linalg.norm(X[:, :3, 3] - X_ref[:, :3, 3], axis=-1).max()
    # the angle from the skew part of R^T R_ref: linear in small angles, so
    # f32 rounding of the matrices does not put a ~3e-4 rad floor under it
    # as arccos of the trace would
    dR = np.einsum("kji,kjl->kil", X[:, :3, :3], X_ref[:, :3, :3])
    w = 0.5 * np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0], dR[:, 1, 0] - dR[:, 0, 1]], -1)
    rot = np.arcsin(np.clip(np.linalg.norm(w, axis=-1), 0.0, 1.0)).max()
    ref_m = {tuple(int(v) for v in k): H for k, H in zip(ref[f"{run}_motion_key"], ref[f"{run}_motion_H"])}
    got_m = pipe.backend.matured_motion
    common = sorted(set(ref_m) & set(got_m))
    overlap = len(common) / max(len(set(ref_m) | set(got_m)), 1)
    mot = [float(np.linalg.norm(np.asarray(got_m[k])[:3, 3] - ref_m[k][:3, 3])) for k in common]
    return {"pose_m": float(trans), "pose_rad": float(rot), "motion_max_m": max(mot, default=float("inf")),
            "motion_median_m": float(np.median(mot)) if mot else float("inf"), "n_motions": len(common),
            "overlap": overlap}


def compare_kitti(pipe, ref, mode, bounds=None):
    """kitti_errors against each JAX seed's run of `mode` in `ref`; the
    nearest run (the least largest reading / bound) held to `bounds` (the
    mode's KITTI_REF_BOUNDS) and the key overlap to KITTI_MOTION_OVERLAP
    -> its readings, with `run` its seed, `prefix` its key prefix and
    `seed0` the readings against seed 0."""
    runs = {int(ref["seeds"][0]): mode}
    runs.update({int(sd): f"{mode}_seed{int(sd)}" for sd in ref["seeds"][1:] if f"{mode}_seed{int(sd)}_X" in ref})
    bounds = bounds or KITTI_REF_BOUNDS[mode]
    errs = {sd: kitti_errors(pipe, ref, mode, run) for sd, run in runs.items()}
    seed, err = min(errs.items(), key=lambda kv: max(kv[1][k] / b for k, b in bounds.items()))
    if err["overlap"] < KITTI_MOTION_OVERLAP:
        raise AssertionError(f"{mode}: matured motions share {err['overlap']:.4f} of their (frame, object) keys")
    if not all(err[k] <= b for k, b in bounds.items()):
        raise AssertionError(f"{mode}: vs the nearest JAX run (seed {seed}), readings {err} against bounds "
                             f"{bounds}; vs each seed: {errs}")
    return {**err, "run": seed, "prefix": runs[seed], "seed0": errs[int(ref["seeds"][0])]}


def check_kitti_summary(summary, ref, mode):
    """The evaluator's numbers inside the JAX seeds' range, widened by the
    margins -> the per-field (lo, hi) ranges."""
    fields = [str(f) for f in ref["summary_fields"]]
    seeds = ref["summary"][[str(m) for m in ref["modes"]].index(mode)]
    ranges, outside = {}, []
    for name, margin in KITTI_RANGE_MARGIN.items():
        col = seeds[:, fields.index(name)]
        mid = 0.5 * (col.min() + col.max())
        lo, hi = col.min() - margin * mid, col.max() + margin * mid
        ranges[name] = (lo, hi)
        if not lo <= summary[name] <= hi:
            outside.append(f"{name} {summary[name]} outside [{lo}, {hi}] (JAX seeds {col.tolist()}, "
                           f"margin {margin})")
    if outside:
        raise AssertionError(f"{mode}: " + "; ".join(outside))
    return ranges


def _logs_equal(dir_a, dir_b, kinds):
    for kind in kinds:
        name = f"dynosam_tpu_{kind}_log.csv"
        with open(os.path.join(dir_a, name), "rb") as fa, open(os.path.join(dir_b, name), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"deferred {name} differs from the eager one")


def run_pipeline_path(torch, seed, ref_path, device="cuda", smi=""):
    """Phase 7: the host pipeline over the dyno-KITTI fixture from disk."""
    import shutil
    import tempfile

    import numpy as np

    from dynosam_tpu_torch.bench_config import kitti_accuracy_config, kitti_real_io_config
    from dynosam_tpu_torch.dataproviders.base import create_dataset
    from dynosam_tpu_torch.eval.evaluator import DatasetEvaluator, summarize
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.utils.stats import Statistics, Timer

    ref = np.load(ref_path)
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="smoke_pipeline_")
    launches = {"K1": 0, "K1 map": 0}

    def count(n_frames):
        k1, k1_map = _k1_counts(st)
        if on_card and (k1, k1_map) != (n_frames, 0):
            raise AssertionError(f"fused K1 launched {k1} times and the map entry {k1_map} times "
                                 f"over {n_frames} frames")
        launches["K1"] += k1
        launches["K1 map"] += k1_map
        return k1, k1_map

    try:
        # ---- (a) the three hybrid modes at ACCURACY.md's configuration ------
        eager_dirs = {}
        for mode in KITTI_MODES:
            out = eager_dirs[mode] = os.path.join(tmp, mode)
            st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
            pipe, n, dt, sync = kitti_run(torch, kitti_accuracy_config(mode, PIPE_FRAMES), out, device, seed)
            syncs = sync.count
            k1, k1_map = count(n)
            t = Timer("smoke.evaluator").start()
            summary = summarize(DatasetEvaluator(out).run_analysis()["dynosam_tpu"])
            t.stop()
            for v in summary.values():
                if not np.isfinite(v):
                    raise AssertionError(f"{mode}: non-finite evaluator summary {summary}")
            acc = ACCURACY_ROWS[mode]
            line = (f"pipeline {mode}: {n} frames on {device} in {dt:.2f} s ({n / dt:.2f} frames/s, "
                    f"eager, {syncs if syncs is not None else 'n/a'} host syncs = "
                    f"{syncs / n if syncs is not None else float('nan'):.1f}/frame), fused K1 launches "
                    f"{k1}, map entry {k1_map}; evaluator {Statistics.get('smoke.evaluator').samples[-1]:.1f} "
                    f"ms: camera ATE {summary['ate_unaligned_m'] * 100:.4f} cm, ATE rot "
                    f"{summary['ate_rot_rad']:.5f} rad, AME rms {summary['ame_rms_m'] * 100:.4f} cm, "
                    f"median {summary['ame_median_m'] * 100:.4f} cm, {summary['n_motions']:.0f} motions "
                    f"(ACCURACY.md row, an older code state: {acc[0]} cm, {acc[1]} rad, {acc[2]} cm, "
                    f"{acc[3]} cm)")
            err = compare_kitti(pipe, ref, mode)
            ranges = check_kitti_summary(summary, ref, mode)
            fields = [str(f) for f in ref["spread_fields"]]
            spread = ref["seed_spread"][KITTI_MODES.index(mode), 1:].max(axis=0)
            seeds = [int(sd) for sd in ref["seeds"]]
            line += (f"; vs the nearest JAX run, seed {err['run']} of {seeds[0]}-{seeds[-1]}, over "
                     f"{err['n_motions']} matured motions (key overlap {err['overlap']:.4f}), reading / "
                     f"bound / vs seed {seeds[0]} / JAX seeds {seeds[1]}-{seeds[-1]} vs {seeds[0]}: "
                     + ", ".join(f"{k} {err[k]:.2e} / {b:.0e} / {err['seed0'][k]:.2e} / "
                                 f"{spread[fields.index(k)]:.2e}" for k, b in KITTI_REF_BOUNDS[mode].items())
                     + "; evaluator inside the JAX seed ranges "
                     + ", ".join(f"{k} [{lo:.6g}, {hi:.6g}]" for k, (lo, hi) in ranges.items()))
            say(line)

        # ---- (b) incremental again, deferred, with mid-run drains ------------
        out = os.path.join(tmp, "incremental_deferred")
        cfg = kitti_accuracy_config("incremental", PIPE_FRAMES).with_overrides(
            {"pipeline.defer_host_outputs": True, "pipeline.drain_every": DRAIN_EVERY})
        st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
        pipe, n, dt, sync = kitti_run(torch, cfg, out, device, seed)
        syncs = sync.count
        k1, k1_map = count(n)
        _logs_equal(eager_dirs["incremental"], out, DEFERRED_LOGS)
        say(f"pipeline incremental deferred (drain every {DRAIN_EVERY}): {n} frames in {dt:.2f} s "
            f"({n / dt:.2f} frames/s, {syncs if syncs is not None else 'n/a'} host syncs = "
            f"{syncs / n if syncs is not None else float('nan'):.1f}/frame), fused K1 launches {k1}, "
            f"map entry {k1_map}; {', '.join(DEFERRED_LOGS)} logs equal the eager run's byte for byte; "
            f"most frequent sync sites: {sync.top() if sync.count is not None else 'n/a'}")

        # ---- (c) the real-io configuration, timed after a warm-up -------------
        cfg = kitti_real_io_config()
        ds = create_dataset(0, KITTI_FIXTURE, device=device, pad_to_multiple=32)
        n = min(REAL_IO_FRAMES, len(ds))
        warm = cfg.backend.max_frames + 2
        out = os.path.join(tmp, "real_io")
        from dynosam_tpu_torch.run_dynosam import build_pipeline

        st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
        pipe = build_pipeline(cfg, ds.intrinsics(), out, device=device, seed=seed)
        for k in range(warm):
            pipe.process_frame(ds.frame(k), ds.ground_truth(k))
        pipe._drain_outputs()
        if on_card:
            torch.cuda.synchronize()
        Statistics.reset()
        t0 = time.perf_counter()
        pipe.run((ds.frame_host(k) for k in range(warm, n)), (ds.ground_truth(k) for k in range(warm, n)))
        dt = time.perf_counter() - t0
        count(n)
        fps = (n - warm) / dt

        def mean(tag):
            c = Statistics.get(tag)
            return f"{c.mean:.2f} ms x {c.count}"

        say(f"{smi} | pipeline real-io (kitti-fixture-60f: incremental, 2 LM iterations, deferred, "
            f"prefetch on): {fps:.3f} frames/s over frames {warm}-{n - 1} after {warm} warm frames, "
            f"{dt:.3f} s including disk decode, prefetch, logging and finish(); host times per call: "
            f"decode {mean('pipeline.decode')}, prefetch wait {mean('pipeline.prefetch_wait')}, "
            f"frontend dispatch {mean('pipeline.frontend_dispatch')}, backend dispatch "
            f"{mean('pipeline.backend_dispatch')}, drain {mean('pipeline.drain')}, mature re-log "
            f"{mean('pipeline.relog')}, total {mean('pipeline.total')}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, fps


def forms_bench_readings(torch, seed, name, ref_path, device="cuda"):
    """The fused step at bench_config() with formulation `name` over the
    bench frames -> (launches, readings against the ground truth and the
    JAX reference, the phase's line)."""
    import numpy as np

    from dynosam_tpu_torch.backend import hybrid
    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step
    from dynosam_tpu_torch.utils import lie

    cfg, intr = bench_config()
    cfg = cfg.with_overrides(FORM_BENCH[name])
    scene = bench_scene(intr, BENCH_FRAMES, device=device)
    frames = scene.frames()
    step = make_fused_step(cfg, intr, torch.Generator(device=device).manual_seed(seed))
    state = init_pipeline_state(cfg, device)
    last = {}
    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    with SyncCounter(torch, device) as sync:
        outs, times = _drive(torch, step, state, frames, device, after=lambda s: last.update(graph=s.graph))
    launches = {"K1": st.shi_tomasi_cell_max.launches, "K1 map": st.shi_tomasi_response.launches}
    if device == "cuda" and (launches["K1"], launches["K1 map"]) != (BENCH_FRAMES, 0):
        raise AssertionError(f"forms {name}: fused K1 launched {launches['K1']} times and the map entry "
                             f"{launches['K1 map']} times over {BENCH_FRAMES} frames")
    sites = {k: v for k, v in sync.sites.items() if not k.startswith("chip_smoke.py")}
    syncs = None if sync.count is None else sum(sites.values())
    ref = np.load(ref_path)
    X = torch.stack([o["X_world_cam"] for o in outs])
    rot, trans = rot_trans_err(torch, lie, X, scene.scn.X_gt)
    rd = {"gt_m": float(trans.max()), "gt_rad": float(rot.max())}
    # WCME and WCPE take no LM step at this width (see FORM_COV_REL), so a
    # motion whose object was not valid the frame before is the frontend's
    # RANSAC estimate under the port's own draws: compared settled motions
    # only, the first one after a gap read alone
    settled = name != "joint"
    rd["ref_m"], rd["ref_rad"], rd["n_motions"], rd["motion_m"] = compare_to_reference(
        torch, lie, outs, ref, device, bounds=(np.inf,) * 3, settled_only=settled)
    extra = ""
    if settled:
        _, _, n_all, all_m = compare_to_reference(torch, lie, outs, ref, device, bounds=(np.inf,) * 3)
        extra = (f" (settled: valid the frame before too); all {n_all} motions, first ones after a gap "
                 f"included, max {all_m:.2e} m")
    if name == "joint":
        cfg_b = cfg.normalized().backend
        cov_X, cov_H = hybrid.marginal_covariances(last["graph"], cfg_b)
        rd["cov"] = 0.0
        for got, r in ((cov_X, ref["cov_X"]), (cov_H, ref["cov_H"])):
            got = got.cpu().numpy()
            if not np.isfinite(got).all():
                raise AssertionError("forms joint: non-finite marginal covariances")
            scale = np.abs(r).max(axis=(-1, -2), keepdims=True)
            rd["cov"] = max(rd["cov"], float((np.abs(got - r) / scale).max()))
        extra += (f"; marginal covariances of the final window (cov_X {tuple(cov_X.shape)}, cov_H "
                 f"{tuple(cov_H.shape)}) vs JAX ref within {rd['cov']:.2e} of each block's largest entry")
    line = (f"forms {name}: {BENCH_FRAMES} frames of bench_config with {FORM_BENCH[name]} on "
            f"{frames[0].depth.device} (window of 10 advanced {BENCH_FRAMES - 10} times), fused K1 launches "
            f"{launches['K1']}, map entry {launches['K1 map']}; camera vs GT max {rd['gt_m']:.2e} m / "
            f"{rd['gt_rad']:.2e} rad; vs JAX ref max {rd['ref_m']:.2e} m / {rd['ref_rad']:.2e} rad; "
            f"{rd['n_motions']} object motions vs JAX ref max {rd['motion_m']:.2e} m{extra}; first frame "
            f"{times[0] * 1e3:.1f} ms, median frames 2-10 {statistics.median(times[1:10]) * 1e3:.2f} ms, median "
            f"frames 11-{BENCH_FRAMES} (advancing) {statistics.median(times[10:]) * 1e3:.2f} ms, host syncs "
            f"{syncs if syncs is not None else 'n/a'} = {syncs / BENCH_FRAMES if syncs is not None else float('nan'):.1f}"
            f"/frame (sites: {', '.join(f'{k} x{v}' for k, v in sorted(sites.items(), key=lambda kv: -kv[1])) or 'n/a'})")
    return launches, rd, line


def forms_kitti_readings(torch, seed, name, ref, out_dir, device="cuda"):
    """The entry point's pipeline over the fixture in incremental mode with
    formulation `name` -> (launches, readings against kitti_forms_ref_30f,
    evaluator summary, the phase's line)."""
    from dynosam_tpu_torch.bench_config import kitti_accuracy_config
    from dynosam_tpu_torch.eval.evaluator import DatasetEvaluator, summarize
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    cfg = kitti_accuracy_config("incremental", FORM_KITTI_FRAMES, FORM_KITTI[name])
    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    pipe, n, dt, sync = kitti_run(torch, cfg, out_dir, device, seed, frames=FORM_KITTI_FRAMES)
    k1, k1_map = _k1_counts(st)
    if torch.device(device).type == "cuda" and (k1, k1_map) != (n, 0):
        raise AssertionError(f"forms kitti {name}: fused K1 launched {k1} times and the map entry {k1_map} "
                             f"times over {n} frames")
    summary = summarize(DatasetEvaluator(out_dir).run_analysis()["dynosam_tpu"])
    err = kitti_errors(pipe, ref, name)
    syncs = sync.count
    line = (f"forms kitti {name}: {n} frames of the fixture, incremental, on {device} in {dt:.2f} s "
            f"({n / dt:.2f} frames/s, {syncs if syncs is not None else 'n/a'} host syncs = "
            f"{syncs / n if syncs is not None else float('nan'):.1f}/frame; sites: "
            f"{sync.top() if syncs is not None else 'n/a'}), fused K1 launches {k1}, map entry {k1_map}; camera "
            f"ATE {summary['ate_unaligned_m'] * 100:.4f} cm, ATE rot {summary['ate_rot_rad']:.5f} rad, AME rms "
            f"{summary['ame_rms_m'] * 100:.4f} cm, median {summary['ame_median_m'] * 100:.4f} cm, "
            f"{summary['n_motions']:.0f} motions; vs JAX ref over {err['n_motions']} matured motions (key "
            f"overlap {err['overlap']:.4f}), reading / bound: "
            + ", ".join(f"{k} {err[k]:.2e} / {b:.0e}" for k, b in FORM_KITTI_BOUNDS.items()))
    return {"K1": k1, "K1 map": k1_map}, err, summary, line


def run_forms_path(torch, seed, testdata, device="cuda"):
    """Phase 10: the other formulations, each run held to its bounds ->
    {path: launches}."""
    import shutil
    import tempfile

    import numpy as np

    paths = {}
    for name in FORM_BENCH:
        launches, rd, line = forms_bench_readings(torch, seed, name,
                                                  os.path.join(testdata, f"bench_{name}_ref_20f.npz"), device)
        checks = {"gt_m": GT_TRANS_M, "gt_rad": GT_ROT_RAD, "ref_m": REF_TRANS_M, "ref_rad": REF_ROT_RAD,
                  "motion_m": REF_MOTION_TRANS_M}
        if name == "joint":
            checks["cov"] = FORM_COV_REL
        over = {k: (rd[k], v) for k, v in checks.items() if not rd[k] <= v}
        if over:
            raise AssertionError(f"forms {name}: readings over their bounds (reading, bound): {over}")
        say(line)
        paths[f"forms_{name}"] = launches
    ref = np.load(os.path.join(testdata, f"kitti_forms_ref_{FORM_KITTI_FRAMES}f.npz"))
    tmp = tempfile.mkdtemp(prefix="smoke_forms_")
    try:
        for name in FORM_KITTI:
            launches, err, summary, line = forms_kitti_readings(torch, seed, name, ref, os.path.join(tmp, name),
                                                                device)
            if err["overlap"] < KITTI_MOTION_OVERLAP:
                raise AssertionError(f"forms kitti {name}: matured motions share {err['overlap']:.4f} of their keys")
            if not all(err[k] <= b for k, b in FORM_KITTI_BOUNDS.items()):
                raise AssertionError(f"forms kitti {name}: vs JAX reference, readings {err} against bounds "
                                     f"{FORM_KITTI_BOUNDS}")
            ranges = check_kitti_summary(summary, ref, name)
            say(line + "; evaluator inside the JAX seed ranges "
                + ", ".join(f"{k} [{lo:.6g}, {hi:.6g}]" for k, (lo, hi) in ranges.items()))
            paths[f"forms_kitti_{name}"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


def _stack_inputs(torch, frames):
    """One FrameInputs with a leading batch axis from per-sequence frames."""
    import dataclasses

    f0 = frames[0]
    return dataclasses.replace(f0, **{k: torch.stack([getattr(f, k) for f in frames]).contiguous()
                                      for k in f0.tensors()})


def profile_frames(torch, step, state, frames):
    """The step over `frames` again from `state` under torch.profiler (on
    the card) -> (device ops per frame, device busy ms per frame (the sum of
    the kernels' times), the fused K1's device ms per launch or None)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fr in frames:
            state, _ = step(state, fr)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / len(frames)
    k1 = [e.time_range.elapsed_us() for e in kernels if "shi_tomasi_cell_kernel" in e.name]
    return len(kernels) / len(frames), busy, (statistics.mean(k1) / 1e3 if k1 else None)


def batched_errors(torch, outs, ref, B, n_frames, X_gt, device, form=None):
    """Each sequence of a batched run (`outs`: per frame, each output with
    the leading B) against the ground truth and the JAX reference `ref` ->
    the largest readings over the sequences (see batched_readings)."""
    from dynosam_tpu_torch.utils import lie

    rd = {"gt_m": 0.0, "gt_rad": 0.0, "ref_m": 0.0, "ref_rad": 0.0, "motion_m": 0.0, "n_motions": 0,
          "excluded_ref": {}}
    excluded = BATCHED_REF_EXCLUDED.get(form, ())
    for b in range(B):
        # sequence b starts at scene frame b: its world is that camera
        gt = lie.mm(lie.inverse(X_gt[b]), X_gt[b:b + n_frames])
        seq = [{k: v[b] for k, v in o.items() if torch.is_tensor(v)} for o in outs]
        rot, trans = rot_trans_err(torch, lie, torch.stack([o["X_world_cam"] for o in seq]), gt)
        rd["gt_m"], rd["gt_rad"] = max(rd["gt_m"], float(trans.max())), max(rd["gt_rad"], float(rot.max()))
        ref_b = {k: ref[k][:n_frames, b] for k in ("X_world_cam", "object_ids", "object_motions",
                                                   "object_motion_valid")}
        tr, rr, n_mot, mot = compare_to_reference(torch, lie, seq, ref_b, device, bounds=(float("inf"),) * 3,
                                                  settled_only=form in ("wcme", "wcpe"))
        if b in excluded:
            rd["excluded_ref"][b] = (tr, rr, mot)
            continue
        rd["ref_m"], rd["ref_rad"] = max(rd["ref_m"], tr), max(rd["ref_rad"], rr)
        rd["motion_m"], rd["n_motions"] = max(rd["motion_m"], mot), rd["n_motions"] + n_mot
    return rd


def batched_readings(torch, seed, ref, B, device="cuda", form=None, n_frames=BATCHED_FRAMES, profile=True):
    """make_batched_pipeline at bench_config (with formulation `form` of
    FORM_BENCH, or the bench's decoupled hybrid) over B sequences ->
    (launches, readings, final state, per-frame host seconds, host-sync
    sites, device ops per advancing frame, device busy ms per advancing
    frame and the fused K1's device ms per launch on the path, the last
    three None off the card or without `profile`). WCME's and WCPE's
    motions are compared where settled only (see FORM_COV_REL). The sequences of
    BATCHED_REF_EXCLUDED[form] are held to the ground truth only: their
    readings against the JAX reference go to `excluded_ref` (sequence ->
    (m, rad, motion m)) and into no maximum."""
    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.parallel.batched import make_batched_pipeline

    cfg, intr = bench_config()
    if form is not None:
        cfg = cfg.with_overrides(FORM_BENCH[form])
    scene = bench_scene(intr, BATCHED_FRAMES + max(BATCHED_SIZES) - 1, device=device)
    frames = scene.frames()
    stacked = [_stack_inputs(torch, frames[k:k + B]) for k in range(n_frames)]
    step, init = make_batched_pipeline(cfg, intr, torch.Generator(device=device).manual_seed(seed))
    held = {"n": 0}

    def after(state):
        # the state before the last frame, for its profiled replay
        held["n"] += 1
        if held["n"] == n_frames - 1:
            held["before_last"] = state
        held["last"] = state

    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    with SyncCounter(torch, device) as sync:
        outs, times = _drive(torch, step, init(B, device), stacked, device, after=after)
    launches = {"K1": st.shi_tomasi_cell_max.launches, "K1 map": st.shi_tomasi_response.launches}
    if device == "cuda" and (launches["K1"], launches["K1 map"]) != (n_frames, 0):
        raise AssertionError(f"batched B={B}: fused K1 launched {launches['K1']} times and the map "
                             f"entry {launches['K1 map']} times over {n_frames} frames")
    # _drive's own per-frame synchronize() calls are not the program's
    sites = {k: v for k, v in sync.sites.items() if not k.startswith("chip_smoke.py")}

    rd = batched_errors(torch, outs, ref, B, n_frames, scene.scn.X_gt, device, form)

    # device operations per advancing frame: the last frame again, from
    # the state before it, under the profiler (not counted as launches)
    ops = busy = k1_ms = None
    if device == "cuda" and profile:
        ops, busy, k1_ms = profile_frames(torch, step, held["before_last"], stacked[-1:])
    return launches, rd, held, times, sites, ops, busy, k1_ms


def run_batched_path(torch, seed, ref_path, device="cuda", smi=""):
    """Phase 11: the batched step at B=1 and B=8, held to its bounds, and
    the chunked assembly on the B=1 run's final window -> {path: launches}."""
    import numpy as np

    from dynosam_tpu_torch.backend import hybrid
    from dynosam_tpu_torch.bench_config import bench_config
    from dynosam_tpu_torch.parallel import sharded
    from dynosam_tpu_torch.parallel.batched import _map_tensors

    ref = np.load(ref_path)
    paths, ops, lines, finals = {}, {}, [], {}
    for B in BATCHED_SIZES:
        n_frames = BATCHED_B1_FRAMES if B == 1 else BATCHED_FRAMES
        launches, rd, held, times, sites, ops[B], _, k1_ms = batched_readings(torch, seed, ref, B, device,
                                                                               n_frames=n_frames)
        checks = {"gt_m": GT_TRANS_M, "gt_rad": GT_ROT_RAD, "ref_m": REF_TRANS_M, "ref_rad": REF_ROT_RAD,
                  "motion_m": REF_MOTION_TRANS_M}
        over = {k: (rd[k], v) for k, v in checks.items() if not rd[k] <= v}
        if over:
            raise AssertionError(f"batched B={B}: readings over their bounds (reading, bound): {over}")
        steady = statistics.median(times[10:])
        n_sync = sum(sites.values())
        lines.append(
            f"B={B} ({n_frames} frames): fused K1 launches {launches['K1']}, map entry {launches['K1 map']}; camera vs GT "
            f"max {rd['gt_m']:.2e} m / {rd['gt_rad']:.2e} rad; vs JAX ref max {rd['ref_m']:.2e} m / "
            f"{rd['ref_rad']:.2e} rad; {rd['n_motions']} object motions vs JAX ref max "
            f"{rd['motion_m']:.2e} m; first frame {times[0] * 1e3:.1f} ms, median frames 2-10 "
            f"{statistics.median(times[1:10]) * 1e3:.2f} ms, median advancing frames 11-"
            f"{n_frames} {steady * 1e3:.2f} ms = {B / steady:.2f} frames/s aggregate, "
            f"{1 / steady:.2f} per sequence; device ops per advancing frame "
            f"{ops[B] if ops[B] is not None else 'n/a'}, the fused K1 (blockIdx.z over {B}) "
            f"{f'{k1_ms:.4f}' if k1_ms is not None else 'n/a'} ms of device time per launch there; "
            f"host syncs {n_sync / n_frames:.1f}/frame "
            f"(sites: {', '.join(f'{k} x{v}' for k, v in sorted(sites.items(), key=lambda kv: -kv[1])) or 'none'})")
        paths[f"batched_b{B}"] = launches
        finals[B] = held["last"]
    ratio = None
    if ops[1] is not None:
        ratio = ops[8] / ops[1]
        if not ratio <= BATCHED_OPS_RATIO:
            raise AssertionError(f"batched: {ops[8]} device ops per advancing frame at B=8 against "
                                 f"{ops[1]} at B=1 (ratio {ratio:.3f} > {BATCHED_OPS_RATIO})")

    # the chunked assembly on the B=1 run's final window
    cfg, _ = bench_config()
    g = _map_tensors(lambda x: x[0], finals[1].graph)
    lam = torch.tensor(1e-4, device=device)
    S_c, rhs_c = sharded.chunked_linearize(g, cfg.backend, lam, CHUNK_P)
    whole = hybrid.linearize(g, cfg.backend, lam)
    rel = {name: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for name, a, b in (("S", S_c, whole.S), ("rhs", rhs_c, whole.rhs))}
    if not max(rel.values()) <= CHUNK_REL:
        raise AssertionError(f"chunked_linearize (P={CHUNK_P}) vs linearize: relative {rel} > {CHUNK_REL}")
    say(f"batched path: make_batched_pipeline at bench_config, {BATCHED_FRAMES} frames per sequence "
        f"(window of 10 advanced {BATCHED_FRAMES - 10} times), sequence b on scene frames b..b+"
        f"{BATCHED_FRAMES - 1}, on {device} ({smi}); " + "; ".join(lines)
        + f"; device ops per advancing frame B=8 / B=1 = "
        + (f"{ratio:.3f}" if ratio is not None else "n/a") + f" (bound {BATCHED_OPS_RATIO}); "
        f"chunked_linearize P={CHUNK_P} vs linearize on the B=1 final window: S {rel['S']:.2e}, rhs "
        f"{rel['rhs']:.2e} of the largest entry (bound {CHUNK_REL})")

    # every other formulation at B=8, each held to its own JAX reference
    for form in FORM_BENCH:
        B = BATCHED_FORMS_B
        ref = np.load(os.path.join(os.path.dirname(ref_path), f"bench_batched_{form}_ref_b{B}_20f.npz"))
        t = time.perf_counter()
        launches, rd, _, times, sites, ops_f, busy, k1_ms = batched_readings(torch, seed, ref, B, device, form,
                                                                             n_frames=BATCHED_FORMS_FRAMES,
                                                                             profile=False)
        over = {k: (rd[k], v) for k, v in BATCHED_FORM_BOUNDS[form].items() if not rd[k] <= v}
        excl = "".join(f"; sequence {b} (held to the ground truth only) vs JAX ref {m:.2e} m / {r:.2e} rad, "
                       f"motions {mo:.2e} m" for b, (m, r, mo) in rd["excluded_ref"].items())
        if over:
            raise AssertionError(f"batched {form} B={B}: readings over their bounds (reading, bound): {over}")
        steady = statistics.median(times[10:])
        idle = None if busy is None else 1.0 - busy / (steady * 1e3)
        n_sync = sum(sites.values())
        say(f"batched {form}: make_batched_pipeline at bench_config with {FORM_BENCH[form]}, B={B}, "
            f"{BATCHED_FORMS_FRAMES} frames per sequence, on {device} ({smi}): fused K1 launches {launches['K1']}, "
            f"map entry {launches['K1 map']}; camera vs GT max {rd['gt_m']:.2e} m / {rd['gt_rad']:.2e} rad; "
            f"vs JAX ref max {rd['ref_m']:.2e} m / {rd['ref_rad']:.2e} rad; {rd['n_motions']} object motions"
            f"{' (settled: valid the frame before too)' if form != 'joint' else ''} vs JAX ref max "
            f"{rd['motion_m']:.2e} m{excl}; first frame {times[0] * 1e3:.1f} ms, median advancing frames 11-"
            f"{BATCHED_FORMS_FRAMES} {steady * 1e3:.2f} ms = {B / steady:.2f} frames/s aggregate, {1 / steady:.2f} "
            f"per sequence; device ops per advancing frame {ops_f if ops_f is not None else 'n/a'}, device "
            f"busy {f'{busy:.2f}' if busy is not None else 'n/a'} ms per advancing frame, idle "
            f"{f'{idle:.1%}' if idle is not None else 'n/a'} of the step; K1b "
            f"{f'{k1_ms:.4f}' if k1_ms is not None else 'n/a'} ms per launch; host syncs "
            f"{n_sync / BATCHED_FORMS_FRAMES:.1f}/frame (sites: "
            f"{', '.join(f'{k} x{v}' for k, v in sorted(sites.items(), key=lambda kv: -kv[1])) or 'none'}); "
            f"{time.perf_counter() - t:.1f} s")
        paths[f"batched_{form}_b{B}"] = launches
    return paths


def batched_modes_readings(torch, seed, ref, mode, device="cuda", tracked=False):
    """make_batched_pipeline over BATCHED_MODES_B sequences in frontend mode
    `mode` of BATCHED_MODES (bench_config.batched_{mode}_config()), sequence
    b on scene frames b .. b+BATCHED_MODES_FRAMES-1; stereo_imu with
    `tracked` on bench_config.tracked_scene, rendered on the host as its
    reference's frames were -> (launches, readings against the ground truth
    and the JAX reference, per-frame host seconds, host-sync sites, device
    ops and busy ms per advancing frame and K1b's device ms per launch, the
    last three None off the card)."""
    import dataclasses

    import numpy as np

    from dynosam_tpu_torch import bench_config as bc
    from dynosam_tpu_torch.ops import interp
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.parallel.batched import make_batched_pipeline
    from dynosam_tpu_torch.utils import lie

    B, n = BATCHED_MODES_B, BATCHED_MODES_FRAMES
    t0 = time.perf_counter()
    if mode == "bytetrack":
        cfg, intr = bc.batched_bytetrack_config()
        scene = bc.bench_scene(intr, n + B - 1, device=device)
        frames = scene.frames()
        lut = bc.label_permutations(0, n, B, 2 * cfg.frontend.max_objects)
        if not np.array_equal(lut, ref["label_lut"]):
            raise AssertionError("bytetrack: label permutations differ from the reference file's")
        lut_t = torch.as_tensor(lut, device=device)

        def seq_frame(k, b):
            fr = frames[k + b]
            return dataclasses.replace(fr, mask=lut_t[k, b][fr.mask.long()])
    else:
        cfg, intr = bc.batched_stereo_imu_config()
        if tracked:
            if (float(ref["ground_y"]), float(ref["forward_m"])) != (bc.TRACKED_GROUND_Y, bc.TRACKED_FORWARD_M):
                raise AssertionError("stereo_imu_tracked: the reference file holds another scene")
            scene = bc.tracked_scene(intr, n + B - 1, device="cpu")
        else:
            scene = bc.bench_scene(intr, n + B - 1, device=device, world_texture=True)
        frames = [bc.stereo_imu_frame(scene, k, IMU_SAMPLES).to(device) for k in range(n + B - 1)]

        def seq_frame(k, b):
            return frames[k + b]
    stacked = [_stack_inputs(torch, [seq_frame(k, b) for b in range(B)]) for k in range(n)]
    step, init = make_batched_pipeline(cfg, intr, torch.Generator(device=device).manual_seed(seed))
    held = {"n": 0}

    def after(state):
        held["n"] += 1
        if held["n"] == n - 1:
            held["before_last"] = state
        trk = state.frontend.tracker
        return {"n_static": trk.s_valid.sum(-1), "n_dynamic": trk.d_valid.sum(-1), "s_uv": trk.s_uv.clone(),
                "s_depth": trk.s_depth.clone(), "s_valid": trk.s_valid.clone(), "d_uv": trk.d_uv.clone(),
                "d_oid": trk.d_oid.clone(), "d_valid": trk.d_valid.clone()}

    t1 = time.perf_counter()
    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    with SyncCounter(torch, device) as sync:
        outs, times = _drive(torch, step, init(B, device), stacked, device, after=after)
    launches = {"K1": st.shi_tomasi_cell_max.launches, "K1 map": st.shi_tomasi_response.launches}
    t2 = time.perf_counter()
    if device == "cuda" and (launches["K1"], launches["K1 map"]) != (n, 0):
        raise AssertionError(f"batched {mode}: fused K1 launched {launches['K1']} times and the map entry "
                             f"{launches['K1 map']} times over {n} frames")
    sites = {k: v for k, v in sync.sites.items() if not k.startswith("chip_smoke.py")}

    rd = {"gt_m": 0.0, "gt_rad": 0.0, "ref_gt_m": 0.0, "ref_gt_rad": 0.0, "gt_excess_m": 0.0,
          "gt_excess_rad": 0.0, "ref_m": 0.0, "ref_rad": 0.0, "motion_m": 0.0, "n_motions": 0, "count_rel": 0.0}
    counts = np.stack([[o["after"]["n_static"].cpu().numpy(), o["after"]["n_dynamic"].cpu().numpy()]
                       for o in outs])                                         # (n, 2, B)
    ref_counts = np.stack([ref["n_static"], ref["n_dynamic"]], 1)
    rd["count_rel"] = float((np.abs(counts - ref_counts) / np.maximum(ref_counts, 1)).max())
    X_gt = scene.scn.X_gt.to(device)
    id_errs, identity, depth_errs, depth_worst = 0, {}, [], 0.0
    true_depth = {}             # scene frame -> its uncorrupted depth, shared by the sequences
    for b in range(B):
        gt = lie.mm(lie.inverse(X_gt[b]), X_gt[b:b + n])
        seq = [{k: v[b] for k, v in o.items() if torch.is_tensor(v)} for o in outs]
        rot, trans = rot_trans_err(torch, lie, torch.stack([o["X_world_cam"] for o in seq]), gt)
        ref_b = {k: ref[k][:, b] for k in ("X_world_cam", "object_ids", "object_motions", "object_motion_valid")}
        rot_r, trans_r = rot_trans_err(torch, lie, torch.as_tensor(ref_b["X_world_cam"], device=device), gt)
        for key, v in (("gt_m", trans), ("gt_rad", rot), ("ref_gt_m", trans_r), ("ref_gt_rad", rot_r),
                       ("gt_excess_m", trans - trans_r), ("gt_excess_rad", rot - rot_r)):
            rd[key] = max(rd[key], float(v.max()))
        tr, rr, n_mot, mot = compare_to_reference(torch, lie, seq, ref_b, device, bounds=(float("inf"),) * 3,
                                                  settled_only=mode == "stereo_imu")
        rd["ref_m"], rd["ref_rad"] = max(rd["ref_m"], tr), max(rd["ref_rad"], rr)
        rd["motion_m"], rd["n_motions"] = max(rd["motion_m"], mot), rd["n_motions"] + n_mot
        ids = torch.stack([o["object_ids"] for o in seq]).cpu().numpy()
        id_errs += int((ids != ref_b["object_ids"]).sum())
        if mode == "bytetrack":
            # the scene's own labels (its object ids) under each valid
            # dynamic track, frame by frame: (ground-truth object, id) pairs
            identity[b] = []
            for k, o in enumerate(outs):
                a = o["after"]
                gt_lab = interp.sample_label(frames[k + b].mask, a["d_uv"][b])
                sel = a["d_valid"][b] & (gt_lab > 0)
                identity[b].append(set(zip(gt_lab[sel].tolist(), a["d_oid"][b][sel].tolist())))
        else:
            errs = []
            for k, o in enumerate(outs[1:], start=1):
                a = o["after"]
                j = k + b
                if j not in true_depth:
                    true_depth[j] = scene._depth_mask(scene.scn.X_gt[j], [L[j] for L in scene.scn.L_gt])[0].to(device)
                H, W = true_depth[j].shape
                uv, depth, valid = a["s_uv"][b], a["s_depth"][b], a["s_valid"][b]
                iu = torch.clamp(torch.round(uv[:, 0]).long(), 0, W - 1)
                iv = torch.clamp(torch.round(uv[:, 1]).long(), 0, H - 1)
                g = true_depth[j][iv, iu]
                sel = valid & (depth > 0)
                errs.append((torch.abs(depth - g) / g)[sel])
            errs = torch.cat(errs)
            depth_worst = max(depth_worst, float(torch.median(errs)))
            depth_errs.append(errs)
    rd["id_mismatches"] = id_errs
    if mode == "bytetrack":
        # in every frame each tracked ground-truth object carries one id and
        # no two share one; an id changes between frames only where
        # ByteTrack spawned a new track (an object that left the view, or
        # whose box jumped below the match IoU), as the reference's ids do
        rd["one_id_per_frame"] = all(
            len({g for g, _ in pairs}) == len(pairs) == len({o for _, o in pairs})
            for frames_b in identity.values() for pairs in frames_b)
        switches = []
        for b, frames_b in identity.items():
            last = {}
            for k, pairs in enumerate(frames_b):
                for g, o in pairs:
                    if g in last and last[g] != o:
                        switches.append((b, k, g, last[g], o))
                    last[g] = o
        rd["id_switches"] = switches
        rd["id_pairs"] = {b: sorted(set().union(*frames_b)) for b, frames_b in identity.items()}
    else:
        errs = torch.cat(depth_errs)
        rd["depth_tracks"] = int(errs.numel())
        rd["depth_relerr"] = float(torch.median(errs))
        rd["depth_relerr_worst_seq"] = depth_worst
    # device operations per advancing frame: the last frame again, from the
    # state before it, under the profiler (one frame keeps the phase short)
    t3 = time.perf_counter()
    ops = busy = k1_ms = None
    if device == "cuda":
        ops, busy, k1_ms = profile_frames(torch, step, held["before_last"], stacked[-1:])
    rd["phase_s"] = {"set_up": t1 - t0, "run": t2 - t1, "checks": t3 - t2, "profile": time.perf_counter() - t3}
    return launches, rd, times, sites, ops, busy, k1_ms


def run_batched_modes_path(torch, seed, testdata, device="cuda", smi=""):
    """Phase 14: the batched step at B=8 in each frontend mode of
    BATCHED_MODES, held to BATCHED_MODE_BOUNDS and its JAX reference ->
    {path: launches}."""
    B, n = BATCHED_MODES_B, BATCHED_MODES_FRAMES
    paths = {}
    for mode in BATCHED_MODES:
        ref_path = os.path.join(testdata, f"bench_batched_{mode}_ref_b{B}_{n}f.npz")
        paths.update(check_batched_mode(torch, seed, ref_path, mode, device, smi))
    return paths


def check_batched_mode(torch, seed, ref_path, mode, device="cuda", smi="", tracked=False):
    """The batched step at B=8 in frontend mode `mode` (with `tracked`,
    phase 11c: on bench_config.tracked_scene), held to BATCHED_MODE_BOUNDS
    and its JAX reference -> {path: launches}."""
    import numpy as np

    B, n = BATCHED_MODES_B, BATCHED_MODES_FRAMES
    name = mode + ("_tracked" if tracked else "")
    t = time.perf_counter()
    ref = np.load(ref_path)
    launches, rd, times, sites, ops, busy, k1_ms = batched_modes_readings(torch, seed, ref, mode, device, tracked)
    over = {k: (rd[k], v) for k, v in BATCHED_MODE_BOUNDS[name].items() if not rd[k] <= v}
    if rd["id_mismatches"]:
        over["id_mismatches"] = (rd["id_mismatches"], 0)
    if mode == "bytetrack" and not rd["one_id_per_frame"]:
        over["one_id_per_frame"] = (rd["id_pairs"], "one id per ground-truth object in each frame")
    if over:
        raise AssertionError(f"batched {name} B={B}: readings over their bounds (reading, bound): {over}")
    steady = statistics.median(times[10:])
    idle = None if busy is None else 1.0 - busy / (steady * 1e3)
    n_sync = sum(sites.values())
    detail = (f"object ids equal to the JAX ref's in every sequence and frame, one id per ground-truth "
              f"object in each frame; ids that changed (sequence, frame, object, old id, new id) "
              f"{rd['id_switches']}" if mode == "bytetrack" else
              f"static track depths ({rd['depth_tracks']} over frames 1-{n - 1}, all sequences) median "
              f"relative error {rd['depth_relerr']:.3%} against the true depth, worst sequence "
              f"{rd['depth_relerr_worst_seq']:.3%} (provided depth off by 15%)")
    say(f"batched {name}: make_batched_pipeline at bench_config.batched_{mode}_config(), B={B}, {n} frames "
        f"per sequence (window of 10 advanced {n - 10} times)"
        + (" on tracked_scene (rendered on the host)" if tracked else "")
        + f", on {device} ({smi}): fused K1 launches {launches['K1']}, map entry {launches['K1 map']}; camera vs GT max {rd['gt_m']:.2e} m / "
        f"{rd['gt_rad']:.2e} rad (the JAX ref's own {rd['ref_gt_m']:.2e} m / {rd['ref_gt_rad']:.2e} rad, "
        f"the port at most {rd['gt_excess_m']:.2e} m / {rd['gt_excess_rad']:.2e} rad past it); vs JAX ref "
        f"max {rd['ref_m']:.2e} m / {rd['ref_rad']:.2e} rad; "
        f"{rd['n_motions']} object motions{' (settled)' if mode == 'stereo_imu' else ''} vs JAX ref max "
        f"{rd['motion_m']:.2e} m; valid track counts vs JAX ref within {rd['count_rel']:.2%}; {detail}; "
        f"first frame {times[0] * 1e3:.1f} ms, median advancing frames 11-{n} {steady * 1e3:.2f} ms = "
        f"{B / steady:.2f} frames/s aggregate, {1 / steady:.2f} per sequence; device ops per advancing "
        f"frame {ops if ops is not None else 'n/a'}, device busy "
        f"{f'{busy:.2f}' if busy is not None else 'n/a'} ms per advancing frame, idle "
        f"{f'{idle:.1%}' if idle is not None else 'n/a'} of the step; K1b "
        f"{f'{k1_ms:.4f}' if k1_ms is not None else 'n/a'} ms per launch; host syncs "
        f"{n_sync / n:.1f}/frame (sites: "
        f"{', '.join(f'{k} x{v}' for k, v in sorted(sites.items(), key=lambda kv: -kv[1])) or 'none'}); "
        f"{time.perf_counter() - t:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in rd['phase_s'].items())})")
    return {f"batched_{name}_b{B}": launches}


def _aligned_truth(np, scene):
    """The scene's camera poses and object motions in the frame of its first
    camera pose (the readers align the first pose to the identity)."""
    X = scene.scn.X_gt.detach().cpu().numpy().astype(np.float64)
    A = np.linalg.inv(X[0])
    H = {oid: np.einsum("ij,fjk,kl->fil", A, h.detach().cpu().numpy().astype(np.float64), X[0])
         for oid, h in zip(scene.scn.object_ids, scene.scn.H_gt)}
    return A @ X, H


def check_reader(torch, name, ds, scene, k):
    """(a) of phase 12: the reader's frame k against what the writer was
    given, within the format's quantisation -> the readings."""
    import numpy as np

    from dynosam_tpu_torch.bench_config import DATASET_FORMATS

    got = {f: v.detach().cpu().numpy() for f, v in ds.frame_host(k).tensors().items()}
    src = {f: v.detach().cpu().numpy() for f, v in scene.frame(k).tensors().items()}
    out = {}
    if not np.array_equal(got["mask"], src["mask"]):
        raise AssertionError(f"{name}: frame {k} mask differs from the written one "
                             f"on {int((got['mask'] != src['mask']).sum())} pixels")
    out["flow_px"] = float(np.abs(got["flow"] - src["flow"]).max())
    # VKITTI's 16-bit codes step 2 (w - 1) / 65535 px; rounding is half a step
    w = src["flow"].shape[1]
    if out["flow_px"] > ((w - 1) / 65535.0 + DATASET_VKITTI_FLOW_PX if name == "vkitti" else 0.0):
        raise AssertionError(f"{name}: frame {k} flow off by {out['flow_px']} px")
    rgb8 = np.floor(src["rgb"] * np.float32(255.0))
    out["rgb_levels"] = float(np.abs(got["rgb"] * np.float32(255.0) - rgb8).max())
    if out["rgb_levels"] > (DATASET_JPEG_LEVELS if name == "vkitti" else 1e-3):
        raise AssertionError(f"{name}: frame {k} rgb off by {out['rgb_levels']} grey levels")
    d, dg = src["depth"].astype(np.float64), got["depth"].astype(np.float64)
    err = np.abs(dg - d)
    _, _, _, (fx, _, _, _), baseline, _, _ = DATASET_FORMATS[name]
    if name in ("viode", "clusterslam"):
        valid = dg > 0
        rel = float(np.median(err[valid] / d[valid]))
        out.update(depth_valid=float(valid.mean()), depth_median_rel=rel)
        if valid.mean() < 0.2 or rel > STEREO_DEPTH_RELERR:
            raise AssertionError(f"{name}: stereo depth valid on {valid.mean():.3f}, median rel err {rel}")
    else:
        if name in ("kitti_png", "omd"):      # uint16 disparity at 1/256 px
            bound = d ** 2 / (fx * baseline * 256.0) * 0.51 + 1e-4
        elif name == "vkitti":                # centimetres
            bound = np.full_like(d, 0.005 + 1e-5)
        else:                                 # depth * 256
            bound = np.full_like(d, 0.5 / 256.0 + 1e-6)
        out["depth_excess"] = float((err - bound).max())
        if out["depth_excess"] > 0:
            raise AssertionError(f"{name}: frame {k} depth beyond its quantisation by {out['depth_excess']} m")
    return out


def dataset_errors(pipe, scene, ref, name):
    """(b) and (c) of phase 12: mature camera poses and matured object
    motions against the scene's ground truth and against the JAX reference's
    run -> readings."""
    import numpy as np

    X = np.stack(pipe.trajectory).astype(np.float64)
    X_true, H_true = _aligned_truth(np, scene)
    X_true = X_true[:len(X)]
    out = {"ate_max_m": float(np.linalg.norm(X[:, :3, 3] - X_true[:, :3, 3], axis=-1).max())}
    dR = np.einsum("kji,kjl->kil", X[:, :3, :3], X_true[:, :3, :3])
    w = 0.5 * np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0], dR[:, 1, 0] - dR[:, 0, 1]], -1)
    out["ate_rot_rad"] = float(np.arcsin(np.clip(np.linalg.norm(w, axis=-1), 0.0, 1.0)).max())
    got_m = pipe.backend.matured_motion
    mot = [float(np.linalg.norm(np.asarray(H)[:3, 3] - H_true[oid][f][:3, 3]))
           for (f, oid), H in got_m.items() if oid in H_true and f > 0]
    if not mot:
        raise AssertionError(f"{name}: no matured object motion")
    out.update(ame_max_m=max(mot), ame_median_m=float(np.median(mot)), n_motions=len(mot))
    ref_err = kitti_errors(pipe, ref, name)
    out.update({f"ref_{k}": v for k, v in ref_err.items()})
    return out


def dataset_run(torch, name, root, device, seed=0):
    """One format of phase 12: write dataset_frames(name) frames of its scene with
    the port's writers, check frame DATASET_CHECK_FRAME read back, run
    run_dynosam.run over the directory at the real-io configuration ->
    (pipeline, scene, readings). The first frame's inputs and the graph
    state after it must lie on `device`; K1 counts are left for the caller."""
    from dynosam_tpu_torch import run_dynosam
    from dynosam_tpu_torch.bench_config import (DATASET_FORMATS, dataset_frames, dataset_scene,
                                                kitti_real_io_config)
    from dynosam_tpu_torch.dataproviders import fixture_writers, kitti_writer
    from dynosam_tpu_torch.dataproviders.base import create_dataset
    from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline
    from dynosam_tpu_torch.utils.stats import Statistics

    dtype, _, _, (fx, _, _, _), baseline, writer_kw, reader_kw = DATASET_FORMATS[name]
    scene = dataset_scene(name, dataset_frames(name), device=device)
    out_dir = os.path.join(root, name)
    t0 = time.perf_counter()
    if name == "kitti_png":
        kitti_writer.write_kitti_sequence(scene, out_dir, base_line=fx * baseline, **writer_kw)
    else:
        writer = {"vkitti": "write_vkitti_sequence", "omd": "write_omd_sequence",
                  "tartanair": "write_tartanair_sequence", "viode": "write_viode_sequence",
                  "clusterslam": "write_clusterslam_sequence", "aria": "write_aria_sequence"}[name]
        getattr(fixture_writers, writer)(scene, out_dir, **writer_kw)
    readings = {"write_s": time.perf_counter() - t0}
    readings.update(check_reader(torch, name, create_dataset(dtype, out_dir, device=device, **reader_kw),
                                 scene, DATASET_CHECK_FRAME))

    first = {}
    process = DynoPipeline.process_frame

    def checked(self, inputs, gt=None):
        result = process(self, inputs, gt)
        if not first:
            first.update(inputs=_device_types(inputs), state=_device_types(self.backend.state))
        return result

    Statistics.reset()
    DynoPipeline.process_frame = checked
    try:
        pipe, n, dt = run_dynosam.run(kitti_real_io_config(), dtype, out_dir, os.path.join(root, name + "_out"),
                                      device=device, dataset_kwargs=reader_kw)
    finally:
        DynoPipeline.process_frame = process
    want = torch.device(device).type
    off = {k: v for part in first.values() for k, v in part.items() if v != want}
    if off or not first:
        raise AssertionError(f"{name}: pipeline tensors not on {want}: {off}")
    decode = Statistics.get("pipeline.decode")
    readings.update(frames=n, run_s=dt, fps=n / dt, decode_ms=decode.mean)
    return pipe, scene, readings


def datasets_readings(torch, ref, device="cuda", names=None):
    """Every format of phase 12 without the bounds -> {name: readings}
    (for calibration on the CPU: device="cpu")."""
    import shutil
    import tempfile

    from dynosam_tpu_torch.bench_config import DATASET_FORMATS
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    root = tempfile.mkdtemp(prefix="smoke_datasets_")
    out = {}
    try:
        for name in names or DATASET_FORMATS:
            st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
            pipe, scene, readings = dataset_run(torch, name, root, device)
            readings["k1"], readings["k1_map"] = _k1_counts(st)
            readings.update(dataset_errors(pipe, scene, ref, name))
            out[name] = readings
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def tooling_readings(torch, seed, out_dir, device="cuda"):
    """Phase 13's runs without the bounds -> (launches per run, readings,
    the phase's line). (a) `python -m dynosam_tpu_torch.run_dynosam --viz`
    (its main(), in this process) over TOOLING_FRAMES fixture frames; (b)
    the same frames through build_pipeline, the packets saved and replayed
    through PacketReplayProvider into a fresh RegularBackend; (c)
    graph_tools on the replayed final window; (d) one detector frame through
    --use_detector --detector_weights, a state dict written here from the
    port's own scale-n, 80-class network under ultralytics' names, and the
    same frame through an engine holding that network directly."""
    import numpy as np

    from dynosam_tpu_torch import jpeg, native
    from dynosam_tpu_torch import run_dynosam as trun
    from dynosam_tpu_torch.backend import graph_tools, hybrid
    from dynosam_tpu_torch.backend.backend import RegularBackend
    from dynosam_tpu_torch.frontend import serialization
    from dynosam_tpu_torch.nn import weights, yolov8
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
    from dynosam_tpu_torch.pipeline import viz

    flags = os.path.join(ROOT, "params", "backend.flags")
    base = ["--dataset_type", "0", "--dataset_path", KITTI_FIXTURE, "--flags", flags, "--device", device]
    rd, launches = {}, {}

    def zero():
        st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
        mc.mask_combine.launches = mc.mask_label.launches = 0

    def counts():
        return {"K1": st.shi_tomasi_cell_max.launches, "K1 map": st.shi_tomasi_response.launches,
                "K2": mc.mask_combine.launches, "K2 label": mc.mask_label.launches}

    # (a) the entry point with --viz
    viz_out = os.path.join(out_dir, "viz_run")
    zero()
    t = time.perf_counter()
    trun.main(base + ["--frames", str(TOOLING_FRAMES), "--output_path", viz_out, "--viz"])
    rd["viz_s"] = time.perf_counter() - t
    launches["viz"] = counts()
    vdir = os.path.join(viz_out, "viz")
    pngs = sorted(f for f in os.listdir(vdir) if f.startswith("tracking_") and f.endswith(".png"))
    imgs = [native.read_png(os.path.join(vdir, f), color=True) for f in pngs]
    traj = native.read_png(os.path.join(vdir, "trajectory_topdown.png"), color=True)
    avi = viz.read_avi_frames(os.path.join(vdir, "tracking.avi"))
    rd["pngs"], rd["avi_frames"], rd["traj_shape"] = len(pngs), len(avi), traj.shape
    decoded = [jpeg.decode_jpeg(f) for f in avi]
    rd["avi_is_png_jpeg"] = all(np.array_equal(d, jpeg.decode_jpeg(jpeg.encode_jpeg(img, 95)))
                                for d, img in zip(decoded, imgs))
    rd["avi_mean_levels"] = max((float(np.abs(d.astype(np.int32) - img).mean()) for d, img in zip(decoded, imgs)),
                                default=float("inf"))

    # (b) packets saved and replayed into a fresh backend
    cfg = trun.build_config(None, [flags])
    intr, frame_it, gt_it, n = trun.open_dataset(0, KITTI_FIXTURE, TOOLING_FRAMES, cfg.backend.max_objects, device)
    zero()
    pipe = trun.build_pipeline(cfg, intr, os.path.join(out_dir, "replay_src"), device=device, seed=seed)
    packets, first_rgb = [], None
    for inputs, gt in zip(frame_it, gt_it):
        first_rgb = inputs.rgb if first_rgb is None else first_rgb
        pipe.process_frame(inputs, gt)
        packets.append(pipe.last_packet)
    pipe.finish()
    launches["replay_source"] = counts()
    path = os.path.join(out_dir, "packets.npz")
    serialization.save_packets(path, packets)
    backend = RegularBackend(pipe.cfg.backend, intr, device=device)
    replayed = [backend.step(p).X_world_cam for p in serialization.PacketReplayProvider(path, device=device)]
    rd["replayed"] = len(replayed)
    rd["replay_m"] = max(float(np.abs(a - o.X_world_cam).max()) for a, o in zip(replayed, pipe.outputs))

    # (c) graph tools on the replayed final window
    g = backend.state
    doc = graph_tools.export_graph_json(g, pipe.cfg.backend, os.path.join(out_dir, "graph.json"), hybrid=True)
    S = hybrid.linearize(g, pipe.cfg.backend, 0.0).S
    stats = graph_tools.sparsity_stats(S)
    graph_tools.save_sparsity_png(S, os.path.join(out_dir, "sparsity.png"))
    rd["graph"] = (doc["frames"], g.num_frames, doc["factors"], stats)
    rd["graph_errors_finite"] = all(np.isfinite(v) for v in doc["errors"].values())

    # (d) the detector from an ultralytics-named state dict
    torch.manual_seed(seed)
    model = yolov8.YoloV8Seg(num_classes=80, scale="n").eval()
    wpath = os.path.join(out_dir, "yolov8n-seg-sd.pt")
    torch.save(weights.ultralytics_state_dict(model), wpath)
    zero()
    trun.main(base + ["--frames", "1", "--output_path", os.path.join(out_dir, "det_run"), "--use_detector",
                      "--detector_weights", wpath])
    launches["detector_weights"] = counts()
    hw = (intr.height, intr.width)
    rgb = first_rgb.to(device)
    la, da = YoloV8DetectorEngine(weights.load_ultralytics_weights(wpath, device=device), input_hw=hw,
                                  device=device).detect(rgb)
    lb, db = YoloV8DetectorEngine(model, input_hw=hw, device=device).detect(rgb)
    rd["det_valid"] = (int(da.valid.sum()), int(db.valid.sum()))
    rd["det_equal"] = bool(torch.equal(da.valid, db.valid) and torch.equal(la, lb))
    rd["det_box_px"] = float((da.boxes - db.boxes)[da.valid].abs().max()) if bool(da.valid.any()) else 0.0
    line = (f"tooling: run_dynosam --viz over {TOOLING_FRAMES} fixture frames on {device} in {rd['viz_s']:.1f} s "
            f"({rd['pngs']} tracking PNGs, trajectory plot {rd['traj_shape']}, AVI of {rd['avi_frames']} "
            f"Motion-JPEG frames, {'each' if rd['avi_is_png_jpeg'] else 'NOT each'} its PNG's JPEG, "
            f"within {rd['avi_mean_levels']:.2f} grey levels of the PNGs on average), "
            f"launches {launches['viz']}; {len(packets)} packets saved and replayed into a fresh "
            f"RegularBackend: {rd['replayed']} camera poses within {rd['replay_m']:.2e} of the pipeline's; "
            f"graph_tools on the final window: {doc['frames']} frames, factors {doc['factors']}, sparsity "
            f"{stats['nnz']} of {stats['rows']}x{stats['cols']} ({stats['fill']:.3f}); --use_detector "
            f"--detector_weights (scale n, 80 classes, ultralytics names) on one frame: launches "
            f"{launches['detector_weights']}, {rd['det_valid'][0]} valid detections, labels and validity "
            f"{'equal to' if rd['det_equal'] else 'NOT equal to'} the network loaded directly, boxes within "
            f"{rd['det_box_px']:.2e} px")
    return launches, rd, line


def run_tooling_path(torch, seed, device="cuda"):
    """Phase 13: the tooling modules through the entry point, held to their
    checks -> {path: launches}."""
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="smoke_tooling_")
    try:
        launches, rd, line = tooling_readings(torch, seed, out_dir, device)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    want = {"viz": {"K1": TOOLING_FRAMES, "K1 map": 0, "K2": 0, "K2 label": 0},
            "replay_source": {"K1": TOOLING_FRAMES, "K1 map": 0, "K2": 0, "K2 label": 0},
            "detector_weights": {"K1": 1, "K1 map": 0, "K2": 0, "K2 label": 1}}
    if torch.device(device).type == "cuda" and launches != want:
        raise AssertionError(f"tooling: launches {launches}, expected {want}")
    frames, fill, factors, stats = rd["graph"]
    fails = [why for why, bad in (
        ("tracking PNGs", rd["pngs"] != TOOLING_FRAMES), ("AVI frames", rd["avi_frames"] != TOOLING_FRAMES),
        ("trajectory plot", rd["traj_shape"] != (512, 512, 3)),
        ("AVI vs PNGs", not (rd["avi_is_png_jpeg"] and rd["avi_mean_levels"] <= TOOLING_JPEG_MEAN_LEVELS)),
        ("replayed poses", rd["replayed"] != TOOLING_FRAMES or not rd["replay_m"] <= TOOLING_REPLAY_M),
        ("graph export", frames != fill or factors["dynamic_point"] <= 0 or not rd["graph_errors_finite"]),
        ("sparsity", not 0 < stats["nnz"] < stats["rows"] * stats["cols"]),
        ("detector", not rd["det_equal"] or not rd["det_box_px"] <= TOOLING_DET_BOX_PX)) if bad]
    if fails:
        raise AssertionError(f"tooling: {', '.join(fails)} failed ({rd})")
    say(line)
    return launches


def run_datasets_path(torch, seed, ref_path, device="cuda", smi=""):
    """Phase 12: the seven on-disk formats, each written by the port's
    writers at its dataset's frame size and run from disk through
    run_dynosam.run, held to DATASET_BOUNDS -> K1 launches."""
    import numpy as np

    from dynosam_tpu_torch.bench_config import DATASET_FORMATS

    ref = np.load(ref_path)
    on_card = torch.device(device).type == "cuda"
    launches = {"K1": 0, "K1 map": 0}
    for name, r in datasets_readings(torch, ref, device).items():
        if on_card and (r["k1"], r["k1_map"]) != (r["frames"], 0):
            raise AssertionError(f"{name}: fused K1 launched {r['k1']} times and the map entry "
                                 f"{r['k1_map']} times over {r['frames']} frames")
        launches["K1"] += r["k1"]
        launches["K1 map"] += r["k1_map"]
        if r["ref_overlap"] < DATASET_MOTION_OVERLAP:
            raise AssertionError(f"{name}: matured motions share {r['ref_overlap']:.3f} of their keys with JAX's")
        bounds = DATASET_BOUNDS[name]
        over = {k: (r[k], b) for k, b in bounds.items() if not r[k] <= b}
        if over:
            raise AssertionError(f"{name}: readings beyond bounds (reading, bound): {over}")
        _, w, h, _, _, _, _ = DATASET_FORMATS[name]
        say(f"{smi} | dataset {name} ({w}x{h}, {r['frames']} frames written in {r['write_s']:.2f} s): "
            f"{r['fps']:.3f} frames/s on {device} through run_dynosam.run (real-io: incremental, 2 LM "
            f"iterations, deferred, prefetch), decode {r['decode_ms']:.2f} ms/frame, fused K1 {r['k1']}, map "
            f"{r['k1_map']}; frame {DATASET_CHECK_FRAME} read back: mask exact, flow {r['flow_px']:.2e} px, rgb "
            f"{r['rgb_levels']:.0f} levels, "
            + (f"stereo depth valid {r['depth_valid']:.3f} median rel {r['depth_median_rel']:.4f}"
               if "depth_valid" in r else f"depth within its quantisation ({r['depth_excess']:.2e} m)")
            + f"; vs GT ATE {r['ate_max_m'] * 100:.3f} cm / {r['ate_rot_rad']:.2e} rad, AME median "
            f"{r['ame_median_m'] * 100:.3f} cm max {r['ame_max_m'] * 100:.3f} cm over {r['n_motions']}; "
            f"vs JAX pose {r['ref_pose_m']:.2e} m / {r['ref_pose_rad']:.2e} rad, motions median "
            f"{r['ref_motion_median_m']:.2e} max {r['ref_motion_max_m']:.2e} m (key overlap "
            f"{r['ref_overlap']:.3f}); bounds {bounds}")
    say(check_progressive_jpeg())
    return launches


def check_progressive_jpeg(testdata=os.path.join(ROOT, "dynosam_tpu_torch", "testdata")):
    """Phase 12's progressive JPEG: the committed 1242x375 file that cv2
    wrote with IMWRITE_JPEG_PROGRESSIVE, decoded by the port's jpeg.py on
    this host, equal to cv2's decode committed beside it -> the line."""
    import numpy as np

    from dynosam_tpu_torch import jpeg

    path = os.path.join(testdata, "progressive_1242x375.jpg")
    want = np.load(os.path.join(testdata, "progressive_1242x375_cv2.npz"))["rgb"]
    times = []
    for _ in range(PROGRESSIVE_RUNS):
        t0 = time.perf_counter()
        got = jpeg.read_jpeg(path)
        times.append(time.perf_counter() - t0)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"progressive JPEG: {int((got != want).sum())} values differ from cv2's decode")
    return (f"progressive JPEG {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} bytes, "
            f"{want.shape[1]}x{want.shape[0]}): equal to cv2's decode pixel for pixel, median "
            f"{statistics.median(times) * 1e3:.1f} ms per frame on the host over {PROGRESSIVE_RUNS} decodes")


def rich_readings(torch, seed, ref, device="cuda"):
    """Phase 15 without its bounds -> (launches, readings, evaluator
    summary, the phase's line). The readings hold, against the nearest JAX
    seed, the pose and motion errors (kitti_errors), `withheld_frames` and
    `resampled_frames` (frames whose rows differ from that seed's) and the
    times."""
    import shutil
    import tempfile

    import numpy as np

    from dynosam_tpu_torch.bench_config import RICH_MIN_AREA, kitti_accuracy_config
    from dynosam_tpu_torch.eval.accuracy import write_rich
    from dynosam_tpu_torch.eval.evaluator import DatasetEvaluator, summarize
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="smoke_rich_")
    try:
        t0 = time.perf_counter()
        write_rich(os.path.join(tmp, "rich"), RICH_FRAMES, "cpu")
        t_write = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(os.path.join(tmp, "rich"))
                      for f in fs)
        rows = []

        def on_frame(pipe, inputs, packet):
            tr = pipe.frontend_state.tracker
            rows.append((tr.obj_ids.clone(), tr.obj_det_area.clone(), packet.object_resampled.clone(),
                         tuple(inputs.mask.shape[-2:])))

        cfg = kitti_accuracy_config("incremental", RICH_FRAMES, min_observable_mask_area=RICH_MIN_AREA)
        st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
        pipe, n, dt, sync = kitti_run(torch, cfg, os.path.join(tmp, "out"), device, seed, RICH_FRAMES,
                                      root=os.path.join(tmp, "rich"), on_frame=on_frame)
        launches = {"K1": st.shi_tomasi_cell_max.launches, "K1 map": st.shi_tomasi_response.launches}
        if on_card and (launches["K1"], launches["K1 map"]) != (n, 0):
            raise AssertionError(f"rich: fused K1 launched {launches['K1']} times and the map entry "
                                 f"{launches['K1 map']} times over {n} frames")
        summary = summarize(DatasetEvaluator(os.path.join(tmp, "out")).run_analysis()["dynosam_tpu"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    withheld, resampled = [], []
    for ids, area, res, (h, w) in rows:
        ids = ids.cpu().numpy()
        floor = RICH_MIN_AREA * float(h * w)
        withheld.append(np.where((ids > 0) & (area.cpu().numpy() < floor), ids, 0))
        resampled.append(res.cpu().numpy())
    withheld, resampled = np.stack(withheld), np.stack(resampled)
    err = compare_kitti(pipe, ref, "incremental", RICH_REF_BOUNDS)
    ref_w, ref_r = ref[f"{err['prefix']}_withheld"], ref[f"{err['prefix']}_resampled"]
    rd = {**err, "withheld_frames": [k for k in range(n) if sorted(withheld[k][withheld[k] > 0]) !=
                                     sorted(ref_w[k][ref_w[k] > 0])],
          "resampled_frames": [k for k in range(n) if not np.array_equal(resampled[k], ref_r[k])],
          "write_s": t_write, "run_s": dt}
    held = {k: sorted(int(o) for o in withheld[k] if o > 0) for k in range(n) if (withheld[k] > 0).any()}
    flagged = {k: np.flatnonzero(resampled[k]).tolist() for k in range(n) if resampled[k].any()}
    syncs = sync.count
    line = (f"rich: {n} frames of the rich fixture (1242x375, 4 objects) rendered on the host and written in "
            f"{t_write:.2f} s ({written / 1e6:.1f} MB), read back padded to {rows[0][3][0]}x{rows[0][3][1]}, "
            f"hybrid incremental at the floor {RICH_MIN_AREA} in {dt:.2f} s ({n / dt:.2f} frames/s, "
            f"{syncs if syncs is not None else 'n/a'} host syncs), fused K1 launches {launches['K1']}, map entry "
            f"{launches['K1 map']}; withheld {held} and resampled slots {flagged}, equal to JAX seed "
            f"{err['run']}'s in every frame; camera ATE {summary['ate_unaligned_m'] * 100:.4f} cm, ATE rot "
            f"{summary['ate_rot_rad']:.5f} rad, AME rms {summary['ame_rms_m'] * 100:.4f} cm, median "
            f"{summary['ame_median_m'] * 100:.4f} cm, {summary['n_motions']:.0f} motions; vs the nearest JAX run, "
            f"seed {err['run']}, over {err['n_motions']} matured motions (key overlap {err['overlap']:.4f}), "
            f"reading / bound / vs seed 0: "
            + ", ".join(f"{k} {err[k]:.2e} / {b:.0e} / {err['seed0'][k]:.2e}" for k, b in RICH_REF_BOUNDS.items()))
    return launches, rd, summary, line


def run_rich_path(torch, seed, ref_path, device="cuda"):
    """Phase 15: rich_readings held to the nearest JAX seed -> launches."""
    import numpy as np

    ref = np.load(ref_path)
    launches, rd, summary, line = rich_readings(torch, seed, ref, device)
    if rd["withheld_frames"] or rd["resampled_frames"]:
        raise AssertionError(f"rich: frames whose withheld objects ({rd['withheld_frames']}) or resample flags "
                             f"({rd['resampled_frames']}) differ from JAX seed {rd['run']}'s")
    ranges = check_kitti_summary(summary, ref, "incremental")
    say(line + "; evaluator inside the JAX seed ranges "
        + ", ".join(f"{k} [{lo:.6g}, {hi:.6g}]" for k, (lo, hi) in ranges.items()))
    return launches


def det_pipeline_readings(torch, seed, ref, device="cuda"):
    """Phase 16 without its bounds -> (launches, readings, the phase's
    line)."""
    import shutil
    import tempfile

    import numpy as np

    from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.eval.accuracy import run_cell, write_detector_scene
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    tmp = tempfile.mkdtemp(prefix="smoke_det_pipe_")
    try:
        t0 = time.perf_counter()
        write_detector_scene(tmp, DET_PIPE_FRAMES)
        t_write = time.perf_counter() - t0
        ds = KittiDataProvider(tmp, device=device)
        hw = (int(ds.intrinsics().height), int(ds.intrinsics().width))
        engine = YoloV8DetectorEngine(input_hw=hw, score_threshold=DET_ACC_SCORE, device=device)
        ids = []
        st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
        mc.mask_combine.launches = mc.mask_label.launches = 0
        with SyncCounter(torch, device) as sync:
            t0 = time.perf_counter()
            r, pipe, assoc = run_cell(ds, DET_PIPE_FRAMES, engine, device, seed,
                                      on_frame=lambda i, p: ids.append((p.object_ids.clone(),
                                                                        p.object_valid.clone())))
            dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"K1": st.shi_tomasi_cell_max.launches, "K2": mc.mask_combine.launches,
                "K2 label": mc.mask_label.launches, "K1 map": st.shi_tomasi_response.launches}
    n = DET_PIPE_FRAMES
    if torch.device(device).type == "cuda" and launches != {"K1": n, "K2": 0, "K2 label": n, "K1 map": 0}:
        raise AssertionError(f"detector pipeline: kernel launches {launches} over {n} frames")
    got_ids = np.stack([np.where(v.cpu().numpy(), i.cpu().numpy(), 0) for i, v in ids])
    fields = [str(f) for f in ref["result_fields"]]
    # the nearest JAX seed by the camera poses (RANSAC's draws)
    runs = {0: "detected", **{int(sd): f"detected_seed{int(sd)}" for sd in ref["seeds"][1:]}}
    errs = {sd: kitti_errors(pipe, ref, "detected", p) for sd, p in runs.items()}
    seed_ref = min(errs, key=lambda sd: errs[sd]["pose_m"])
    prefix = runs[seed_ref]
    err = errs[seed_ref]
    jassoc = {int(a): int(b) for a, b in ref[f"{prefix}_assoc"]}
    if not len(ref[f"{prefix}_motion_key"]) and not pipe.backend.matured_motion:
        # the reference matures no object motion on these frames: nor may the port
        err.update(motion_max_m=0.0, motion_median_m=0.0, overlap=1.0)
    jr = dict(zip(fields, ref["results"][[str(x) for x in ref["rows"]].index("detected")] if seed_ref == 0
                  else ref[f"{prefix}_results"]))
    ref_ids = np.where(ref[f"{prefix}_packet_valid"], ref[f"{prefix}_packet_ids"], 0)
    finite = [k for k in ("ate_t", "ame_t", "ame_t_med") if np.isfinite(jr[k])]
    rd = {**err, "run": seed_ref, "pose_m_seed0": errs[0]["pose_m"],
          "id_frames": [k for k in range(n) if not np.array_equal(got_ids[k], ref_ids[k])],
          "assoc_equal": assoc == jassoc,
          "result_m": max(abs(r[k] - jr[k]) for k in finite),
          "counts_equal": all(int(r[k]) == int(jr[k]) for k in ("n_motions", "n_tracks", "n_assoc"))
          and all(np.isfinite(r[k]) == np.isfinite(jr[k]) for k in ("ate_t", "ame_t", "ame_t_med"))}
    syncs = sync.count
    line = (f"detector pipeline: {n} frames of detector_scene written in {t_write:.2f} s and read back, through "
            f"DynoPipeline with the detected masks (engine at {hw[0]}x{hw[1]}, score {DET_ACC_SCORE}, ByteTrack; "
            f"hybrid sliding-window, window 8) on {device} in {dt:.2f} s ({n / dt:.2f} frames/s, "
            f"{syncs if syncs is not None else 'n/a'} host "
            f"syncs), launches {launches}; camera ATE {r['ate_t'] * 100:.4f} cm (JAX {jr['ate_t'] * 100:.4f}), "
            f"AME rms {r['ame_t'] * 100:.4f} cm (JAX {jr['ame_t'] * 100:.4f}), median {r['ame_t_med'] * 100:.4f} "
            f"cm (JAX {jr['ame_t_med'] * 100:.4f}), {r['n_motions']} motions, {r['n_assoc']}/{r['n_tracks']} "
            f"tracks associated {assoc} (JAX {int(jr['n_motions'])}, {int(jr['n_assoc'])}/{int(jr['n_tracks'])} "
            f"{jassoc}); packet ids differ from JAX's in frames {rd['id_frames']}; vs the nearest JAX run, seed "
            f"{seed_ref} (poses {rd['pose_m_seed0']:.2e} m from seed 0), over {rd['n_motions']} matured motions "
            f"(key overlap {rd['overlap']:.4f}), reading / bound: "
            + ", ".join(f"{k} {rd[k]:.2e} / {b:.0e}" for k, b in DET_PIPE_BOUNDS.items())
            + f", result {rd['result_m']:.2e} / {DET_PIPE_RESULT:.0e} m")
    return launches, rd, line


def run_det_pipeline_path(torch, seed, ref_path, device="cuda"):
    """Phase 16: det_pipeline_readings held to det_acc_ref_20f.npz ->
    launches."""
    import numpy as np

    launches, rd, line = det_pipeline_readings(torch, seed, np.load(ref_path), device)
    over = {k: (rd[k], b) for k, b in DET_PIPE_BOUNDS.items() if not rd[k] <= b}
    if rd["result_m"] > DET_PIPE_RESULT:
        over["result_m"] = (rd["result_m"], DET_PIPE_RESULT)
    if over or rd["id_frames"] or not rd["assoc_equal"] or not rd["counts_equal"] or \
            rd["overlap"] < KITTI_MOTION_OVERLAP:
        raise AssertionError(f"detector pipeline against det_acc_ref_20f.npz: over bounds {over}; {line}")
    say(line)
    return launches


# Phase 17 (train): 6 steps of the port's train_detector from the committed
# checkpoint (read as float32, a fresh optimizer state) at 384x640, batch
# 8, the schedule over T = 1500 (step 0 has lr 0), seed 0, drawing from the
# one-scene pool JAX rendered (testdata/train_ref_6steps.npz,
# make_torch_smoke_reference.py --only train). Each step's loss is held to
# JAX's within TRAIN_LOSS_REL of it; each leaf element's change over the
# steps (parameters and batch_stats) to JAX's (stored in float16: ~1.5e-7
# of rounding at the largest change, 3.0e-4), all but TRAIN_LEAF_SHARE of
# the elements within TRAIN_LEAF_ABS and every one within TRAIN_LEAF_MAX,
# twice the sum of the steps' learning rates (Adam's normalised step
# m / sqrt(v) carries the whole relative error of a gradient element that
# sits near zero, up to a flip of its sign); and the held-out evaluation
# of the written f16 checkpoint over 16 scenes to JAX's eval_iou of its
# own float32 6-step parameters: instances equal, mean IoU within
# TRAIN_EVAL_IOU. Torch on the CPU (4 threads) against JAX on the CPU read:
# losses 2.4e-7 relative, every element within 1.3e-7, mean IoU 2.9e-5
# (35 instances, as JAX), the pool's render 76 of 983,040 pixels one level
# off JAX's, masks equal.
TRAIN_REF = "train_ref_6steps.npz"
TRAIN_LOSS_REL = 1e-5
TRAIN_LEAF_ABS = 2e-6
TRAIN_LEAF_SHARE = 1e-3
TRAIN_EVAL_IOU = 1e-3
# Phase 18 (experiments): run_experiments.main over the fixture, 10 frames,
# forms 0, 1, 3 x modes 0, 1, 2, the port's own RANSAC generator (seed 0):
# each cell's fields within the range of the JAX sweep's seeds 0-5
# (testdata/experiments_ref_10f/seed<s>.npz) widened by margin * the
# range's midpoint, as phase 9 widens its range. Torch on the CPU (2
# threads) read at most, beyond the six seeds' range: ATE 0.26%, ATE rot
# 0.07%, RPE 0.01%, AME rms 2.9% (wcpe batch), AME median 3.8% (wcpe
# sliding); the margins are about twice that (ATE rot as phase 9's: the
# aligned rotation is ill-conditioned about the direction of travel).
# WCME and WCPE sliding-window have bands of their own, EXP_MARGIN_CELL:
# their damped Gauss-Newton accepts every finite step, and on WCME's second
# frame and WCPE's third the step's reduced system is cond ~1e11, the same
# matrix in both packages in float64 but off it by 16-124% of its largest
# entry in float32 on either side, so the step is rounding noise and the
# factorisation's implementation (cuSOLVER here, XLA's in JAX) decides it
# (tests/test_torch_experiments.py::
# test_sliding_window_step_is_float32_rounding_noise). The H100 (runs BV,
# BW, identical) read WCME sliding ATE 24% beyond the seeds' range, AME rms
# 0.7%, AME median 8.0%, and WCPE sliding nothing beyond it; every cell's
# ATE rot at most 28%. So those two cells' camera fields are held to half
# the range's midpoint, AME rms to EXP_MARGIN's 8% and AME median to 16%,
# about twice the card's readings.
EXP_FRAMES = 10
EXP_REF_DIR = "experiments_ref_10f"
EXP_MARGIN = {"ate_trans_rmse": 0.02, "ate_rot_rmse": 0.3, "rpe_trans_rmse": 0.02, "ame_trans_rmse": 0.08,
              "ame_trans_median": 0.08}
EXP_MARGIN_CELL = {c: {"ate_trans_rmse": 0.5, "ate_rot_rmse": 0.5, "rpe_trans_rmse": 0.5, "ame_trans_rmse": 0.08,
                       "ame_trans_median": 0.16} for c in ("wcme_sliding", "wcpe_sliding")}
EXP_SUMMARY_HEADER = "| config | ATE (cm) | AME rms (cm) | AME med (cm) | frontend ms | backend ms |"
# Phase 19 (scale): scale_check.time_config at J=32, F=16, 2048 dynamic
# landmarks, WCME and hybrid sliding-window, the graph after the optimize
# and after the advance held to JAX's (testdata/scale_ref_J32_F16_2048.npz,
# --only scale): frame ids, object slots and motion validity equal, camera
# poses within SCALE_POSE_M, settled motions (valid at the slot before too)
# within SCALE_MOTION_M[formulation]. The port's Scenario draws its landmark
# clouds from the JAX Scenario's uniforms (stored in the file), so both
# backends take the same packets. Torch on the CPU (4 threads) read, after
# the optimize and after the advance alike: poses 4.8e-7 m (both), settled
# motions 5.3e-5 m (WCME, 407 compared) and 3.7e-4 m (hybrid, 376; its
# decoupled object phase moves motions by ~1e-4 under f32 rounding of its
# inputs, ROADMAP queue 3); the bounds are about 10x.
SCALE_J, SCALE_F, SCALE_DYN = 32, 16, 2048
SCALE_REF = f"scale_ref_J{SCALE_J}_F{SCALE_F}_{SCALE_DYN}.npz"
SCALE_POSE_M = 1e-5
SCALE_MOTION_M = {0: 5e-4, 3: 4e-3}


def _zero_all_counts():
    """Every kernel wrapper's launch count to 0 (phases 17-21 read all four,
    the zeros they expect included)."""
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    st.shi_tomasi_cell_max.launches = st.shi_tomasi_response.launches = 0
    mc.mask_combine.launches = mc.mask_label.launches = 0


def _all_counts():
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    return {"K1": st.shi_tomasi_cell_max.launches, "K1 map": st.shi_tomasi_response.launches,
            "K2": mc.mask_combine.launches, "K2 label": mc.mask_label.launches}


def train_readings(torch, ref, device="cuda"):
    """Phase 17 without its bounds -> readings (losses, leaf errors, the
    pool's render against JAX's, the held-out numbers, times, peak memory,
    launches)."""
    import shutil
    import tempfile

    import numpy as np

    from dynosam_tpu_torch import train_detector as td
    from dynosam_tpu_torch.eval import detector_heldout as dh
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine
    from dynosam_tpu_torch.nn.weights import load_flax_checkpoint

    on_card = torch.device(device).type == "cuda"
    steps, batch, total, tseed = (int(v) for v in ref["config"])
    lr = float(ref["lr"])
    rd = {}
    # the one-scene pool: JAX's render (what the steps draw) and the port's
    t0 = time.perf_counter()
    pi, pm, _ = td.build_pool(np.random.default_rng(tseed + 1), 1, device=device)
    rd["pool_render_s"] = time.perf_counter() - t0
    same_shape = np.stack(pi).shape == ref["pool_imgs"].shape
    d = np.abs(np.stack(pi).astype(np.int32) - ref["pool_imgs"].astype(np.int32)) if same_shape else None
    rd["pool_px_differ"] = int((d > 0).any(-1).sum()) if same_shape else -1
    rd["pool_px_total"] = int(np.prod(ref["pool_imgs"].shape[:3]))
    rd["pool_max_levels"] = int(d.max()) if same_shape else -1
    rd["pool_mask_differ"] = int((np.stack(pm) != ref["pool_masks"]).sum()) if same_shape else -1
    pool = (list(ref["pool_imgs"]), list(ref["pool_masks"]), list(ref["pool_cmaps"]))

    leaves = td.load_leaves(td.COMMITTED_CKPT, device)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    opt = td.OptaxAdamW(leaves, lambda c: td.warmup_cosine_lr(c, lr, total))
    step = td.make_train_step(td.make_model(device), opt)
    rng = np.random.default_rng(tseed + 1)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _zero_all_counts()          # the main path: the steps, then the held-out evaluation
    losses, times = [], []
    for _ in range(steps):
        host = td.sample_batch(rng, *pool, batch)
        t0 = time.perf_counter()
        leaves, loss = step(leaves, *td.to_device(host, device))
        losses.append(float(loss))          # waits for the step
        times.append(time.perf_counter() - t0)
    rd["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    rd["losses"], rd["times"] = losses, times
    rd["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"]))
    leaf_err, worst, loose, n_el = 0.0, "", 0, 0
    for k, v in leaves.items():
        e = (v.detach() - start[k] - torch.as_tensor(ref[f"delta/{k}"].astype(np.float32), device=device)).abs()
        loose += int((e > TRAIN_LEAF_ABS).sum())
        n_el += e.numel()
        if float(e.max()) >= leaf_err:
            leaf_err, worst = float(e.max()), k
    rd["leaf_err"], rd["leaf_worst"], rd["n_leaves"] = leaf_err, worst, len(leaves)
    rd["leaf_loose"], rd["n_elements"] = loose, n_el
    rd["leaf_max_bound"] = 2.0 * sum(td.warmup_cosine_lr(c, lr, total) for c in range(steps))
    rd["largest_change"] = max(float(np.abs(ref[f"delta/{k}"]).max()) for k in leaves)

    tmp = tempfile.mkdtemp(prefix="smoke_train_")
    try:
        path = os.path.join(tmp, "yolov8t_seg_synth.msgpack")
        td.save_checkpoint(path, leaves, {"steps": steps, "scale": td.SCALE, "input_hw": [td.IMG_H, td.IMG_W],
                                          "num_classes": td.NUM_CLASSES})
        model, _ = load_flax_checkpoint(path)
        engine = YoloV8DetectorEngine(model, input_hw=(td.IMG_H, td.IMG_W), max_detections=8, score_threshold=0.25,
                                      class_ids=None, device=device)
        t0 = time.perf_counter()
        res = dh.evaluate(int(ref["eval_num_scenes"]), dh.SEED, device=device, engine=engine)
        rd["eval_s"] = time.perf_counter() - t0
        rd["launches"] = _all_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rd["eval"] = (res["mean_mask_iou"], res["class_accuracy"], res["instances"])
    rd["eval_iou_err"] = abs(res["mean_mask_iou"] - float(ref["eval"][0]))
    return rd


def run_train_path(torch, ref_path, device="cuda", smi=""):
    """Phase 17: train_readings held to the JAX run -> launches."""
    import numpy as np

    ref = np.load(ref_path)
    rd = train_readings(torch, ref, device)
    n_scenes = int(ref["eval_num_scenes"])
    if device == "cuda" and rd["launches"] != {"K1": 0, "K1 map": 0, "K2": 0, "K2 label": n_scenes}:
        raise AssertionError(f"train: kernel launches {rd['launches']} over {int(ref['config'][0])} steps and "
                             f"{n_scenes} held-out scenes")
    problems = []
    if not rd["loss_rel"] <= TRAIN_LOSS_REL:
        problems.append(f"loss {rd['losses']} vs JAX {ref['loss'].tolist()} (rel {rd['loss_rel']:.2e})")
    if not (rd["leaf_err"] <= rd["leaf_max_bound"] and rd["leaf_loose"] <= TRAIN_LEAF_SHARE * rd["n_elements"]):
        problems.append(f"leaf change {rd['leaf_err']:.2e} off JAX's at {rd['leaf_worst']} (bound "
                        f"{rd['leaf_max_bound']:.2e}), {rd['leaf_loose']} of {rd['n_elements']} elements beyond "
                        f"{TRAIN_LEAF_ABS:.0e}")
    if rd["eval"][2] != int(ref["eval"][2]) or not rd["eval_iou_err"] <= TRAIN_EVAL_IOU:
        problems.append(f"held-out {rd['eval']} vs JAX {ref['eval'].tolist()}")
    if problems:
        raise AssertionError("train vs the JAX run: " + "; ".join(problems))
    steps, batch, total, _ = (int(v) for v in ref["config"])
    peak = f"{rd['peak_bytes'] / 2**30:.2f} GiB" if rd["peak_bytes"] is not None else "n/a"
    say(f"{smi} | train: {steps} steps of train_detector from the committed checkpoint at "
        f"384x640, batch {batch}, schedule over {total} (lr 0 on step 0), on {device}: "
        f"{statistics.median(rd['times'][1:]) * 1e3:.1f} ms per step (median of steps 1-{steps - 1}; the first "
        f"{rd['times'][0] * 1e3:.1f} ms), peak device memory {peak}; "
        f"losses {', '.join(f'{v:.6f}' for v in rd['losses'])} (JAX {', '.join(f'{v:.6f}' for v in ref['loss'])}; "
        f"largest relative diff {rd['loss_rel']:.2e}, bound {TRAIN_LOSS_REL:.0e}); {rd['n_leaves']} leaves' change "
        f"within {rd['leaf_err']:.2e} of JAX's (bound {rd['leaf_max_bound']:.1e}; largest change "
        f"{rd['largest_change']:.2e}, worst {rd['leaf_worst']}), {rd['leaf_loose']} of {rd['n_elements']} elements "
        f"beyond {TRAIN_LEAF_ABS:.0e} (bound {TRAIN_LEAF_SHARE:.0e} of them); the pool rendered on {device}: "
        f"{rd['pool_px_differ']} of {rd['pool_px_total']} pixels differ from JAX's render, by at most "
        f"{rd['pool_max_levels']} levels, {rd['pool_mask_differ']} mask pixels ({rd['pool_render_s']:.2f} s); the "
        f"written f16 checkpoint loaded back through load_flax_checkpoint: {n_scenes} held-out scenes, K2 label "
        f"entry {rd['launches']['K2 label']} launches, entry A {rd['launches']['K2']}, K1 fused {rd['launches']['K1']}, "
        f"K1 map {rd['launches']['K1 map']} (counted over the steps and the evaluation); {rd['eval'][2]} instances "
        f"(JAX {int(ref['eval'][2])}), mean IoU {rd['eval'][0]:.6f} (JAX's f32 parameters {float(ref['eval'][0]):.6f}, "
        f"|diff| {rd['eval_iou_err']:.2e}, bound {TRAIN_EVAL_IOU:.0e}), class accuracy {rd['eval'][1]:.6f} (JAX "
        f"{float(ref['eval'][1]):.6f}); {rd['eval_s']:.1f} s")
    return rd["launches"]


def experiments_readings(torch, testdata, device="cuda"):
    """Phase 18 without its bounds -> (summary, SUMMARY.md's lines, the
    JAX seeds' (lo, hi) per cell and field, launches, seconds, the files
    one cell wrote, the number of JAX seeds). The sweep draws RANSAC from
    run_experiments' own generator (seed 0), as a user's run does."""
    import glob
    import shutil
    import tempfile

    import numpy as np

    from dynosam_tpu_torch import run_experiments as rx

    refs = [np.load(p) for p in sorted(glob.glob(os.path.join(testdata, EXP_REF_DIR, "seed*.npz")))]
    cells = [str(c) for c in refs[0]["cells"]]
    fields = [str(f) for f in refs[0]["fields"]]
    stack = np.stack([r["summary"] for r in refs])             # (seeds, cells, fields)
    ranges = {(c, f): (float(stack[:, i, j].min()), float(stack[:, i, j].max()))
              for i, c in enumerate(cells) for j, f in enumerate(fields)}
    tmp = tempfile.mkdtemp(prefix="smoke_exp_")
    try:
        _zero_all_counts()
        t0 = time.perf_counter()
        summary = rx.main(["--sequence", f"kitti:{KITTI_FIXTURE}", "--frames", str(EXP_FRAMES), "--forms", "0,1,3",
                           "--modes", "0,1,2", "--out", tmp, "--device", device])
        dt = time.perf_counter() - t0
        launches = _all_counts()
        with open(os.path.join(tmp, "SUMMARY.md")) as fh:
            md = fh.read().splitlines()
        files = sorted(os.listdir(os.path.join(tmp, "kitti_kitti_fixture", cells[0])))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summary, md, ranges, launches, dt, files, len(refs)


def run_experiments_path(torch, testdata, device="cuda"):
    """Phase 18: experiments_readings held to the JAX seeds' range -> launches."""
    summary, md, ranges, launches, dt, files, n_seeds = experiments_readings(torch, testdata, device)
    cells = summary["kitti_kitti_fixture"]
    n_cells = len(cells)
    if device == "cuda" and launches != {"K1": n_cells * EXP_FRAMES, "K1 map": 0, "K2": 0, "K2 label": 0}:
        raise AssertionError(f"experiments: kernel launches {launches} over {n_cells} cells of {EXP_FRAMES} frames")
    errors = {c: r["error"] for c, r in cells.items() if "error" in r}
    if errors or n_cells != 9:
        raise AssertionError(f"experiments: {n_cells} cells, errors {errors}")
    out, excess = [], {}
    for (c, f), (lo, hi) in ranges.items():
        v = float(cells[c][f])
        mid = 0.5 * (lo + hi)
        excess[(c, f)] = max(lo - v, v - hi, 0.0) / mid
        if not excess[(c, f)] <= EXP_MARGIN_CELL.get(c, EXP_MARGIN)[f]:
            out.append(f"{c} {f} {v:.6g} outside JAX's [{lo:.6g}, {hi:.6g}] by {excess[(c, f)]:.2%} of its midpoint")
    if out:
        raise AssertionError("experiments vs the JAX seeds: " + "; ".join(out))
    if EXP_SUMMARY_HEADER not in md:
        raise AssertionError(f"experiments: SUMMARY.md lacks the reference's columns: {md[:4]}")
    tags = [c for c, r in cells.items() if not {"pipeline.frontend", "pipeline.backend"} <= set(r["timing_ms"])]
    if tags:
        raise AssertionError(f"experiments: cells {tags} lack pipeline.frontend / pipeline.backend timings")
    say(f"experiments: run_experiments.main over the fixture, {EXP_FRAMES} frames, forms 0,1,3 x modes 0,1,2 on "
        f"{device}: {n_cells} cells, none with an error, in {dt:.1f} s ({dt / n_cells:.1f} s per cell); fused K1 "
        f"launches {launches['K1']}, map entry {launches['K1 map']}, K2 entries A / B {launches['K2']} / "
        f"{launches['K2 label']}; every field inside the range of {n_seeds} JAX "
        f"seeds widened by a share of its midpoint, EXP_MARGIN ("
        + ", ".join(f"{f} {m:.0%}" for f, m in EXP_MARGIN.items())
        + "), and for " + " and ".join(EXP_MARGIN_CELL) + " EXP_MARGIN_CELL ("
        + ", ".join(f"{f} {m:.0%}" for f, m in next(iter(EXP_MARGIN_CELL.values())).items())
        + "); largest excess beyond the range, of its midpoint, in the other cells: "
        + ", ".join(f"{f} {max(e for (c, g), e in excess.items() if g == f and c not in EXP_MARGIN_CELL):.2%}"
                    for f in EXP_MARGIN)
        + "; " + "; ".join(f"in {c}: " + ", ".join(f"{f} {excess[(c, f)]:.2%}" for f in EXP_MARGIN)
                           for c in EXP_MARGIN_CELL)
        + f"; per cell ATE / AME rms / AME med (cm), frontend / backend ms: "
        + "; ".join(f"{c} {r['ate_trans_rmse'] * 100:.3f} / {r['ame_trans_rmse'] * 100:.3f} / "
                    f"{r['ame_trans_median'] * 100:.3f}, {r['timing_ms']['pipeline.frontend']:.1f} / "
                    f"{r['timing_ms']['pipeline.backend']:.1f}" for c, r in cells.items())
        + f"; each cell wrote {', '.join(files)}")
    return launches


def scale_readings(torch, ref, device="cuda"):
    """Phase 19 without its bounds -> ({formulation: (columns, readings)},
    launches over both runs)."""
    import numpy as np

    from dynosam_tpu_torch import scale_check as sc

    # the JAX Scenario's landmark clouds, so both backends take the same packets
    uniforms = {"static": ref["uniforms_static"], "objects": list(ref["uniforms_objects"])}
    out, launches = {}, {}
    for form in (0, 3):
        _zero_all_counts()
        res, st_opt, st_adv = sc.time_config(SCALE_J, SCALE_F, SCALE_DYN, form, 1, device=device, uniforms=uniforms)
        launches[form] = _all_counts()
        rd = {}
        for tag, g in (("opt", st_opt), ("adv", st_adv)):
            p = f"{form}_{tag}_"
            rd[f"{tag}_structure_equal"] = all(np.array_equal(getattr(g, k).cpu().numpy(), ref[p + k])
                                               for k in ("frame_ids", "obj_ids", "H_valid"))
            rd[f"{tag}_pose_m"] = float(np.abs(g.X.cpu().numpy()[..., :3, 3] - ref[p + "X"][..., :3, 3]).max())
            rd[f"{tag}_pose_rot"] = float(np.abs(g.X.cpu().numpy()[..., :3, :3] - ref[p + "X"][..., :3, :3]).max())
            both = g.H_valid.cpu().numpy() & ref[p + "H_valid"]
            settled = both.copy()
            settled[:, 1:] &= both[:, :-1]
            settled[:, 0] = False
            err = np.linalg.norm(g.H.cpu().numpy()[..., :3, 3] - ref[p + "H"][..., :3, 3], axis=-1)
            rd[f"{tag}_motion_m"] = float(err[settled].max()) if settled.any() else float("nan")
            rd[f"{tag}_n_settled"] = int(settled.sum())
        out[form] = (res, rd)
    return out, launches


def run_scale_path(torch, ref_path, device="cuda", smi=""):
    """Phase 19: scale_readings held to JAX; prints the SCALE.md table it
    would write (the committed dynosam_tpu_torch/SCALE.md is refreshed only
    by `python -m dynosam_tpu_torch.scale_check --out
    dynosam_tpu_torch/SCALE.md`) -> launches, all 0: the path is the
    backend alone."""
    import tempfile

    import numpy as np

    from dynosam_tpu_torch import scale_check as sc

    ref = np.load(ref_path)
    out, launches = scale_readings(torch, ref, device)
    rows, lines = [], []
    for form, (res, rd) in out.items():
        name = {0: "WCME", 3: "Hybrid"}[form]
        if device == "cuda" and any(launches[form].values()):
            raise AssertionError(f"scale {name}: kernel launches {launches[form]} on a path with no kernel")
        bad = [tag for tag in ("opt", "adv") if not (rd[f"{tag}_structure_equal"]
                                                     and rd[f"{tag}_pose_m"] <= SCALE_POSE_M
                                                     and rd[f"{tag}_motion_m"] <= SCALE_MOTION_M[form]
                                                     and rd[f"{tag}_n_settled"] > 0)]
        if bad:
            raise AssertionError(f"scale {name}: after {bad} vs JAX: {rd}")
        rows.append({**res, "formulation": name})
        lines.append(f"{name}: " + ", ".join(f"{c} {res[c]:.4f}" for c in sc.COLUMNS)
                     + "; after the optimize / the advance: frame ids, slots and motion validity equal to JAX's, "
                     f"camera {rd['opt_pose_m']:.2e} / {rd['adv_pose_m']:.2e} m, {rd['opt_n_settled']} / "
                     f"{rd['adv_n_settled']} settled motions within {rd['opt_motion_m']:.2e} / "
                     f"{rd['adv_motion_m']:.2e} m (bounds {SCALE_POSE_M:.0e} m, {SCALE_MOTION_M[form]:.0e} m); "
                     f"launches " + ", ".join(f"{k} {v}" for k, v in launches[form].items()))
    with tempfile.TemporaryDirectory(prefix="smoke_scale_") as tmp:
        path = os.path.join(tmp, "SCALE.md")
        sc.write_scale_md(path, rows, SCALE_J, SCALE_F, SCALE_DYN, smi or sc.device_label(device))
        with open(path) as fh:
            table = [ln for ln in fh.read().splitlines() if ln.startswith("|")]
    say(f"{smi} | scale: scale_check.time_config at J={SCALE_J}, F={SCALE_F}, {SCALE_DYN} dynamic landmarks, "
        f"sliding window, on {device}: " + "; ".join(lines))
    for ln in table:
        say(f"scale table: {ln}")
    return {k: sum(c[k] for c in launches.values()) for k in launches[0]}


# Phase 20 (streaming): exp_streaming (the port of scripts/exp_streaming.py)
# at the script's defaults (20 frames, window 8, modes 0, 1, 2, 10 LM
# iterations), the port's Scenario drawing its landmark clouds and its
# measurement noise from the JAX run's uniforms and normals
# (testdata/streaming_ref_20f.npz, make_torch_smoke_reference.py --only
# streaming). The noisy packets' initial values (lie.retract of the same
# numpy normals, float32 on both sides) within STREAMING_PACKET of JAX's,
# their tracks' valid flags equal, uv within STREAMING_UV_PX on the valid
# tracks (the invalid ones, behind or near the camera plane, amplify the
# pose chains' ulps to pixels and are masked everywhere) and depth within
# STREAMING_DEPTH_M;
# per mode the same scored (frame, object) keys, every frame's pose and
# every scored motion within STREAMING_BOUNDS of JAX's. Each optimize ends
# at the float32 error floor of its LM, and the windowed modes carry each
# tail forward: on identical packets one ulp of one frame's depths moves
# JAX's own sliding-window run by 2.1e-4 m, more than the port differs
# from it (tests/test_torch_streaming.py). The H100 (80GB HBM3, 700 W)
# read: initial values 3.8e-6, uv 4.0e-4 px, depth 1.24e-5 m (its sin /
# cos part the ground-truth chains from JAX's further than the CPU's,
# 1.9e-6 / 6.1e-5 px / 3.8e-6 m); poses 4.4e-5 / 2.6e-4 / 1.5e-4 m and
# motions 4.7e-5 / 6.1e-5 / 1.7e-5 m (full-batch, sliding-window,
# incremental; torch on the CPU at 4 threads 5.5e-5 / 1.5e-4 / 1.4e-4 and
# 8.9e-5 / 7.7e-5 / 2.9e-5). The bounds are about 10x the card's.
STREAMING_REF = "streaming_ref_20f.npz"
STREAMING_PACKET = 4e-5
STREAMING_UV_PX = 4e-3
STREAMING_DEPTH_M = 1e-4
STREAMING_BOUNDS = {"pose_m": 3e-3, "motion_m": 6e-4}
STREAMING_MODES = {0: "full-batch", 1: "sliding-window", 2: "incremental"}
# Phase 21 (fixture writer): make_fixture_sequence.main at its defaults (60
# frames, 320x96) on the card into a temporary directory, held to the
# committed tests/fixtures/kitti_fixture. The same file names; times.txt and
# DatasetParams.yaml byte-equal; RGB images equal. The rest follows the
# scene's float32 pose chains, which part between renderers (se3_exp is
# ill-conditioned at the fixture's 0.002 rad yaw; the committed files were
# rendered elsewhere, and JAX on a CPU renders them 508 mask pixels apart
# too): pose_gt.txt within FIXTURE_BOUNDS["pose_gt_m_per_frame"] per frame,
# object_pose.txt with the same (frame, object) rows, boxes within one
# pixel, translations and yaw within their bounds; masks equal but at
# pixels on a boundary between the two labels, at most
# "mask_pixels_max_frame" in one frame; uint16 disparity within
# "depth_levels" where the masks agree, on at most "depth_share" of those
# pixels; .flo flow within "flow_px" where the masks of both frames agree.
# The H100 (80GB HBM3, 700 W) read poses 6.8e-8 m per frame (2.7e-6 m at
# frame 59: its sin / cos render the committed chains closely), object
# translations 1.4e-5 m, yaw 1.1e-7 rad, boxes 1 px, masks 508 pixels (at
# most 50 in a frame, all on boundaries), disparity 1 level on 0.018%,
# flow 1.8e-4 px (2.74 px at the mask edges), the visibility line equal to
# the committed files'; torch on the CPU (tests/test_torch_fixture_sequence.py
# holds its render to the same bounds) 7.1e-6 m per frame (4.0e-4 m at
# frame 59), 4.5e-4 m, 9.9e-8 rad, 1 px, 507 pixels (50), 1 level on
# 0.093%, 4.6e-4 px. The bounds are about 10x the larger reading (boxes,
# RGB and disparity levels at it).
FIXTURE_BOUNDS = {"pose_gt_m_per_frame": 1e-4, "object_pose_m": 5e-3, "object_yaw_rad": 1e-6,
                  "object_box_px": 1.0, "image_levels": 0, "mask_pixels_max_frame": 500,
                  "depth_levels": 1, "depth_share": 1e-2, "flow_px": 5e-3}


def streaming_draws(ref):
    """The JAX Scenario's uniforms and normals stored in the reference, as
    the port's Scenario takes them."""
    u = {"static": ref["uniforms_static"], "objects": list(ref["uniforms_objects"])}
    n = {"static": (ref["normals_static_pixel"], ref["normals_static_depth"]),
         "objects": list(zip(ref["normals_objects_pixel"], ref["normals_objects_depth"]))}
    return u, n


def _summary_numbers(line):
    """(ATE cm, AME rms cm, AME median cm, rotation rad, motions) of one of
    the script's summary lines."""
    f = line.replace("[", " ").split()
    return float(f[2]), float(f[7]), float(f[10]), float(f[13]), int(f[14])


def streaming_readings(torch, ref, device="cuda"):
    """Phase 20 without its bounds -> (launches, packet readings, {mode:
    readings})."""
    import numpy as np

    from dynosam_tpu_torch import exp_streaming as es

    d = es.DEFAULTS
    n, window, iters = (int(x) for x in ref["args"])
    assert (n, window, iters) == (d["frames"], d["window"], d["iters"]), ref["args"]
    u, nm = streaming_draws(ref)
    jax_lines = {int(ln[5]): ln for ln in ref["lines"] if ln.startswith("mode=")}
    _zero_all_counts()
    t0 = time.perf_counter()
    scn = es.scenario(n, d["pixel_noise"], d["depth_noise"], device, uniforms=u, normals=nm)
    packets = es.noisy_packets(scn, d["init_rot_noise"], d["init_trans_noise"])
    pk = {"packets_s": time.perf_counter() - t0, "initial": 0.0, "uv_px": 0.0, "depth_m": 0.0,
          "valid_equal": True}
    for k, p in enumerate(packets):
        for name, key in (("X_world_cam", "packet_X"), ("odom_prev_curr", "packet_odom"),
                          ("object_motions", "packet_motions")):
            pk["initial"] = max(pk["initial"], float(np.abs(getattr(p, name).cpu().numpy() - ref[key][k]).max()))
        for table in ("static", "dynamic"):
            tt = getattr(p, f"{table}_tracks")
            valid = ref[f"packet_{table}_valid"][k]
            pk["uv_px"] = max(pk["uv_px"], float(np.abs(tt.uv.cpu().numpy() - ref[f"packet_{table}_uv"][k])[valid]
                                                 .max(initial=0.0)))
            pk["depth_m"] = max(pk["depth_m"], float(np.abs(tt.depth.cpu().numpy()
                                                            - ref[f"packet_{table}_depth"][k]).max()))
            pk["valid_equal"] &= bool(np.array_equal(tt.valid.cpu().numpy(), valid))
    modes = {}
    for mode in (int(m) for m in d["modes"].split(",")):
        t0 = time.perf_counter()
        be, step_s, end_s = es.run_mode(mode, scn, packets, window, iters, device)
        wall = time.perf_counter() - t0
        me, pe = es.motion_errors(be, scn), es.pose_errors(be, scn)
        X = np.stack([be.pose_at(k) for k in range(n)])
        keys = [tuple(int(x) for x in key) for key in ref[f"{mode}_motion_key"]]
        r = {"wall_s": wall, "end_s": end_s, "first_step_ms": step_s[0] * 1e3,
             # the steady step: the median over frames 2.. (frame 0 opens the
             # graph, frame 1 is the first optimize with objects)
             "step_ms": statistics.median(step_s[2:]) * 1e3,
             "pose_m": float(np.abs(X - ref[f"{mode}_X"]).max()),
             "keys_equal": sorted(me) == sorted(keys),
             "motion_m": max((float(np.abs(be.motion_at(*key) - H).max())
                              for key, H in zip(keys, ref[f"{mode}_motion_H"]) if key in me), default=float("nan")),
             "err_m": max((abs(me[key][0] - e[0]) for key, e in zip(keys, ref[f"{mode}_motion_err"]) if key in me),
                          default=float("nan")),
             "summary": es.summary(me, pe), "jax_line": jax_lines[mode],
             "line": es.summary_line(mode, es.summary(me, pe))}
        modes[mode] = r
    return _all_counts(), pk, modes


def run_streaming_path(torch, ref_path, device="cuda", smi=""):
    """Phase 20: streaming_readings held to the JAX run -> launches, all 0:
    the path is the backend alone."""
    import numpy as np

    ref = np.load(ref_path)
    launches, pk, modes = streaming_readings(torch, ref, device)
    over = []
    if device == "cuda" and any(launches.values()):
        over.append(f"kernel launches {launches} on a path with no kernel")
    if not (pk["valid_equal"] and pk["initial"] <= STREAMING_PACKET and pk["uv_px"] <= STREAMING_UV_PX
            and pk["depth_m"] <= STREAMING_DEPTH_M):
        over.append(f"packets {pk}")
    parts = []
    for mode, r in modes.items():
        if not (r["keys_equal"] and r["pose_m"] <= STREAMING_BOUNDS["pose_m"]
                and r["motion_m"] <= STREAMING_BOUNDS["motion_m"] and r["err_m"] <= STREAMING_BOUNDS["motion_m"]):
            over.append(f"mode {mode}: {({k: v for k, v in r.items() if k not in ('summary', 'line', 'jax_line')})}")
        s, j = r["summary"], _summary_numbers(r["jax_line"])
        parts.append(f"{STREAMING_MODES[mode]}: ATE {s['ate'] * 100:.3f} cm (JAX {j[0]:.3f}), AME rms "
                     f"{s['ame_rms'] * 100:.3f} cm ({j[1]:.3f}), median {s['ame_med'] * 100:.3f} cm ({j[2]:.3f}), "
                     f"rot {s['rot_rms']:.5f} rad ({j[3]:.5f}), {s['n_motions']} motions ({j[4]}); poses "
                     f"{r['pose_m']:.2e} m and motions {r['motion_m']:.2e} m from JAX's, the same scored keys: "
                     f"{r['keys_equal']}; {r['wall_s']:.2f} s wall, step {r['step_ms']:.2f} ms steady "
                     f"(first {r['first_step_ms']:.1f} ms), finish + matured {r['end_s'] * 1e3:.1f} ms")
    line = (f"{smi} | streaming: exp_streaming at the script's defaults on {device}, the JAX run's draws: packets "
            f"in {pk['packets_s']:.2f} s, initial values {pk['initial']:.2e} from JAX's (bound "
            f"{STREAMING_PACKET:.0e}), valid equal {pk['valid_equal']}, uv {pk['uv_px']:.2e} px on the valid tracks, "
            f"depth {pk['depth_m']:.2e} m; "
            + "; ".join(parts) + f" (bounds {STREAMING_BOUNDS}); launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items()))
    if over:
        raise AssertionError(f"streaming against {os.path.basename(ref_path)}: {over}; {line}")
    say(line)
    for mode, r in modes.items():
        say(f"streaming {r['line']}")
    return launches


def _tree(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


def _rows(path):
    with open(path) as f:
        return [[float(x) for x in ln.split()] for ln in f.read().splitlines() if ln.strip()]


def _on_boundary(mask, v, u, labels):
    near = mask[max(v - 1, 0):v + 2, max(u - 1, 0):u + 2]
    return all((near == lab).any() for lab in labels)


def fixture_file_readings(ref_dir, out_dir):
    """A dyno-KITTI sequence written at `out_dir` against the one at
    `ref_dir` (phase 21's readings; the port's decoders, no cv2)."""
    import numpy as np

    from dynosam_tpu_torch import native

    names = _tree(ref_dir)
    r = {"names_equal": names == _tree(out_dir), "n_files": len(names)}

    def raw(root, rel):
        with open(os.path.join(root, rel), "rb") as f:
            return f.read()

    r["text_unequal"] = [f for f in ("times.txt", "DatasetParams.yaml") if raw(ref_dir, f) != raw(out_dir, f)]
    pa, pb = (np.array(_rows(os.path.join(d, "pose_gt.txt"))) for d in (ref_dir, out_dir))
    r["pose_rows_equal"] = pa.shape == pb.shape and bool((pa[:, 0] == pb[:, 0]).all())
    dp = np.abs(pa[:, 1:] - pb[:, 1:]).max(1) if r["pose_rows_equal"] else np.array([np.inf])
    r["pose_gt_m"] = float(dp.max())
    r["pose_gt_m_per_frame"] = float((dp / np.maximum(pa[:, 0], 1)).max())
    oa, ob = ({(int(x[0]), int(x[1])): np.array(x[2:]) for x in _rows(os.path.join(d, "object_pose.txt"))}
              for d in (ref_dir, out_dir))
    r["object_rows_equal"] = sorted(oa) == sorted(ob)
    shared = sorted(set(oa) & set(ob))
    r["object_box_px"] = float(max(np.abs(oa[k][:4] - ob[k][:4]).max() for k in shared))
    r["object_pose_m"] = float(max(np.abs(oa[k][4:7] - ob[k][4:7]).max() for k in shared))
    r["object_yaw_rad"] = float(max(abs(oa[k][7] - ob[k][7]) for k in shared))
    r.update(image_levels=0, mask_pixels=0, mask_pixels_max_frame=0, mask_off_boundary=0, depth_levels=0,
             flow_px=0.0, flow_px_anywhere=0.0)
    n_depth = n_depth_off = 0
    vis = {"ref": {}, "out": {}}
    masks = {}

    def mask(root, k, h, w):
        if (root, k) not in masks:
            masks[(root, k)] = native.read_txt_mask(os.path.join(root, "motion", f"{k:06d}.txt"), h, w)
        return masks[(root, k)]

    n = len(pa)
    for k in range(n):
        s = f"{k:06d}"
        ia, ib = (native.read_png(os.path.join(d, "image_0", s + ".png")).astype(np.int64) for d in (ref_dir, out_dir))
        r["image_levels"] = max(r["image_levels"], int(np.abs(ia - ib).max()))
        h, w = ia.shape[:2]
        ma, mb = mask(ref_dir, k, h, w), mask(out_dir, k, h, w)
        for tag, m in (("ref", ma), ("out", mb)):
            for oid in np.unique(m[m > 0]):
                vis[tag][int(oid)] = vis[tag].get(int(oid), 0) + int((m == oid).sum() >= 25)
        diff = np.argwhere(ma != mb)
        r["mask_pixels"] += len(diff)
        r["mask_pixels_max_frame"] = max(r["mask_pixels_max_frame"], len(diff))
        r["mask_off_boundary"] += sum(not (_on_boundary(ma, v, u, (ma[v, u], mb[v, u]))
                                           and _on_boundary(mb, v, u, (ma[v, u], mb[v, u]))) for v, u in diff)
        same = ma == mb
        da, db = (native.read_png(os.path.join(d, "depth", s + ".png")).astype(np.int64) for d in (ref_dir, out_dir))
        dd = np.abs(da - db)[same]
        r["depth_levels"] = max(r["depth_levels"], int(dd.max(initial=0)))
        n_depth += dd.size
        n_depth_off += int((dd > 0).sum())
        fa, fb = (native.read_flo(os.path.join(d, "flow", s + ".flo"), h, w) for d in (ref_dir, out_dir))
        fd = np.abs(fa - fb).max(-1)
        # file k holds the k -> k+1 flow: where frame k's and k+1's masks agree
        ok = same & (mask(ref_dir, k + 1, h, w) == mask(out_dir, k + 1, h, w)) if k + 1 < n else same
        r["flow_px"] = max(r["flow_px"], float(fd[ok].max(initial=0.0)))
        r["flow_px_anywhere"] = max(r["flow_px_anywhere"], float(fd.max()))
        masks.pop((ref_dir, k - 1), None)
        masks.pop((out_dir, k - 1), None)
    r["depth_share"] = n_depth_off / max(n_depth, 1)
    r["visible_ref"], r["visible_out"] = vis["ref"], vis["out"]
    return r


def fixture_writer_over(r):
    """The readings of fixture_file_readings outside FIXTURE_BOUNDS (or
    structurally different) -> {name: reading}."""
    over = {k: r[k] for k, b in FIXTURE_BOUNDS.items() if not r[k] <= b}
    for k in ("names_equal", "pose_rows_equal", "object_rows_equal"):
        if not r[k]:
            over[k] = r[k]
    if r["text_unequal"] or r["mask_off_boundary"]:
        over.update(text_unequal=r["text_unequal"], mask_off_boundary=r["mask_off_boundary"])
    return over


def fixture_writer_readings(torch, device="cuda"):
    """Phase 21 without its bounds -> (launches, readings, the entry
    point's printed lines, wall seconds)."""
    import contextlib
    import io
    import tempfile

    from dynosam_tpu_torch import make_fixture_sequence as mfs

    with tempfile.TemporaryDirectory(prefix="smoke_fixture_") as tmp:
        out = os.path.join(tmp, "kitti_fixture")
        buf = io.StringIO()
        _zero_all_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mfs.main(["--out", out, "--device", device])
        wall = time.perf_counter() - t0
        launches = _all_counts()
        r = fixture_file_readings(KITTI_FIXTURE, out)
    return launches, r, buf.getvalue().splitlines(), wall


def run_fixture_writer_path(torch, device="cuda", smi=""):
    """Phase 21: the fixture writer's entry point held to the committed
    fixture -> launches, all 0 (the renderer and the writer run no hand
    kernel)."""
    launches, r, lines, wall = fixture_writer_readings(torch, device)
    over = fixture_writer_over(r)
    if r["visible_ref"] != r["visible_out"]:
        over["visible"] = (r["visible_ref"], r["visible_out"])
    if device == "cuda" and any(launches.values()):
        over["launches"] = launches
    line = (f"{smi} | fixture writer: python -m dynosam_tpu_torch.make_fixture_sequence at its defaults on {device} "
            f"in {wall:.2f} s ({' / '.join(lines)}); against tests/fixtures/kitti_fixture: names equal "
            f"{r['names_equal']} ({r['n_files']} files), times.txt and DatasetParams.yaml byte-equal "
            f"{not r['text_unequal']}, RGB {r['image_levels']} levels off, pose_gt {r['pose_gt_m']:.2e} m "
            f"({r['pose_gt_m_per_frame']:.2e} m per frame), object boxes {r['object_box_px']:.0f} px, translations "
            f"{r['object_pose_m']:.2e} m, yaw {r['object_yaw_rad']:.2e} rad, masks {r['mask_pixels']} pixels apart "
            f"(at most {r['mask_pixels_max_frame']} in a frame, {r['mask_off_boundary']} off a label boundary), "
            f"disparity {r['depth_levels']} levels on {r['depth_share']:.4%} where the masks agree, flow "
            f"{r['flow_px']:.2e} px where they agree ({r['flow_px_anywhere']:.2f} px anywhere), visible frames "
            f"{r['visible_out']} (committed {r['visible_ref']}); bounds {FIXTURE_BOUNDS}; launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items()))
    if over:
        raise AssertionError(f"fixture writer over bounds {over}; {line}")
    say(line)
    return launches


# phase 22: the multi-device path (dynosam_tpu_torch/multichip.py, the port
# of the reference's dryrun_multichip): make_batched_pipeline at
# bench_config over a process group, MULTICHIP_B sequences of the bench
# scene (sequence b on scene frames b..b+11: the window fills and advances
# twice), each rank on the card stepping its B/P of them, and
# sharded_optimize at scale_check's defaults (J=32, F=16, 2048 dynamic,
# 256 static; five iterations). Runs: 2 ranks over gloo on the one card
# (NCCL refuses two ranks on one GPU) and 1 rank over NCCL (the NCCL calls
# on the card), and NCCL over min(count, 4) cards where the machine has
# more than one. Every sequence held to the ground truth and
# bench_batched_ref_b8_20f.npz's first 12 frames at phase 11's bounds (GT_*,
# REF_*), and to the unsharded batched run of this process at
# MULTICHIP_UNSHARDED; with rank 0's own unsharded run (multichip's
# SHARD_BOUNDS) and sharded_optimize to chunked_optimize at the same P
# (multichip.check_failures) where the run's third field says so: not at
# world 1, where both are the same program; every rank's system and step
# equal to rank 0's; K1b once per frame on every rank, the K1 map entry and
# K2 never. MULTICHIP_UNSHARDED: the H100 (700 W) read 7.6e-6 on poses and
# 5.5695e-4 on motions over 2 gloo ranks, in every run; the CPU 0 at one
# thread per process. The cause is torch's CUDA sum over a
# batch (scripts/bisect_torch_batch.py): the camera refit's weighted point
# sum over (B, 800, 3) (ops/kabsch.py::solve_rigid_quat) splits its 800
# terms by a launch shape that depends on B, so a row of B=4 rounds
# otherwise than the same row of B=8 from frame 1 (one ulp, 1.95e-3 of
# ~1e4), and the motion solvers carry it to 5.5695e-4 m at frame 10 (the
# first advance), the same reading as the ranks'
# (tests/test_torch_cuda.py::test_point_sum_rounds_by_batch_size). Poses
# ~13x that reading (1e-4); motions ~3x (1.7e-3).
MULTICHIP_B = 8
MULTICHIP_FRAMES = 12
MULTICHIP_RUNS = (("gloo", 2, True), ("nccl", 1, False))
MULTICHIP_UNSHARDED = {"pose": 1e-4, "motion": 1.7e-3}


def multichip_readings(torch, seed, ref, device="cuda", runs=MULTICHIP_RUNS):
    """Phase 22 without its bounds -> ({run: (batched, sharded, readings)},
    the unsharded run's steady step ms). `readings` holds the sequences'
    errors (batched_errors), the largest differences from this process's
    unsharded run, and every failure multichip.check_failures finds."""
    from dynosam_tpu_torch import multichip
    from dynosam_tpu_torch.bench_config import bench_config, bench_scene
    from dynosam_tpu_torch.parallel.batched import make_batched_pipeline

    cfg, intr = bench_config()
    B, n = MULTICHIP_B, MULTICHIP_FRAMES
    scene = bench_scene(intr, n + B - 1, device=device)
    frames = scene.frames()
    stacked = [_stack_inputs(torch, frames[k:k + B]) for k in range(n)]
    step, init = make_batched_pipeline(cfg, intr, torch.Generator(device=device).manual_seed(seed))
    outs, times = _drive(torch, step, init(B, device), stacked, device)
    unsharded = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    del frames, stacked, outs
    if device == "cuda":
        torch.cuda.empty_cache()
    out = {}
    for backend, ranks, reference in runs:
        batched, sharded = multichip.run(ranks, backend, device, B, n, seed, reference=reference,
                                         threads=None if device == "cuda" else 1)
        got = {k: torch.as_tensor(v, device=device) for k, v in batched[0]["outputs"].items()}
        rd = batched_errors(torch, [{k: v[i] for k, v in got.items()} for i in range(n)], ref, B, n,
                            scene.scn.X_gt, device)
        d = multichip.output_diffs(got, unsharded)
        rd["unsharded"] = d
        rd["failures"] = multichip.check_failures(batched, sharded)
        out[(backend, ranks)] = (batched, sharded, rd)
    return out, statistics.median(times[10:]) * 1e3


def run_multichip_path(torch, seed, ref_path, device="cuda", smi=""):
    """Phase 22: the multi-device path, held to its bounds -> {path:
    launches}, one path per run and rank."""
    import numpy as np

    from dynosam_tpu_torch import multichip

    runs = list(MULTICHIP_RUNS)
    count = torch.cuda.device_count() if device == "cuda" else 1
    if count > 1:
        runs.append(("nccl", min(count, 4), True))
    results, unsharded_ms = multichip_readings(torch, seed, np.load(ref_path), device, tuple(runs))
    paths = {}
    for (backend, ranks), (batched, sharded, rd) in results.items():
        checks = {"gt_m": GT_TRANS_M, "gt_rad": GT_ROT_RAD, "ref_m": REF_TRANS_M, "ref_rad": REF_ROT_RAD,
                  "motion_m": REF_MOTION_TRANS_M}
        over = {k: (rd[k], v) for k, v in checks.items() if not rd[k] <= v}
        d = rd["unsharded"]
        for k, bound in (("X_world_cam", MULTICHIP_UNSHARDED["pose"]), ("frontend_pose", MULTICHIP_UNSHARDED["pose"]),
                         ("object_motions", MULTICHIP_UNSHARDED["motion"]), ("object_ids", 0),
                         ("object_motion_valid", 0)):
            if not d[k] <= bound:
                over[f"unsharded {k}"] = (d[k], bound)
        for r in batched:
            paths[f"multichip_{backend}_r{ranks}_rank{r['rank']}"] = r["launches"]
            want = {"K1": MULTICHIP_FRAMES if device == "cuda" else 0, "K1 map": 0, "K2": 0, "K2 label": 0}
            if r["launches"] != want:
                over[f"rank {r['rank']} launches"] = (r["launches"], want)
        lines = multichip.report(batched, sharded, ranks, MULTICHIP_FRAMES)
        line = (f"multichip {backend} x {ranks} on {device} ({smi}): {' | '.join(lines)}; sequences vs GT max "
                f"{rd['gt_m']:.2e} m / {rd['gt_rad']:.2e} rad, vs JAX ref max {rd['ref_m']:.2e} m / "
                f"{rd['ref_rad']:.2e} rad, {rd['n_motions']} motions max {rd['motion_m']:.2e} m; vs this "
                f"process's unsharded run {d} (bounds {MULTICHIP_UNSHARDED}; its steady step "
                f"{unsharded_ms:.2f} ms at {torch.get_num_threads()} threads)")
        if over or rd["failures"]:
            raise AssertionError(f"multichip {backend} x {ranks}: over bounds {over}; {rd['failures']}; {line}")
        say(line)
    return paths


# phases 5-22 that run in a second process beside this one's (the host-bound
# pipeline, dataset and experiment runs, and the tracked-scene phases, which
# render on the host: ~half of the phases' time)
SECOND_LANE = ("6t (tracked klt)", "7t (tracked stereo + IMU)", "9 (pipeline)", "11c (tracked batched stereo + IMU)",
               "12 (datasets)", "16 (detector pipeline)", "18 (experiments)", "21 (fixture writer)")


def _timed(phase, fn, *a, **kw):
    t = time.perf_counter()
    out = fn(*a, **kw)
    say(f"phase {phase} done in {time.perf_counter() - t:.1f} s")
    return out


def main_path_phases(torch, seed, testdata, smi):
    """{phase: (function, args, kwargs)} of phases 5-22, in order; each
    returns its launches."""
    j = os.path.join
    return {
        "5 (bench)": (run_bench_path, (torch, seed, j(testdata, "bench_ref_20f.npz")), {}),
        "5b (pipelined)": (run_pipelined_path, (torch, seed, j(testdata, "bench_pipelined_ref_20f.npz")), {}),
        "6 (klt)": (run_klt_path, (torch, seed, j(testdata, "bench_klt_ref_20f.npz")), {}),
        "7 (stereo + IMU)": (run_klt_path, (torch, seed, j(testdata, "stereo_imu_ref_12f.npz")),
                             {"stereo_imu": True}),
        "6t (tracked klt)": (run_klt_path, (torch, seed, j(testdata, f"tracked_klt_ref_{KLT_FRAMES}f.npz")),
                             {"tracked": True}),
        "7t (tracked stereo + IMU)": (run_klt_path,
                                      (torch, seed, j(testdata, f"tracked_stereo_imu_ref_{STEREO_IMU_FRAMES}f.npz")),
                                      {"stereo_imu": True, "tracked": True}),
        "8 (detector)": (run_detector_path, (torch, seed, j(testdata, "det_ref_24f.npz")), {}),
        "8b (held-out)": (run_heldout_path, (torch, j(testdata, "det_heldout_ref_48.npz")), {}),
        "9 (pipeline)": (run_pipeline_path, (torch, seed, j(testdata, f"kitti_ref_{PIPE_FRAMES}f.npz")),
                         {"smi": smi}),
        "10 (formulations)": (run_forms_path, (torch, seed, testdata), {}),
        "11 (batched)": (run_batched_path, (torch, seed, j(testdata, "bench_batched_ref_b8_20f.npz")),
                         {"smi": smi}),
        "11c (tracked batched stereo + IMU)": (
            check_batched_mode,
            (torch, seed, j(testdata, f"tracked_batched_stereo_imu_ref_b{BATCHED_MODES_B}_{BATCHED_MODES_FRAMES}f.npz"),
             "stereo_imu"), {"smi": smi, "tracked": True}),
        "12 (datasets)": (run_datasets_path, (torch, seed, j(testdata, "datasets_ref_12f.npz")), {"smi": smi}),
        "13 (tooling)": (run_tooling_path, (torch, seed), {}),
        "14 (batched modes)": (run_batched_modes_path, (torch, seed, testdata), {"smi": smi}),
        "15 (rich)": (run_rich_path, (torch, seed, j(testdata, f"rich_ref_{RICH_FRAMES}f.npz")), {}),
        "16 (detector pipeline)": (run_det_pipeline_path,
                                   (torch, seed, j(testdata, f"det_acc_ref_{DET_PIPE_FRAMES}f.npz")), {}),
        "17 (train)": (run_train_path, (torch, j(testdata, TRAIN_REF)), {"smi": smi}),
        "18 (experiments)": (run_experiments_path, (torch, testdata), {}),
        "19 (scale)": (run_scale_path, (torch, j(testdata, SCALE_REF)), {"smi": smi}),
        "20 (streaming)": (run_streaming_path, (torch, j(testdata, STREAMING_REF)), {"smi": smi}),
        "21 (fixture writer)": (run_fixture_writer_path, (torch,), {"smi": smi}),
        "22 (multichip)": (run_multichip_path, (torch, seed, j(testdata, "bench_batched_ref_b8_20f.npz")),
                           {"smi": smi}),
    }


def run_lane(names, seed, testdata, smi):
    """The phases `names` in this (spawned) process, on the kernels phase 2
    built -> {phase: launches}."""
    import torch

    from dynosam_tpu_torch.ops.cuda import _build
    from dynosam_tpu_torch.ops.cuda import mask_combine as mc
    from dynosam_tpu_torch.ops.cuda import shi_tomasi as st

    for src in (st.SOURCE, mc.SOURCE):
        _build.load(src)
    phases = main_path_phases(torch, seed, testdata, smi)
    return {name: _timed(name, fn, *a, **kw) for name, (fn, a, kw) in phases.items() if name in names}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the RANSAC and test-input generators")
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    testdata = os.path.join(root, "dynosam_tpu_torch", "testdata")

    import torch

    t_start = time.perf_counter()
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
    # (K2 v3, the kernel before its redesign, only for phase 4's times)
    t0 = time.perf_counter()
    jobs = {str(_build.CSRC / src): lambda src=src: _build.build(src)
            for src in (st.SOURCE, mc.SOURCE, K2_V3_SOURCE)}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {src: pool.submit(job) for src, job in jobs.items()}
        built = {src: f.result() for src, f in futures.items()}
    for src, (lib, build_s) in built.items():
        say(f"built {os.path.relpath(src, root)} -> {os.path.relpath(lib, root)} "
            f"with nvcc {' '.join(_build.NVCC_FLAGS)} in {build_s:.2f} s"
            + (" (cached)" if build_s == 0.0 else ""))
    say(f"all {len(jobs)} builds done in {time.perf_counter() - t0:.2f} s wall")

    # ---- 3, 4. kernels against their plain versions --------------------------
    k1 = _timed("3 (K1)", check_k1, torch, args.seed)
    k2 = _timed("4 (K2)", check_k2, torch, args.seed, built[K2_V3_SOURCE][0])

    # ---- 5-22. the main paths, counts zeroed just before each, in two lanes --
    import multiprocessing

    phases = main_path_phases(torch, args.seed, testdata, smi)
    with ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn")) as pool:
        second = pool.submit(run_lane, SECOND_LANE, args.seed, testdata, smi)
        out = {name: _timed(name, fn, *a, **kw) for name, (fn, a, kw) in phases.items()
               if name not in SECOND_LANE}
        out.update(second.result())
    (bench_launches, pipelined_launches, klt_launches, stereo_launches, tracked_klt_launches,
     tracked_stereo_launches, det_launches, heldout_launches, (pipe_launches, _), forms_launches,
     batched_launches, tracked_batched_launches, dataset_launches, tooling_launches, modes_launches,
     rich_launches, det_pipe_launches, train_launches, exp_launches, scale_launches, streaming_launches,
     fixture_launches, multichip_launches) = (out[name] for name in phases)

    # ---- 23. results ------------------------------------------------------------
    paths = {"bench": bench_launches, "pipelined": pipelined_launches, "klt": klt_launches,
             "stereo_imu": stereo_launches, "klt_tracked": tracked_klt_launches,
             "stereo_imu_tracked": tracked_stereo_launches, "detector": det_launches, "heldout": heldout_launches,
             "pipeline": pipe_launches, **forms_launches, **batched_launches, **tracked_batched_launches,
             "datasets": dataset_launches,
             **{f"tooling_{k}": v for k, v in tooling_launches.items()}, **modes_launches, "rich": rich_launches,
             "detector_pipeline": det_pipe_launches, "train": train_launches, "experiments": exp_launches,
             "scale": scale_launches, "streaming": streaming_launches, "fixture_writer": fixture_launches,
             **multichip_launches}
    # the batched step's paths, and each multichip rank's (its B/P sequences)
    batched = {p for p in paths if p.startswith(("batched_", "multichip_"))}

    def row(name, kid, source, replaces, check, only=None, **extra):
        # K1's counter counts the fused entry on every path; on the batched
        # paths it launches as K1b (the kernel's blockIdx.z over B)
        by_path = {p: launches.get(kid, 0) for p, launches in paths.items() if only is None or only(p)}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": check["max_abs_err"], "ms": check["ms"], "plain_ms": check["plain_ms"],
                "bound_ms": check["bound"][0], "bound_by": check["bound"][1],
                # no single PyTorch call computes K1's or the label image's
                # function; entry A's yardstick is the cuBLAS product alone
                "library_ms": check.get("library_ms"),
                "timing": f"ms, plain_ms, library_ms: one event pair around up to {LOOP_LAUNCHES} back-to-back "
                          f"calls (loop_calls), divided by their count; *single_launch_ms: median of one event "
                          f"pair per call; profiler_ms: torch.profiler's device time per call",
                **{k: v for k, v in check.items() if k not in ("max_abs_err", "ms", "plain_ms", "bound",
                                                              "library_ms")}, **extra}

    say(f"all phases done in {time.perf_counter() - t_start:.1f} s (builds included; the limit is 1200 s)")
    st_src, mc_src = "dynosam_tpu_torch/csrc/shi_tomasi.cu", "dynosam_tpu_torch/csrc/mask_combine.cu"
    print(json.dumps({"kernels": [
        row("shi_tomasi_cell_max", "K1", st_src, "dynosam_tpu/ops/pallas/shi_tomasi.py:31", k1["fused"],
            only=lambda p: p not in batched),
        row("shi_tomasi_response (K1 map entry)", "K1 map", st_src, "dynosam_tpu/ops/pallas/shi_tomasi.py:31",
            k1["map"]),
        row("shi_tomasi_cell_max batched (K1b)", "K1", st_src, "dynosam_tpu/ops/pallas/shi_tomasi.py:87",
            k1["batched"], only=lambda p: p in batched),
        row("mask_combine (K2 entry A)", "K2", mc_src, "dynosam_tpu/ops/pallas/mask_combine.py:23", k2["combine"]),
        row("mask_label (K2 entry B)", "K2 label", mc_src, "dynosam_tpu/ops/pallas/mask_combine.py:23",
            k2["label"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
