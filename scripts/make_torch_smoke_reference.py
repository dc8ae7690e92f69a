"""Write the JAX reference outputs that chip_smoke.py holds the port to.

Runs the JAX package on the CPU and writes five files under
dynosam_tpu_torch/testdata/:

  * bench_ref_20f.npz — the fused step (parallel/batched.py::make_fused_step)
    at bench.bench_config() over the first 20 bench frames: the 10-frame
    window fills and then advances 10 times. Per frame: X_world_cam,
    object_ids, object_motions, object_motion_valid.
  * det_ref_24f.npz — the detector path over the 24 frames of the port's
    detector_scene() at detector_config(): per frame the YOLOv8-seg engine
    (committed checkpoint, XLA mask combination) labels the rendered frame,
    then the fused step runs on it with ByteTrack relabelling. Per frame: the
    detection table (det_boxes, det_scores, det_classes, det_valid), the
    label image as uint8, and the fused step's outputs as above.
  * kitti_ref_30f.npz — the host pipeline (DynoPipeline -> RegularBackend,
    CSV logs, DatasetEvaluator) over the first 30 of the 60 frames of
    tests/fixtures/kitti_fixture in the three hybrid modes at ACCURACY.md's
    on-disk configuration (dynosam_tpu_torch.bench_config.kitti_accuracy_config).
    Per mode, RANSAC seed 0: the mature camera poses `<mode>_X` (30, 4, 4)
    and the matured object motions `<mode>_motion_key` (N, 2) [frame id,
    object id] with `<mode>_motion_H` (N, 4, 4). `summary` (mode, seed,
    field) holds the evaluator's numbers under seeds 0-5, and
    `seed_spread` (mode, seed, field of `spread_fields`) how far each seed
    lands from seed 0: its poses (largest translation, m, and rotation,
    rad) and its matured motions on the shared keys (largest and median
    translation, m). The other seeds' runs are kept too, as
    `<mode>_seed<s>_X`, `_motion_key` and `_motion_H`: where an LM
    accept/reject decision lies within f32 rounding, seeds take either
    branch (full-batch seed 3 at frame 26's warm start, sliding-window seed
    5 at frame 29), and the port must land on one of the runs.
  * bench_klt_ref_20f.npz — the KLT path: the fused step at bench_config()
    tracking by KLT on CLAHE-equalized frames (prefer_provided_optical_flow
    False) over the first 20 frames of bench.make_frames(world_texture=True).
    Per frame the fused step's outputs as above and the counts of valid
    static and dynamic tracks after the step (n_static, n_dynamic).
  * stereo_imu_ref_12f.npz — the stereo + IMU path: the KLT configuration
    with use_imu and the IMU rotation prior, over 12 frames of the same
    world-textured bench scene, each frame carrying the right image rendered
    at +baseline along camera x, its provided depth corrupted by 1.15x and
    the 32-sample IMU window of the interval before it. The same keys as
    the KLT file.
  * bench_{wcme,wcpe,joint}_ref_20f.npz (--only forms) — the fused step at
    bench.bench_config() with the WCME (backend_updater_enum 0) and WCPE (1)
    backends and the joint hybrid solve (3, decoupled_object_solve False)
    over the 20 bench frames, keys as bench_ref_20f.npz; the joint file
    also holds `cov_X` (F, 6, 6) and `cov_H` (J, F, 6, 6), the marginal
    covariances of the final window.
  * kitti_forms_ref_30f.npz (--only forms, or alone --only forms_kitti) —
    the host pipeline over the first 30 fixture frames in incremental mode with the WCME and WCPE backends at
    ACCURACY.md's on-disk configuration (scripts/accuracy_report.py
    run_config_dataset), RANSAC seeds 0, 1 and 2, keys as kitti_ref_30f.npz
    with the formulation ("wcme", "wcpe") in place of the mode. This part
    builds its configurations from the JAX package alone.
  * bench_batched_ref_b8_20f.npz (--only batched) — the batched step
    (parallel/batched.py::make_batched_pipeline, jitted, its own per-sequence
    keys) at bench.bench_config() over B=8 sequences of one 27-frame bench
    scene, sequence b taking frames b .. b+19: the window fills and then
    advances 10 times. Keys as bench_ref_20f.npz, each (frames, B, ...).
  * bench_batched_{wcme,wcpe,joint}_ref_b8_20f.npz (--only batched_forms) —
    the same batched run with the WCME (backend_updater_enum 0) and WCPE
    (1) backends and the joint hybrid solve (decoupled_object_solve off),
    keys as bench_batched_ref_b8_20f.npz.
  * bench_batched_bytetrack_ref_b8_14f.npz and
    bench_batched_stereo_imu_ref_b8_14f.npz (--only batched_modes) — the
    batched step at the port's bench_config.batched_bytetrack_config() /
    batched_stereo_imu_config() (set in the JAX package's DynoConfig without
    editing it) over B=8 sequences, sequence b taking scene frames b ..
    b+13: the window fills and then advances 4 times. ByteTrack runs on the
    bench frames with each mask's labels permuted per frame and per
    sequence by bench_config.label_permutations(0, ...), saved as
    `label_lut` (frames, B, 17); stereo + IMU on the frames of the stereo_imu
    file (world-textured, right image, 1.15x depth, 32 IMU samples). Keys as
    bench_batched_ref_b8_20f.npz, plus per frame and sequence n_static /
    n_dynamic, the valid track counts, and the static tracks' s_uv,
    s_depth and s_valid.
  * bench_pipelined_ref_20f.npz (--only pipelined) — the pipelined fused
    step (make_fused_step(..., pipelined=True), jitted) at
    bench.bench_config() over the 20 bench frames, keys as
    bench_ref_20f.npz.

  * datasets_ref_12f.npz (--only datasets) — the host pipeline at the port's
    real-io configuration (bench_config.kitti_real_io_config(): hybrid
    incremental, 2 LM iterations, deferred outputs) over each on-disk format
    of bench_config.DATASET_FORMATS: the port's two-object dataset scene
    rendered by the JAX package at the format's frame size and camera,
    written by the JAX writers (dyno-KITTI's masks converted to png), read
    by the JAX readers padded to multiples of 32 as run_dynosam reads them,
    bench_config.dataset_frames(name) frames (12; VIODE and Aria 10),
    RANSAC seed 0. Per format `<name>_X` (frames, 4, 4) mature
    camera poses and `<name>_motion_key` / `<name>_motion_H` the matured
    object motions, as kitti_ref_30f.npz.
  * det_heldout_ref_48.npz (--only heldout) — the committed detector
    checkpoint's held-out evaluation (scripts/train_detector.py eval_iou:
    48 scenes of random_scene from np.random.default_rng(10_000), the JAX
    engine with at most 8 detections, score 0.25, no class filter, the
    XLA mask combination) rerun: per ground-truth instance its best mask
    IoU (`iou`), class hit (`class_hit`), `scene` and `frame`; the totals
    mean_mask_iou, class_accuracy, instances, mean_detected_iou,
    missed_rate; and the checkpoint's sidecar numbers as json_*.

  * rich_ref_50f.npz (--only rich) — hybrid incremental at the rich
    matrix's observability floor (bench_config.RICH_MIN_AREA) over the
    first 50 frames of the rich fixture (bench_config.fixture_scenario at
    1242x375, rich=True, rendered by the port on the CPU and written by the
    port's dyno-KITTI writer: see _write_rich), read by the JAX reader
    padded to multiples of 32 as run_dynosam reads it, RANSAC seeds 0-5:
    keys as kitti_ref_30f.npz, plus per run `_withheld` (frames, J), the ids
    the floor withheld per frame, and `_resampled` (frames, J), the
    packets' object_resampled flags.
  * rich_matrix_ref_100f.npz (--only rich_matrix) — scripts/accuracy_rich.py's
    nine cells (modes 1, 2, 0 x formulations 3, 1, 0) over the 100-frame
    rich fixture (read unpadded) at the floor, seed 0: `summary` (cell,
    FULL_SUMMARY_FIELDS, the frontend's columns included) and each cell's
    poses and matured motions.
  * rich_seeds_ref_100f/<mode>_<formulation>.npz (--only rich_seeds
    [--cells ...] [--seeds ...]) — the matrix's WCME and WCPE cells under
    RANSAC seeds 1-5 (full-batch: seed 1, ~40-75 min a cell on the CPU): `seeds`
    and `summary` (seed, FULL_SUMMARY_FIELDS), rewritten after every
    seed. With seed 0 of the matrix file they are the spread the RANSAC
    draws give these cells, which eval/accuracy.py holds them to.
  * --only rich_draws writes nothing: it prints the port's rows of four of
    those cells on the CPU with JAX seed 0's RANSAC draws injected, beside
    the matrix file's (rich_draws_check).
  * sweep_ref_60f.npz (--only sweep) — hybrid sliding-window at windows 8,
    12 and 16 over the 60-frame fixture, seed 0, keys as the matrix file.
  * det_acc_ref_60f.npz (--only det_acc) — scripts/accuracy_detector.py
    run_cell with the provided and the detected masks (the engine at the
    fixture's 96x320, score 0.35) over the fixture's 60 frames, seed 0:
    `results` (row, result_fields), and per row the poses, matured motions,
    association `_assoc` (estimated id, ground-truth id) and the packets'
    object ids and valid flags.
  * det_acc_ref_20f.npz (--only det_pipe) — the same run over the first 20
    frames of bench_config.detector_scene (the scene the checkpoint was
    trained on; it finds nothing on the fixture), rendered by the port on
    the CPU and written by its dyno-KITTI writer, the engine at 384x640,
    the detected row also under seeds 1-5.
  * progressive_1242x375.jpg and progressive_1242x375_cv2.npz (--only
    progressive) — a synthetic frame cv2 wrote as a progressive JPEG, and
    cv2's decode of it.

Usage: JAX_PLATFORMS=cpu python scripts/make_torch_smoke_reference.py
    [--only bench|detector|kitti|klt|stereo_imu|forms|forms_kitti|batched|batched_forms|batched_modes|pipelined|
            datasets|heldout|rich|rich_matrix|rich_seeds|rich_draws|sweep|det_acc|det_pipe|progressive]
    [--cells incremental_0,...] [--seeds 1,2,...]   (rich_seeds only)
(~80 s for the first two files; ~32 min for the third, most of it the
full-batch runs at a 60-frame window; a few minutes for each of the two
after it; the forms files' CPU time is in CHANGES.md)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BENCH_FRAMES = 20
DET_FRAMES = 24
TESTDATA = os.path.join(ROOT, "dynosam_tpu_torch", "testdata")
BENCH_OUT = os.path.join(TESTDATA, "bench_ref_20f.npz")
DET_OUT = os.path.join(TESTDATA, "det_ref_24f.npz")
KLT_FRAMES = 20
KLT_OUT = os.path.join(TESTDATA, "bench_klt_ref_20f.npz")
STEREO_IMU_FRAMES = 12
STEREO_IMU_OUT = os.path.join(TESTDATA, "stereo_imu_ref_12f.npz")
IMU_SAMPLES = 32
DEPTH_CORRUPTION = 1.15
KITTI_FRAMES = 30             # the three hybrid modes (chip_smoke.py phase 9)
KITTI_OUT = os.path.join(TESTDATA, f"kitti_ref_{KITTI_FRAMES}f.npz")
KITTI_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "kitti_fixture")
KITTI_FORMS_FRAMES = 30       # the WCME / WCPE fixture runs (phase 10)
KITTI_MODES = ("incremental", "sliding_window", "full_batch")
KITTI_SEEDS = (0, 1, 2)
KITTI_30F_SEEDS = (0, 1, 2, 3, 4, 5)
KITTI_SUMMARY_FIELDS = ("ate_unaligned_m", "ate_rot_rad", "ame_rms_m", "ame_median_m", "n_motions")
KITTI_SPREAD_FIELDS = ("pose_m", "pose_rad", "motion_max_m", "motion_median_m")
KEYS = ("X_world_cam", "object_ids", "object_motions", "object_motion_valid")
FORMS_BENCH = {"wcme": {"backend.backend_updater_enum": 0}, "wcpe": {"backend.backend_updater_enum": 1},
               "joint": {"backend.decoupled_object_solve": False}}
FORMS_KITTI = {"wcme": 0, "wcpe": 1}
KITTI_FORMS_OUT = os.path.join(TESTDATA, f"kitti_forms_ref_{KITTI_FORMS_FRAMES}f.npz")
RICH_FRAMES = 50              # object 4's two drop-outs and re-entries (chip_smoke.py phase 15a)
RICH_OUT = os.path.join(TESTDATA, f"rich_ref_{RICH_FRAMES}f.npz")
RICH_MATRIX_FRAMES = 100      # the nine cells of scripts/accuracy_rich.py
RICH_MATRIX_OUT = os.path.join(TESTDATA, f"rich_matrix_ref_{RICH_MATRIX_FRAMES}f.npz")
# (mode, formulation) in scripts/accuracy_rich.py's order: modes 1, 2, 0,
# formulations 3, 1, 0
RICH_SEEDS_OUT = os.path.join(TESTDATA, f"rich_seeds_ref_{RICH_MATRIX_FRAMES}f")
RICH_SEED_CELLS = tuple(f"{m}_{f}" for m in ("sliding_window", "incremental", "full_batch") for f in (1, 0))
RICH_SEEDS = {"sliding_window": (1, 2, 3, 4, 5), "incremental": (1, 2, 3, 4, 5), "full_batch": (1,)}
RICH_CELLS = tuple((m, f) for m in ("sliding_window", "incremental", "full_batch") for f in (3, 1, 0))
SWEEP_FRAMES = 60
SWEEP_OUT = os.path.join(TESTDATA, f"sweep_ref_{SWEEP_FRAMES}f.npz")
DET_ACC_FRAMES = 60           # the table's run, on the fixture
DET_ACC_OUT = os.path.join(TESTDATA, f"det_acc_ref_{DET_ACC_FRAMES}f.npz")
DET_PIPE_FRAMES = 20          # the smoke's run (phase 16), on the detector's scene
DET_PIPE_OUT = os.path.join(TESTDATA, f"det_acc_ref_{DET_PIPE_FRAMES}f.npz")
PROGRESSIVE_JPG = os.path.join(TESTDATA, "progressive_1242x375.jpg")
PROGRESSIVE_REF = os.path.join(TESTDATA, "progressive_1242x375_cv2.npz")
# the evaluator's numbers of a run, as scripts/accuracy_report.py
# run_config_dataset summarises them (fe_*: the frontend's own estimates)
FULL_SUMMARY_FIELDS = ("ate_t", "ate_r", "rpe_t", "ame_t", "ame_r", "ame_t_med", "ame_r_med", "n_motions",
                       "fe_ate_t", "fe_ame_t", "fe_ame_t_med")
BATCHED_B = 8
BATCHED_OUT = os.path.join(TESTDATA, "bench_batched_ref_b8_20f.npz")
BATCHED_MODES_FRAMES = 14     # the window fills, then advances 4 times
BATCHED_BYTETRACK_OUT = os.path.join(TESTDATA, f"bench_batched_bytetrack_ref_b8_{BATCHED_MODES_FRAMES}f.npz")
BATCHED_STEREO_IMU_OUT = os.path.join(TESTDATA, f"bench_batched_stereo_imu_ref_b8_{BATCHED_MODES_FRAMES}f.npz")
PIPELINED_OUT = os.path.join(TESTDATA, "bench_pipelined_ref_20f.npz")
DATASETS_OUT = os.path.join(TESTDATA, "datasets_ref_12f.npz")
HELDOUT_OUT = os.path.join(TESTDATA, "det_heldout_ref_48.npz")
HELDOUT_SCENES = 48
HELDOUT_SEED = 10_000


def _save(path, arrays, t0):
    import numpy as np

    np.savez_compressed(path, **arrays)
    print(f"wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} bytes) "
          f"in {time.time() - t0:.1f} s", flush=True)


def _run(step, state, frames, per_frame=None, track_counts=False):
    """The step over the frames -> {output key: (frames, ...)}; with
    track_counts also n_static / n_dynamic, the valid tracks per frame."""
    import numpy as np

    outs = {k: [] for k in KEYS + (("n_static", "n_dynamic") if track_counts else ())}
    for fr in frames:
        if per_frame is not None:
            fr = per_frame(fr)
        state, out = step(state, fr)
        for key in KEYS:
            outs[key].append(np.asarray(out[key]))
        if track_counts:
            outs["n_static"].append(int(state.frontend.tracker.s_valid.sum()))
            outs["n_dynamic"].append(int(state.frontend.tracker.d_valid.sum()))
    return {k: np.stack(v) for k, v in outs.items()}


def bench_reference():
    import jax

    import bench
    from dynosam_tpu.parallel.batched import init_pipeline_state, make_fused_step

    t0 = time.time()
    cfg, intr = bench.bench_config()
    frames = bench.make_frames(intr, num_frames=BENCH_FRAMES)
    step = jax.jit(make_fused_step(cfg, intr))
    _save(BENCH_OUT, _run(step, init_pipeline_state(cfg), frames), t0)


def pipelined_reference():
    import jax

    import bench
    from dynosam_tpu.parallel.batched import init_pipeline_state, make_fused_step

    t0 = time.time()
    cfg, intr = bench.bench_config()
    frames = bench.make_frames(intr, num_frames=BENCH_FRAMES)
    step = jax.jit(make_fused_step(cfg, intr, pipelined=True))
    _save(PIPELINED_OUT, _run(step, init_pipeline_state(cfg), frames), t0)


def batched_reference(forms=False):
    """The batched step over B=8 sequences: the bench's hybrid backend, or
    with `forms` each of FORMS_BENCH in its own file."""
    import jax
    import jax.numpy as jnp

    import bench
    from dynosam_tpu.parallel.batched import make_batched_pipeline

    cfg0, intr = bench.bench_config()
    frames = bench.make_frames(intr, num_frames=BENCH_FRAMES + BATCHED_B - 1)
    stacked = [jax.tree.map(lambda *x: jnp.stack(x), *frames[k:k + BATCHED_B]) for k in range(BENCH_FRAMES)]
    runs = ([(os.path.join(TESTDATA, f"bench_batched_{name}_ref_b8_20f.npz"), cfg0.with_overrides(over))
             for name, over in FORMS_BENCH.items()] if forms else [(BATCHED_OUT, cfg0)])
    for path, cfg in runs:
        t0 = time.time()
        step, init = make_batched_pipeline(cfg, intr)
        _save(path, _run(step, init(BATCHED_B), stacked), t0)


def _klt_cfg(**overrides):
    import bench

    cfg, intr = bench.bench_config()
    return cfg.with_overrides({"frontend.tracker.prefer_provided_optical_flow": False, **overrides}), intr


def klt_reference():
    import jax

    import bench
    from dynosam_tpu.parallel.batched import init_pipeline_state, make_fused_step

    t0 = time.time()
    cfg, intr = _klt_cfg()
    frames = bench.make_frames(intr, num_frames=KLT_FRAMES, world_texture=True)
    step = jax.jit(make_fused_step(cfg, intr))
    state = init_pipeline_state(cfg, image_shape=(intr.height, intr.width))
    _save(KLT_OUT, _run(step, state, frames, track_counts=True), t0)


def _stereo_imu_frames(intr, n):
    """frame(k) of the port's bench scene, world-textured, rendered by the
    JAX package over `n` frames: the right image at +baseline along camera
    x, the provided depth corrupted by DEPTH_CORRUPTION and the
    IMU_SAMPLES-sample window of the interval before it."""
    import jax.numpy as jnp

    from dynosam_tpu.dataproviders.simulator import ObjectSpec, ScenarioSpec
    from dynosam_tpu.dataproviders.synthetic_dense import DenseScenario
    from dynosam_tpu_torch import bench_config as tbench

    tscene = tbench.bench_scene(tbench.bench_config()[1], n, device="cpu", world_texture=True)
    sp = tscene.scn.spec
    spec = ScenarioSpec(
        num_frames=sp.num_frames, num_static=0, camera_motion_xi=sp.camera_motion_xi,
        frame_dt=sp.frame_dt,
        objects=[ObjectSpec(object_id=o.object_id, initial_pose_xi=o.initial_pose_xi,
                            motion_xi=o.motion_xi, num_points=0) for o in sp.objects],
    )
    scene = DenseScenario(spec, intr, ground_y=tscene.ground_y, far_depth=tscene.far_depth,
                          world_texture=True, object_half_extents=tscene.obj_extents)
    T_lr = jnp.eye(4).at[0, 3].set(float(intr.baseline))

    def frame(k):
        fr = scene.frame(k)
        X_r = scene.scn.X_gt[k] @ T_lr
        L_k = scene._L_all[:, k]
        depth_r, mask_r = scene._depth_mask(X_r, L_k)
        imu, imu_valid = scene.scn.imu_window(k, IMU_SAMPLES)
        return fr.replace(depth=fr.depth * DEPTH_CORRUPTION,
                          right=scene._world_rgb(X_r, L_k, depth_r, mask_r),
                          imu_samples=imu, imu_valid=imu_valid)

    return frame


def stereo_imu_reference():
    import jax

    from dynosam_tpu.parallel.batched import init_pipeline_state, make_fused_step

    t0 = time.time()
    cfg, intr = _klt_cfg(**{"frontend.use_imu": True, "frontend.imu.use_rotation_prior": True})
    frame = _stereo_imu_frames(intr, STEREO_IMU_FRAMES)
    step = jax.jit(make_fused_step(cfg, intr))
    state = init_pipeline_state(cfg, image_shape=(intr.height, intr.width))
    frames = [frame(k) for k in range(STEREO_IMU_FRAMES)]
    _save(STEREO_IMU_OUT, _run(step, state, frames, track_counts=True), t0)


def batched_modes_reference():
    """The batched step over B=8 sequences in the two frontend modes of the
    port's bench_config.batched_{bytetrack,stereo_imu}_config(), sequence b
    taking scene frames b .. b+BATCHED_MODES_FRAMES-1."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu.parallel.batched import make_batched_pipeline
    from dynosam_tpu_torch import bench_config as tbench

    B, n = BATCHED_B, BATCHED_MODES_FRAMES

    def stack(frames):
        return jax.tree.map(lambda *x: jnp.stack(x), *frames)

    def run(path, tcfg, intr, stacked, extra):
        t0 = time.time()
        step, init = make_batched_pipeline(DynoConfig.from_dict(dataclasses.asdict(tcfg)), intr)
        state = init(B)
        outs = {k: [] for k in KEYS + ("n_static", "n_dynamic", "s_uv", "s_depth", "s_valid")}
        for fr in stacked:
            state, out = step(state, fr)
            for key in KEYS:
                outs[key].append(np.asarray(out[key]))
            trk = state.frontend.tracker
            outs["n_static"].append(np.asarray(trk.s_valid.sum(-1)))
            outs["n_dynamic"].append(np.asarray(trk.d_valid.sum(-1)))
            for key in ("s_uv", "s_depth", "s_valid"):
                outs[key].append(np.asarray(getattr(trk, key)))
        _save(path, {**{k: np.stack(v) for k, v in outs.items()}, **extra}, t0)

    # ByteTrack: the bench frames with each mask's labels permuted per frame
    # and per sequence (bench_config.label_permutations, seed 0)
    tcfg, _ = tbench.batched_bytetrack_config()
    _, intr = bench.bench_config()
    frames = bench.make_frames(intr, num_frames=n + B - 1)
    lut = tbench.label_permutations(0, n, B, 2 * tcfg.frontend.max_objects)
    stacked = [stack([frames[k + b].replace(mask=jnp.asarray(lut[k, b])[frames[k + b].mask])
                      for b in range(B)]) for k in range(n)]
    run(BATCHED_BYTETRACK_OUT, tcfg, intr, stacked, {"label_lut": lut})

    # stereo + IMU on the provided flow
    tcfg, _ = tbench.batched_stereo_imu_config()
    frame = _stereo_imu_frames(intr, n + B - 1)
    frames = [frame(k) for k in range(n + B - 1)]
    run(BATCHED_STEREO_IMU_OUT, tcfg, intr, [stack(frames[k:k + B]) for k in range(n)], {})


def detector_reference():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from flax import serialization

    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu.cv import camera as jcam
    from dynosam_tpu.dataproviders.simulator import ObjectSpec, ScenarioSpec
    from dynosam_tpu.dataproviders.synthetic_dense import DenseScenario
    from dynosam_tpu.nn import detector as jdet
    from dynosam_tpu.parallel.batched import init_pipeline_state, make_fused_step
    from dynosam_tpu_torch import bench_config as tbench

    t0 = time.time()
    tcfg, tintr = tbench.detector_config()
    cfg = DynoConfig.from_dict(dataclasses.asdict(tcfg))
    tscene = tbench.detector_scene(tintr, DET_FRAMES, device="cpu")
    intr = jcam.CameraIntrinsics.create(tintr.fx, tintr.fy, tintr.cx, tintr.cy, width=tintr.width,
                                        height=tintr.height, baseline=tintr.baseline)
    sp = tscene.scn.spec
    spec = ScenarioSpec(
        num_frames=sp.num_frames, num_static=0, camera_motion_xi=sp.camera_motion_xi,
        objects=[ObjectSpec(object_id=o.object_id, initial_pose_xi=o.initial_pose_xi,
                            motion_xi=o.motion_xi, num_points=0) for o in sp.objects],
    )
    scene = DenseScenario(
        spec, intr, ground_y=tscene.ground_y, far_depth=tscene.far_depth,
        world_texture=True, object_texture=True, object_half_extents=tscene.obj_extents,
        object_classes=tscene.object_classes,
    )
    # the committed checkpoint, as the engine's default loads it (its 2-class
    # head drops the COCO filter), with the XLA mask combination of the CPU
    with open(jdet.CKPT_PATH, "rb") as fh:
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                 serialization.msgpack_restore(fh.read()))
    with open(jdet.CKPT_PATH + ".json") as fh:
        import json

        meta = json.load(fh)
    engine = jdet.YoloV8DetectorEngine(variables, num_classes=meta["num_classes"], scale=meta["scale"],
                                       class_ids=None, use_pallas_masks=False)
    dets = {k: [] for k in ("det_boxes", "det_scores", "det_classes", "det_valid", "labels")}

    def detect(fr):
        label, det = engine.detect(fr.rgb)
        dets["det_boxes"].append(np.asarray(det.boxes))
        dets["det_scores"].append(np.asarray(det.scores))
        dets["det_classes"].append(np.asarray(det.classes))
        dets["det_valid"].append(np.asarray(det.valid))
        dets["labels"].append(np.asarray(label).astype(np.uint8))
        return fr.replace(mask=label)

    step = jax.jit(make_fused_step(cfg, intr))
    outs = _run(step, init_pipeline_state(cfg), scene.frames(), per_frame=detect)
    outs.update({k: np.stack(v) for k, v in dets.items()})
    _save(DET_OUT, outs, t0)


def heldout_reference():
    """The checkpoint's held-out evaluation (scripts/train_detector.py
    eval_iou) rerun, keeping each instance's IoU and class hit; raises
    unless its totals equal eval_iou's own over the same scenes."""
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np
    from flax import serialization

    from dynosam_tpu.nn import detector as jdet

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_detector as td

    t0 = time.time()
    with open(jdet.CKPT_PATH, "rb") as fh:
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                 serialization.msgpack_restore(fh.read()))
    with open(jdet.CKPT_PATH + ".json") as fh:
        meta = json.load(fh)
    # eval_iou's engine: at most 8 detections, score 0.25, no class filter,
    # the XLA mask combination
    engine = jdet.YoloV8DetectorEngine(variables, num_classes=meta["num_classes"], scale=meta["scale"],
                                       input_hw=(td.IMG_H, td.IMG_W), max_detections=8,
                                       score_threshold=0.25, class_ids=None, use_pallas_masks=False)
    rng = np.random.default_rng(HELDOUT_SEED)
    out = {k: [] for k in ("iou", "class_hit", "scene", "frame")}
    for s in range(HELDOUT_SCENES):
        scn = td.random_scene(rng)
        cm = td._cls_of_oid(scn)
        k = int(rng.integers(0, scn.scn.spec.num_frames))
        fr = scn.frame(k)
        gt = np.asarray(fr.mask)
        label, det = engine.detect(jnp.asarray(fr.rgb))
        label = np.asarray(label)
        det_cls = np.asarray(det.classes)
        for oid in np.unique(gt):           # eval_iou's scoring
            if oid <= 0:
                continue
            g = gt == oid
            if g.sum() < 40:
                continue
            best, best_lab = 0.0, -1
            for lab in np.unique(label):
                if lab <= 0:
                    continue
                p = label == lab
                iou = np.logical_and(g, p).sum() / max(np.logical_or(g, p).sum(), 1)
                if iou > best:
                    best, best_lab = iou, int(lab)
            out["iou"].append(best)
            out["class_hit"].append(best_lab > 0 and int(det_cls[best_lab - 1]) == int(cm[int(oid)]))
            out["scene"].append(s)
            out["frame"].append(k)
    a = np.asarray(out["iou"], np.float64)
    arrays = {"iou": a, "class_hit": np.asarray(out["class_hit"], bool),
              "scene": np.asarray(out["scene"], np.int32), "frame": np.asarray(out["frame"], np.int32),
              "mean_mask_iou": a.mean(), "class_accuracy": np.mean(out["class_hit"]),
              "instances": a.size, "mean_detected_iou": a[a > 0.1].mean(),
              "missed_rate": np.mean(a <= 0.1),
              # the checkpoint's sidecar, for comparison
              "json_mean_mask_iou": meta["mean_mask_iou"], "json_class_accuracy": meta["class_accuracy"],
              "json_instances": meta["instances"]}
    # the totals are eval_iou's own: the scoring above is its body
    miou, cacc, count, extra = td.eval_iou(variables, num_scenes=HELDOUT_SCENES, seed=HELDOUT_SEED)
    mine = (int(arrays["instances"]), float(arrays["mean_mask_iou"]), float(arrays["class_accuracy"]),
            float(arrays["mean_detected_iou"]), float(arrays["missed_rate"]))
    theirs = (count, miou, cacc, extra["mean_detected_iou"], extra["missed_rate"])
    if mine != theirs:
        raise AssertionError(f"held-out totals {mine} differ from eval_iou's {theirs}")
    print(f"  held-out: {a.size} instances, mean IoU {a.mean():.6f}, class accuracy "
          f"{np.mean(out['class_hit']):.6f} (checkpoint json: {meta['instances']}, "
          f"{meta['mean_mask_iou']:.6f}, {meta['class_accuracy']:.6f})", flush=True)
    _save(HELDOUT_OUT, arrays, t0)


def _summary(mod):
    """One module of the JAX evaluator's report -> KITTI_SUMMARY_FIELDS, the
    aggregation of scripts/accuracy_report.py: AME RMS over objects, AME
    median averaged over objects."""
    import numpy as np

    objs = list(mod.get("objects", {}).values())
    ame_t = [o["ame_trans_rmse"] for o in objs]
    med_t = [o.get("ame_trans_median", float("nan")) for o in objs]
    return (mod["camera"]["ate_unaligned_trans_rmse"], mod["camera"]["ate_rot_rmse"],
            float(np.sqrt(np.mean(np.square(ame_t)))) if ame_t else float("nan"),
            float(np.mean(med_t)) if med_t else float("nan"),
            float(sum(o["n_frames"] for o in objs)))


def _rot_angle(R, R_ref):
    """Angle (rad) of R^T R_ref from its skew part, per frame: linear in
    small angles, so f32 rounding puts no ~3e-4 rad floor under it as
    arccos of the trace would."""
    import numpy as np

    dR = np.einsum("kji,kjl->kil", R.astype(np.float64), R_ref.astype(np.float64))
    w = 0.5 * np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0], dR[:, 1, 0] - dR[:, 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(w, axis=-1), 0.0, 1.0))


def _withheld(pipe, mask_hw):
    """The object ids the frontend's observability floor withheld from the
    frame just processed (TrackerParams.min_observable_mask_area, the
    reference's frontend.py:420-425), as a (J,) int32 row: the id where
    withheld, else 0; and the packet's object_resampled flags (J,)."""
    import numpy as np

    tr = pipe.frontend_state.tracker
    a = pipe.cfg.frontend.tracker.min_observable_mask_area
    ids = np.asarray(tr.obj_ids)
    floor = a if a >= 1.0 else a * float(mask_hw[0] * mask_hw[1])
    unobs = (a > 0) & (ids > 0) & (np.asarray(tr.obj_det_area) < floor)
    return np.where(unobs, ids, 0).astype(np.int32), np.asarray(pipe.last_packet.object_resampled)


def _kitti_runs(runs, out_path, t0, frames, seeds=KITTI_SEEDS, ds=None, per_frame=False):
    """The host pipeline over the first `frames` frames of `ds` (the
    committed fixture by default) for each (name, JAX DynoConfig) of `runs`
    under `seeds` -> out_path, the keys of kitti_ref_30f.npz with `name` in
    place of the mode. With `per_frame`, each run also keeps
    `<prefix>_withheld` (frames, J), the ids the observability floor
    withheld per frame (0 elsewhere), and `<prefix>_resampled` (frames, J),
    the packets' object_resampled flags."""
    import shutil
    import tempfile

    import jax
    import numpy as np

    from dynosam_tpu.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu.eval.evaluator import DatasetEvaluator
    from dynosam_tpu.pipeline.pipeline import DynoPipeline

    ds = ds or KittiDataProvider(KITTI_FIXTURE)
    n = min(frames, len(ds))
    gts = [ds.ground_truth(k) for k in range(n)]
    names = [name for name, _ in runs]
    out = {"modes": np.array(names), "seeds": np.array(seeds),
           "summary_fields": np.array(KITTI_SUMMARY_FIELDS), "spread_fields": np.array(KITTI_SPREAD_FIELDS)}
    summary = np.zeros((len(runs), len(seeds), len(KITTI_SUMMARY_FIELDS)))
    spread = np.zeros((len(runs), len(seeds), len(KITTI_SPREAD_FIELDS)))

    def keep(prefix, X, motions, rows):
        keys = sorted(motions)
        out[f"{prefix}_X"] = X
        out[f"{prefix}_motion_key"] = np.array(keys, np.int32).reshape(-1, 2)
        out[f"{prefix}_motion_H"] = np.stack([motions[k] for k in keys])
        if per_frame:
            out[f"{prefix}_withheld"] = np.stack([r[0] for r in rows])
            out[f"{prefix}_resampled"] = np.stack([r[1] for r in rows])

    for i, (name, jcfg) in enumerate(runs):
        for s, seed in enumerate(seeds):
            tmp = tempfile.mkdtemp(prefix="kitti_ref_")
            rows = []
            try:
                pipe = DynoPipeline(jcfg, ds.intrinsics(), output_path=tmp)
                pipe.frontend_state = pipe.frontend_state.replace(key=jax.random.PRNGKey(seed))
                for k, gt in enumerate(gts):
                    fr = ds.frame(k)
                    pipe.process_frame(fr, gt)
                    if per_frame:
                        rows.append(_withheld(pipe, fr.mask.shape))
                pipe.finish()
                rep = DatasetEvaluator(tmp).run_analysis()["dynosam_tpu"]
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            summary[i, s] = _summary(rep)
            print(f"  {name} seed {seed}: {summary[i, s].tolist()} ({time.time() - t0:.0f} s)", flush=True)
            X = np.stack(pipe.trajectory).astype(np.float32)
            motions = {k: np.asarray(v, np.float32) for k, v in pipe.backend.matured_motion.items()}
            if s == 0:
                keep(name, X, motions, rows)
                X0, motions0 = X, motions
                continue
            keep(f"{name}_seed{seed}", X, motions, rows)
            # how far another seed lands from seed 0: poses (m, rad),
            # matured motions on the shared keys (largest, median m)
            common = sorted(set(motions) & set(motions0))
            mot = [np.linalg.norm(motions[k][:3, 3] - motions0[k][:3, 3]) for k in common]
            spread[i, s] = [
                np.linalg.norm(X[:, :3, 3] - X0[:, :3, 3], axis=-1).max(),
                _rot_angle(X[:, :3, :3], X0[:, :3, :3]).max(),
                max(mot), float(np.median(mot)),
            ]
    out["summary"] = summary
    out["seed_spread"] = spread
    _save(out_path, out, t0)


def kitti_reference():
    """The host pipeline (DynoPipeline -> RegularBackend -> CSV logs ->
    DatasetEvaluator) over the first 30 frames of the committed dyno-KITTI
    fixture, in the three hybrid modes at ACCURACY.md's on-disk
    configuration, under RANSAC seeds 0-5. Every seed's mature camera
    poses and matured object motions are kept (the port must land on one of
    the runs), and every seed's evaluator summary sets the ranges."""
    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu_torch.bench_config import kitti_accuracy_config

    t0 = time.time()
    # the port's config of the same values, read by the JAX package
    runs = [(mode, DynoConfig.from_dict(dataclasses.asdict(kitti_accuracy_config(mode, KITTI_FRAMES))))
            for mode in KITTI_MODES]
    _kitti_runs(runs, KITTI_OUT, t0, KITTI_FRAMES, seeds=KITTI_30F_SEEDS)


def _jax_kitti_config(formulation: int):
    """scripts/accuracy_report.py run_config_dataset's configuration,
    incremental mode (backend window 8), from the JAX package."""
    from dynosam_tpu.config import BackendParams, DynoConfig, FrontendParams, OptimizerParams, TrackerParams

    return DynoConfig(
        frontend=FrontendParams(max_objects=8, tracker=TrackerParams(
            max_features_per_frame=512, min_features_per_frame=200, max_dynamic_features_per_frame=768,
            detection_cell_size=8, min_corner_response=1e-6)),
        backend=BackendParams(optimization_mode=2, backend_updater_enum=formulation, max_frames=8,
                              optimizer=OptimizerParams(max_iterations=10)),
    )


def forms_reference():
    """The other formulations: the fused step at the bench configuration
    (WCME, WCPE, the joint hybrid solve with its final marginal
    covariances) and the fixture pipeline in incremental mode (WCME,
    WCPE)."""
    import jax
    import numpy as np

    import bench
    from dynosam_tpu.backend import hybrid as jhybrid
    from dynosam_tpu.parallel.batched import init_pipeline_state, make_fused_step

    cfg0, intr = bench.bench_config()
    frames = bench.make_frames(intr, num_frames=BENCH_FRAMES)
    for name, overrides in FORMS_BENCH.items():
        t0 = time.time()
        cfg = cfg0.with_overrides(overrides)
        step = jax.jit(make_fused_step(cfg, intr))
        state = init_pipeline_state(cfg)
        outs = {k: [] for k in KEYS}
        for fr in frames:
            state, out = step(state, fr)
            for key in KEYS:
                outs[key].append(np.asarray(out[key]))
        arrays = {k: np.stack(v) for k, v in outs.items()}
        if name == "joint":
            cov_X, cov_H = jax.jit(lambda g: jhybrid.marginal_covariances(g, cfg.backend))(state.graph)
            arrays.update(cov_X=np.asarray(cov_X), cov_H=np.asarray(cov_H))
        _save(os.path.join(TESTDATA, f"bench_{name}_ref_20f.npz"), arrays, t0)
    forms_kitti_reference()


def forms_kitti_reference():
    """The fixture pipeline in incremental mode with WCME and WCPE."""
    t0 = time.time()
    _kitti_runs([(name, _jax_kitti_config(f)) for name, f in FORMS_KITTI.items()], KITTI_FORMS_OUT, t0,
                KITTI_FORMS_FRAMES)


def _write_rich(path, frames):
    """The rich fixture (bench_config.fixture_scenario at 1242x375,
    rich=True, the port's counterpart of scripts/make_fixture_sequence.py's)
    over `frames` frames, rendered by the port on the CPU and written by the
    port's dyno-KITTI writer as eval/accuracy.py writes it. The JAX
    pipelines read these files: the f32 scene trajectory is ill-conditioned
    at the fixture's small yaw (se3_exp's (1 - cos) / theta^2), so the JAX
    renderer's scene sits ~1e-5 m per frame from the port's and its
    disparity quantisation is another noise draw (tests/test_torch_rich.py
    holds the two renderers to each other)."""
    import torch

    from dynosam_tpu_torch.eval.accuracy import write_rich

    torch.set_num_threads(4)
    write_rich(path, frames, "cpu")


def rich_reference():
    """Hybrid incremental at RICH_MIN_AREA over the first RICH_FRAMES frames
    of the rich fixture (_write_rich), read as run_dynosam reads it (padded
    to multiples of 32: 384x1248), under seeds 0-5, with the per-frame
    floor and resample rows (chip_smoke.py phase 15)."""
    import shutil
    import tempfile

    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu.dataproviders.base import create_dataset
    from dynosam_tpu_torch.bench_config import RICH_MIN_AREA, kitti_accuracy_config

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="rich_ref_")
    try:
        _write_rich(tmp, RICH_FRAMES)
        ds = create_dataset(0, tmp, pad_to_multiple=32)
        cfg = DynoConfig.from_dict(dataclasses.asdict(
            kitti_accuracy_config("incremental", RICH_FRAMES, min_observable_mask_area=RICH_MIN_AREA)))
        _kitti_runs([("incremental", cfg)], RICH_OUT, t0, RICH_FRAMES, seeds=KITTI_30F_SEEDS, ds=ds,
                    per_frame=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _full_summary(rep):
    """The JAX evaluator's report -> FULL_SUMMARY_FIELDS (NaN for the
    frontend's columns when it logged none)."""
    import numpy as np

    def summ(mod):
        objs = list(mod.get("objects", {}).values())

        def rms(key):
            v = [o[key] for o in objs]
            return float(np.sqrt(np.mean(np.square(v)))) if v else float("nan")

        def mean(key):
            v = [o.get(key, float("nan")) for o in objs]
            return float(np.mean(v)) if v else float("nan")

        cam = mod["camera"]
        return dict(ate_t=cam["ate_unaligned_trans_rmse"], ate_r=cam["ate_rot_rmse"], rpe_t=cam["rpe_trans_rmse"],
                    ame_t=rms("ame_trans_rmse"), ame_r=rms("ame_rot_rmse"), ame_t_med=mean("ame_trans_median"),
                    ame_r_med=mean("ame_rot_median"), n_motions=float(sum(o["n_frames"] for o in objs)))

    res = summ(rep["dynosam_tpu"])
    fe = summ(rep["frontend"]) if "frontend" in rep and "camera" in rep["frontend"] else {}
    res.update(fe_ate_t=fe.get("ate_t", float("nan")), fe_ame_t=fe.get("ame_t", float("nan")),
               fe_ame_t_med=fe.get("ame_t_med", float("nan")))
    return [res[k] for k in FULL_SUMMARY_FIELDS]


def _cells(ds, runs, frames, t0, seed=0):
    """Each (name, JAX DynoConfig) of `runs` over the first `frames` frames
    of `ds`, RANSAC seed `seed`, through the CSV logs and the evaluator ->
    {summary (cells, FULL_SUMMARY_FIELDS), `<name>_X`, `<name>_motion_key`,
    `<name>_motion_H`}."""
    import shutil
    import tempfile

    import jax
    import numpy as np

    from dynosam_tpu.eval.evaluator import DatasetEvaluator
    from dynosam_tpu.pipeline.pipeline import DynoPipeline

    n = min(frames, len(ds))
    out = {"cells": np.array([name for name, _ in runs]), "summary_fields": np.array(FULL_SUMMARY_FIELDS),
           "frames": n}
    summary = []
    for name, cfg in runs:
        t1 = time.time()
        tmp = tempfile.mkdtemp(prefix="cells_ref_")
        try:
            pipe = DynoPipeline(cfg, ds.intrinsics(), output_path=tmp)
            pipe.frontend_state = pipe.frontend_state.replace(key=jax.random.PRNGKey(seed))
            for k in range(n):
                pipe.process_frame(ds.frame(k), ds.ground_truth(k))
            pipe.finish()
            rep = DatasetEvaluator(tmp).run_analysis()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        summary.append(_full_summary(rep))
        motions = {k: np.asarray(v, np.float32) for k, v in pipe.backend.matured_motion.items()}
        keys = sorted(motions)
        out[f"{name}_X"] = np.stack(pipe.trajectory).astype(np.float32)
        out[f"{name}_motion_key"] = np.array(keys, np.int32).reshape(-1, 2)
        out[f"{name}_motion_H"] = np.stack([motions[k] for k in keys]) if keys else np.zeros((0, 4, 4), np.float32)
        print(f"  {name}: {dict(zip(FULL_SUMMARY_FIELDS, summary[-1]))} ({time.time() - t1:.0f} s, "
              f"{time.time() - t0:.0f} s in all)", flush=True)
    out["summary"] = np.array(summary)
    return out


def rich_matrix_reference():
    """The nine cells of scripts/accuracy_rich.py over the 100-frame rich
    fixture (_write_rich; read unpadded, as that script reads it) at
    RICH_MIN_AREA, seed 0, in the script's order."""
    import shutil
    import tempfile

    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.bench_config import RICH_MIN_AREA, kitti_accuracy_config

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="rich_matrix_ref_")
    try:
        _write_rich(tmp, RICH_MATRIX_FRAMES)
        ds = KittiDataProvider(tmp)
        runs = [(f"{mode}_{form}", DynoConfig.from_dict(dataclasses.asdict(kitti_accuracy_config(
            mode, RICH_MATRIX_FRAMES, form, min_observable_mask_area=RICH_MIN_AREA)))) for mode, form in RICH_CELLS]
        _save(RICH_MATRIX_OUT, _cells(ds, runs, RICH_MATRIX_FRAMES, t0), t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rich_seeds_reference(cells=RICH_SEED_CELLS, seeds=None):
    """The rich matrix's `cells` ("<mode>_<formulation>") under RANSAC
    `seeds` (RICH_SEEDS by mode if None) -> one file per cell under
    RICH_SEEDS_OUT, rewritten after every seed."""
    import shutil
    import tempfile

    import numpy as np

    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.bench_config import RICH_MIN_AREA, kitti_accuracy_config

    t0 = time.time()
    os.makedirs(RICH_SEEDS_OUT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rich_seeds_ref_")
    try:
        _write_rich(tmp, RICH_MATRIX_FRAMES)
        ds = KittiDataProvider(tmp)
        for cell in cells:
            mode, form = cell.rsplit("_", 1)
            cfg = DynoConfig.from_dict(dataclasses.asdict(kitti_accuracy_config(
                mode, RICH_MATRIX_FRAMES, int(form), min_observable_mask_area=RICH_MIN_AREA)))
            done = []
            for seed in seeds or RICH_SEEDS[mode]:
                done.append((seed, _cells(ds, [(cell, cfg)], RICH_MATRIX_FRAMES, t0, seed)["summary"][0]))
                _save(os.path.join(RICH_SEEDS_OUT, f"{cell}.npz"),
                      {"cell": cell, "seeds": np.array([sd for sd, _ in done]),
                       "summary_fields": np.array(FULL_SUMMARY_FIELDS),
                       "summary": np.array([v for _, v in done])}, t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rich_draws_check(cells=("sliding_window_1", "sliding_window_0", "incremental_1", "incremental_0")):
    """The port on the CPU over the 100-frame rich fixture (_write_rich) in
    the matrix's WCME / WCPE `cells`, its RANSAC sampling JAX seed 0's
    draws (tests/torch_port_util.py reference_draws / inject_draws), through
    eval/accuracy.py run_config_dataset, printed beside the matrix file's
    seed-0 rows: whether the port's gap to those rows on the card is the
    draws'. Writes no file."""
    import shutil
    import tempfile

    import jax
    import numpy as np
    import pytest

    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu_torch.bench_config import RICH_MIN_AREA, kitti_accuracy_config
    from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.eval import accuracy

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_util import inject_draws, reference_draws

    t0 = time.time()
    ref = np.load(RICH_MATRIX_OUT)
    fields = [str(f) for f in ref["summary_fields"]]
    tmp = tempfile.mkdtemp(prefix="rich_draws_")
    try:
        _write_rich(tmp, RICH_MATRIX_FRAMES)
        ds = KittiDataProvider(tmp, device="cpu")
        for cell in cells:
            mode, form = cell.rsplit("_", 1)
            jcfg = DynoConfig.from_dict(dataclasses.asdict(kitti_accuracy_config(
                mode, RICH_MATRIX_FRAMES, int(form), min_observable_mask_area=RICH_MIN_AREA)))
            draws = reference_draws(jax.random.PRNGKey(0), jcfg.frontend, RICH_MATRIX_FRAMES)
            with pytest.MonkeyPatch.context() as mp:
                queue = inject_draws(mp, draws)
                mode_enum = {v: k for k, v in accuracy.MODE_KEYS.items()}[mode]
                r = accuracy.run_config_dataset(ds, int(form), mode_enum, RICH_MATRIX_FRAMES, "cpu",
                                                min_observable_mask_area=RICH_MIN_AREA)
            jr = dict(zip(fields, ref["summary"][[str(c) for c in ref["cells"]].index(cell)]))
            print(f"  {cell} with JAX seed 0's draws ({len(queue)} left): "
                  + ", ".join(f"{k} {r[k]:.6g} / JAX {jr[k]:.6g}" for k in
                              ("ate_t", "ame_t", "ame_r", "ame_t_med", "n_motions", "fe_ame_t"))
                  + f" ({time.time() - t0:.0f} s)", flush=True)
            del draws
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sweep_reference():
    """Hybrid sliding-window at windows 8, 12 and 16 over the 60-frame
    fixture, seed 0 (scripts/accuracy_rich.py's sweep)."""
    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.bench_config import SWEEP_WINDOWS, kitti_accuracy_config

    t0 = time.time()
    runs = [(f"window_{w}", DynoConfig.from_dict(dataclasses.asdict(
        kitti_accuracy_config("sliding_window", SWEEP_FRAMES, window=w)))) for w in SWEEP_WINDOWS]
    out = _cells(KittiDataProvider(KITTI_FIXTURE), runs, SWEEP_FRAMES, t0)
    out["windows"] = list(SWEEP_WINDOWS)
    _save(SWEEP_OUT, out, t0)


def _det_acc_runs(ds, frames, out_path, seeds=(0,)):
    """scripts/accuracy_detector.py run_cell over the first `frames` frames
    of `ds`, provided and detected masks (seed 0; the detected row also
    under the other `seeds`, as `detected_seed<s>_*`), the engine at the
    dataset's frame size with score 0.35 and the XLA mask combination of
    the CPU -> out_path: its result, and from the pipeline it builds the
    mature poses, the matured motions, the association of estimated object
    ids to ground-truth ids (object-pose trajectories, as run_cell
    associates them) and per frame the packet's object ids and valid
    flags."""
    import numpy as np

    import dynosam_tpu.pipeline.pipeline as jpipeline
    from dynosam_tpu.nn.detector import YoloV8DetectorEngine

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import accuracy_detector

    import jax

    hw = (int(ds.intrinsics().height), int(ds.intrinsics().width))
    base = jpipeline.DynoPipeline
    made, seed = [], [0]

    class Recorded(base):
        """The reference's pipeline under RANSAC seed seed[0], keeping itself
        and each frame's packet ids for the file."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.frontend_state = self.frontend_state.replace(key=jax.random.PRNGKey(seed[0]))
            self.packet_ids, self.packet_valid = [], []
            made.append(self)

        def process_frame(self, *a, **kw):
            out = super().process_frame(*a, **kw)
            self.packet_ids.append(np.asarray(self.last_packet.object_ids))
            self.packet_valid.append(np.asarray(self.last_packet.object_valid))
            return out

    def keep(prefix, pipe):
        motions = {k: np.asarray(v, np.float32) for k, v in pipe.backend.matured_motion.items()}
        keys = sorted(motions)
        out[f"{prefix}_X"] = np.stack(pipe.trajectory).astype(np.float32)
        out[f"{prefix}_motion_key"] = np.array(keys, np.int32).reshape(-1, 2)
        out[f"{prefix}_motion_H"] = np.array([motions[k] for k in keys], np.float32).reshape(-1, 4, 4)
        out[f"{prefix}_packet_ids"] = np.stack(pipe.packet_ids).astype(np.int32)
        out[f"{prefix}_packet_valid"] = np.stack(pipe.packet_valid)

    jpipeline.DynoPipeline = Recorded
    t0 = time.time()
    out = {"rows": np.array(["provided", "detected"]), "frames": frames, "seeds": np.array(seeds),
           "result_fields": np.array(["ate_t", "ame_t", "ame_t_med", "n_motions", "n_tracks", "n_assoc"])}
    try:
        engine = YoloV8DetectorEngine(input_hw=hw, score_threshold=0.35)
        results = []
        for row, det in (("provided", None), ("detected", engine)):
            r = accuracy_detector.run_cell(ds, frames, det)
            pipe = made[-1]
            results.append([r[k] for k in out["result_fields"]])
            keep(row, pipe)
            assoc = associate(pipe, [ds.ground_truth(k) for k in range(frames)])
            out[f"{row}_assoc"] = np.array(sorted(assoc.items()), np.int32).reshape(-1, 2)
            print(f"  {row} ({frames} frames): {r}, association {assoc} ({time.time() - t0:.0f} s)", flush=True)
        out["results"] = np.array(results, np.float64)
        for sd in seeds[1:]:
            seed[0] = sd
            r = accuracy_detector.run_cell(ds, frames, engine)
            p = f"detected_seed{sd}"
            keep(p, made[-1])
            out[f"{p}_results"] = np.array([r[k] for k in out["result_fields"]], np.float64)
            assoc = associate(made[-1], [ds.ground_truth(k) for k in range(frames)])
            out[f"{p}_assoc"] = np.array(sorted(assoc.items()), np.int32).reshape(-1, 2)
            print(f"  detected seed {sd} ({frames} frames): {r}, association {assoc} ({time.time() - t0:.0f} s)",
                  flush=True)
    finally:
        jpipeline.DynoPipeline = base
    _save(out_path, out, t0)


def det_acc_reference():
    """The table's run: _det_acc_runs over the fixture's 60 frames (the
    engine at its 96x320), seed 0."""
    from dynosam_tpu.dataproviders.kitti import KittiDataProvider

    _det_acc_runs(KittiDataProvider(KITTI_FIXTURE), DET_ACC_FRAMES, DET_ACC_OUT)


def det_pipe_reference():
    """The smoke's run (chip_smoke.py phase 16): _det_acc_runs over the
    first DET_PIPE_FRAMES frames of bench_config.detector_scene, rendered by
    the port on the CPU and written by its dyno-KITTI writer
    (eval/accuracy.py write_detector_scene), the engine at 384x640, seeds
    0-5."""
    import shutil
    import tempfile

    import torch

    from dynosam_tpu.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.eval.accuracy import write_detector_scene

    torch.set_num_threads(4)
    tmp = tempfile.mkdtemp(prefix="det_pipe_ref_")
    try:
        write_detector_scene(tmp, DET_PIPE_FRAMES)
        _det_acc_runs(KittiDataProvider(tmp), DET_PIPE_FRAMES, DET_PIPE_OUT, seeds=KITTI_30F_SEEDS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def associate(pipe, gts):
    """scripts/accuracy_detector.py run_cell's association of estimated
    object ids to ground-truth ids by object-pose trajectory (its body,
    returned instead of consumed)."""
    import numpy as np

    est_pos = {}
    for (fid, oid), L in pipe.backend.matured_objpose.items():
        est_pos.setdefault(oid, {})[fid] = np.asarray(L)[:3, 3]
    gt_pos = {}
    for k, g in enumerate(gts):
        for i, goid in enumerate(np.asarray(g.object_ids)):
            if int(goid) > 0:
                gt_pos.setdefault(int(goid), {})[k] = np.asarray(g.object_poses[i])[:3, 3]
    assoc = {}
    for eid, traj in est_pos.items():
        best, best_d = None, np.inf
        for goid, gtraj in gt_pos.items():
            common = sorted(set(traj) & set(gtraj))
            if len(common) < 3:
                continue
            d = float(np.mean([np.linalg.norm(traj[f] - gtraj[f]) for f in common]))
            if d < best_d:
                best, best_d = goid, d
        if best is not None and best_d < 3.0:
            assoc[int(eid)] = best
    return assoc


def progressive_reference():
    """A 1242x375 synthetic frame (the world-textured dataset scene at
    Virtual KITTI 2's size, frame 0, rendered by the port on the CPU)
    written by cv2 as a progressive JPEG at quality 95, and cv2's decode of
    that file as RGB (chip_smoke.py phase 12 decodes it on the card's
    machine, which has no cv2)."""
    import cv2
    import numpy as np

    from dynosam_tpu_torch.bench_config import dataset_scene

    t0 = time.time()
    rgb = dataset_scene("vkitti", 1, device="cpu").frame(0).rgb.numpy()
    bgr = np.clip(np.rint(rgb[..., ::-1] * 255.0), 0, 255).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok and b"\xff\xc2" in buf.tobytes()
    with open(PROGRESSIVE_JPG, "wb") as f:
        f.write(buf.tobytes())
    _save(PROGRESSIVE_REF, {"rgb": cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]}, t0)


def datasets_reference():
    """The JAX writers, readers and pipeline over each format of
    bench_config.DATASET_FORMATS (see the module's doc)."""
    import shutil
    import tempfile

    import cv2
    import numpy as np

    from dynosam_tpu.config import DynoConfig
    from dynosam_tpu.cv import camera as jcam
    from dynosam_tpu.dataproviders import fixture_writers, kitti_writer
    from dynosam_tpu.dataproviders.base import create_dataset
    from dynosam_tpu.dataproviders.simulator import ObjectSpec, ScenarioSpec
    from dynosam_tpu.dataproviders.synthetic_dense import DenseScenario
    from dynosam_tpu.pipeline.pipeline import DynoPipeline
    from dynosam_tpu_torch import bench_config as tbench

    t0 = time.time()
    cfg = DynoConfig.from_dict(dataclasses.asdict(tbench.kitti_real_io_config()))
    writers = {"vkitti": "write_vkitti_sequence", "omd": "write_omd_sequence",
               "tartanair": "write_tartanair_sequence", "viode": "write_viode_sequence",
               "clusterslam": "write_clusterslam_sequence", "aria": "write_aria_sequence"}
    out = {}
    for name, (dtype, w, h, (fx, fy, cx, cy), baseline, writer_kw, reader_kw) in tbench.DATASET_FORMATS.items():
        intr = jcam.CameraIntrinsics.create(fx, fy, cx, cy, width=w, height=h, baseline=baseline)
        sp = tbench.dataset_spec(tbench.dataset_frames(name))
        spec = ScenarioSpec(
            num_frames=sp.num_frames, num_static=0, camera_motion_xi=sp.camera_motion_xi, frame_dt=sp.frame_dt,
            objects=[ObjectSpec(object_id=o.object_id, initial_pose_xi=o.initial_pose_xi, motion_xi=o.motion_xi,
                                num_points=0) for o in sp.objects],
        )
        scene = DenseScenario(spec, intr, world_texture=True)
        tmp = tempfile.mkdtemp(prefix="datasets_ref_")
        try:
            if name == "kitti_png":
                kitti_writer.write_kitti_sequence(scene, tmp, base_line=fx * baseline)
                motion = os.path.join(tmp, "motion")
                for f in sorted(os.listdir(motion)):
                    mask = np.loadtxt(os.path.join(motion, f), dtype=np.int32)
                    cv2.imwrite(os.path.join(motion, f[:-4] + ".png"), mask.astype(np.uint8))
                    os.remove(os.path.join(motion, f))
            else:
                getattr(fixture_writers, writers[name])(scene, tmp, **writer_kw)
            ds = create_dataset(dtype, tmp, pad_to_multiple=32, **reader_kw)
            pipe = DynoPipeline(cfg, ds.intrinsics())
            for k in range(len(ds)):
                pipe.process_frame(ds.frame(k), ds.ground_truth(k))
            pipe.finish()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        motions = {k: np.asarray(v, np.float32) for k, v in pipe.backend.matured_motion.items()}
        keys = sorted(motions)
        out[f"{name}_X"] = np.stack(pipe.trajectory).astype(np.float32)
        out[f"{name}_motion_key"] = np.array(keys, np.int32).reshape(-1, 2)
        out[f"{name}_motion_H"] = np.stack([motions[k] for k in keys])
        print(f"  {name}: {len(ds)} frames, {len(keys)} matured motions ({time.time() - t0:.0f} s)", flush=True)
    _save(DATASETS_OUT, out, t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parts = ["bench", "detector", "kitti", "klt", "stereo_imu", "forms", "batched", "batched_forms", "batched_modes",
             "pipelined", "datasets", "heldout", "rich", "rich_matrix", "rich_seeds", "rich_draws", "sweep",
             "det_acc", "det_pipe", "forms_kitti", "progressive"]
    ap.add_argument("--only", choices=parts, action="append", help="write only these files (default: all)")
    ap.add_argument("--cells", help="rich_seeds: comma-separated cells (default: RICH_SEED_CELLS)")
    ap.add_argument("--seeds", help="rich_seeds: comma-separated seeds (default: RICH_SEEDS by mode)")
    args = ap.parse_args()
    todo = args.only or parts
    os.makedirs(TESTDATA, exist_ok=True)
    if "bench" in todo:
        bench_reference()
    if "detector" in todo:
        detector_reference()
    if "kitti" in todo:
        kitti_reference()
    if "klt" in todo:
        klt_reference()
    if "stereo_imu" in todo:
        stereo_imu_reference()
    if "forms" in todo:
        forms_reference()
    elif "forms_kitti" in todo:
        forms_kitti_reference()
    if "batched" in todo:
        batched_reference()
    if "batched_forms" in todo:
        batched_reference(forms=True)
    if "batched_modes" in todo:
        batched_modes_reference()
    if "pipelined" in todo:
        pipelined_reference()
    if "datasets" in todo:
        datasets_reference()
    if "heldout" in todo:
        heldout_reference()
    if "rich" in todo:
        rich_reference()
    if "rich_matrix" in todo:
        rich_matrix_reference()
    if "rich_seeds" in todo:
        rich_seeds_reference(tuple(args.cells.split(",")) if args.cells else RICH_SEED_CELLS,
                             tuple(int(x) for x in args.seeds.split(",")) if args.seeds else None)
    if "rich_draws" in todo:
        rich_draws_check()
    if "sweep" in todo:
        sweep_reference()
    if "det_acc" in todo:
        det_acc_reference()
    if "det_pipe" in todo:
        det_pipe_reference()
    if "progressive" in todo:
        progressive_reference()


if __name__ == "__main__":
    main()
