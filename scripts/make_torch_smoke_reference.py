"""Write the JAX reference outputs that chip_smoke.py holds the port to.

Runs the JAX package on the CPU and writes two files under
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

Usage: JAX_PLATFORMS=cpu python scripts/make_torch_smoke_reference.py
"""

from __future__ import annotations

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
KEYS = ("X_world_cam", "object_ids", "object_motions", "object_motion_valid")


def _save(path, arrays, t0):
    import numpy as np

    np.savez_compressed(path, **arrays)
    print(f"wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} bytes) "
          f"in {time.time() - t0:.1f} s", flush=True)


def _run(step, state, frames, per_frame=None):
    import numpy as np

    outs = {k: [] for k in KEYS}
    for fr in frames:
        if per_frame is not None:
            fr = per_frame(fr)
        state, out = step(state, fr)
        for key in KEYS:
            outs[key].append(np.asarray(out[key]))
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


def main():
    os.makedirs(TESTDATA, exist_ok=True)
    bench_reference()
    detector_reference()


if __name__ == "__main__":
    main()
