"""Run the full pipeline on a dataset and, optionally, evaluate the results
(the port's counterpart of scripts/run_dynosam.py, flag for flag, plus
--device and --dataset_option).

Examples:
  # the committed dyno-KITTI fixture, hybrid incremental, with evaluation
  python -m dynosam_tpu_torch.run_dynosam --dataset_type 0 \\
      --dataset_path tests/fixtures/kitti_fixture --flags params/backend.flags \\
      --output_path results/kitti --run_analysis

  # the same on the CPU
  python -m dynosam_tpu_torch.run_dynosam ... --device cpu

  # a VIODE sequence written by dataproviders/fixture_writers.py at its
  # 0.5 m fixture baseline (reader arguments by --dataset_option)
  python -m dynosam_tpu_torch.run_dynosam --dataset_type 6 --dataset_path /data/viode \\
      --flags params/backend.flags --dataset_option baseline=0.5

  # synthetic dense scene (no dataset needed), parameter overrides
  python -m dynosam_tpu_torch.run_dynosam --dataset_type 100 --frames 16 \\
      --params_path params/default.yaml --override opt_window_size=12

  # tracking images, the trajectory plot and a Motion-JPEG AVI under
  # <output_path>/viz; the detector from an ultralytics YOLOv8-seg
  # state_dict (torch.save(model.model.state_dict(), "yolov8n-seg-sd.pt"))
  python -m dynosam_tpu_torch.run_dynosam --dataset_type 0 \\
      --dataset_path tests/fixtures/kitti_fixture --viz \\
      --use_detector --detector_weights yolov8n-seg-sd.pt

With no --flags or --params_path the configuration is the reference's
default (WCME, sliding window); params/backend.flags selects the hybrid
backend.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

from dynosam_tpu_torch.config import DynoConfig, load_flags_file


def _parse_value(v: str):
    """A command-line value as an int, float or bool where it reads as one."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v == "true" if v in ("true", "false") else v


def build_config(params_path: Optional[str] = None, flags: List[str] = (),
                 overrides: List[str] = ()) -> DynoConfig:
    """DynoConfig from a YAML file (else the defaults), then .flags files,
    then name=value overrides."""
    cfg = DynoConfig.from_yaml(params_path) if params_path else DynoConfig()
    values = {}
    for f in flags:
        values.update(load_flags_file(f))
    for ov in overrides:
        k, v = ov.split("=", 1)
        values[k] = _parse_value(v)
    return cfg.with_overrides(values) if values else cfg


def open_dataset(dataset_type: int, dataset_path: Optional[str], frames: Optional[int],
                 max_objects: int, device, dataset_kwargs: Optional[dict] = None):
    """-> (intrinsics, host frames iterable, ground truths iterable, count).
    dataset_kwargs go to the reader (e.g. a VIODE fixture's baseline, a
    TartanAir fixture's depth_scale)."""
    if dataset_type == 100:
        from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario

        n = frames or 16
        dense = default_dense_scenario(num_frames=n, device=device)
        return (dense.intr, (dense.frame(k) for k in range(n)),
                [dense.scn.ground_truth(k, max_objects) for k in range(n)], n)
    from dynosam_tpu_torch.dataproviders.base import create_dataset

    ds = create_dataset(dataset_type, dataset_path, device=device, pad_to_multiple=32,
                        **(dataset_kwargs or {}))
    n = min(frames or len(ds), len(ds))
    return (ds.intrinsics(), (ds.frame_host(k) for k in range(n)),
            (ds.ground_truth(k) for k in range(n)), n)


def build_pipeline(cfg: DynoConfig, intr, output_path: str, name: str = "dynosam_tpu",
                   use_detector: bool = False, device="cuda", seed: int = 0,
                   detector_weights: Optional[str] = None):
    """The DynoPipeline of a run, logging under `output_path`. The detector
    is the committed checkpoint's, or with `detector_weights` an
    ultralytics YOLOv8-seg state_dict (80 classes, scale n, as the
    reference's loader defaults)."""
    from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline

    os.makedirs(output_path, exist_ok=True)
    detector = None
    if use_detector:
        from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine

        model = None
        if detector_weights:
            from dynosam_tpu_torch.nn.weights import load_ultralytics_weights

            model = load_ultralytics_weights(detector_weights, device=device)
        detector = YoloV8DetectorEngine(model, input_hw=(intr.height, intr.width), device=device)
        cfg = cfg.with_overrides({"frontend.tracker.prefer_provided_object_detection": False})
    return DynoPipeline(cfg, intr, output_path=output_path, module_name=name,
                        detector=detector, device=device, seed=seed)


def run(cfg: DynoConfig, dataset_type: int, dataset_path: Optional[str], output_path: str,
        frames: Optional[int] = None, name: str = "dynosam_tpu", use_detector: bool = False,
        device="cuda", dataset_kwargs: Optional[dict] = None, viz: bool = False,
        detector_weights: Optional[str] = None):
    """Run the pipeline over a dataset, writing the CSV logs and statistics
    under `output_path` -> (pipeline, frames processed, wall seconds).

    With `viz`, every frame's tracking image goes to `output_path`/viz as
    it is processed, then the trajectory plot and the Motion-JPEG AVI of
    the tracking images (pipeline/viz.py; the reference draws tracking
    images only for its synthetic scene)."""
    intr, frame_it, gt_it, n = open_dataset(
        dataset_type, dataset_path, frames, cfg.backend.max_objects, device, dataset_kwargs
    )
    pipe = build_pipeline(cfg, intr, output_path, name=name, use_detector=use_detector,
                          device=device, detector_weights=detector_weights)
    writer = on_frame = None
    if viz:
        from dynosam_tpu_torch.pipeline.viz import DisplayWriter

        writer = DisplayWriter(output_path)
        on_frame = lambda inputs, packet: writer.write_tracking(inputs.rgb, packet)  # noqa: E731
    t0 = time.perf_counter()
    pipe.run(frame_it, gt_it, on_frame=on_frame)
    dt = time.perf_counter() - t0
    if not viz:
        return pipe, n, dt
    writer.write_trajectory(pipe.trajectory, None)
    video = writer.write_video()
    if video:
        print(f"wrote {video}")
    return pipe, n, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset_type", type=int, default=100,
                    help="DatasetType enum (0 KITTI, 1 Virtual KITTI 2, 2 ClusterSlam, 3 OMD, "
                    "4 Aria, 5 TartanAir-Shibuya, 6 VIODE, 100 synthetic)")
    ap.add_argument("--dataset_option", action="append", default=[],
                    help="reader argument name=value (e.g. baseline=0.5 for a VIODE fixture)")
    ap.add_argument("--dataset_path", default=None)
    ap.add_argument("--params_path", default=None, help="DynoConfig YAML")
    ap.add_argument("--flags", action="append", default=[],
                    help=".flags files with --name=value overrides")
    ap.add_argument("--override", action="append", default=[],
                    help="single override name=value")
    ap.add_argument("--output_path", default="results")
    ap.add_argument("--name", default="dynosam_tpu", help="module/log prefix")
    ap.add_argument("--frames", type=int, default=None, help="limit frames")
    ap.add_argument("--run_analysis", action="store_true")
    ap.add_argument("--viz", action="store_true",
                    help="dump tracking images, the trajectory plot and a Motion-JPEG AVI to "
                    "<output_path>/viz")
    ap.add_argument("--use_detector", action="store_true",
                    help="run the YOLOv8-seg engine (the committed checkpoint) instead of "
                    "dataset masks (prefer_provided_object_detection=false)")
    ap.add_argument("--detector_weights", default=None,
                    help="ultralytics YOLOv8-seg state_dict .pt for the detector (with --use_detector)")
    ap.add_argument("--device", default="cuda", help="torch device of the pipeline")
    args = ap.parse_args(argv)

    from dynosam_tpu_torch.utils.stats import Statistics

    cfg = build_config(args.params_path, args.flags, args.override)
    pipe, n, dt = run(cfg, args.dataset_type, args.dataset_path, args.output_path,
                      frames=args.frames, name=args.name, use_detector=args.use_detector,
                      device=args.device, viz=args.viz, detector_weights=args.detector_weights,
                      dataset_kwargs={k: _parse_value(v) for k, v in
                                      (o.split("=", 1) for o in args.dataset_option)})
    print(f"processed {n} frames in {dt:.2f}s ({n / dt:.1f} FPS incl. host I/O) on {pipe.device}")
    print(Statistics.summary())

    if args.run_analysis:
        from dynosam_tpu_torch.eval.evaluator import DatasetEvaluator

        evaluator = DatasetEvaluator(args.output_path)
        report = evaluator.write_report()
        print(f"evaluation written to {report}")
        plots = evaluator.write_plots()
        if plots:
            print(f"plots written to {plots}")
        with open(report) as f:
            print(f.read())


if __name__ == "__main__":
    main()
