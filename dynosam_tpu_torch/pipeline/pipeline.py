"""Host-side pipeline orchestration (port of dynosam_tpu/pipeline/pipeline.py).

`DynoPipeline` wires the frontend step and `RegularBackend` on one device,
with the CSV loggers, the mature-estimate re-log and the statistics dump.

  * Eager `process_frame`: frontend, backend, then the frame's output
    snapshot and packet fields come to the host in one copy and are logged.
  * Deferred (`pipeline.defer_host_outputs`): nothing is read per frame;
    each frame's snapshot is packed into one row of a device ring buffer
    (utils/packing.py) and `drain_every` rows come to the host in one copy.
    After `finish()` the trajectories and the camera-pose, object-motion,
    object-pose and bbx logs equal the eager path's (the map-points log,
    which needs the landmark tables, gets no rows).
  * `run()` with `pipeline.parallel_run`: a worker thread decodes the next
    frames on the host (numpy and zlib release the GIL), pins them and
    copies them to the card on a side stream; the consuming stream waits on
    the copy's event and the tensors are recorded on it. Sequential and
    parallel runs give identical logs.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from dynosam_tpu_torch.backend.backend import BackendOutput, RegularBackend
from dynosam_tpu_torch.config import DynoConfig
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.frontend.frontend import empty_frontend_state, frontend_step
from dynosam_tpu_torch.frontend.types import FrameInputs, GroundTruthFrame, VisionPacket
from dynosam_tpu_torch.utils.logger import EstimationModuleLogger
from dynosam_tpu_torch.utils.packing import build_packer, to_host
from dynosam_tpu_torch.utils.stats import Statistics, Timer

_END = object()


def _upload(inputs: FrameInputs, device: torch.device, stream) -> tuple:
    """Copy the host tensors of frame inputs to `device` on `stream` from
    pinned buffers (tensors already there, such as a stereo reader's depth,
    stay) -> (inputs on the device, event marking the end of the copies and
    of the work queued on `stream` before them). The caching host allocator
    keeps each pinned buffer until its copy has ended."""
    if device.type != "cuda":
        return inputs, None
    with torch.cuda.stream(stream):
        out = dataclasses.replace(inputs, **{
            k: v if v.is_cuda else v.pin_memory().to(device, non_blocking=True)
            for k, v in inputs.tensors().items()
        })
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _prefetch(it: Iterator, size: int, device: torch.device) -> Iterator:
    """Yield the items of `it` (FrameInputs), decoded and uploaded ahead by
    a worker thread; an error in the worker is raised here. On a card the
    worker's current stream is the side stream, so device work done while
    producing an item (a reader's stereo depth) is ordered before the
    item's event."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def worker():
        try:
            if stream is not None:
                torch.cuda.set_device(device)
                torch.cuda.set_stream(stream)
            for item in it:
                q.put(_upload(item, device, stream))
            q.put((_END, None))
        except Exception as e:      # re-raised by the consumer
            q.put((e, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        t = Timer("pipeline.prefetch_wait").start()
        item, event = q.get()
        t.stop()
        if item is _END:
            return
        if isinstance(item, Exception):
            raise item
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for v in item.tensors().values():
                v.record_stream(consumer)
        yield item


def _timed_decode(frames: Iterable) -> Iterator:
    """The items of `frames`, each one's production timed as decode."""
    it = iter(frames)
    while True:
        t = Timer("pipeline.decode").start()
        try:
            item = next(it)
        except StopIteration:
            return
        t.stop()
        yield item


class DynoPipeline:
    """Frontend + backend, wired; the DynoPipelineManager analogue."""

    def __init__(
        self,
        cfg: DynoConfig,
        intr: cam.CameraIntrinsics,
        output_path: Optional[str] = None,
        module_name: str = "dynosam_tpu",
        detector=None,
        device="cuda",
        seed: int = 0,
    ):
        """detector: optional engine (nn/detector.py). When given and
        prefer_provided_object_detection is False, its instance masks
        replace the dataset's. RANSAC draws from a generator on `device`
        seeded with `seed`."""
        cfg = cfg.normalized()
        self.cfg = cfg
        self.intr = intr
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.detector = detector
        self._use_detector = (
            detector is not None and not cfg.frontend.tracker.prefer_provided_object_detection
        )
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.frontend_state = empty_frontend_state(
            cfg.frontend, self.device, image_shape=(intr.height, intr.width)
        )
        self.backend = RegularBackend(cfg.backend, intr, device=self.device)
        self.logger = EstimationModuleLogger(module_name, output_path) if output_path else None
        # the frontend's own (pre-optimization) estimates, as a module of
        # their own, so evaluation reports the backend's value-add
        self.frontend_logger = (
            EstimationModuleLogger("frontend", output_path) if output_path else None
        )
        self.trajectory: List[np.ndarray] = []            # backend camera poses
        self.last_packet: Optional[VisionPacket] = None
        self.frontend_trajectory: List[np.ndarray] = []
        self.outputs: List[BackendOutput] = []
        self._gts: List[Optional[GroundTruthFrame]] = []
        self._defer = cfg.pipeline.defer_host_outputs
        self.backend.defer_margin = self._defer
        self._pending_gts: List = []
        self._snap_buf = None          # (drain_every, width) float32 on the device
        self._snap_pack = None         # built from the first frame's record
        self._snap_unpack = None
        self._finished = False

    # ------------------------------------------------------------------
    def _record(self, packet: VisionPacket, lite: bool):
        """The frame's backend snapshot and packet fields, on the device."""
        snap = (self.backend._device_outputs_lite(self.backend.state) if lite
                else self.backend.device_output_snapshot())
        rec = dict(snap)
        rec.update({
            "pk_frame_id": packet.frame_id,
            "pk_X_world_cam": packet.X_world_cam,
            "pk_object_ids": packet.object_ids,
            "pk_object_motions": packet.object_motions,
            "pk_object_valid": packet.object_valid,
        })
        return rec

    def process_frame(
        self, inputs: FrameInputs, gt: Optional[GroundTruthFrame] = None
    ) -> Optional[BackendOutput]:
        if inputs.rgb.device != self.device:
            inputs = inputs.to(self.device)
        if self._use_detector:
            t = Timer("pipeline.detector").start()
            inputs = dataclasses.replace(inputs, mask=self.detector.process(inputs.rgb))
            t.stop(block_on=inputs.mask if not self._defer else None)

        if self._defer:
            # no per-frame host read: the record goes into the ring buffer
            t = Timer("pipeline.frontend_dispatch").start()
            self.frontend_state, packet = frontend_step(
                self.frontend_state, inputs, self.intr, self.cfg.frontend, self.generator
            )
            t.stop()
            t = Timer("pipeline.backend_dispatch").start()
            self.backend.step(packet, extract=False)
            rec = self._record(packet, lite=True)
            if self._snap_pack is None:
                self._snap_pack, self._snap_unpack, width = build_packer(rec)
                self._snap_buf = torch.zeros(
                    (self.cfg.pipeline.drain_every, width), dtype=torch.float32, device=self.device
                )
            self._snap_pack(rec, out=self._snap_buf[len(self._pending_gts)])
            t.stop()
            self._pending_gts.append(gt)
            self.last_packet = packet
            if len(self._pending_gts) >= self.cfg.pipeline.drain_every:
                self._drain_outputs()
            return None

        t = Timer("pipeline.frontend").start()
        self.frontend_state, packet = frontend_step(
            self.frontend_state, inputs, self.intr, self.cfg.frontend, self.generator
        )
        t.stop(block_on=packet.X_world_cam)

        t = Timer("pipeline.backend").start()
        self.backend.step(packet, extract=False)
        rec = to_host(self._record(packet, lite=False))     # the frame's one copy
        out = self._emit(rec, gt)
        t.stop()
        self.last_packet = packet
        return out

    def _emit(self, rec, gt) -> BackendOutput:
        """Materialize, keep and log one frame's host record."""
        pk = {k[3:]: v for k, v in rec.items() if k.startswith("pk_")}
        dev = {k: v for k, v in rec.items() if not k.startswith("pk_")}
        fid = int(pk["frame_id"])
        out = self.backend.materialize_output(dev, fid)
        self.frontend_trajectory.append(pk["X_world_cam"])
        self.trajectory.append(out.X_world_cam)
        self.outputs.append(out)
        self._gts.append(gt)
        if self.logger is not None:
            self._log(out, dev, gt)
        if self.frontend_logger is not None:
            self._log_frontend(fid, pk, gt)
        return out

    def _drain_outputs(self):
        """Materialize and log the deferred records, in order: the backlog
        comes to the host in one copy."""
        gts, self._pending_gts = self._pending_gts, []
        if not gts:
            return
        t = Timer("pipeline.drain").start()
        # a copy: on the CPU .cpu() would alias the ring buffer, which the
        # next frames overwrite
        rows = self._snap_buf[: len(gts)].to("cpu", copy=True).numpy()
        for i, gt in enumerate(gts):
            self._emit(self._snap_unpack(rows[i]), gt)
        t.stop()

    def run(
        self,
        frames: Iterable[FrameInputs],
        gts: Optional[Iterable[Optional[GroundTruthFrame]]] = None,
        on_frame: Optional[Callable[[FrameInputs, VisionPacket], None]] = None,
    ) -> List[BackendOutput]:
        """Process every frame, then finish. `on_frame(inputs, packet)`, when
        given, is called after each frame with its frontend packet."""
        it: Iterator = _timed_decode(frames)
        if self.cfg.pipeline.parallel_run:
            it = _prefetch(it, self.cfg.pipeline.data_provider_prefetch, self.device)
        gts_it = iter(gts) if gts is not None else None
        t = Timer("pipeline.total").start()
        for inputs in it:
            gt = next(gts_it) if gts_it is not None else None
            self.process_frame(inputs, gt)
            if on_frame is not None:
                on_frame(inputs, self.last_packet)
        t.stop()
        self.finish()
        return self.outputs

    def finish(self):
        """Drain, solve (full-batch), take the mature estimates, re-log and
        dump the statistics. Idempotent."""
        if self._finished:
            return
        self._finished = True
        if self._defer:
            self._drain_outputs()
        if self.cfg.backend.optimization_mode == 0:
            t = Timer("pipeline.batch_solve").start()
            self.backend.finish()
            t.stop(block_on=self.backend.state.X)
        # mature estimates: full-batch takes everything from the final
        # solve; windowed modes combine the per-advance stashes with the
        # final window contents
        t = Timer("pipeline.relog").start()
        self.backend.finalize_matured()
        for fid in range(len(self.trajectory)):
            X = self.backend.pose_at(fid)
            if X is not None:
                self.trajectory[fid] = X
        if self.logger is not None:
            self._relog_final()
        t.stop()
        if self.frontend_logger is not None:
            self.frontend_logger.close()
        if self.logger is not None:
            self.logger.close()
            out_dir = self.logger.path
            Statistics.write_all_samples_to_csv(os.path.join(out_dir, "statistics_samples.csv"))
            with open(os.path.join(out_dir, "statistics_summary.txt"), "w") as f:
                f.write(Statistics.summary())

    @staticmethod
    def _gt_match(gt, oid):
        """(H_gt, L_gt) of object `oid` in `gt`, or (None, None)."""
        if gt is None:
            return None, None
        hit = np.nonzero(np.asarray(gt.object_ids) == oid)[0]
        if not len(hit):
            return None, None
        j = int(hit[0])
        return np.asarray(gt.object_motions[j]), np.asarray(gt.object_poses[j])

    def _relog_final(self):
        """Rewrite the camera-pose / object-motion / object-pose logs from
        the mature estimates: the final solve for full-batch, the
        marginalization-time values for the windowed modes."""
        self.logger.reset(("camera_pose", "object_motion", "object_pose"))
        L_cur = {}
        for fid, out in enumerate(self.outputs):
            gt = self._gts[fid] if fid < len(self._gts) else None
            gt_X = np.asarray(gt.X_world_cam) if gt is not None else None
            self.logger.log_camera_pose(fid, self.trajectory[fid], gt_X)
            for j, oid in enumerate(out.object_ids):
                oid = int(oid)
                if oid <= 0 or not out.object_motion_valid[j]:
                    continue
                H = self.backend.motion_at(fid, object_id=oid)
                H = np.asarray(H) if H is not None else out.object_motions[j]
                if (fid, oid) in self.backend.matured_objpose:
                    L_cur[oid] = self.backend.matured_objpose[(fid, oid)]
                # re-propagate from the object's streamed anchor pose
                elif oid not in L_cur:
                    L_cur[oid] = np.asarray(out.object_poses[j])
                else:
                    L_cur[oid] = H @ L_cur[oid]
                H_gt, L_gt = self._gt_match(gt, oid)
                self.logger.log_object_motion(fid, oid, H, H_gt)
                self.logger.log_object_pose(fid, oid, L_cur[oid], L_gt)

    def _log_frontend(self, fid, pk, gt):
        """The frontend's own estimates under the 'frontend' module."""
        gt_X = np.asarray(gt.X_world_cam) if gt is not None else None
        self.frontend_logger.log_camera_pose(fid, pk["X_world_cam"], gt_X)
        for j, oid in enumerate(pk["object_ids"]):
            oid = int(oid)
            if oid <= 0 or not pk["object_valid"][j]:
                continue
            H_gt, _ = self._gt_match(gt, oid)
            self.frontend_logger.log_object_motion(fid, oid, pk["object_motions"][j], H_gt)

    # ------------------------------------------------------------------
    def _log(self, out: BackendOutput, dev, gt):
        fid = out.frame_id
        gt_X = np.asarray(gt.X_world_cam) if gt is not None else None
        self.logger.log_camera_pose(fid, out.X_world_cam, gt_X)
        for j, oid in enumerate(out.object_ids):
            oid = int(oid)
            if oid <= 0 or not out.object_motion_valid[j]:
                continue
            H_gt, L_gt = self._gt_match(gt, oid)
            self.logger.log_object_motion(fid, oid, out.object_motions[j], H_gt)
            self.logger.log_object_pose(fid, oid, out.object_poses[j], L_gt)
            # 3D bbox of this object's landmarks in the object frame, from
            # the device-computed bounds (the same numbers in both modes)
            if dev["bbx_ok"][j]:
                self.logger.log_object_bbx(
                    fid, oid, dev["bbx_min"][j], dev["bbx_max"][j], out.object_poses[j]
                )
        valid = out.dynamic_valid
        if valid.any():
            self.logger.log_map_points(
                fid,
                out.dynamic_object_ids[valid],
                np.nonzero(valid)[0],
                out.dynamic_landmarks[valid],
            )
