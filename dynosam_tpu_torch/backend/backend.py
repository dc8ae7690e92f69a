"""Backend module: formulation and mode dispatch, the per-frame step and
state accessors (port of dynosam_tpu/backend/backend.py).

`RegularBackend` runs one of three formulations (backend_updater_enum):
WCME (0, world-centric motions, the default: `graph.update_from_packet`,
`solver.optimize`, `window.advance`), WCPE (1, world-centric object poses:
`wcpe.update_from_packet_wcpe`, `wcpe.optimize`, `window.advance_wcpe`) or
hybrid (2 or 3, object-centric keyframed: `graph.update_from_packet_hybrid`,
`hybrid.optimize`, `window.advance_hybrid`), in three modes: full-batch (0:
ingest every frame, a short warm-started LM per ingestion, one solve at
`finish`), sliding-window (1) and incremental (2: warm-started LM with few
iterations and accept/reject).

Host discipline: the window fill is the host integer
`GraphState.num_frames`, so a step reads nothing from the device but the
advance's one Cholesky status. Per-frame output snapshots and the mature
estimates stashed before each advance are packed into one float32 row on
the device (utils/packing.py); eagerly each comes to the host in one copy,
and in deferred mode (`defer_margin`) rows accumulate in a device ring
buffer that a drain reads in one copy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from dynosam_tpu_torch.backend import graph, hybrid, solver, wcpe, window
from dynosam_tpu_torch.config import BackendParams
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.frontend.types import VisionPacket
from dynosam_tpu_torch.utils import lie
from dynosam_tpu_torch.utils.packing import build_packer, to_host

@dataclass
class BackendOutput:
    """Per-frame backend output, host-side."""

    frame_id: int
    X_world_cam: np.ndarray              # (4, 4) optimized latest pose
    object_ids: np.ndarray               # (J,) int32 (-1 pad)
    object_motions: np.ndarray           # (J, 4, 4) optimized H at latest frame
    object_motion_valid: np.ndarray      # (J,) bool
    object_poses: np.ndarray             # (J, 4, 4) object poses
    static_landmarks: np.ndarray         # (Ls, 3)
    static_valid: np.ndarray             # (Ls,) bool
    dynamic_landmarks: np.ndarray        # (Ld, 3) at latest frame
    dynamic_valid: np.ndarray            # (Ld,) bool
    dynamic_object_ids: np.ndarray       # (Ld,) int32 object id per landmark


def _with_optimizer(cfg: BackendParams, **kw) -> BackendParams:
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, **kw))


class RegularBackend:
    """Full-batch / sliding-window / incremental backend of the WCME, WCPE
    or hybrid formulation."""

    # landmark-table snapshot keys dropped from the deferred (lite) record:
    # they are most of its bytes, and the device-computed bbx and centroid
    # fields replace their consumers
    _HEAVY_SNAPSHOT_KEYS = ("md_world", "d_obj", "d_valid_f", "ms", "s_valid_any")

    def __init__(self, cfg: BackendParams, intr: cam.CameraIntrinsics, device="cuda"):
        if cfg.backend_updater_enum not in (0, 1, 2, 3):
            raise ValueError(f"backend_updater_enum={cfg.backend_updater_enum}: 0, 1, 2 or 3")
        if cfg.optimization_mode not in (0, 1, 2):
            raise ValueError(f"optimization_mode={cfg.optimization_mode}: 0, 1 or 2")
        self.cfg = cfg
        self.intr = intr
        self.device = torch.device(device)
        self.state = graph.empty_graph(cfg, self.device)
        # object id -> (4, 4) latest object pose
        self.object_poses: Dict[int, np.ndarray] = {}
        # deferred mature-estimate records (defer_margin): packed rows in a
        # device ring buffer, drained in one copy before any mature read
        self.defer_margin = False
        self._marg_cap = 512
        self._marg_n = 0
        self._marg_buf = None
        self._marg_pack = None
        self._marg_unpack = None
        # marginalization-time ("mature") estimates of windowed modes: a
        # fixed-lag smoother's estimate of frame k is final when k leaves the
        # window. pose: frame_id -> (4,4); motion/objpose: (frame_id,
        # object_id) -> (4,4)
        self.matured_pose: Dict[int, np.ndarray] = {}
        self.matured_motion: Dict[tuple, np.ndarray] = {}
        self.matured_objpose: Dict[tuple, np.ndarray] = {}
        self._host_view = (None, None)    # (state, host copy of its accessor fields)

        # incremental: few warm-started LM iterations with accept/reject
        self._opt_cfg = (
            _with_optimizer(cfg, max_iterations=cfg.optimizer.incremental_iterations,
                            accept_reject=True)
            if cfg.optimization_mode == 2 else cfg
        )
        # full-batch warm start: a short warm-started LM per ingestion so the
        # final solve starts from a path-followed estimate
        self._warm_cfg = (
            _with_optimizer(cfg, max_iterations=cfg.optimizer.incremental_iterations,
                            accept_reject=True)
            if cfg.optimization_mode == 0 and cfg.batch_warm_start else None
        )
        # formulation dispatch: 0 = WCME, 1 = WCPE, 2 and 3 = hybrid
        self.hybrid = cfg.backend_updater_enum in (2, 3)
        self.wcpe = cfg.backend_updater_enum == 1
        self.wcme = cfg.backend_updater_enum == 0
        if self.hybrid:
            self._update, self._optimize, self._advance = (
                graph.update_from_packet_hybrid, hybrid.optimize, window.advance_hybrid)
        elif self.wcpe:
            self._update, self._optimize, self._advance = (
                wcpe.update_from_packet_wcpe, wcpe.optimize, window.advance_wcpe)
        else:
            self._update, self._optimize, self._advance = (
                graph.update_from_packet, solver.optimize, window.advance)

    # ------------------------------------------------------------------
    def step(
        self,
        packet: VisionPacket,
        optimize: Optional[bool] = None,
        extract: bool = True,
    ) -> Optional[BackendOutput]:
        """Ingest one packet (advancing a full window first) and optimize.
        extract=False returns None and reads nothing from the device: pair
        with device_output_snapshot() / materialize_output()."""
        cfg = self.cfg
        if cfg.regular_backend_static_only:
            # the backend estimates the camera and static scene only
            packet = dataclasses.replace(
                packet,
                dynamic_tracks=dataclasses.replace(
                    packet.dynamic_tracks,
                    valid=torch.zeros_like(packet.dynamic_tracks.valid),
                ),
                object_valid=torch.zeros_like(packet.object_valid),
            )
        if self.state.num_frames >= cfg.max_frames:
            if cfg.optimization_mode == 0:
                raise RuntimeError("FULL_BATCH window capacity exceeded; raise max_frames")
            # advance stride (opt_window_overlap): slide so `overlap` frames
            # stay shared between consecutive full windows; -1 slides by one.
            # Each slide stashes the departing frame's mature estimate first.
            if cfg.opt_window_overlap < 0:
                stride = 1
            else:
                stride = max(1, cfg.max_frames - 1 - cfg.opt_window_overlap)
            for _ in range(stride):
                self._stash_before_advance()
                self.state = self._advance(self.state, cfg)

        self.state = self._update(self.state, packet, self.intr, cfg)

        if optimize is None:
            # full-batch defers the full optimization to `finish`
            optimize = cfg.optimization_mode != 0
        if optimize:
            self.state = self._optimize(self.state, self._opt_cfg)
        elif self._warm_cfg is not None:
            self.state = self._optimize(self.state, self._warm_cfg)

        if not extract:
            return None
        return self.materialize_output(self.device_output_snapshot(), int(packet.frame_id))

    def finish(self) -> None:
        """Full-batch final solve."""
        self.state = self._optimize(self.state, self._opt_cfg)

    # ------------------------------------------------------------------
    def _motion_slot_outputs(self, st, f):
        """(motion (J,4,4), valid (J,), object pose (J,4,4)) at slot f, a
        host int. Hybrid and WCPE form F2F motions, which need slot f-1: a
        motion (pose) variable there, or for hybrid the object's keyframe
        (H_{e,e} = I). WCME's motions are per-frame variables and it
        carries no object pose (identity here; the host propagates one)."""
        fprev = max(f - 1, 0)
        if self.hybrid:
            valid = st.H_valid[:, f] & (st.H_valid[:, fprev] | (st.kf_slot == fprev)) & (f > 0)
            return hybrid.f2f_motion(st, f), valid, hybrid.object_pose(st, f)
        if self.wcpe:
            valid = st.H_valid[:, f] & st.H_valid[:, fprev] & (f > 0)
            return wcpe.f2f_motion(st, f), valid, st.H[:, f]
        eye = torch.eye(4, dtype=st.X.dtype, device=st.X.device).expand(st.J, 4, 4)
        return st.H[:, f], st.H_valid[:, f], eye

    def _device_margin_outputs(self, st):
        """Mature estimates taken just before an advance drops slot 0: slot
        0's pose (never re-optimized) and the object motions of the oldest
        slot still able to form one: slot 1 for the F2F chains of hybrid and
        WCPE, slot 0 for WCME's per-frame motion variables."""
        f_m = 0 if self.wcme else 1
        H_m, valid, L = self._motion_slot_outputs(st, f_m)
        return dict(
            pose_fid=st.frame_ids[0],
            X=st.X[0],
            motion_fid=st.frame_ids[f_m],
            H=H_m,
            H_valid=valid,
            obj_pose=L,
            obj_ids=st.obj_ids,
        )

    def _stash_before_advance(self):
        rec = self._device_margin_outputs(self.state)
        if not self.defer_margin:
            self._stash_matured(to_host(rec))
            return
        if self._marg_pack is None:
            self._marg_pack, self._marg_unpack, width = build_packer(rec)
            self._marg_buf = torch.zeros((self._marg_cap, width), dtype=torch.float32,
                                         device=self.device)
        if self._marg_n >= self._marg_cap:
            self.drain_matured()
        self._marg_pack(rec, out=self._marg_buf[self._marg_n])
        self._marg_n += 1

    def drain_matured(self):
        """Materialize the deferred mature-estimate records: the ring buffer
        comes to the host in one copy."""
        n, self._marg_n = self._marg_n, 0
        if not n:
            return
        rows = self._marg_buf[:n].to("cpu", copy=True).numpy()   # never an alias of the buffer
        for i in range(n):
            self._stash_matured(self._marg_unpack(rows[i]))

    def _stash_matured(self, rec):
        pfid = int(rec["pose_fid"])
        if pfid >= 0:
            self.matured_pose[pfid] = rec["X"]
        mfid = int(rec["motion_fid"])
        if mfid >= 0:
            for j, oid in enumerate(rec["obj_ids"]):
                oid = int(oid)
                if oid > 0 and bool(rec["H_valid"][j]):
                    self.matured_motion[(mfid, oid)] = rec["H"][j]
                    self.matured_objpose[(mfid, oid)] = rec["obj_pose"][j]

    def finalize_matured(self) -> None:
        """Record the mature estimates of the frames still in the window
        (at sequence end, after the final solve): every in-window pose and
        the motions of every slot that can still form one. With the
        per-advance stashes this gives one mature estimate per frame."""
        self.drain_matured()
        n = self.state.num_frames
        if n == 0:
            return
        h = self._host()
        ids, X, obj_ids = h["frame_ids"], h["X"], h["obj_ids"]
        for f in range(n):
            if ids[f] >= 0:
                self.matured_pose[int(ids[f])] = X[f]
        f0 = 0 if self.wcme else 1
        for f in range(f0, n):
            fid = int(ids[f])
            if fid < 0:
                continue
            for j, oid in enumerate(obj_ids):
                oid = int(oid)
                if oid > 0 and bool(h["slot_valid"][j, f]):
                    self.matured_motion[(fid, oid)] = h["f2f"][j, f]
                    self.matured_objpose[(fid, oid)] = h["obj_pose"][j, f]

    def _host(self):
        """Host copy of the current state's accessor fields, read in one
        copy and kept until the state changes."""
        st = self.state
        if self._host_view[0] is not st:
            F = st.F
            fs = torch.arange(F, device=st.X.device)
            fprev = torch.clamp(fs - 1, min=0)
            if self.wcme:
                f2f, slot_valid = st.H, st.H_valid
                obj_pose = torch.eye(4, dtype=st.X.dtype, device=st.X.device).expand(st.H.shape)
            else:
                f2f = lie.mm(st.H, lie.inverse(st.H[:, fprev]))
                prev_ok = st.H_valid[:, fprev]
                if self.hybrid:
                    prev_ok = prev_ok | (st.kf_slot[:, None] == fprev[None, :])
                    obj_pose = lie.mm(st.H, st.L_e[:, None])
                else:
                    obj_pose = st.H
                slot_valid = st.H_valid & prev_ok & (fs > 0)[None, :]
            self._host_view = (st, to_host(dict(
                frame_ids=st.frame_ids, X=st.X, obj_ids=st.obj_ids, H_valid=st.H_valid,
                f2f=f2f, obj_pose=obj_pose, slot_valid=slot_valid,
            )))
        return self._host_view[1]

    def marginal_covariances(self):
        """(cov_X (F, 6, 6), cov_H (J, F, 6, 6)) marginals at the current
        estimate, from one dense inverse of the reduced system (the exact
        joint marginals), as host arrays. Hybrid formulations only; computed
        on demand, not part of the per-frame step."""
        if not self.hybrid:
            raise NotImplementedError(
                "marginal covariances are exported for the hybrid formulations (backend_updater_enum 2/3)"
            )
        cov_X, cov_H = hybrid.marginal_covariances(self.state, self._opt_cfg)
        h = to_host(dict(cov_X=cov_X, cov_H=cov_H))
        return h["cov_X"], h["cov_H"]

    # ------------------------------------------------------------------
    def _device_outputs(self, st):
        """Canonical outputs of the latest frame slot, on the device."""
        f = min(max(st.num_frames - 1, 0), st.F - 1)
        J = st.J
        H_out, H_valid, obj_pose = self._motion_slot_outputs(st, f)
        d_slot = torch.clamp(st.d_obj, 0, J - 1).long()
        if self.hybrid:
            md_world = lie.transform_points(obj_pose[d_slot], st.m_hyb)
        else:
            md_world = st.md[:, f]
        d_valid_f = st.d_valid[:, f]
        # per-object landmark bounding boxes in the OBJECT frame, and the
        # world-frame landmark centroid: the deferred record ships these
        # (J, 3) fields instead of the landmark tables
        Lj = obj_pose[d_slot]                                           # (Ld, 4, 4)
        local = lie.einsum("lab,la->lb", lie.rotation(Lj), md_world - Lj[:, :3, 3])
        sel = d_valid_f[:, None] & (
            st.d_obj[:, None] == torch.arange(J, device=st.d_obj.device)[None, :]
        )                                                               # (Ld, J)
        bbx_min = torch.amin(torch.where(sel[:, :, None], local[:, None, :], torch.inf), dim=0)
        bbx_max = torch.amax(torch.where(sel[:, :, None], local[:, None, :], -torch.inf), dim=0)
        cnt = torch.sum(sel, dim=0)
        obj_centroid = torch.sum(
            torch.where(sel[:, :, None], md_world[:, None, :], 0.0), dim=0
        ) / torch.clamp(cnt, min=1)[:, None].to(md_world.dtype)
        return dict(
            X=st.X[f],
            H=H_out,
            H_valid=H_valid,
            md_world=md_world,
            obj_pose=obj_pose,
            obj_ids=st.obj_ids,
            slot_open=st.slot_open,
            d_obj=st.d_obj,
            d_valid_f=d_valid_f,
            ms=st.ms,
            s_valid_any=torch.any(st.s_valid, dim=0),
            bbx_min=bbx_min,
            bbx_max=bbx_max,
            bbx_ok=torch.any(sel, dim=0),
            obj_centroid=obj_centroid,
        )

    def _device_outputs_lite(self, st):
        dev = self._device_outputs(st)
        for k in self._HEAVY_SNAPSHOT_KEYS:
            dev.pop(k)
        return dev

    def device_output_snapshot(self):
        """The current frame's full output snapshot, on the device."""
        return self._device_outputs(self.state)

    def materialize_output(self, dev, frame_id: int) -> BackendOutput:
        """Host BackendOutput from a snapshot (tensors, read in one copy, or
        host arrays). Call in frame order: object poses carry over.

        Lite (deferred) snapshots omit the landmark tables: those
        BackendOutput fields come back empty, so the map-points log gets no
        rows, while the camera, motion, pose and bbx logs equal the eager
        path's."""
        if any(torch.is_tensor(v) for v in dev.values()):
            dev = to_host(dev)
        X = dev["X"]
        obj_ids = dev["obj_ids"]
        H = dev["H"]
        H_valid = dev["H_valid"]

        lite = "md_world" not in dev
        Ld, Ls = self.state.Ld, self.state.Ls
        d_obj = dev["d_obj"] if not lite else np.full((Ld,), -1, np.int32)
        d_valid = dev["d_valid_f"] if not lite else np.zeros((Ld,), bool)
        md = dev["md_world"] if not lite else np.zeros((Ld, 3), np.float32)
        if not self.wcme:
            # object poses are direct state; open slots win over closed
            # epochs sharing the id (a closed epoch's pose stopped updating)
            obj_poses = dev["obj_pose"]
            open_np = dev["slot_open"]
            for j, oid in enumerate(obj_ids):
                oid = int(oid)
                if oid > 0 and (open_np[j] or oid not in self.object_poses):
                    self.object_poses[oid] = obj_poses[j]
        else:
            # WCME: propagate L_k = H_k L_{k-1} from the object's landmark
            # centroid (computed on the device, so deferred snapshots carry it)
            obj_poses = np.tile(np.eye(4, dtype=X.dtype), (len(obj_ids), 1, 1))
            for j, oid in enumerate(obj_ids):
                oid = int(oid)
                if oid <= 0:
                    continue
                if oid in self.object_poses and H_valid[j]:
                    self.object_poses[oid] = H[j] @ self.object_poses[oid]
                elif oid not in self.object_poses:
                    L0 = np.eye(4, dtype=X.dtype)
                    L0[:3, 3] = dev["obj_centroid"][j]
                    self.object_poses[oid] = L0
                obj_poses[j] = self.object_poses[oid]

        s_valid = dev["s_valid_any"] if not lite else np.zeros((Ls,), bool)
        d_oid = np.full(d_obj.shape[0], -1, np.int32)
        mask = d_obj >= 0
        d_oid[mask] = obj_ids[d_obj[mask]]

        return BackendOutput(
            frame_id=frame_id,
            X_world_cam=X,
            object_ids=obj_ids,
            object_motions=H,
            object_motion_valid=H_valid,
            object_poses=obj_poses,
            static_landmarks=dev["ms"] if not lite else np.zeros((Ls, 3), np.float32),
            static_valid=s_valid,
            dynamic_landmarks=md,
            dynamic_valid=d_valid,
            dynamic_object_ids=d_oid,
        )

    # ------------------------------------------------------------------
    def pose_at(self, frame_id: int) -> Optional[np.ndarray]:
        if self._marg_n:
            self.drain_matured()
        if frame_id in self.matured_pose:
            return self.matured_pose[frame_id]
        h = self._host()
        hits = np.nonzero(h["frame_ids"] == frame_id)[0]
        if len(hits) == 0:
            return None
        return h["X"][int(hits[0])]

    def motion_at(self, frame_id: int, object_id: int) -> Optional[np.ndarray]:
        if self._marg_n:
            self.drain_matured()
        if (frame_id, object_id) in self.matured_motion:
            return self.matured_motion[(frame_id, object_id)]
        h = self._host()
        hits = np.nonzero(h["frame_ids"] == frame_id)[0]
        if len(hits) == 0:
            return None
        f = int(hits[0])
        # an id may occupy several slots (epochs after re-entry breaks);
        # their valid frames are disjoint: take the slot whose motion exists
        for j in np.nonzero(h["obj_ids"] == object_id)[0]:
            if h["H_valid"][j, f] and h["slot_valid"][j, f]:
                return h["f2f"][j, f]
        return None
