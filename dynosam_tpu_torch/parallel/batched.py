"""The fused per-frame SLAM step and its multi-sequence batch (port of
`init_pipeline_state`, `make_fused_step` and `make_batched_pipeline` in
dynosam_tpu/parallel/batched.py).

One call runs frontend(k) -> window advance when the window is full ->
backend ingestion -> the formulation's optimizer on the window through k,
and returns the new state and the frame's outputs; the pipelined step
optimizes the window through k-1 before the advance and ingestion. The
formulation is backend_updater_enum: 0 WCME, 1 WCPE, 2 or 3 hybrid
(decoupled or joint). The window fill is the host integer
`GraphState.num_frames`, so the reference's `lax.cond` on it
(batched.py:108-112) is a Python branch here.

`make_batched_pipeline` steps B sequences as one program: every module on
the path takes a leading batch axis, so each operation runs once for the
whole batch (the reference's `jax.vmap` of the fused step), never once per
sequence. Given a process group (`parallel/group.py`, the reference's
`mesh=`), each rank steps its own B/P consecutive sequences; `shard_rows`
takes a rank's rows of the batch's inputs and `gather_outputs` puts the
sequences' outputs together on rank 0.

While `utils/stats.py::tracing` is on, the batched step records the span
`step` (its call index is the step id of every span inside it), and the
backend the spans `backend`, `backend.advance` (when the window is full),
`backend.ingest` and `backend.optimize`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from dynosam_tpu_torch.config import DynoConfig
from dynosam_tpu_torch.backend import graph as graph_mod
from dynosam_tpu_torch.backend import hybrid as hybrid_mod
from dynosam_tpu_torch.backend import solver
from dynosam_tpu_torch.backend import wcpe as wcpe_mod
from dynosam_tpu_torch.backend import window as window_mod
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.cv import camera as cam
from dynosam_tpu_torch.frontend.frontend import (
    FrontendState,
    empty_frontend_state,
    frontend_step,
)
from dynosam_tpu_torch.frontend.types import FrameInputs
from dynosam_tpu_torch.ops.ransac import BatchRows
from dynosam_tpu_torch.parallel.group import Group, gather_to_rank0
from dynosam_tpu_torch.utils.stats import span


@dataclass
class PipelineState:
    frontend: FrontendState
    graph: GraphState


def init_pipeline_state(cfg: DynoConfig, device="cuda", image_shape=None) -> PipelineState:
    cfg = cfg.normalized()
    return PipelineState(
        frontend=empty_frontend_state(cfg.frontend, device, image_shape=image_shape),
        graph=graph_mod.empty_graph(cfg.backend, device),
    )


def _incremental(cfg: DynoConfig) -> DynoConfig:
    """The normalized configuration the fused step runs: incremental mode
    (optimization_mode 2) warm-starts a few accept/reject LM iterations."""
    cfg = cfg.normalized()
    bcfg = cfg.backend
    if bcfg.optimization_mode == 2:
        # incremental mode: warm-started LM, few iterations, accept/reject
        bcfg = dataclasses.replace(
            bcfg,
            optimizer=dataclasses.replace(
                bcfg.optimizer,
                accept_reject=True,
                max_iterations=min(3, bcfg.optimizer.max_iterations),
            ),
        )
    return dataclasses.replace(cfg, backend=bcfg)


def _formulation(bcfg):
    """(advance, ingestion, optimizer) of backend_updater_enum: 0 WCME,
    1 WCPE, 2 or 3 hybrid (decoupled or joint)."""
    enum = bcfg.backend_updater_enum
    if enum in (2, 3):
        return window_mod.advance_hybrid, graph_mod.update_from_packet_hybrid, hybrid_mod.optimize
    if enum == 1:
        return window_mod.advance_wcpe, wcpe_mod.update_from_packet_wcpe, wcpe_mod.optimize
    if enum == 0:
        return window_mod.advance, graph_mod.update_from_packet, solver.optimize
    raise ValueError(f"backend_updater_enum={enum}: 0, 1, 2 or 3")


def _backend_step(cfg: DynoConfig, pipelined: bool):
    """backend(g, packet, intr) -> g: the window advance when the window
    is full, the packet's ingestion and the formulation's optimizer, in the
    sequential order (optimize the window through the packet's frame) or,
    pipelined, the reference's order: optimize the window through the
    previous frame, then advance and ingest."""
    bcfg = cfg.backend
    advance_fn, update_fn, optimize_fn = _formulation(bcfg)

    def advance_if_full(g):
        if g.num_frames < bcfg.max_frames:
            return g
        with span("backend.advance"):
            return advance_fn(g, bcfg)

    def ingest(g, packet, intr):
        with span("backend.ingest"):
            return update_fn(g, packet, intr, bcfg)

    def optimize(g):
        with span("backend.optimize"):
            return optimize_fn(g, bcfg)

    if pipelined:
        def backend(g, packet, intr):
            with span("backend"):
                return ingest(advance_if_full(optimize(g)), packet, intr)
    else:
        def backend(g, packet, intr):
            with span("backend"):
                return optimize(ingest(advance_if_full(g), packet, intr))
    return backend


def make_fused_step(
    cfg: DynoConfig,
    intr: cam.CameraIntrinsics,
    generator: Optional[torch.Generator] = None,
    pipelined: bool = False,
):
    """Returns step(state, inputs) -> (state, outputs). RANSAC draws from
    `generator`, which must live on the frames' device.

    pipelined=True is the reference's software-pipelined step: frontend(k),
    then the optimizer on the window through frame k-1 (which does not
    depend on frame k's images), then the advance if the window is full,
    then frame k's ingestion; its outputs are read before frame k's window
    is optimized. The default is the sequential order."""
    cfg = _incremental(cfg)
    enum = cfg.backend.backend_updater_enum
    backend = _backend_step(cfg, pipelined)

    def step(state: PipelineState, inputs: FrameInputs):
        fe_state, packet = frontend_step(
            state.frontend, inputs, intr, cfg.frontend, generator
        )
        g = backend(state.graph, packet, intr)
        return PipelineState(frontend=fe_state, graph=g), _outputs(g, packet, enum)

    return step


def _outputs(g: GraphState, packet, enum: int):
    """The frame's outputs at the newest window slot (each with the batch's
    leading axis, if any)."""
    latest = min(max(g.num_frames - 1, 0), g.F - 1)
    prev = max(latest - 1, 0)
    # the F2F world motion and its validity: hybrid needs a motion
    # variable or the keyframe at the previous slot, WCPE both pose
    # variables; WCME's motions are per-frame variables
    if enum in (2, 3):
        H_out = hybrid_mod.f2f_motion(g, latest)
        H_ok = g.H_valid[..., latest] & (g.H_valid[..., prev] | (g.kf_slot == prev)) & (latest > 0)
    elif enum == 1:
        H_out = wcpe_mod.f2f_motion(g, latest)
        H_ok = g.H_valid[..., latest] & g.H_valid[..., prev] & (latest > 0)
    else:
        H_out, H_ok = g.H[..., latest, :, :], g.H_valid[..., latest]
    return {
        "X_world_cam": g.X[..., latest, :, :],
        "object_ids": g.obj_ids,
        "object_motions": H_out,
        "object_motion_valid": H_ok,
        "frontend_pose": packet.X_world_cam,
    }


def _map_tensors(fn, obj):
    """`obj` (nested dataclasses of tensors and host ints) with `fn` applied
    to every tensor."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return fn(obj) if torch.is_tensor(obj) else obj


def _refuse_unbatched(cfg: DynoConfig):
    """ValueError for KLT tracking, which the reference's batch cannot run
    either: its batch is built without an image_shape (`_init_batch`), so
    its `empty_frontend_state` raises in KLT mode."""
    if not cfg.frontend.tracker.prefer_provided_optical_flow:
        raise ValueError(
            "make_batched_pipeline: KLT tracking (prefer_provided_optical_flow=False) needs the "
            "previous frame in the state, and the reference's batch is built without an "
            "image_shape (_init_batch), so its empty_frontend_state raises in KLT mode"
        )


def _rows(B: int, group: Optional[Group]) -> slice:
    """The rows of a batch of B sequences that `group`'s rank steps."""
    if group is None:
        return slice(0, B)
    if B % group.world:
        raise ValueError(f"a batch of {B} sequences does not divide over {group.world} ranks")
    n = B // group.world
    return slice(group.rank * n, (group.rank + 1) * n)


def shard_rows(obj, group: Optional[Group]):
    """This rank's rows of a batch (a dataclass such as FrameInputs or
    PipelineState, or a dict, of tensors with the batch's leading axis)."""
    if group is None:
        return obj
    if isinstance(obj, dict):
        return {k: shard_rows(v, group) for k, v in obj.items()}
    rows = _rows(_first_tensor(obj).shape[0], group)
    return obj[rows] if torch.is_tensor(obj) else _map_tensors(lambda t: t[rows], obj)


def _first_tensor(obj):
    if torch.is_tensor(obj):
        return obj
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            found = _first_tensor(getattr(obj, f.name))
            if found is not None:
                return found
    return None


def gather_outputs(outputs: dict, group: Optional[Group]):
    """A step's per-sequence outputs (each (B/P, ...) on every rank) -> on
    rank 0 each (B, ...) in sequence order; None on the other ranks."""
    if group is None:
        return outputs
    parts = {k: gather_to_rank0(v, group) for k, v in outputs.items()}
    return None if group.rank else {k: torch.cat(v, dim=0) for k, v in parts.items()}


def make_batched_pipeline(
    cfg: DynoConfig,
    intr: cam.CameraIntrinsics,
    generator: Optional[torch.Generator] = None,
    group: Optional[Group] = None,
):
    """The fused step over B sequences at once -> (step, init_fn).

    `init_fn(B, device="cuda")` gives a PipelineState whose tensors carry a
    leading batch axis of B (the reference's `_init_batch`); with a `group`,
    this rank's B/P rows of it.
    `step(states, inputs)` takes FrameInputs with the same leading B and
    returns the new states and per-sequence outputs, each (B, ...). It is
    one program: every torch operation runs once for the whole batch, the
    Shi-Tomasi kernel launches once per frame for all B images, and RANSAC
    draws the whole batch's uniforms from the one `generator` (on the
    frames' device). The sequences step in lockstep, so the window fill
    stays one host integer, `GraphState.num_frames`, as the reference's
    sequences advance together under vmap. Every formulation runs batched
    (backend_updater_enum 0 WCME, 1 WCPE, 2 or 3 hybrid, decoupled or
    joint), dispatched as make_fused_step dispatches, and every frontend
    mode of the reference's vmapped step: the provided flow with provided
    object ids or the detector's ByteTrack relabelling
    (prefer_provided_object_detection=False), the IMU with its rotation
    prior on frames carrying an IMU window, and in-loop stereo on frames
    carrying a right image (decided for the whole batch).

    `group` (`parallel/group.py`, one rank per device) is the reference's
    `mesh=`: the sequence axis split over the ranks, rank r stepping
    sequences [r B/P, (r + 1) B/P) with the inputs' rows `shard_rows` takes.
    The sequences share nothing, so no collective runs in the step. Every
    rank must hold a `generator` seeded as the unsharded run's: each draw is
    made for the whole batch and the rank's rows kept (`ops/ransac.py::
    BatchRows`), so sequence b takes the same numbers at any world size, as
    the reference's sequences carry their keys in their states. Without a
    group the draws are the whole batch's, as ever.

    As in the reference, whose batch is built without an image shape
    (`_init_batch`), KLT tracking raises ValueError here, and mask
    propagation never runs."""
    cfg = _incremental(cfg)
    _refuse_unbatched(cfg)
    enum = cfg.backend.backend_updater_enum
    backend = _backend_step(cfg, pipelined=False)
    if group is not None:
        generator = BatchRows(generator, group.world, group.rank)

    def init_fn(B: int, device="cuda") -> PipelineState:
        rows = _rows(B, group)
        one = init_pipeline_state(cfg, device)
        n = rows.stop - rows.start
        return _map_tensors(lambda t: t.expand((n,) + t.shape).clone(), one)

    def step(states: PipelineState, inputs: FrameInputs):
        fidx = states.frontend.frame_idx
        if fidx.ndim != 1 or inputs.rgb.ndim != 4 or inputs.rgb.shape[0] != fidx.shape[0]:
            raise ValueError(
                f"batched step: states with frame_idx {tuple(fidx.shape)} and rgb "
                f"{tuple(inputs.rgb.shape)} must share one leading batch axis"
            )
        with span("step", new_step=True):
            fe_state, packet = frontend_step(states.frontend, inputs, intr, cfg.frontend, generator)
            g = backend(states.graph, packet, intr)
            return PipelineState(frontend=fe_state, graph=g), _outputs(g, packet, enum)

    return step, init_fn
