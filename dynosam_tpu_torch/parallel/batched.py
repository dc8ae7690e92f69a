"""The fused per-frame SLAM step (port of `init_pipeline_state` and the
sequential route of `make_fused_step` in dynosam_tpu/parallel/batched.py).

One call runs frontend(k) -> window advance when the window is full ->
backend ingestion -> the formulation's optimizer on the window through k,
and returns the new state and the frame's outputs. The formulation is
backend_updater_enum: 0 WCME, 1 WCPE, 2 or 3 hybrid (decoupled or joint).
The window fill is the host integer `GraphState.num_frames`, so the
reference's `lax.cond` on it (batched.py:108-112) is a Python branch here.
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


@dataclass
class PipelineState:
    frontend: FrontendState
    graph: GraphState


def init_pipeline_state(cfg: DynoConfig, device, image_shape=None) -> PipelineState:
    cfg = cfg.normalized()
    return PipelineState(
        frontend=empty_frontend_state(cfg.frontend, device, image_shape=image_shape),
        graph=graph_mod.empty_graph(cfg.backend, device),
    )


def make_fused_step(
    cfg: DynoConfig,
    intr: cam.CameraIntrinsics,
    generator: Optional[torch.Generator] = None,
):
    """Returns step(state, inputs) -> (state, outputs). RANSAC draws from
    `generator`, which must live on the frames' device."""
    cfg = cfg.normalized()
    bcfg = cfg.backend
    enum = bcfg.backend_updater_enum
    if enum not in (0, 1, 2, 3):
        raise ValueError(f"backend_updater_enum={enum}: 0, 1, 2 or 3")
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
    cfg = dataclasses.replace(cfg, backend=bcfg)
    F = bcfg.max_frames
    if enum in (2, 3):
        advance_fn = window_mod.advance_hybrid
        update_fn = graph_mod.update_from_packet_hybrid
        optimize_fn = hybrid_mod.optimize
    elif enum == 1:
        advance_fn = window_mod.advance_wcpe
        update_fn = wcpe_mod.update_from_packet_wcpe
        optimize_fn = wcpe_mod.optimize
    else:
        advance_fn = window_mod.advance
        update_fn = graph_mod.update_from_packet
        optimize_fn = solver.optimize

    def _outputs(g: GraphState, packet):
        latest = min(max(g.num_frames - 1, 0), F - 1)
        prev = max(latest - 1, 0)
        # the F2F world motion and its validity: hybrid needs a motion
        # variable or the keyframe at the previous slot, WCPE both pose
        # variables; WCME's motions are per-frame variables
        if enum in (2, 3):
            H_out = hybrid_mod.f2f_motion(g, latest)
            H_ok = g.H_valid[:, latest] & (g.H_valid[:, prev] | (g.kf_slot == prev)) & (latest > 0)
        elif enum == 1:
            H_out = wcpe_mod.f2f_motion(g, latest)
            H_ok = g.H_valid[:, latest] & g.H_valid[:, prev] & (latest > 0)
        else:
            H_out, H_ok = g.H[:, latest], g.H_valid[:, latest]
        return {
            "X_world_cam": g.X[latest],
            "object_ids": g.obj_ids,
            "object_motions": H_out,
            "object_motion_valid": H_ok,
            "frontend_pose": packet.X_world_cam,
        }

    def step(state: PipelineState, inputs: FrameInputs):
        fe_state, packet = frontend_step(
            state.frontend, inputs, intr, cfg.frontend, generator
        )
        g = state.graph
        if g.num_frames >= F:
            g = advance_fn(g, cfg.backend)
        g = update_fn(g, packet, intr, cfg.backend)
        g = optimize_fn(g, cfg.backend)
        return PipelineState(frontend=fe_state, graph=g), _outputs(g, packet)

    return step
