"""The fused per-frame SLAM step (port of `init_pipeline_state` and the
sequential hybrid route of `make_fused_step` in
dynosam_tpu/parallel/batched.py).

One call runs frontend(k) -> window advance when the window is full ->
backend ingestion -> decoupled hybrid LM on the window through k, and
returns the new state and the frame's outputs. The window fill is the host
integer `GraphState.num_frames`, so the reference's `lax.cond` on it
(batched.py:108-112) is a Python branch here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from dynosam_tpu_torch.config import DynoConfig
from dynosam_tpu_torch.backend import graph as graph_mod
from dynosam_tpu_torch.backend import hybrid as hybrid_mod
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
    """Returns step(state, inputs) -> (state, outputs) for the hybrid
    backend (backend_updater_enum 2 or 3, decoupled solve). RANSAC draws
    from `generator`, which must live on the frames' device."""
    cfg = cfg.normalized()
    bcfg = cfg.backend
    if bcfg.backend_updater_enum not in (2, 3):
        raise NotImplementedError(
            f"backend_updater_enum={bcfg.backend_updater_enum}: only the hybrid backend (2, 3) is ported"
        )
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

    def _outputs(g: GraphState, packet):
        latest = min(max(g.num_frames - 1, 0), F - 1)
        prev = max(latest - 1, 0)
        # F2F world motion; valid when both keyframed slots exist
        H_ok = (
            g.H_valid[:, latest]
            & (g.H_valid[:, prev] | (g.kf_slot == prev))
            & (latest > 0)
        )
        return {
            "X_world_cam": g.X[latest],
            "object_ids": g.obj_ids,
            "object_motions": hybrid_mod.f2f_motion(g, latest),
            "object_motion_valid": H_ok,
            "frontend_pose": packet.X_world_cam,
        }

    def step(state: PipelineState, inputs: FrameInputs):
        fe_state, packet = frontend_step(
            state.frontend, inputs, intr, cfg.frontend, generator
        )
        g = state.graph
        if g.num_frames >= F:
            g = window_mod.advance_hybrid(g, cfg.backend)
        g = graph_mod.update_from_packet_hybrid(g, packet, intr, cfg.backend)
        g = hybrid_mod.optimize(g, cfg.backend)
        return PipelineState(frontend=fe_state, graph=g), _outputs(g, packet)

    return step
