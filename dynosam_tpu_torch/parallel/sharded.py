"""Landmark-chunked backend assembly (port of dynosam_tpu/parallel/sharded.py).

The reference shards a single sequence's landmark tables over a device mesh:
the Hessian assembly is an exact sum over landmarks,

    S = sum_l S_l(theta)  ->  split l into P parts, sum the (D, D) partials,

so each shard runs `hybrid.linearize` on its slice of the landmark tables
with the non-landmark terms (smoothing, odometry, gauge, marginal prior)
scaled by 1/P, one `psum` gives the exact global normal equations, and the
landmark back-substitution stays shard-local.

One GPU has no mesh, so here the P chunks are linearized in turn on the one
device and `_reduce` adds their systems: the same exact sum. The reduction
is that one function, which a multi-GPU version would replace with an
`all_reduce` over a process group.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from dynosam_tpu_torch.backend import hybrid
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.backend.solver import _clip_step, _final_reg, chol_solve
from dynosam_tpu_torch.config import BackendParams

# landmark-indexed GraphState fields -> the axis that runs over landmarks
LD_FIELDS = {"md": 0, "d_tid": 0, "d_obj": 0, "d_z": 0, "d_valid": 0,
             "d_sig": 0, "m_hyb": 0}
LS_FIELDS = {"ms": 0, "s_tid": 0, "s_z": 1, "s_valid": 1, "s_sig": 1}
_LANDMARK_AXES = {**LD_FIELDS, **LS_FIELDS}


def chunk_state(state: GraphState, P: int) -> List[GraphState]:
    """The state split into P chunks along the landmark tables; every other
    field is shared by all chunks (the reference's `shard_state`). The
    capacities Ls and Ld must divide by P."""
    for cap, name in ((state.Ls, "max_static_landmarks"), (state.Ld, "max_dynamic_landmarks")):
        if cap % P:
            raise ValueError(f"{name} = {cap} does not divide into {P} chunks")
    parts = {name: torch.chunk(getattr(state, name), P, dim=axis)
             for name, axis in _LANDMARK_AXES.items()}
    return [dataclasses.replace(state, **{name: p[i] for name, p in parts.items()})
            for i in range(P)]


def merge_chunks(chunks: List[GraphState]) -> GraphState:
    """The inverse of `chunk_state`: landmark tables concatenated, the
    shared fields taken from the first chunk."""
    return dataclasses.replace(chunks[0], **{
        name: torch.cat([getattr(c, name) for c in chunks], dim=axis)
        for name, axis in _LANDMARK_AXES.items()
    })


def _reduce(parts: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the chunks' partial systems (the reference's psum)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _chunk_lins(chunks: List[GraphState], cfg: BackendParams, lam):
    P = len(chunks)
    return [hybrid.linearize(c, cfg, lam, fixed_scale=1.0 / P, final_reg=False) for c in chunks]


def chunked_linearize(state: GraphState, cfg: BackendParams, lam, P: int):
    """Exact global (S, rhs) of `hybrid.linearize` by landmark-chunked
    assembly and one reduction (the reference's `sharded_linearize`)."""
    lins = _chunk_lins(chunk_state(state, P), cfg, lam)
    S = _reduce([lin.S for lin in lins])
    rhs = _reduce([lin.rhs for lin in lins])
    return _final_reg(S, lam), rhs


def chunked_gn_step(state: GraphState, cfg: BackendParams, lam, P: int, max_step: float = 0.2):
    """One Gauss-Newton step with chunked assembly and chunk-local landmark
    back-substitution (the reference's `sharded_gn_step`): the (D, D) solve
    runs once, each chunk applies the same pose and motion update and its
    own points' updates."""
    chunks = chunk_state(state, P)
    lins = _chunk_lins(chunks, cfg, lam)
    S = _final_reg(_reduce([lin.S for lin in lins]), lam)
    rhs = _reduce([lin.rhs for lin in lins])
    dx = _clip_step(chol_solve(S, rhs), max_step)
    return merge_chunks([hybrid._apply_update(c, lin, dx) for c, lin in zip(chunks, lins)])


def chunked_optimize(state: GraphState, cfg: BackendParams, P: int, iterations: int = None):
    """Fixed-iteration damped GN with chunked assembly (the reference's
    `sharded_optimize`: no accept/reject, as incremental mode's plain
    warm-started GN)."""
    op = cfg.optimizer
    lam = torch.full((), op.lm_initial_lambda, dtype=state.X.dtype, device=state.X.device)
    for _ in range(iterations or op.max_iterations):
        state = chunked_gn_step(state, cfg, lam, P, max_step=op.gn_max_step)
    return state
