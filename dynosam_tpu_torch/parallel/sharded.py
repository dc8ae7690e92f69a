"""Landmark-sharded backend assembly (port of dynosam_tpu/parallel/sharded.py).

The reference shards a single sequence's landmark tables over a device mesh:
the Hessian assembly is an exact sum over landmarks,

    S = sum_l S_l(theta)  ->  split l into P parts, sum the (D, D) partials,

so each shard runs `hybrid.linearize` on its slice of the landmark tables
with the non-landmark terms (smoothing, odometry, gauge, marginal prior)
scaled by 1/P, one `psum` gives the exact global normal equations, and the
landmark back-substitution stays shard-local.

Two forms of it here:

  * over a process group (`parallel/group.py`, one rank per device, the
    reference's mesh axis): `shard_state`, `sharded_linearize`,
    `sharded_gn_step` and `sharded_optimize`, under the reference's names.
    Each rank holds one chunk of the landmark tables, linearizes it, and
    one `all_reduce` of S and rhs gives every rank the same global system;
    the (D, D) solve is replicated and each rank back-substitutes its own
    points. `gather_state` puts the chunks together on rank 0.
  * in one process (`chunked_*`): the P chunks linearized in turn on one
    device, their systems added by `_reduce`: the same exact sum.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from dynosam_tpu_torch.backend import hybrid
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.backend.solver import _clip_step, _final_reg, chol_solve
from dynosam_tpu_torch.config import BackendParams
from dynosam_tpu_torch.parallel.group import Group, all_reduce_sum, gather_to_rank0

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


def shard_state(state: GraphState, group: Group) -> GraphState:
    """This rank's chunk of `state` (the same state on every rank): its
    share of the landmark tables, every other field whole (the reference's
    `shard_state`). The capacities must divide by the world size."""
    return chunk_state(state, group.world)[group.rank]


def gather_state(chunk: GraphState, group: Group):
    """The chunks of every rank merged on rank 0 (None elsewhere); the
    shared fields are rank 0's."""
    parts = {name: gather_to_rank0(getattr(chunk, name), group) for name in _LANDMARK_AXES}
    if group.rank:
        return None
    return dataclasses.replace(chunk, **{name: torch.cat(parts[name], dim=axis)
                                         for name, axis in _LANDMARK_AXES.items()})


def _sharded_system(chunk: GraphState, cfg: BackendParams, lam, group: Group):
    lin = hybrid.linearize(chunk, cfg, lam, fixed_scale=1.0 / group.world, final_reg=False)
    S = all_reduce_sum(lin.S.clone(memory_format=torch.contiguous_format), group)
    rhs = all_reduce_sum(lin.rhs.clone(memory_format=torch.contiguous_format), group)
    return lin, _final_reg(S, lam), rhs


def sharded_linearize(chunk: GraphState, cfg: BackendParams, lam, group: Group):
    """Exact global (S, rhs) of `hybrid.linearize`, on every rank: this
    rank's chunk linearized with the non-landmark terms scaled by 1/P, one
    all_reduce (the reference's psum), then the final regularisation."""
    _, S, rhs = _sharded_system(chunk, cfg, lam, group)
    return S, rhs


def sharded_gn_step(chunk: GraphState, cfg: BackendParams, lam, group: Group, max_step: float = 0.2,
                    with_dx: bool = False):
    """One Gauss-Newton step over the group (the reference's
    `sharded_gn_step`): the reduced (D, D) system solved on every rank (it
    is small, cheaper than broadcasting a factor), the same pose and motion
    update applied everywhere and each rank's own points updated. Returns
    the new chunk, and the step `dx` with `with_dx`."""
    lin, S, rhs = _sharded_system(chunk, cfg, lam, group)
    dx = _clip_step(chol_solve(S, rhs), max_step)
    out = hybrid._apply_update(chunk, lin, dx)
    return (out, dx) if with_dx else out


def sharded_optimize(chunk: GraphState, cfg: BackendParams, group: Group, iterations: int = None,
                     on_step=None):
    """Fixed-iteration damped GN over the group (the reference's
    `sharded_optimize`: no accept/reject). `on_step(dx)`, if given, sees
    each iteration's step."""
    op = cfg.optimizer
    lam = torch.full((), op.lm_initial_lambda, dtype=chunk.X.dtype, device=chunk.X.device)
    for _ in range(iterations or op.max_iterations):
        chunk, dx = sharded_gn_step(chunk, cfg, lam, group, max_step=op.gn_max_step, with_dx=True)
        if on_step is not None:
            on_step(dx)
    return chunk
