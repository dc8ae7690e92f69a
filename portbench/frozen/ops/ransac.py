"""Fixed-shape, fully vectorised RANSAC (port of dynosam_tpu/ops/ransac.py).

A static number of hypotheses is sampled, solved and scored in parallel. The
port batches over any leading dimensions of `valid` (the object-slot axis of
the per-object solves), where the reference vmaps. With `nb=1` the data carry
a leading batch axis of sequences too (the batched step): `valid` is
(B, *S, N) and each data tensor (B, N, ...), and each sequence samples its
own correspondences.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class BatchRows:
    """A source of RANSAC draws for rows [rank * n, (rank + 1) * n) of a
    batch of world * n sequences (one rank's share of the batched step):
    each draw is made for the whole batch from `source` (a torch.Generator,
    None for torch's default, or another draw source) and this rank's rows
    kept, so sequence b's numbers are the same at any world size and equal
    the unsharded batch's."""

    def __init__(self, source, world: int, rank: int):
        self.source, self.world, self.rank = source, world, rank

    def rand(self, shape, device):
        n = shape[0]
        full = draw_uniform(self.source, (n * self.world,) + tuple(shape[1:]), device)
        return full[self.rank * n:(self.rank + 1) * n]


class ReplayDraws:
    """A source of RANSAC draws that hands out the given arrays in call
    order (a reference's own uniforms, for a parity run)."""

    def __init__(self, arrays):
        self.queue = list(arrays)

    def rand(self, shape, device):
        if not self.queue:
            raise IndexError("ReplayDraws: no draw left")
        g = torch.as_tensor(self.queue.pop(0), dtype=torch.float32, device=device)
        if tuple(g.shape) != tuple(shape):
            raise ValueError(f"ReplayDraws: the next draw is {tuple(g.shape)}, the call wants {tuple(shape)}")
        return g


def draw_uniform(source, shape, device) -> torch.Tensor:
    """Uniforms in [0, 1) of `shape` from `source`: a torch.Generator (or
    None, torch's default one) or a draw source with `rand(shape, device)`
    (BatchRows, ReplayDraws)."""
    if hasattr(source, "rand"):
        return source.rand(shape, device)
    return torch.rand(shape, generator=source, device=device)


class RansacResult(NamedTuple):
    model: torch.Tensor        # (*B, 4, 4)
    inliers: torch.Tensor      # (*B, N) bool
    num_inliers: torch.Tensor  # (*B,) int64
    valid: torch.Tensor        # (*B,) bool


def _sample_indices(
    generator: Optional[torch.Generator],
    valid: torch.Tensor,
    num_hypotheses: int,
    sample_size: int,
    uniforms: Optional[torch.Tensor] = None,
):
    """(*B, num_hypotheses, sample_size) indices drawn among valid slots.

    Gumbel top-k by `sample_size` successive argmax + mask passes, as in the
    reference. `generator` is a torch.Generator or a draw source
    (`draw_uniform`). `uniforms` (*B, num_hypotheses, N) in [0, 1) replaces
    the draw (tests inject the reference's draws this way)."""
    n = valid.shape[-1]
    shape = valid.shape[:-1] + (num_hypotheses, n)
    if uniforms is None:
        g = draw_uniform(generator, shape, valid.device)
    else:
        g = uniforms.to(device=valid.device, dtype=torch.float32).expand(shape)
    g = torch.where(valid[..., None, :], g, -torch.inf)
    lane = torch.arange(n, device=valid.device)
    cols = []
    for _ in range(sample_size):
        i = torch.argmax(g, dim=-1)
        cols.append(i)
        g = torch.where(lane == i[..., None], -torch.inf, g)
    return torch.stack(cols, dim=-1)


def _lift(data: dict, nb: int, k: int) -> dict:
    """Data tensors (*nb batch axes, N, ...) with k unit axes inserted after
    the batch axes, so they broadcast against models of k more leading
    axes; views only."""
    return {key: v.reshape(v.shape[:nb] + (1,) * k + v.shape[nb:]) for key, v in data.items()}


def ransac(
    generator: Optional[torch.Generator],
    solve_fn: Callable,       # sampled dict (*B, M, s, ...) -> models (*B, M, 4, 4)
    residual_fn: Callable,    # (models (*B', 4, 4), data) -> (*B', N)
    data: dict,               # per-correspondence tensors (N, ...), shared over *B
    valid: torch.Tensor,      # (*B, N) bool
    *,
    num_hypotheses: int,
    sample_size: int,
    threshold: float,
    min_inliers: int,
    refit_fn: Callable | None = None,  # (data, weights (*B, N), model (*B,4,4)) -> model
    refit_rounds: int = 2,
    uniforms: Optional[torch.Tensor] = None,
    nb: int = 0,              # leading sequence axes of `data` (0 or 1)
) -> RansacResult:
    idx = _sample_indices(generator, valid, num_hypotheses, sample_size, uniforms)
    if nb == 0:
        sampled = {k: v[idx] for k, v in data.items()}
        data_m = data_1 = data
    else:
        b = torch.arange(idx.shape[0], device=idx.device).reshape((-1,) + (1,) * (idx.ndim - 1))
        sampled = {k: v[b, idx] for k, v in data.items()}
        data_m = _lift(data, nb, valid.ndim - nb)            # against (B, *S, M)
        data_1 = _lift(data, nb, valid.ndim - nb - 1)        # against (B, *S)
    models = solve_fn(sampled)                               # (*B, M, 4, 4)
    residuals = residual_fn(models, data_m)                  # (*B, M, N)
    inlier_masks = (residuals < threshold) & valid[..., None, :]
    counts = torch.sum(inlier_masks, dim=-1)
    best = torch.argmax(counts, dim=-1)                      # (*B,) first max

    model = torch.take_along_dim(models, best[..., None, None, None], dim=-3)[..., 0, :, :]
    inliers = torch.take_along_dim(inlier_masks, best[..., None, None], dim=-2)[..., 0, :]

    if refit_fn is not None:
        for _ in range(refit_rounds):
            model = refit_fn(data_1, inliers.to(residuals.dtype), model)
            res = residual_fn(model, data_1)
            inliers = (res < threshold) & valid

    num_inliers = torch.sum(inliers, dim=-1)
    return RansacResult(
        model=model,
        inliers=inliers,
        num_inliers=num_inliers,
        valid=num_inliers >= min_inliers,
    )
