"""Fixed-shape, fully vectorised RANSAC (port of dynosam_tpu/ops/ransac.py).

A static number of hypotheses is sampled, solved and scored in parallel. The
port batches over any leading dimensions of `valid` (the object-slot axis of
the per-object solves), where the reference vmaps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


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
    reference. `uniforms` (*B, num_hypotheses, N) in [0, 1) replaces the draw
    from `generator` (tests inject the reference's draws this way)."""
    n = valid.shape[-1]
    shape = valid.shape[:-1] + (num_hypotheses, n)
    if uniforms is None:
        g = torch.rand(shape, generator=generator, device=valid.device)
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
) -> RansacResult:
    idx = _sample_indices(generator, valid, num_hypotheses, sample_size, uniforms)
    sampled = {k: v[idx] for k, v in data.items()}
    models = solve_fn(sampled)                               # (*B, M, 4, 4)
    residuals = residual_fn(models, data)                    # (*B, M, N)
    inlier_masks = (residuals < threshold) & valid[..., None, :]
    counts = torch.sum(inlier_masks, dim=-1)
    best = torch.argmax(counts, dim=-1)                      # (*B,) first max

    model = torch.take_along_dim(models, best[..., None, None, None], dim=-3)[..., 0, :, :]
    inliers = torch.take_along_dim(inlier_masks, best[..., None, None], dim=-2)[..., 0, :]

    if refit_fn is not None:
        for _ in range(refit_rounds):
            model = refit_fn(data, inliers.to(residuals.dtype), model)
            res = residual_fn(model, data)
            inliers = (res < threshold) & valid

    num_inliers = torch.sum(inliers, dim=-1)
    return RansacResult(
        model=model,
        inliers=inliers,
        num_inliers=num_inliers,
        valid=num_inliers >= min_inliers,
    )
