"""The plain reference of the batched step: the configuration's reference
package (`portbench/frozen`, a frozen copy of the port's step with the
Shi-Tomasi kernel's plain PyTorch form) replays a sample of the window's
lanes from their first frame, on the same frames and the same RANSAC draws.

The program draws each RANSAC batch for all B lanes from one generator; the
replay seeds its own generator alike, draws the same whole-batch shapes and
keeps its lanes' rows (`Rows`), so a lane takes the numbers it took in the
window. Matrix products run in float32 with TF32 off, as the configuration
states. Nothing here imports the port, JAX or the JAX package, and nothing
the program made is read: the replay builds its own configuration and state
from the configuration file and the scene bank.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import check, programs
from portbench.drivers import lockstep


class Rows:
    """A draw source for a subset of a batch's lanes: each draw is made for
    all `B` lanes from `generator` and the `rows` kept."""

    def __init__(self, generator, B: int, rows: torch.Tensor):
        self.generator, self.B, self.rows = generator, B, rows

    def rand(self, shape, device):
        full = torch.rand((self.B,) + tuple(shape[1:]), generator=self.generator, device=device)
        return full[self.rows]


def replay(cell, bank, rows: list, steps: int, seed: int, device) -> np.ndarray:
    """Window steps [0, steps) of lanes `rows` -> (steps, len(rows), P)
    packed outputs, stepped as a batch of len(rows) lanes."""
    api = programs.load(cell.config["reference"])
    dev = torch.device(device)
    B = cell.traffic["lanes"]
    idx = torch.as_tensor(rows, dtype=torch.long, device=dev)
    cfg, intr = programs.build(api, cell.config)
    gen = torch.Generator(device=dev).manual_seed(seed)
    step, init_fn = api.batched.make_batched_pipeline(cfg, intr, Rows(gen, B, idx))
    n = len(rows)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        states = init_fn(n, dev)
        for i in range(steps):
            if lockstep.schedule(i, bank.K)[1] == 0 and i > 0:
                states = init_fn(n, dev)
            states, o = step(states, lockstep.frame_inputs(api, bank, B, i, idx))
            out.append(check.pack(o).cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return np.stack(out)
