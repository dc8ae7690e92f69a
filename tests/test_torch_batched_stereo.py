"""The batched step with in-loop stereo against the JAX reference and
against the port's unbatched step: the stereo mode of
test_torch_batched_modes.py (whose docstring gives the scene and the
bounds), in a file of its own so that the two run side by side."""

import numpy as np
import pytest
import torch

from test_torch_batched_modes import B, N, _run_mode, check_equals_unbatched, check_matches_reference


@pytest.fixture(scope="module")
def run():
    return "stereo", _run_mode("stereo")


def test_batched_stereo_matches_reference(run):
    check_matches_reference(*run)
    # stereo took the static depths back from the 1.15x corruption in
    # every sequence: the median relative error of the near tracks at the
    # last frame well under the corruption's 15% (0.055 at most here, where
    # some tracks fail their match and keep the provided depth)
    mode, r = run
    td, ts = r["td"], r["ts"]
    k_last = N - 1
    for b in range(B):
        k = k_last + b
        true_depth, _ = td._depth_mask(td.scn.X_gt[k], [L[k] for L in td.scn.L_gt])
        trk = ts.frontend.tracker
        valid = trk.s_valid[b]
        uv = trk.s_uv[b][valid].round().long()
        gt = true_depth[uv[:, 1].clamp(0, td.intr.height - 1), uv[:, 0].clamp(0, td.intr.width - 1)]
        near = gt < 15.0
        assert int(near.sum()) >= 5, b
        err = torch.abs(trk.s_depth[b][valid][near] - gt[near]) / gt[near]
        assert float(torch.median(err)) < 0.1, (b, float(torch.median(err)))


def test_batched_stereo_equals_unbatched_runs(run):
    check_equals_unbatched(*run)
