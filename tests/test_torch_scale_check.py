"""Parity of the port's scale_check (dynosam_tpu_torch/scale_check.py) with
scripts/scale_check.py on the CPU at J=4 objects, an F=6 window and 64
dynamic landmarks: the reference's time_config runs as it is, and its graph
states are taken where it waits on them (after the second optimize and the
second advance); the port's time_config keeps the same two states, its
landmark clouds drawn from the reference's uniforms. Frame
ids, object slots and motion validity equal; camera poses within 1e-5 m;
settled motions (valid at the slot before too) within 1e-5 m for WCME and
1e-3 m for the hybrid formulation, whose decoupled object phase moves its
motions by ~1e-4 under f32 rounding of its inputs (ROADMAP queue 3). Also
the CLI's columns and where it writes."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from dynosam_tpu_torch import scale_check as sc
from torch_port_util import scenario_uniforms

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J, F, N_DYN = 4, 6, 64
MOTION_M = {0: 1e-5, 3: 1e-3}


def _reference():
    spec = importlib.util.spec_from_file_location("ref_scale_check", os.path.join(ROOT, "scripts", "scale_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_states(monkeypatch, formulation):
    seen = []
    orig = jax.block_until_ready
    monkeypatch.setattr(jax, "block_until_ready", lambda x: (seen.append(x), orig(x))[1])
    res = _reference().time_config(J, F, N_DYN, formulation, 1)
    monkeypatch.undo()
    assert len(seen) == 6          # update 0, updates 1..F-1, optimize x2, advance x2
    return res, seen[3], seen[5]


@pytest.mark.parametrize("formulation", [0, 3], ids=["wcme", "hybrid"])
def test_time_config_state_matches_jax(monkeypatch, formulation):
    jres, jopt, jadv = _jax_states(monkeypatch, formulation)
    # the reference's landmark clouds, so both backends take the same packets
    spec = sc.scale_scenario(J, F, sc.scale_config(J, F, N_DYN, formulation, 1)[1], "cpu").spec
    res, topt, tadv = sc.time_config(J, F, N_DYN, formulation, 1, device="cpu",
                                     uniforms=scenario_uniforms(spec))
    assert set(res) == set(jres) == set(sc.COLUMNS)
    assert all(np.isfinite(v) and v >= 0 for v in res.values())
    for js, ts in ((jopt, topt), (jadv, tadv)):
        for k in ("frame_ids", "obj_ids", "H_valid"):
            np.testing.assert_array_equal(ts.__dict__[k].numpy(), np.asarray(getattr(js, k)), err_msg=k)
        np.testing.assert_allclose(ts.X.numpy(), np.asarray(js.X), rtol=0, atol=1e-5)
        both = ts.H_valid.numpy() & np.asarray(js.H_valid)
        settled = both.copy()
        settled[:, 1:] &= both[:, :-1]
        settled[:, 0] = False
        assert settled.sum() >= 6
        err = np.linalg.norm(ts.H.numpy()[..., :3, 3] - np.asarray(js.H)[..., :3, 3], axis=-1)
        assert err[settled].max() <= MOTION_M[formulation], err[settled].max()


def test_cli_writes_every_column_outside_the_reference(tmp_path):
    out = tmp_path / "SCALE.md"
    rows = sc.main(["--J", "2", "--F", "4", "--dyn", "16", "--device", "cpu", "--out", str(out)])
    assert [r["formulation"] for r in rows] == ["WCME", "Hybrid"]
    text = out.read_text()
    assert "J=2 objects, F=4 window, 16 dynamic landmarks (cpu (not a card))" in text
    header = [ln for ln in text.splitlines() if ln.startswith("| Formulation")][0]
    assert header.count("|") == 8 and "advance step (ms)" in header
    assert len([ln for ln in text.splitlines() if ln.startswith("| WCME") or ln.startswith("| Hybrid")]) == 2
    # the default output is no committed file (the reference's SCALE.md,
    # the port's dynosam_tpu_torch/SCALE.md): it lies under the git-ignored
    # results/
    assert sc.DEFAULT_OUT == os.path.join("results", "torch", "SCALE.md")
    assert "results/" in open(os.path.join(ROOT, ".gitignore")).read().splitlines()
    assert _reference().time_config.__module__ == "ref_scale_check"
