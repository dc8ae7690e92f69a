"""A whole run at the tiny cut on the CPU: the result's shape with and
without the trace, what the command does without a card, what the harness
and the reference load, and `correct` coming out false when the timed step
is broken underneath (the faults a lockstep sweep on one card can have)."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

import tiny
from portbench import run

SEED = 2**31 + 777


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cells under the kitti-hybrid cell's committed limits (those
    on the ground truth at the tiny cut's own values)."""
    limits = tiny.tiny_limits(tiny.load("limits", "kitti-hybrid.sweep.json")["limits"])
    return tiny.make_root(str(tmp_path_factory.mktemp("portbench")), limits=limits)


@pytest.fixture(scope="module")
def truth_root(tmp_path_factory):
    """The tiny cells held to the ground truth alone, as a defect that the
    program and the reference's frozen copy of it share would leave them."""
    limits = {k: v for k, v in tiny.TRUTH.items()}
    return tiny.make_root(str(tmp_path_factory.mktemp("portbench_truth")), limits=limits)


def _run(root, workload="tiny-hybrid.sweep", trace=0, seconds=0.5, wrap_step=None):
    return run.run_cell(root, workload, SEED, seconds, trace, device="cpu", t_start=time.perf_counter(),
                        wrap_step=wrap_step, log=lambda s: None)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line_has_the_contract_keys(root, trace):
    r = _run(root, "tiny-stereo-imu.sweep", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    keys += ["numbers", "checks"]
    assert list(r) == keys
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] % 2 == 0 and r["attempted"] >= 6
    if trace:
        assert {"frontend_dispatch_ms", "backend_dispatch_ms", "stereo_imu_dispatch_ms", "step_ms_p95"} <= set(r["metrics"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in r["device"] and "window_s" in r["device"]
    else:
        assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def _stale(step):
    """A step that hands back its input state and the outputs of its first call."""
    first = {}

    def broken(states, inputs):
        if not first:
            first["state"], first["out"] = step(states, inputs)
        return states, first["out"]
    return broken


def _half(step):
    """A step that computes half of the lanes and gives the other half their outputs."""
    def broken(states, inputs):
        states, out = step(states, inputs)
        h = out["X_world_cam"].shape[0] // 2
        return states, {k: torch.cat([v[:h], v[:h]]) for k, v in out.items()}
    return broken


def _altered(step):
    """A step whose camera poses are moved 5 cm where they are produced."""
    def broken(states, inputs):
        states, out = step(states, inputs)
        X = out["X_world_cam"].clone()
        X[..., 0, 3] += 0.05
        return states, dict(out, X_world_cam=X)
    return broken


def _no_motions(step):
    """A step that marks every object motion invalid where it is produced."""
    def broken(states, inputs):
        states, out = step(states, inputs)
        return states, dict(out, object_motion_valid=torch.zeros_like(out["object_motion_valid"]))
    return broken


FAULTS = [_stale, _half, _altered, _no_motions]
FAULT_IDS = ["stale", "half", "altered", "no_motions"]


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_a_broken_step_is_not_correct(root, fault):
    assert _run(root, seconds=1.5, wrap_step=fault)["correct"] is False


def test_a_sound_step_is_correct_against_the_truth_alone(truth_root):
    r = _run(truth_root, seconds=1.5)
    assert r["correct"] is True and set(r["checks"]) == {"nonfinite_lane_frames"} | set(tiny.TRUTH)


@pytest.mark.parametrize("fault", [_stale, _no_motions], ids=["stale", "no_motions"])
def test_the_truth_alone_catches_a_broken_step(truth_root, fault):
    assert _run(truth_root, seconds=1.5, wrap_step=fault)["correct"] is False


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "kitti-hybrid.sweep", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


PROBE = """
import json, sys, time
sys.path.insert(0, {tests!r})
import tiny
root = tiny.make_root({tmp!r})
if {ref_only}:
    from portbench import check, reference, scenes, spec
    cell = spec.load_cell(root, "tiny-stereo-imu.sweep")
    bank = scenes.SceneBank(5, cell.traffic, cell.config, "cpu")
    reference.replay(cell, bank, [0, 1], 2, 9, "cpu")
else:
    from portbench import run
    run.run_cell(root, "tiny-stereo-imu.sweep", 5, 0.5, 1, device="cpu", t_start=time.perf_counter(),
                 log=lambda s: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("ref_only", [False, True], ids=["harness", "reference"])
def test_what_a_run_and_the_reference_load(tmp_path, ref_only):
    code = PROBE.format(tests=tiny.HERE, tmp=str(tmp_path), ref_only=ref_only)
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True, check=True)
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "dynosam_tpu"}
    assert ("dynosam_tpu_torch" in top) is not ref_only
