"""The port of scripts/bisect_perf.py (dynosam_tpu_torch/bisect_perf.py):
its variants are the reference's, each variant's configuration is JAX's
`with_overrides` of the bench configuration field for field, and the fused
step with each switch the variants flip is held to JAX's on the dense test
scene (6 frames at max_frames=4, two advances; the noise-free scene makes
RANSAC's outcome independent of the draws). The port's code for the off
state of refine_motion_with_joint_of, refine_camera_pose_with_joint_of,
scene_flow_percentage and marginal_point_uncertainty runs nowhere else in
the tests. The fused steps of the first half of the variants are here, the
rest in test_torch_bisect_perf_steps.py (each file stays within ~3 minutes
in one worker)."""

import dataclasses
import importlib.util
import os

import pytest
import torch

import bench
from dynosam_tpu_torch import bisect_perf as tbp
from dynosam_tpu_torch.bench import build
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from torch_port_util import fused_step_readings, port_cfg, small_cfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_FRAMES = 6
# the bounds of test_torch_slice.py's fused-step tests: camera poses within
# 1e-4 (entries), object motions within 1e-3, ids and validity equal
POSE_TOL, MOTION_TOL = 1e-4, 1e-3
FIRST_HALF = ["shipped", "no_obj_joint_of", "no_cam_joint_of", "no_propogate_mask"]


def reference_script():
    """scripts/bisect_perf.py as a module (its main() is not run)."""
    spec = importlib.util.spec_from_file_location("ref_bisect_perf", os.path.join(ROOT, "scripts", "bisect_perf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variants_are_the_reference_variants():
    ref = reference_script()
    assert tbp.VARIANTS == ref.VARIANTS
    assert list(tbp.VARIANTS) == list(ref.VARIANTS)
    assert tbp.WARMUP == 8 and ref.measure.__defaults__ == (30, tbp.WARMUP)


@pytest.mark.parametrize("name", list(tbp.VARIANTS))
def test_variant_config_matches_reference(name):
    jcfg, _ = bench.bench_config()
    ref = jcfg.with_overrides(tbp.VARIANTS[name]) if tbp.VARIANTS[name] else jcfg
    cfg, _ = tbp.variant_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    # the test configuration the fused steps below run
    assert (dataclasses.asdict(port_cfg(small_cfg(4).with_overrides(tbp.VARIANTS[name])))
            == dataclasses.asdict(port_cfg(small_cfg(4)).with_overrides(tbp.VARIANTS[name])))


def check_variant_step(name):
    cfg = small_cfg(4).with_overrides(tbp.VARIANTS[name])
    pose_err, motion_err, n_motions, tg, _ = fused_step_readings(cfg, STEP_FRAMES)
    print(f"{name}: poses {pose_err:.2e}, {n_motions} motions {motion_err:.2e}")
    assert n_motions > 0 and bool(tg.prior_valid)
    assert pose_err <= POSE_TOL and motion_err <= MOTION_TOL


@pytest.mark.parametrize("name", FIRST_HALF)
def test_variant_fused_step_matches_reference(name):
    check_variant_step(name)


def test_no_propogate_mask_runs_shipped_program():
    """Without an image shape mask propagation never runs, so switching it
    off changes nothing: every output of every frame equal."""
    scene = t_dense(num_frames=STEP_FRAMES, device="cpu")
    outs = {}
    for name in ("shipped", "no_propogate_mask"):
        cfg = port_cfg(small_cfg(4).with_overrides(tbp.VARIANTS[name]))
        step, state = build(cfg, scene.intr, "cpu", seed=0)
        outs[name] = []
        for k in range(STEP_FRAMES):
            state, out = step(state, scene.frame(k))
            outs[name].append(out)
    for a, b in zip(outs["shipped"], outs["no_propogate_mask"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_main_prints_each_variant_against_shipped(capsys):
    rows = tbp.main(["--variants", "shipped,no_propogate_mask,all_off", "-n", "1", "--device", "cpu", "--small"])
    out = capsys.readouterr().out
    assert list(rows) == ["shipped", "no_propogate_mask", "all_off"]
    assert all(r["ms"] > 0 and r["K1"] == 0 for r in rows.values())     # no kernel on the CPU
    assert "vs shipped" in out and "same program as shipped" in out
    with pytest.raises(SystemExit):
        tbp.main(["--variants", "no_such_variant", "--device", "cpu"])
