"""The accuracy runs of eval/accuracy.py held to the JAX package on the CPU,
over the committed dyno-KITTI fixture read from disk, the port taking the
reference's RANSAC draws:

  * the window sweep's longest window: hybrid sliding-window at window 16
    over the first 20 frames (the window fills at 16 and advances 4
    times): mature camera poses within 5e-4 and matured motions within
    1e-3 (test_torch_reanchor.py's bounds);
  * scripts/accuracy_detector.py run_cell over the first 8 frames, with the
    provided masks and with the committed YOLOv8-seg checkpoint (score
    0.35, at the fixture's 96x320) + ByteTrack supplying them: the packets'
    object ids in every frame, the association of estimated ids to
    ground-truth ids and the counts equal; camera ATE, AME rms and median
    within 1e-4 m; the mature poses within 5e-4. With the detected masks
    the reference matures no object motion over these frames (nor over 20:
    the checkpoint, trained at 384x640, finds the fixture's cars poorly at
    96x320), so that row's association is empty on both sides and its AME
    undefined;
  * the same run_cell with the detected masks over the first 8 frames of
    bench_config.detector_scene (the scene the checkpoint was trained on,
    at 384x640), written to disk by eval/accuracy.py write_detector_scene
    and read back on both sides: chip_smoke.py phase 16's run, in which
    the detector finds the cars and ByteTrack gives them ids; ids,
    association and counts equal, ATE within 1e-4 m, poses within 5e-4,
    AME within DET_SCENE_AME_TOL.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from dynosam_tpu.config import DynoConfig
from dynosam_tpu.dataproviders.kitti import KittiDataProvider as JaxKitti
from dynosam_tpu.pipeline.pipeline import DynoPipeline as JaxPipeline
from dynosam_tpu_torch.bench_config import detector_accuracy_config, kitti_accuracy_config
from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider
from dynosam_tpu_torch.eval import accuracy
from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline
from torch_port_util import inject_draws, reference_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "kitti_fixture")
torch.set_num_threads(1)
SWEEP_FRAMES = 20
DET_FRAMES = 8
POSE_TOL = 5e-4
MOTION_TOL = 1e-3
RESULT_TOL = 1e-4
# the detector's scene: the poses agree to 8.1e-6 m and camera ATE to
# 3.5e-6 m, but the AME over its 9 motions parts by 1.0e-3 m (rms) and
# 7.6e-4 m (median) on this CPU; ~5x that
DET_SCENE_AME_TOL = 5e-3


@pytest.fixture(scope="module")
def window16():
    tcfg = kitti_accuracy_config("sliding_window", SWEEP_FRAMES, window=16)
    cfg = DynoConfig.from_dict(dataclasses.asdict(tcfg))
    jds, tds = JaxKitti(FIXTURE), KittiDataProvider(FIXTURE, device="cpu")
    jp = JaxPipeline(cfg, jds.intrinsics())
    tp = DynoPipeline(tcfg, tds.intrinsics(), device="cpu")
    draws = reference_draws(jp.frontend_state.key, cfg.frontend, SWEEP_FRAMES)
    with pytest.MonkeyPatch.context() as mp:
        queue = inject_draws(mp, draws)
        for k in range(SWEEP_FRAMES):
            jp.process_frame(jds.frame(k), jds.ground_truth(k))
            tp.process_frame(tds.frame(k), tds.ground_truth(k))
        assert not queue
    jp.finish()
    tp.finish()
    return jp, tp


def test_window16_matches_reference(window16):
    jp, tp = window16
    assert tp.cfg.backend.max_frames == 16
    np.testing.assert_allclose(np.stack(tp.trajectory), np.stack(jp.trajectory), atol=POSE_TOL, rtol=0)
    jm, tm = jp.backend.matured_motion, tp.backend.matured_motion
    assert sorted(tm) == sorted(jm) and jm
    err = max(float(np.abs(tm[key] - np.asarray(jm[key])).max()) for key in jm)
    assert err <= MOTION_TOL, err


@pytest.fixture(scope="module")
def det_cells(tmp_path_factory):
    """run_cell on both sides, provided and detected on the fixture and
    detected on the detector's scene -> {row: (JAX result, JAX
    association, JAX packet ids, port result, port association, port
    packet ids, JAX pipeline, port pipeline)}."""
    import accuracy_detector
    import make_torch_smoke_reference

    import dynosam_tpu.pipeline.pipeline as jpipeline
    from dynosam_tpu.nn.detector import YoloV8DetectorEngine as JaxEngine
    from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine

    scene = str(tmp_path_factory.mktemp("detector_scene"))
    accuracy.write_detector_scene(scene, DET_FRAMES)
    out = {}
    for row, root, detected in (("provided", FIXTURE, False), ("detected", FIXTURE, True),
                                ("detected_scene", scene, True)):
        jds, tds = JaxKitti(root), KittiDataProvider(root, device="cpu")
        hw = (int(jds.intrinsics().height), int(jds.intrinsics().width))
        cfg = DynoConfig.from_dict(dataclasses.asdict(detector_accuracy_config(detected)))
        draws = reference_draws(JaxPipeline(cfg, jds.intrinsics()).frontend_state.key, cfg.frontend, DET_FRAMES)
        made, ids = [], {"jax": [], "port": []}

        class Recorded(jpipeline.DynoPipeline):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

            def process_frame(self, *a, **kw):
                res = super().process_frame(*a, **kw)
                ids["jax"].append(np.where(np.asarray(self.last_packet.object_valid),
                                           np.asarray(self.last_packet.object_ids), 0))
                return res

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpipeline, "DynoPipeline", Recorded)
            queue = inject_draws(mp, draws)
            jr = accuracy_detector.run_cell(jds, DET_FRAMES, JaxEngine(input_hw=hw, score_threshold=0.35)
                                            if detected else None)
            jassoc = make_torch_smoke_reference.associate(made[-1], [jds.ground_truth(k) for k in range(DET_FRAMES)])
            tr, tp, tassoc = accuracy.run_cell(
                tds, DET_FRAMES, YoloV8DetectorEngine(input_hw=hw, score_threshold=0.35, device="cpu")
                if detected else None, "cpu",
                on_frame=lambda i, p: ids["port"].append(np.where(p.object_valid.numpy(), p.object_ids.numpy(), 0)))
            assert not queue
        out[row] = (jr, jassoc, ids["jax"], tr, tassoc, ids["port"], made[-1], tp)
    return out


@pytest.mark.parametrize("row", ["provided", "detected", "detected_scene"])
def test_detector_run_cell_matches_reference(det_cells, row):
    jr, jassoc, jids, tr, tassoc, tids, jp, tp = det_cells[row]
    np.testing.assert_array_equal(np.stack(tids), np.stack(jids))
    assert tassoc == jassoc, (tassoc, jassoc)
    for key in ("n_motions", "n_tracks", "n_assoc"):
        assert tr[key] == jr[key], (key, tr[key], jr[key])
    # the provided masks mature every object's motions within 8 frames; the
    # detected ones none on the fixture, in the reference too; on the
    # detector's scene ByteTrack tracks the cars
    assert (tr["n_assoc"] > 0) == (row == "provided") or row == "detected_scene"
    assert (tr["n_tracks"] > 0) == (row != "detected")
    for key in ("ate_t", "ame_t", "ame_t_med"):
        assert np.isnan(jr[key]) == np.isnan(tr[key]), key
        tol = DET_SCENE_AME_TOL if row == "detected_scene" and key != "ate_t" else RESULT_TOL
        if not np.isnan(jr[key]):
            assert abs(tr[key] - jr[key]) <= tol, (key, tr[key], jr[key])
    np.testing.assert_allclose(np.stack(tp.trajectory), np.stack(jp.trajectory), atol=POSE_TOL, rtol=0)


def _rich_rows_of(ref):
    """The JAX matrix's own rows in the table's layout."""
    return [(accuracy.FORMS[form], accuracy.MODES[mode], dict(ref[f"{accuracy.MODE_KEYS[mode]}_{form}"]), 1.0)
            for mode, form in accuracy.RICH_CELLS]


def test_rich_wcme_wcpe_rows_are_held_to_the_jax_seeds(tmp_path):
    """Every WCME / WCPE cell has JAX seeds besides seed 0; the JAX rows
    pass their own bounds; a row past the seeds' range, or a frontend AME
    rms past every seed's, fails."""
    ref = accuracy._ref_rows(os.path.join(accuracy.TESTDATA, "rich_matrix_ref_100f.npz"), "cells")
    spread = accuracy._seed_spread(ref)
    cells = {f"{accuracy.MODE_KEYS[m]}_{f}" for m, f in accuracy.RICH_CELLS if f != 3}
    assert cells <= set(spread)
    assert all(spread[c]["seeds"] == ([0, 1] if c.startswith("full_batch") else [0, 1, 2, 3, 4, 5]) for c in cells)
    lo, hi = spread["frontend"]
    assert lo < hi
    rows = _rich_rows_of(ref)
    assert accuracy.write_table(str(tmp_path / "t.md"), "device cpu", rich=(rows, 100)) == []
    cell = "incremental_0"
    wcme = next(r for r in rows if r[:2] == ("WCME", "incremental"))
    wcme[2]["ate_t"] = spread[cell]["ate_t"][1] * 1.5 + 1e-3
    hybrid = next(r for r in rows if r[:2] == ("Hybrid", "incremental"))
    hybrid[2]["fe_ame_t"] = hi * 1.5
    assert accuracy.write_table(str(tmp_path / "t.md"), "device cpu", rich=(rows, 100)) == [
        "rich Hybrid incremental fe_ame_t", "rich WCME incremental ate_t"]


def test_sweep_and_detector_rows_are_held_to_the_jax_rows(tmp_path):
    sweep = accuracy._ref_rows(os.path.join(accuracy.TESTDATA, "sweep_ref_60f.npz"), "cells")
    det_file = np.load(os.path.join(accuracy.TESTDATA, "det_acc_ref_60f.npz"))
    det = accuracy._ref_rows(os.path.join(accuracy.TESTDATA, "det_acc_ref_60f.npz"), "rows", "result_fields",
                             "results")
    sweep_rows = [(w, dict(sweep[f"window_{w}"]), 1.0) for w in (8, 12, 16)]
    det_rows = [(name, dict(det[name]), {int(a): int(b) for a, b in det_file[f"{name}_assoc"]}, 1.0)
                for name in ("provided", "detected")]
    out = tmp_path / "t.md"
    assert accuracy.write_table(str(out), "device cpu", sweep=(sweep_rows, 60), detector=(det_rows, 60)) == []
    sweep_rows[1][1]["ame_t_med"] += 2e-3 + 0.1 * abs(sweep["window_12"]["ame_t_med"])
    det_rows[0] = ("provided", det_rows[0][1], {1: 2}, 1.0)
    assert accuracy.write_table(str(out), "device cpu", sweep=(sweep_rows, 60), detector=(det_rows, 60)) == [
        "sweep window 12 ame_t_med", "detector provided association"]
    assert "no: ame_t_med" in out.read_text()
