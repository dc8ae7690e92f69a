"""The rich fixture of scripts/accuracy_rich.py (1242x375, KITTI's camera,
four cars, the fourth occluded behind the lead car and re-entering), the
tracker's observability floor and the accuracy runs' configurations,
held to the JAX package on the CPU.

(a) Renderer: `bench_config.fixture_scenario(rich=True)` against
    scripts/make_fixture_sequence.py's at 1242x375 on frames 0, 19, 24, 26,
    48 and 93 (object 4 above the floor, below it, occluded, re-emerging,
    re-entering, gone). The scene's trajectory is a chain of f32 se3_exp /
    compose products, and se3_exp is ill-conditioned at the fixture's 0.002
    rad yaw ((1 - cos) / theta^2 loses ~1.5% to one ulp of cos), so the
    two chains part by ~7e-6 per frame (6.8e-4 at frame 93, measured):
    camera poses within 1e-5 per frame, depth where the masks agree within
    5e-5 relative (2.7e-5 read), flow where the previous frame's masks agree
    within 5e-3 px (2.5e-3 read), RGB within 1e-6. Masks equal but at pixels
    whose ray grazes an edge within that drift: at most 4 per frame (2
    read, frame 93), each on a boundary between the two labels. The files
    both writers produce for 3 frames: the same tree, masks and RGB equal,
    uint16 disparity within one level where it differs at all (at most
    0.1% of the pixels), .flo within 2e-3 px, the numbers of the text
    files (poses, boxes, times) within the trajectory's drift, 1e-5 per
    frame (1.5e-5 read in object_pose.txt).
(b) Floor: both pipelines over the rich preset's first 30 frames at
    414x125 (the JAX render fed to both), hybrid incremental at
    RICH_MIN_AREA, the port taking the reference's RANSAC draws: the
    objects the floor withholds equal in every frame (object 4 from frame
    18, as its mask shrinks behind the lead car) and the resample flags
    equal; mature camera poses within 5e-4 and matured motions within 1e-3,
    test_torch_reanchor.py's bounds.
(d) Configurations: the port's rich-matrix, sweep and detector-accuracy
    configurations equal to the ones scripts/accuracy_rich.py,
    scripts/accuracy_report.py and scripts/accuracy_detector.py build,
    field for field (captured at the reference's DynoPipeline).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from dynosam_tpu.config import DynoConfig
from dynosam_tpu.pipeline.pipeline import DynoPipeline as JaxPipeline
from dynosam_tpu_torch.bench_config import (
    KITTI_BASELINE_M,
    RICH_MIN_AREA,
    SWEEP_WINDOWS,
    detector_accuracy_config,
    fixture_scenario,
    fixture_world_offset,
    kitti_accuracy_config,
)
from dynosam_tpu_torch.frontend.types import FrameInputs
from dynosam_tpu_torch.pipeline.pipeline import DynoPipeline
from torch_port_util import inject_draws, reference_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import make_fixture_sequence  # noqa: E402

torch.set_num_threads(1)
RICH_FRAMES = (0, 19, 24, 26, 48, 93)
POSE_PER_FRAME = 1e-5
DEPTH_RTOL = 5e-5
FLOW_ATOL = 5e-3
MASK_EDGE_PIXELS = 4
FLOOR_FRAMES = 30
FLOOR_HW = (125, 414)
POSE_TOL = 5e-4
MOTION_TOL = 1e-3


@pytest.fixture(scope="module")
def scenes():
    return (fixture_scenario(100, 1242, 375, rich=True, device="cpu"),
            make_fixture_sequence.fixture_scenario(100, 1242, 375, rich=True))


def _boundary(mask, v, u, labels):
    """Whether the 3x3 neighbourhood of (v, u) in `mask` holds every label
    of `labels`."""
    near = mask[max(v - 1, 0):v + 2, max(u - 1, 0):u + 2]
    return all((near == lab).any() for lab in labels)


@pytest.mark.parametrize("k", RICH_FRAMES)
def test_renderer_matches_reference(scenes, k):
    port, ref = scenes
    np.testing.assert_allclose(port.scn.X_gt[k].numpy(), np.asarray(ref.scn.X_gt[k]),
                               atol=POSE_PER_FRAME * k + 1e-6, rtol=0)
    a, b = port.frame(k), ref.frame(k)
    ma, mb = a.mask.numpy(), np.asarray(b.mask)
    differ = np.argwhere(ma != mb)
    assert len(differ) <= MASK_EDGE_PIXELS, differ
    for v, u in differ:
        assert _boundary(ma, v, u, (ma[v, u], mb[v, u])) and _boundary(mb, v, u, (ma[v, u], mb[v, u])), (v, u)
    same = ma == mb
    np.testing.assert_allclose(a.depth.numpy()[same], np.asarray(b.depth)[same], rtol=DEPTH_RTOL, atol=0)
    np.testing.assert_allclose(a.rgb.numpy(), np.asarray(b.rgb), atol=1e-6, rtol=0)
    if k > 0:
        prev = port.frame(k - 1).mask.numpy() == np.asarray(ref.frame(k - 1).mask)
        np.testing.assert_allclose(a.flow.numpy()[prev], np.asarray(b.flow)[prev], atol=FLOW_ATOL, rtol=0)
    # the scene this frame exists for: object 4 visible, occluded or gone
    visible = {o: int((mb == o).sum()) for o in (1, 2, 3, 4)}
    assert (visible[4] == 0) == (k in (24, 93)), visible


def _numbers(path):
    with open(path) as f:
        return [float(x) for x in f.read().replace(":", " ").split() if _is_number(x)]


def _is_number(x):
    try:
        float(x)
        return True
    except ValueError:
        return False


def test_writer_files_match_reference(tmp_path):
    import cv2

    from dynosam_tpu.dataproviders.kitti_writer import write_kitti_sequence as jax_write
    from dynosam_tpu.utils import lie as jlie
    from dynosam_tpu_torch.dataproviders.kitti_writer import write_kitti_sequence

    n = 3
    port = fixture_scenario(n, 1242, 375, rich=True, device="cpu")
    ref = make_fixture_sequence.fixture_scenario(n, 1242, 375, rich=True)
    a_dir, b_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    offset = np.asarray(jlie.se3_exp(np.array([0.0, 0.3, 0.0, 5.0, -1.0, 2.0], np.float32)), np.float64)
    np.testing.assert_array_equal(fixture_world_offset(), offset)
    jax_write(ref, a_dir, base_line=float(ref.intr.fx * KITTI_BASELINE_M), depth_scale_factor=256.0,
              world_offset=offset)
    write_kitti_sequence(port, b_dir, base_line=float(port.intr.fx * KITTI_BASELINE_M), depth_scale_factor=256.0,
                         world_offset=fixture_world_offset())

    def tree(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)

    names = tree(a_dir)
    assert tree(b_dir) == names and len(names) > 4 * n
    for rel in names:
        a_path, b_path = os.path.join(a_dir, rel), os.path.join(b_dir, rel)
        if rel.endswith(".png"):
            a, b = cv2.imread(a_path, cv2.IMREAD_UNCHANGED), cv2.imread(b_path, cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and a.shape == b.shape, rel
            if rel.startswith("depth"):
                d = np.abs(a.astype(np.int64) - b.astype(np.int64))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (rel, d.max(), (d > 0).mean())
            else:
                np.testing.assert_array_equal(b, a, err_msg=rel)
        elif rel.endswith(".flo"):
            a = np.fromfile(a_path, np.float32)[3:]
            b = np.fromfile(b_path, np.float32)[3:]
            np.testing.assert_allclose(b, a, atol=2e-3, rtol=0, err_msg=rel)
        elif rel.startswith("motion"):
            np.testing.assert_array_equal(np.loadtxt(b_path), np.loadtxt(a_path), err_msg=rel)
        else:
            np.testing.assert_allclose(_numbers(b_path), _numbers(a_path), atol=POSE_PER_FRAME * n, rtol=0,
                                       err_msg=rel)


# ---------------------------------------------------------------------------
# (b) the observability floor

def _withheld(mask_hw, obj_ids, det_area):
    """The ids the floor withholds (the reference's frontend.py:420-425)."""
    floor = RICH_MIN_AREA * float(mask_hw[0] * mask_hw[1])
    ids = np.asarray(obj_ids)
    return sorted(int(o) for o in ids[(ids > 0) & (np.asarray(det_area) < floor)])


@pytest.fixture(scope="module")
def floor_runs():
    h, w = FLOOR_HW
    scene = make_fixture_sequence.fixture_scenario(FLOOR_FRAMES, w, h, rich=True)
    tcfg = kitti_accuracy_config("incremental", FLOOR_FRAMES, min_observable_mask_area=RICH_MIN_AREA)
    cfg = DynoConfig.from_dict(dataclasses.asdict(tcfg))
    jp = JaxPipeline(cfg, scene.intr)
    from dynosam_tpu_torch.cv import camera as tcam

    ji = scene.intr
    intr = tcam.CameraIntrinsics.create(fx=float(ji.fx), fy=float(ji.fy), cx=float(ji.cx), cy=float(ji.cy),
                                        width=int(ji.width), height=int(ji.height), baseline=float(ji.baseline))
    tp = DynoPipeline(tcfg, intr, device="cpu")
    draws = reference_draws(jp.frontend_state.key, cfg.frontend, FLOOR_FRAMES)
    rows = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        queue = inject_draws(mp, draws)
        for k in range(FLOOR_FRAMES):
            fr = scene.frame(k)
            jp.process_frame(fr)
            tr = jp.frontend_state.tracker
            rows["jax"].append((_withheld(fr.mask.shape, tr.obj_ids, tr.obj_det_area),
                                np.asarray(jp.last_packet.object_resampled)))
            tf = FrameInputs(**{f.name: torch.from_numpy(np.array(getattr(fr, f.name)))
                                for f in dataclasses.fields(fr) if getattr(fr, f.name) is not None})
            tp.process_frame(tf)
            tr = tp.frontend_state.tracker
            rows["port"].append((_withheld(tf.mask.shape, tr.obj_ids.numpy(), tr.obj_det_area.numpy()),
                                 tp.last_packet.object_resampled.numpy().copy()))
        assert not queue
    jp.finish()
    tp.finish()
    return jp, tp, rows


def test_floor_withholds_what_reference_withholds(floor_runs):
    _, _, rows = floor_runs
    for k, ((jw, jr), (tw, tr)) in enumerate(zip(rows["jax"], rows["port"])):
        assert tw == jw, (k, tw, jw)
        np.testing.assert_array_equal(tr, jr, err_msg=f"frame {k}")
    held = {k: w for k, (w, _) in enumerate(rows["jax"]) if w}
    assert held and min(held) == 18 and all(w == [4] for w in held.values()), held


def test_floor_run_matches_reference(floor_runs):
    jp, tp, _ = floor_runs
    np.testing.assert_allclose(np.stack(tp.trajectory), np.stack(jp.trajectory), atol=POSE_TOL, rtol=0)
    jm, tm = jp.backend.matured_motion, tp.backend.matured_motion
    assert sorted(tm) == sorted(jm) and jm
    err = max(float(np.abs(tm[key] - np.asarray(jm[key])).max()) for key in jm)
    assert err <= MOTION_TOL, err


# ---------------------------------------------------------------------------
# (d) the configurations of the scripts

class _Captured(Exception):
    pass


def _capture(monkeypatch):
    """Make the reference's DynoPipeline record its configuration and stop."""
    import dynosam_tpu.pipeline.pipeline as jpipeline

    seen = []

    def fake(cfg, *a, **kw):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(jpipeline, "DynoPipeline", fake)
    return seen


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("form", [0, 1, 3])
def test_rich_matrix_config_is_the_scripts(monkeypatch, mode, form):
    import accuracy_report

    from dynosam_tpu.dataproviders.kitti import KittiDataProvider

    seen = _capture(monkeypatch)
    with pytest.raises(_Captured):
        accuracy_report.run_config_dataset(KittiDataProvider(os.path.join(ROOT, "tests", "fixtures",
                                                                          "kitti_fixture")),
                                           form, mode, 100, min_observable_mask_area=RICH_MIN_AREA)
    keys = {0: "full_batch", 1: "sliding_window", 2: "incremental"}
    assert _asdict(kitti_accuracy_config(keys[mode], 100, form, min_observable_mask_area=RICH_MIN_AREA)) == \
        _asdict(seen[0])


@pytest.mark.parametrize("window", SWEEP_WINDOWS)
def test_sweep_config_is_the_scripts(monkeypatch, tmp_path, window):
    import accuracy_rich

    seen = _capture(monkeypatch)
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", ["accuracy_rich.py", "--skip-matrix", "--out", str(tmp_path / "a.md"),
                                      "--sweep-windows", str(window)])
    with pytest.raises(_Captured):
        accuracy_rich.main()
    assert _asdict(kitti_accuracy_config("sliding_window", 60, window=window)) == _asdict(seen[0])


@pytest.mark.parametrize("detected", [False, True])
def test_detector_accuracy_config_is_the_scripts(monkeypatch, detected):
    import accuracy_detector

    from dynosam_tpu.dataproviders.kitti import KittiDataProvider

    seen = _capture(monkeypatch)
    with pytest.raises(_Captured):
        accuracy_detector.run_cell(KittiDataProvider(os.path.join(ROOT, "tests", "fixtures", "kitti_fixture")), 1,
                                   object() if detected else None)
    assert _asdict(detector_accuracy_config(detected)) == _asdict(seen[0])
