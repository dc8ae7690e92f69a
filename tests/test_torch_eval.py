"""The port's evaluation and host utilities against the JAX reference:
metrics, DatasetEvaluator reports on the same CSV logs, byte-identical CSV
logging, exact record packing, and the statistics registry."""

import os
import sys

import numpy as np
import pytest
import torch

from dynosam_tpu.eval import evaluator as jeval
from dynosam_tpu.eval import metrics as jmetrics
from dynosam_tpu.utils import logger as jlogger
from dynosam_tpu.utils import packing as jpacking
from dynosam_tpu.utils import stats as jstats
from dynosam_tpu_torch.eval import evaluator as teval
from dynosam_tpu_torch.eval import metrics as tmetrics
from dynosam_tpu_torch.utils import logger as tlogger
from dynosam_tpu_torch.utils import packing as tpacking
from dynosam_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)


def _random_poses(rng, n, scale=1.0):
    from scipy.spatial.transform import Rotation

    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=rng.integers(1 << 30)).as_matrix()
    T[:, :3, 3] = rng.normal(size=(n, 3)) * scale
    return T


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    est, gt = _random_poses(rng, 12, 2.0), _random_poses(rng, 12, 2.0)
    Lp, Lc = _random_poses(rng, 12), _random_poses(rng, 12)
    for name, args in {"ate": (est, gt), "rpe": (est, gt), "ame": (est, gt),
                       "rme": (est, Lp, Lc)}.items():
        a, b = getattr(jmetrics, name)(*args), getattr(tmetrics, name)(*args)
        for field in ("trans_rmse", "rot_rmse", "trans_errors", "rot_errors"):
            np.testing.assert_array_equal(getattr(b, field), getattr(a, field), err_msg=name)
    ua = tmetrics.ate(est, gt, align=False)
    assert ua.trans_rmse == jmetrics.ate(est, gt, align=False).trans_rmse
    np.testing.assert_array_equal(tmetrics.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3]),
                                  jmetrics.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3]))


def _write_logs(mod, path, module, rng, gt_every=1):
    """A small run's logs through logger module `mod` (JAX's or the port's):
    camera poses, two objects' motions and poses, bbx rows, map points,
    some rows without GT, and a reset + re-log of the motions."""
    log = mod.EstimationModuleLogger(module, path)
    X, Xg = _random_poses(rng, 8, 3.0), _random_poses(rng, 8, 3.0)
    for k in range(8):
        log.log_camera_pose(k, X[k].astype(np.float32), Xg[k] if k % gt_every == 0 else None)
    H, Hg = _random_poses(rng, 16, 0.3), _random_poses(rng, 16, 0.3)
    L, Lg = _random_poses(rng, 16, 5.0), _random_poses(rng, 16, 5.0)
    for i in range(16):
        k, oid = i // 2 + 1, 1 + i % 2
        log.log_object_motion(k, oid, H[i], Hg[i])
        log.log_object_pose(k, oid, L[i].astype(np.float32), Lg[i])
        log.log_object_bbx(k, oid, -np.abs(rng.normal(size=3)).astype(np.float32),
                           np.abs(rng.normal(size=3)).astype(np.float32), L[i])
    log.log_map_points(3, np.array([1, 2, 2]), np.array([4, 9, 11]),
                       rng.normal(size=(3, 3)).astype(np.float32))
    log.reset(("object_motion",))
    for i in range(16):
        log.log_object_motion(i // 2 + 1, 1 + i % 2, H[i].astype(np.float32), Hg[i])
    log.close()


def test_logger_writes_byte_identical_csvs(tmp_path):
    for mod, sub in ((jlogger, "jax"), (tlogger, "port")):
        _write_logs(mod, str(tmp_path / sub), "dynosam_tpu", np.random.default_rng(1))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


def _assert_reports_match(a, b, path=""):
    assert type(a) is type(b) or isinstance(a, (int, float)), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_reports_match(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_reports_match(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        # quaternions become rotations in float32 on both sides; the
        # reductions may round the last bit differently
        assert b == pytest.approx(a, rel=1e-5, abs=1e-7), path
    else:
        assert a == b, path


def test_evaluator_report_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    _write_logs(tlogger, str(tmp_path), "dynosam_tpu", rng)
    _write_logs(tlogger, str(tmp_path), "frontend", rng, gt_every=2)
    j, t = jeval.DatasetEvaluator(str(tmp_path)), teval.DatasetEvaluator(str(tmp_path))
    assert t.modules() == j.modules() == ["dynosam_tpu", "frontend"]
    ref, got = j.run_analysis(), t.run_analysis()
    assert "camera" in got["dynosam_tpu"] and "camera" not in got["frontend"]
    assert set(got["dynosam_tpu"]["objects"]) == {1, 2}
    assert "rme_trans_rmse" in got["dynosam_tpu"]["objects"][1]
    _assert_reports_match(ref, got)
    path = t.write_report()
    assert os.path.basename(path) == "evaluation_results.json" and os.path.getsize(path) > 0
    s = teval.summarize(got["dynosam_tpu"])
    assert s["ate_unaligned_m"] == got["dynosam_tpu"]["camera"]["ate_unaligned_trans_rmse"]
    assert s["n_motions"] == 16


def test_pose_loading_matches_reference(tmp_path):
    """Rotations within a few float32 ulps: both sides normalise the
    quaternion in float32, their reductions may round differently."""
    _write_logs(tlogger, str(tmp_path), "m", np.random.default_rng(3))
    cam = str(tmp_path / "m_camera_pose_log.csv")
    for a, b in zip(jeval.load_camera_pose_log(cam), teval.load_camera_pose_log(cam)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    obj = str(tmp_path / "m_object_pose_log.csv")
    ja, ta = jeval.load_object_log(obj), teval.load_object_log(obj)
    assert sorted(ja) == sorted(ta)
    for oid in ja:
        for a, b in zip(ja[oid], ta[oid]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_write_plots_without_matplotlib(tmp_path, monkeypatch):
    _write_logs(tlogger, str(tmp_path), "m", np.random.default_rng(4))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert teval.DatasetEvaluator(str(tmp_path)).write_plots() is None
    assert jeval.DatasetEvaluator(str(tmp_path)).write_plots() is None


def _record():
    g = torch.Generator().manual_seed(5)
    return {
        "X": torch.randn(4, 4, generator=g),
        "ids": torch.tensor([3, -1, 2**31 - 1, -(2**31)], dtype=torch.int32),
        "valid": torch.tensor([True, False, True]),
        "fid": torch.tensor(17, dtype=torch.int32),
        "small": torch.tensor([[200, 7]], dtype=torch.uint8),
        "short": torch.tensor([-300, 301], dtype=torch.int16),
        "scalar": torch.tensor(float("nan")),
    }


def test_packer_round_trips_exactly():
    rec = _record()
    pack, unpack, width = tpacking.build_packer(rec)
    # the reference's layout for the same shapes and dtypes
    import jax

    shapes = {k: jax.ShapeDtypeStruct(tuple(v.shape), v.numpy().dtype) for k, v in rec.items()}
    assert width == jpacking.build_packer(shapes)[2] == 4 * 4 + 4 + 3 + 1 + 2 + 2 + 1
    buf = torch.zeros((3, width))
    out = pack(rec, out=buf[1])
    assert out.data_ptr() == buf[1].data_ptr()            # written in place
    assert not bool(buf[0].any()) and not bool(buf[2].any())
    back = unpack(buf.numpy()[1])
    for k, v in rec.items():
        assert back[k].dtype == v.numpy().dtype and back[k].shape == tuple(v.shape), k
        assert back[k].tobytes() == v.numpy().tobytes(), k
    assert tpacking.to_host(rec)["fid"] == 17


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64, torch.float16, torch.bfloat16])
def test_packer_rejects_inexact_dtypes(dtype):
    with pytest.raises(TypeError):
        tpacking.build_packer({"x": torch.zeros(3, dtype=dtype)})


def test_statistics_match_reference(tmp_path):
    samples = {"pipeline.frontend": [3.5, 1.25, 8.0], "pipeline.backend": [2.0], "a.b": [1.0, 1.0]}
    outs = []
    for mod in (jstats, tstats):
        mod.Statistics.reset()
        for tag, vals in samples.items():
            for v in vals:
                mod.Statistics.add_sample(tag, v)
        path = tmp_path / f"{mod.__name__.split('.')[0]}.csv"
        mod.Statistics.write_all_samples_to_csv(str(path))
        outs.append((mod.Statistics.summary(), path.read_bytes()))
    assert outs[0] == outs[1]
    tstats.Statistics.reset()
    with tstats.timed("t.ctx", block_on=torch.zeros(2)):
        pass
    tstats.Timer("t.timer").start().stop(block_on=torch.zeros(1))
    assert tstats.Statistics.tags() == ["t.ctx", "t.timer"]
    assert all(tstats.Statistics.get(t).count == 1 for t in tstats.Statistics.tags())
    tstats.Statistics.reset()
