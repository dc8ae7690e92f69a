"""The port of bench.py (dynosam_tpu_torch/bench.py) against the reference:
its 8 bench frames against bench.py::make_frames, its configuration against
bench.py::bench_config, the quick configuration, camera and frame of
`--small` against __graft_entry__.py's, the image-shaped fused step that
bench_table's fused-synth rows run (mask propagation live) against JAX's,
and the command: one JSON line through the supervising parent, and the
parent's retries."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import bench
from dynosam_tpu_torch import bench as tb
from dynosam_tpu_torch import bench_config as tbc
from torch_port_util import fused_step_readings, small_cfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_frames_match_make_frames():
    """All 8 frames at 384x1280, as the benchmark steps through them."""
    jcfg, jintr = bench.bench_config()
    cfg, intr, frames = tb.bench_setup("cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jframes = bench.make_frames(jintr)
    assert len(frames) == len(jframes) == bench.DISTINCT_FRAMES == tbc.DISTINCT_FRAMES
    # flow = projected uv - pixel uv, both up to the width: its f32 rounding
    # is a few ulps of 1280 (1.22e-4 each; 2 ulps read) even where the flow
    # is small, so the 160-wide renderer test's 1e-4 px becomes 3 ulps here
    flow_atol = 3 * float(np.spacing(np.float32(bench.WIDTH)))
    for k, (jf, tf) in enumerate(zip(jframes, frames)):
        assert tuple(tf.rgb.shape) == (bench.HEIGHT, bench.WIDTH, 3)
        # the renderer's bounds (test_torch_slice.py::_render_both): depth
        # within f32 rounding, the constant texture exact, masks apart only
        # on silhouette edges
        np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth), rtol=1e-5, err_msg=f"depth {k}")
        np.testing.assert_allclose(tf.flow.numpy(), np.asarray(jf.flow), rtol=1e-5, atol=flow_atol,
                                   err_msg=f"flow {k}")
        np.testing.assert_allclose(tf.rgb.numpy(), np.asarray(jf.rgb), atol=1e-6, err_msg=f"rgb {k}")
        diff = tf.mask.numpy() != np.asarray(jf.mask)
        assert diff.mean() <= 1e-3, (k, diff.mean())
        assert int(tf.frame_id) == int(jf.frame_id) == k


def _fields_equal(got, ref, path=""):
    """Field for field, with the path of the first that differs."""
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        p = f"{path}.{f.name}" if path else f.name
        if dataclasses.is_dataclass(b):
            _fields_equal(a, b, p)
        else:
            assert a == b, (p, a, b)


def test_bench_config_matches_bench_field_for_field():
    jcfg, jintr = bench.bench_config()
    cfg, intr = tbc.bench_config()
    _fields_equal(cfg, jcfg)
    for f in ("fx", "fy", "cx", "cy"):
        assert getattr(intr, f) == float(getattr(jintr, f))
    assert (intr.width, intr.height, intr.baseline) == (jintr.width, jintr.height, jintr.baseline)


@pytest.mark.parametrize("size", [(128, 96), (160, 120)])
def test_small_copies_match_the_graft(size):
    w, h = size
    _fields_equal(tbc.small_config(), ge._small_config())
    intr, jintr = tbc.small_intr(w, h), ge._intr(w, h)
    for f in ("fx", "fy", "cx", "cy", "baseline"):
        assert getattr(intr, f) == float(getattr(jintr, f)), f
    assert (intr.width, intr.height) == (jintr.width, jintr.height)
    for batch in (None, 3):
        got = tbc.small_frame_inputs(w, h, batch, device="cpu")
        ref = ge._frame_inputs(w, h, batch)
        for name in ("frame_id", "rgb", "depth", "flow", "mask"):
            r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
            assert g.dtype == r.dtype, name
            np.testing.assert_array_equal(g, r, err_msg=name)    # the same draws, bit for bit


def test_image_shaped_fused_step_matches_reference():
    """bench_table's fused-synth state: built with the image shape, so the
    frontend propagates the previous mask; 6 frames of the dense test scene
    at max_frames=4 (two advances). Bounds of test_torch_slice.py's
    fused-step tests (ids and validity equal inside the readings)."""
    pose_err, motion_err, n_motions, tg, _ = fused_step_readings(small_cfg(4), 6, image_shape=True)
    print(f"image-shaped fused step: poses {pose_err:.2e}, {n_motions} motions {motion_err:.2e}")
    assert n_motions > 0 and bool(tg.prior_valid)
    assert pose_err <= 1e-4 and motion_err <= 1e-3


def test_command_prints_one_json_line():
    """python -m dynosam_tpu_torch.bench --device cpu --small --measure 2:
    the parent runs the worker and prints its one JSON line, nothing else."""
    out = subprocess.run([sys.executable, "-m", "dynosam_tpu_torch.bench", "--device", "cpu", "--small",
                          "--measure", "2"], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit"} and rec["unit"] == "frames/s"
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert "K1 launches=0" in out.stderr and "first-frame=" in out.stderr


LINE = '{"metric": "e2e_fps_kitti_scale_synth", "value": 2.5, "unit": "frames/s"}'


def _fake_runs(monkeypatch, results):
    """subprocess.run returning `results` (rc, stdout, stderr) in turn; the
    commands and the sleeps recorded."""
    calls, sleeps = [], []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        rc, out, err = results[len(calls) - 1]
        return subprocess.CompletedProcess(cmd, rc, stdout=out, stderr=err)

    monkeypatch.setattr(tb.subprocess, "run", run)
    monkeypatch.setattr(tb.time, "sleep", sleeps.append)
    return calls, sleeps


def test_supervise_retries_a_failed_worker(monkeypatch, capsys):
    calls, sleeps = _fake_runs(monkeypatch, [
        (1, "", "RuntimeError: CUDA error: an illegal memory access was encountered\n"),
        (0, "[bench] noise\n" + LINE + "\n", "[bench] device=cpu\n"),
    ])
    rc = tb.supervise(["--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 0
    assert out.out.splitlines() == [LINE]
    assert "attempt 1/3 failed (rc=1, json=no); retrying in 20s" in out.err
    assert "illegal memory access" in out.err and "[bench] device=cpu" in out.err
    assert sleeps == [tb.RETRY_DELAY_S]
    assert [c[0][1:] for c in calls] == [["-m", "dynosam_tpu_torch.bench", "--worker", "--device", "cpu"]] * 2
    assert calls[0][1]["cwd"] == ROOT


def test_supervise_gives_up_after_three_failures(monkeypatch, capsys):
    _, sleeps = _fake_runs(monkeypatch, [
        (1, "", "first\n"),
        (0, "no json here\n", "second\n"),          # exit 0 without a JSON line is a failure too
        (137, "", "third\n"),
    ])
    rc = tb.supervise([])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    for k, (code, err) in enumerate(((1, "first"), (0, "second"), (137, "third")), 1):
        assert f"attempt {k}/3 failed (rc={code}, json=no)" in out.err and err in out.err
    assert sleeps == [tb.RETRY_DELAY_S] * 2
