"""The port's slice as a whole against the JAX reference: the fused step over
a filled 4-frame window of the noise-free dense scene, the renderer, the
bench configuration and scene, state conversion, and that the port imports
no JAX."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench
from dynosam_tpu.cv import camera as jcam
from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu_torch import bench_config as tbench
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from dynosam_tpu_torch.parallel import batched as tbatched
from dynosam_tpu_torch.utils import lie as tlie
from torch_port_util import assert_tree_matches, np_tree, small_cfg

torch.set_num_threads(1)
NUM_FRAMES = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fused_runs():
    cfg = small_cfg(max_frames=NUM_FRAMES)
    jd, td = j_dense(num_frames=NUM_FRAMES + 1), t_dense(num_frames=NUM_FRAMES + 1)
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr))
    js = jbatched.init_pipeline_state(cfg)
    tstep = tbatched.make_fused_step(cfg, td.intr, torch.Generator().manual_seed(0))
    ts = tbatched.init_pipeline_state(cfg, "cpu")
    jouts, touts = [], []
    for k in range(NUM_FRAMES):
        js, jo = jstep(js, jd.frame(k))
        ts, to = tstep(ts, td.frame(k))
        jouts.append({n: np.asarray(v) for n, v in jo.items()})
        touts.append({n: v.numpy() for n, v in to.items()})
    return cfg, jouts, touts, (tstep, ts, td), js


def _rot_trans(A, B):
    dR = torch.from_numpy(np.swapaxes(A[..., :3, :3], -1, -2) @ B[..., :3, :3])
    rot = torch.linalg.norm(tlie.so3_log(dR), dim=-1).numpy()
    return rot, np.linalg.norm(A[..., :3, 3] - B[..., :3, 3], axis=-1)


@pytest.mark.parametrize("key", ["X_world_cam", "frontend_pose"])
def test_fused_step_camera_poses(fused_runs, key):
    _, jouts, touts, _, _ = fused_runs
    ref = np.stack([o[key] for o in jouts])
    got = np.stack([o[key] for o in touts])
    rot, trans = _rot_trans(got, ref)
    assert trans.max() < 1e-4 and rot.max() < 1e-4, (trans, rot)


def test_fused_step_object_motions(fused_runs):
    _, jouts, touts, _, _ = fused_runs
    n_valid = 0
    for jo, to in zip(jouts, touts):
        np.testing.assert_array_equal(to["object_ids"], jo["object_ids"])
        np.testing.assert_array_equal(to["object_motion_valid"], jo["object_motion_valid"])
        v = jo["object_motion_valid"]
        n_valid += int(v.sum())
        np.testing.assert_allclose(to["object_motions"][v], jo["object_motions"][v], atol=1e-3)
    assert n_valid > 0


def test_fused_step_state_after_window(fused_runs):
    _, _, _, (_, ts, _), js = fused_runs
    ref = np_tree(js)
    got = convert.pipeline_state_to_numpy(ts)
    # integer/bool tables exact; estimates within 1e-3 (the object phase
    # amplifies f32 rounding, see test_torch_backend.test_optimize_decoupled)
    assert_tree_matches(ref, got, atol=1e-3)


def test_fused_step_raises_when_the_window_would_advance(fused_runs):
    _, _, _, (tstep, ts, td), _ = fused_runs
    with pytest.raises(NotImplementedError, match="window advance"):
        tstep(ts, td.frame(NUM_FRAMES))


def test_unported_backend_and_frontend_options_raise():
    cfg = small_cfg()
    intr = t_dense(num_frames=1).intr
    wcme = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, backend_updater_enum=0))
    with pytest.raises(NotImplementedError):
        tbatched.make_fused_step(wcme, intr)
    klt = cfg.with_overrides({"frontend.tracker.prefer_provided_optical_flow": False})
    with pytest.raises(NotImplementedError):
        tbatched.init_pipeline_state(klt, "cpu")
    with pytest.raises(NotImplementedError):
        tbatched.init_pipeline_state(cfg, "cpu", image_shape=(120, 160))


def test_convert_round_trip():
    cfg = small_cfg()
    js = jbatched.init_pipeline_state(cfg)
    d = np_tree(js)
    back = convert.pipeline_state_to_numpy(convert.pipeline_state_from_numpy(d, "cpu"))
    assert_tree_matches(d, back, atol=0.0)


def _render_both(jdense, tdense, frames):
    for k in frames:
        jf, tf = jdense.frame(k), tdense.frame(k)
        np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth), rtol=1e-5)
        # flow = projected uv - pixel uv, both up to W: its f32 rounding is
        # ~1e-5 px absolute even where the flow itself is near zero
        np.testing.assert_allclose(tf.flow.numpy(), np.asarray(jf.flow), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tf.rgb.numpy(), np.asarray(jf.rgb), atol=1e-6)
        diff = tf.mask.numpy() != np.asarray(jf.mask)
        assert diff.mean() <= 1e-3, diff.mean()   # silhouette-edge pixels only
        assert int(tf.frame_id) == int(jf.frame_id)


def test_renderer_matches_reference():
    _render_both(j_dense(num_frames=4), t_dense(num_frames=4), range(4))


def test_bench_scene_matches_bench_make_frames():
    # the bench scene at a reduced image size (the geometry is the same)
    h, w, s = 96, 320, 0.25
    jintr = jcam.CameraIntrinsics.create(720.0 * s, 720.0 * s, w / 2, h / 2, width=w, height=h, baseline=0.537)
    _, tintr = tbench.bench_config()
    tintr = dataclasses.replace(tintr, fx=720.0 * s, fy=720.0 * s, cx=w / 2, cy=h / 2, width=w, height=h)
    jframes = bench.make_frames(jintr, num_frames=3)
    tdense = tbench.bench_scene(tintr, num_frames=3)

    class _Frames:
        def frame(self, k):
            return jframes[k]

    _render_both(_Frames(), tdense, range(3))


def test_bench_config_matches_bench():
    jcfg, jintr = bench.bench_config()
    tcfg, tintr = tbench.bench_config()
    assert tcfg == jcfg
    for f in ("fx", "fy", "cx", "cy"):
        assert getattr(tintr, f) == float(getattr(jintr, f))
    assert (tintr.width, tintr.height, tintr.baseline) == (jintr.width, jintr.height, jintr.baseline)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, dynosam_tpu_torch\n"
        "for m in pkgutil.walk_packages(dynosam_tpu_torch.__path__, 'dynosam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
