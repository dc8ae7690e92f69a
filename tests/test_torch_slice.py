"""The port's slice as a whole against the JAX reference: the fused step over
a filled 4-frame window of the noise-free dense scene, in provided-flow and
in KLT mode; frontend_step in KLT mode (CLAHE on and off), with in-loop
stereo and with the IMU and its rotation prior; the renderer, the bench
configurations and scenes, state conversion, and that the port imports no
JAX.

The KLT-mode runs take the reference's own RANSAC draws (injected), so the
only differences are f32 rounding: measured on these frames, poses within
1e-6, passing tracks' positions within 2e-4 px, stereo depths within 1.3e-3
m of ~10-40 m, object motions within 5e-5; the valid flags equal."""

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
from dynosam_tpu.frontend import frontend as jfrontend
from dynosam_tpu_torch.frontend import frontend as tfrontend
from torch_port_util import (
    assert_tree_matches,
    inject_draws,
    jax_dense,
    np_tree,
    port_cfg,
    reference_draws,
    small_cfg,
    t,
)

torch.set_num_threads(1)
NUM_FRAMES = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fused_runs():
    cfg = small_cfg(max_frames=NUM_FRAMES)
    jd, td = j_dense(num_frames=NUM_FRAMES + 1), t_dense(num_frames=NUM_FRAMES + 1, device="cpu")
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr))
    js = jbatched.init_pipeline_state(cfg)
    tcfg = port_cfg(cfg)
    tstep = tbatched.make_fused_step(tcfg, td.intr, torch.Generator().manual_seed(0))
    ts = tbatched.init_pipeline_state(tcfg, "cpu")
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


def test_fused_step_advances_the_full_window(fused_runs):
    """The frame after a full window advances it: the step runs, keeps the
    window at its size and turns the marginal prior on
    (tests/test_torch_window.py holds the advance to the reference)."""
    _, _, _, (tstep, ts, td), _ = fused_runs
    assert ts.graph.num_frames == NUM_FRAMES and not bool(ts.graph.prior_valid)
    ts, out = tstep(ts, td.frame(NUM_FRAMES))
    assert ts.graph.num_frames == NUM_FRAMES and bool(ts.graph.prior_valid)
    assert int(ts.graph.frame_ids[-1]) == NUM_FRAMES
    assert bool(torch.isfinite(out["X_world_cam"]).all())


def test_unported_backend_and_frontend_options_raise():
    """Every formulation builds the fused step now (WCME, WCPE and the joint
    hybrid, held to the reference in test_torch_wcme.py, test_torch_wcpe.py
    and test_torch_backend.py); an unknown backend_updater_enum raises, and
    a missing dataset directory raises as the file system does (every
    dataset type is ported, test_torch_datasets.py). KLT, the IMU and
    mask propagation build (KLT needs the image shape, as in the
    reference)."""
    from dynosam_tpu_torch.dataproviders.base import create_dataset

    cfg = port_cfg(small_cfg())
    intr = t_dense(num_frames=1, device="cpu").intr
    for enum in (0, 1, 2, 3):
        tbatched.make_fused_step(cfg.with_overrides({"backend.backend_updater_enum": enum}), intr)
    tbatched.make_fused_step(cfg.with_overrides({"backend.decoupled_object_solve": False}), intr)
    with pytest.raises(ValueError, match="backend_updater_enum"):
        tbatched.make_fused_step(cfg.with_overrides({"backend.backend_updater_enum": 4}), intr)
    with pytest.raises(FileNotFoundError):
        create_dataset(1, "unused", device="cpu")
    klt = cfg.with_overrides({"frontend.tracker.prefer_provided_optical_flow": False})
    with pytest.raises(ValueError, match="image_shape"):
        tbatched.init_pipeline_state(klt, "cpu")
    st = tbatched.init_pipeline_state(klt, "cpu", image_shape=(120, 160))
    assert tuple(st.frontend.prev_gray.shape) == (120, 160)
    imu = cfg.with_overrides({"frontend.use_imu": True})
    st = tbatched.init_pipeline_state(imu, "cpu", image_shape=(120, 160))
    assert tuple(st.frontend.prev_gray.shape) == (0, 0) and tuple(st.frontend.v_world.shape) == (3,)
    # mask propagation: with an image shape the state carries the previous mask
    st = tbatched.init_pipeline_state(cfg, "cpu", image_shape=(120, 160))
    assert tuple(st.frontend.prev_mask.shape) == (120, 160)


FE_FRAMES = 4
FE_MODES = {
    "klt_clahe": {},
    "klt_no_clahe": {"frontend.tracker.use_clahe": False},
    "klt_stereo": {},
    "klt_imu_rotation_prior": {"frontend.use_imu": True, "frontend.imu.use_rotation_prior": True},
}


def _fe_frames(jd, mode):
    """The JAX scene's frames; stereo gets right images rendered at
    +baseline and 1.15x corrupted depth, the IMU mode 32-sample windows."""
    import jax.numpy as jnp

    T_lr = jnp.eye(4).at[0, 3].set(float(jd.intr.baseline))
    out = []
    for k in range(FE_FRAMES):
        fr = jd.frame(k)
        if mode == "klt_stereo":
            X_r, L_k = jd.scn.X_gt[k] @ T_lr, jd._L_all[:, k]
            depth_r, mask_r = jd._depth_mask(X_r, L_k)
            fr = fr.replace(depth=fr.depth * 1.15, right=jd._world_rgb(X_r, L_k, depth_r, mask_r))
        elif mode == "klt_imu_rotation_prior":
            imu, imu_valid = jd.scn.imu_window(k, 32)
            fr = fr.replace(imu_samples=imu, imu_valid=imu_valid)
        out.append(fr)
    return out


def _port_frame(td, k, jf):
    """The port's frame k holding the JAX frame's numbers."""
    names = ("rgb", "depth", "flow", "mask", "right", "imu_samples", "imu_valid")
    return dataclasses.replace(td.frame(k), **{n: None if getattr(jf, n) is None else t(getattr(jf, n))
                                               for n in names})


@pytest.mark.parametrize("mode", list(FE_MODES))
def test_frontend_step_klt_modes_match_reference(mode, monkeypatch):
    cfg = small_cfg().with_overrides({"frontend.tracker.prefer_provided_optical_flow": False,
                                      **FE_MODES[mode]})
    tcfg = port_cfg(cfg)
    jd = j_dense(num_frames=FE_FRAMES, world_texture=True)
    td = t_dense(num_frames=FE_FRAMES, world_texture=True, device="cpu")
    hw = (jd.intr.height, jd.intr.width)
    js = jfrontend.empty_frontend_state(cfg.frontend, image_shape=hw)
    ts = tfrontend.empty_frontend_state(tcfg.frontend, "cpu", image_shape=hw)
    inject_draws(monkeypatch, reference_draws(js.key, cfg.frontend, FE_FRAMES))
    jstep = jax.jit(lambda st, fr: jfrontend.frontend_step(st, fr, jd.intr, cfg.frontend))
    n_valid = 0
    for k, jf in enumerate(_fe_frames(jd, mode)):
        js, jp = jstep(js, jf)
        ts, tp = tfrontend.frontend_step(ts, _port_frame(td, k, jf), td.intr, tcfg.frontend)
        np.testing.assert_allclose(tp.X_world_cam.numpy(), np.asarray(jp.X_world_cam), atol=1e-5)
        for table in ("static_tracks", "dynamic_tracks"):
            r, g = getattr(jp, table), getattr(tp, table)
            v = np.asarray(r.valid)
            np.testing.assert_array_equal(g.valid.numpy(), v)
            np.testing.assert_array_equal(g.tracklet_id.numpy(), np.asarray(r.tracklet_id))
            np.testing.assert_allclose(g.uv.numpy()[v], np.asarray(r.uv)[v], atol=1e-3)
            np.testing.assert_allclose(g.depth.numpy()[v], np.asarray(r.depth)[v], rtol=1e-4, atol=2e-3)
            n_valid += int(v.sum())
        ov = np.asarray(jp.object_valid)
        np.testing.assert_array_equal(tp.object_valid.numpy(), ov)
        np.testing.assert_allclose(tp.object_motions.numpy()[ov], np.asarray(jp.object_motions)[ov], atol=1e-3)
        np.testing.assert_allclose(ts.prev_gray.numpy(), np.asarray(js.prev_gray), atol=1e-6)
        np.testing.assert_allclose(ts.v_world.numpy(), np.asarray(js.v_world), atol=1e-5)
    assert n_valid > 400
    if mode == "klt_stereo":
        # stereo took the static depths back from the 1.15x corruption
        true_depth, _ = td._depth_mask(td.scn.X_gt[FE_FRAMES - 1],
                                       [L[FE_FRAMES - 1] for L in td.scn.L_gt])
        s = tp.static_tracks
        uv = s.uv[s.valid].round().long()
        gt = true_depth[uv[:, 1].clamp(0, hw[0] - 1), uv[:, 0].clamp(0, hw[1] - 1)]
        near = gt < 15.0
        assert int(near.sum()) >= 5
        assert float(torch.median(torch.abs(s.depth[s.valid][near] - gt[near]) / gt[near])) < 0.05


def test_fused_step_klt_mode_matches_reference(monkeypatch):
    """Two frames past the window fill (the window advances twice)."""
    n = NUM_FRAMES + 2
    cfg = small_cfg(max_frames=NUM_FRAMES).with_overrides(
        {"frontend.tracker.prefer_provided_optical_flow": False})
    tcfg = port_cfg(cfg)
    jd = j_dense(num_frames=n, world_texture=True)
    td = t_dense(num_frames=n, world_texture=True, device="cpu")
    hw = (jd.intr.height, jd.intr.width)
    js = jbatched.init_pipeline_state(cfg, image_shape=hw)
    ts = tbatched.init_pipeline_state(tcfg, "cpu", image_shape=hw)
    inject_draws(monkeypatch, reference_draws(js.frontend.key, cfg.frontend, n))
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr))
    tstep = tbatched.make_fused_step(tcfg, td.intr)
    n_motions = 0
    for k in range(n):
        jf = jd.frame(k)
        js, jo = jstep(js, jf)
        ts, to = tstep(ts, _port_frame(td, k, jf))
        rot, trans = _rot_trans(to["X_world_cam"].numpy(), np.asarray(jo["X_world_cam"]))
        assert trans < 1e-4 and rot < 1e-4, (k, trans, rot)
        v = np.asarray(jo["object_motion_valid"])
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        np.testing.assert_allclose(to["object_motions"].numpy()[v], np.asarray(jo["object_motions"])[v], atol=1e-3)
        n_motions += int(v.sum())
    assert n_motions > 0 and ts.graph.num_frames == NUM_FRAMES and bool(ts.graph.prior_valid)
    ref, got = np_tree(js), convert.pipeline_state_to_numpy(ts)
    assert_tree_matches(ref["frontend"]["tracker"], {k: got["frontend"]["tracker"][k]
                                                    for k in ("s_valid", "s_tid", "d_valid", "d_tid", "obj_ids")},
                        atol=0.0)


# the bench scene, world-textured, at the smallest forward step tried for a
# scene the reference tracks (scripts/make_torch_smoke_reference.py
# TRACKED_STEPS), on the bench camera scaled to 320x96
CUT_STEP_M = 0.2
CUT_STEP_HW = (96, 320)
CUT_STEP_WINDOW = 3
CUT_STEP_FRAMES = 6
# port against JAX on identical frames and draws, largest over the frames:
# measured 7.3e-5 m (pose elements; the gap grows by ~2e-5 per advance),
# motions 4.4e-4; the bounds ~5x that
CUT_STEP_POSE = 5e-4
CUT_STEP_MOTION = 2e-3


def test_fused_step_klt_cut_step_scene_matches_reference(monkeypatch):
    """The KLT fused step on the bench scene's objects and texture with the
    camera's forward step cut to CUT_STEP_M, at 320x96 with few slots and a
    3-frame window: the window advances three times (frames 3-5), and in
    every frame the poses, motions and track flags follow JAX's."""
    h, w = CUT_STEP_HW
    _, intr = tbench.bench_config()
    s = w / intr.width
    intr = dataclasses.replace(intr, fx=intr.fx * s, fy=intr.fy * s, cx=w / 2, cy=h / 2, width=w, height=h)
    td = tbench.bench_scene(intr, CUT_STEP_FRAMES, device="cpu", world_texture=True, forward_m=CUT_STEP_M)
    jd = jax_dense(td)
    cfg = small_cfg(max_frames=CUT_STEP_WINDOW).with_overrides(
        {"frontend.tracker.prefer_provided_optical_flow": False})
    tcfg = port_cfg(cfg)
    js = jbatched.init_pipeline_state(cfg, image_shape=(h, w))
    ts = tbatched.init_pipeline_state(tcfg, "cpu", image_shape=(h, w))
    inject_draws(monkeypatch, reference_draws(js.frontend.key, cfg.frontend, CUT_STEP_FRAMES))
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr))
    tstep = tbatched.make_fused_step(tcfg, td.intr)
    n_motions = 0
    for k in range(CUT_STEP_FRAMES):
        jf = jd.frame(k)
        js, jo = jstep(js, jf)
        ts, to = tstep(ts, _port_frame(td, k, jf))
        np.testing.assert_allclose(to["X_world_cam"].numpy(), np.asarray(jo["X_world_cam"]), atol=CUT_STEP_POSE)
        v = np.asarray(jo["object_motion_valid"])
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        np.testing.assert_allclose(to["object_motions"].numpy()[v], np.asarray(jo["object_motions"])[v],
                                   atol=CUT_STEP_MOTION)
        n_motions += int(v.sum())
        trk = np_tree(js)["frontend"]["tracker"]
        for key in ("s_valid", "d_valid"):
            np.testing.assert_array_equal(getattr(ts.frontend.tracker, key).numpy(), trk[key], err_msg=f"{key} {k}")
    assert n_motions > 0 and ts.graph.num_frames == CUT_STEP_WINDOW and bool(ts.graph.prior_valid)


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
    _render_both(j_dense(num_frames=4), t_dense(num_frames=4, device="cpu"), range(4))


@pytest.mark.parametrize("scene", ["world_texture", "detector_scene"])
def test_textured_renderer_matches_reference(scene):
    """The world-anchored texture, and the detector scene's per-class object
    texture, half extents and classes, at a reduced image size."""
    h, w = 96, 160
    _, intr = tbench.detector_config()
    intr = dataclasses.replace(intr, fx=90.0, fy=90.0, cx=w / 2, cy=h / 2, width=w, height=h)
    if scene == "detector_scene":
        tdense = tbench.detector_scene(intr, num_frames=3, device="cpu")
    else:
        tdense = tbench.bench_scene(intr, num_frames=3, device="cpu")
        tdense.world_texture = True
    jdense = jax_dense(tdense)
    for k in range(3):
        jf, tf = jdense.frame(k), tdense.frame(k)
        same = tf.mask.numpy() == np.asarray(jf.mask)
        assert (~same).mean() <= 1e-3                  # silhouette-edge pixels only
        np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth), rtol=1e-5)
        # the texture is sin() of metre coordinates at up to 17 rad/m: f32
        # differences of ~1e-6 m in the surface points move it by ~1e-5
        np.testing.assert_allclose(tf.rgb.numpy()[same], np.asarray(jf.rgb)[same], atol=1e-4)
        assert np.unique(tf.rgb.numpy()).size > 100        # textured, not constant


def test_bench_scene_matches_bench_make_frames():
    # the bench scene at a reduced image size (the geometry is the same)
    h, w, s = 96, 320, 0.25
    jintr = jcam.CameraIntrinsics.create(720.0 * s, 720.0 * s, w / 2, h / 2, width=w, height=h, baseline=0.537)
    _, tintr = tbench.bench_config()
    tintr = dataclasses.replace(tintr, fx=720.0 * s, fy=720.0 * s, cx=w / 2, cy=h / 2, width=w, height=h)
    jframes = bench.make_frames(jintr, num_frames=3)
    tdense = tbench.bench_scene(tintr, num_frames=3, device="cpu")

    class _Frames:
        def frame(self, k):
            return jframes[k]

    _render_both(_Frames(), tdense, range(3))


def test_bench_config_matches_bench():
    jcfg, jintr = bench.bench_config()
    tcfg, tintr = tbench.bench_config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for f in ("fx", "fy", "cx", "cy"):
        assert getattr(tintr, f) == float(getattr(jintr, f))
    assert (tintr.width, tintr.height, tintr.baseline) == (jintr.width, jintr.height, jintr.baseline)


def test_detector_config_is_bench_config_with_detector_masks():
    bcfg, _ = bench.bench_config()
    cfg, intr = tbench.detector_config()
    assert not cfg.frontend.tracker.prefer_provided_object_detection
    ref = bcfg.with_overrides({"frontend.tracker.prefer_provided_object_detection": False})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    # the camera the committed checkpoint was trained at
    assert (intr.width, intr.height, intr.fx, intr.fy, intr.cx, intr.cy) == (640, 384, 360.0, 360.0, 320.0, 192.0)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, dynosam_tpu_torch\n"
        "for m in pkgutil.walk_packages(dynosam_tpu_torch.__path__, 'dynosam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dynosam_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
