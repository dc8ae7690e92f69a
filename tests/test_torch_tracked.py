"""The tracked scene (bench_config.tracked_scene: the bench scene with the
camera raised to TRACKED_GROUND_Y and stepping TRACKED_FORWARD_M, where the
JAX reference keeps the camera) on both sides, at the bench camera scaled
to 320x96 with few slots and a 3-frame window.

Where the KLT path parts from JAX's: nowhere, on identical inputs. The two
renderers draw the scene's world texture from f32 sin / cos of metre
coordinates and differ in the last bits (RGB by ~1e-5); the KLT path
carries those bits in its LK positions and, at a near-tie, takes a branch
by them. JAX does too: on the same frames and draws JAX and the port agree
until the third window advance (frame 5 here), where the frontend's camera
takes one of two branches ~5e-3 apart, and one f32 ulp on every RGB value
of JAX's input moves JAX to the port's branch. At full width
(scripts/probe_torch_klt_parting.py) JAX on the port's render parts from
JAX on its own by 3.99e-2 m over 20 frames, as far as the port does, so
the smoke's tracked references run JAX on the port's render.

Both sides take the reference's RANSAC draws (injected). Measured on these
frames (largest over the frames, pose matrix elements): KLT against the
nearer of the two JAX runs (JAX's input as rendered, and one ulp up)
frontend poses 8.4e-5, poses 5.4e-4, object motions (translation) 6.8e-4,
valid flags equal; the tie frame's frontend pose 5.1e-3 from JAX on the
same input; stereo + IMU against JAX poses 1.9e-4, motions 5.7e-4, flags
equal. The bounds are ~5x those."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu_torch import bench_config as tbench
from dynosam_tpu_torch.parallel import batched as tbatched
from torch_port_util import inject_draws, jax_dense, np_tree, port_cfg, reference_draws, small_cfg

torch.set_num_threads(1)
HW = (96, 320)
WINDOW = 3
FRAMES = 6                   # the window fills, then advances three times
TIE_FRAME = 5
FIELDS = ("rgb", "depth", "flow", "mask", "right", "imu_samples", "imu_valid")
KLT_FE_POSE = 5e-4           # frontend pose elements, against the nearer JAX run
KLT_POSE = 2.5e-3            # pose elements, against the nearer JAX run
KLT_MOTION = 3.5e-3          # object motion translations, m
TIE_APART = 1e-3             # the tie frame's frontend pose, the port from JAX on the same input
SI_POSE = 1e-3
SI_MOTION = 3e-3
TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "dynosam_tpu_torch", "testdata")
TRACKED_FILES = {"tracked_klt_ref_20f.npz": 20, "tracked_stereo_imu_ref_12f.npz": 12,
                 "tracked_batched_stereo_imu_ref_b8_14f.npz": 14}


def _scene(n):
    h, w = HW
    _, intr = tbench.bench_config()
    s = w / intr.width
    intr = dataclasses.replace(intr, fx=intr.fx * s, fy=intr.fy * s, cx=w / 2, cy=h / 2, width=w, height=h)
    return tbench.tracked_scene(intr, n, device="cpu")


def test_tracked_scene_is_the_bench_scene_raised():
    """Objects, texture, far wall and intrinsics as the bench scene's; only
    the camera's height and forward step differ."""
    _, intr = tbench.bench_config()
    tr = tbench.tracked_scene(intr, 3, device="cpu")
    bs = tbench.bench_scene(intr, 3, device="cpu", world_texture=True)
    assert (tr.ground_y, tr.scn.spec.camera_motion_xi[5]) == (tbench.TRACKED_GROUND_Y, tbench.TRACKED_FORWARD_M)
    assert (bs.ground_y, bs.scn.spec.camera_motion_xi[5]) == (tbench.BENCH_GROUND_Y, tbench.BENCH_FORWARD_M)
    assert tr.world_texture and (tr.far_depth, tr.obj_extents, tr.intr) == (bs.far_depth, bs.obj_extents, bs.intr)
    np.testing.assert_array_equal(tr.scn.spec.camera_motion_xi[:5], bs.scn.spec.camera_motion_xi[:5])
    for a, b in zip(tr.scn.spec.objects, bs.scn.spec.objects):
        np.testing.assert_array_equal(a.initial_pose_xi, b.initial_pose_xi)
        np.testing.assert_array_equal(a.motion_xi, b.motion_xi)


def test_renderer_matches_reference_at_tracked_ground_y():
    """RGB (where the masks agree), depth, flow and masks of the port's
    render against the JAX package's, frames 0 and 1."""
    td = _scene(2)
    jd = jax_dense(td)
    assert jd.ground_y == tbench.TRACKED_GROUND_Y
    for k in range(2):
        jf, tf = jd.frame(k), td.frame(k)
        same = tf.mask.numpy() == np.asarray(jf.mask)
        assert (~same).mean() <= 1e-3                  # silhouette-edge pixels only
        np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth), rtol=1e-5)
        np.testing.assert_allclose(tf.flow.numpy()[same], np.asarray(jf.flow)[same], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tf.rgb.numpy()[same], np.asarray(jf.rgb)[same], atol=1e-4)
        assert np.unique(tf.rgb.numpy()).size > 100


def _runs(monkeypatch, stereo_imu, ulp_run):
    """JAX on the port's render, (with `ulp_run`) JAX on it with every RGB
    value one ulp up, and the port, all with JAX's draws -> {run: per-frame
    outputs and static / dynamic valid flags}."""
    td = _scene(FRAMES)
    jd = jax_dense(td)
    over = {"frontend.tracker.prefer_provided_optical_flow": False}
    if stereo_imu:
        over.update({"frontend.use_imu": True, "frontend.imu.use_rotation_prior": True})
    cfg = small_cfg(max_frames=WINDOW).with_overrides(over)
    tcfg = port_cfg(cfg)
    pframes = [tbench.stereo_imu_frame(td, k, 32) if stereo_imu else td.frame(k) for k in range(FRAMES)]

    def as_jax(k, rgb=None):
        kw = {f: jnp.asarray(v.numpy()) for f, v in pframes[k].tensors().items() if f in FIELDS}
        if rgb is not None:
            kw["rgb"] = jnp.asarray(rgb)
        return jd.frame(k).replace(**kw)

    inputs = {"jax": [as_jax(k) for k in range(FRAMES)]}
    if ulp_run:
        inputs["jax_ulp"] = [as_jax(k, np.nextafter(pframes[k].rgb.numpy(), np.float32(np.inf)))
                             for k in range(FRAMES)]
    js0 = jbatched.init_pipeline_state(cfg, image_shape=HW)
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr))

    def record(out, flags):
        return {"X": np.asarray(out["X_world_cam"]), "fe": np.asarray(out["frontend_pose"]),
                "H": np.asarray(out["object_motions"]), "H_ok": np.asarray(out["object_motion_valid"]),
                "flags": flags}

    runs = {}
    for name, frames in inputs.items():
        js, runs[name] = js0, []
        for fr in frames:
            js, out = jstep(js, fr)
            trk = np_tree(js)["frontend"]["tracker"]
            runs[name].append(record(out, (trk["s_valid"], trk["d_valid"])))
    inject_draws(monkeypatch, reference_draws(js0.frontend.key, cfg.frontend, FRAMES))
    tstep = tbatched.make_fused_step(tcfg, td.intr)
    ts = tbatched.init_pipeline_state(tcfg, "cpu", image_shape=HW)
    runs["port"] = []
    for fr in pframes:
        ts, out = tstep(ts, fr)
        trk = ts.frontend.tracker
        runs["port"].append(record({k: v.numpy() for k, v in out.items()},
                                   (trk.s_valid.numpy(), trk.d_valid.numpy())))
    assert ts.graph.num_frames == WINDOW and bool(ts.graph.prior_valid)
    return runs


@pytest.fixture(scope="module")
def klt_runs():
    with pytest.MonkeyPatch.context() as mp:
        return _runs(mp, stereo_imu=False, ulp_run=True)


def _err(a, b):
    return float(np.abs(a.astype(np.float64) - b).max())


def test_klt_fused_step_on_tracked_scene_matches_reference(klt_runs):
    """In every frame through three advances the port's poses, object
    motions and valid flags follow the nearer of JAX's two runs (its input,
    and that input one ulp up): the runs JAX itself gives under the last
    bits of its frames."""
    n_motions = 0
    for k, got in enumerate(klt_runs["port"]):
        ref = min((klt_runs[r][k] for r in ("jax", "jax_ulp")), key=lambda r: _err(got["fe"], r["fe"]))
        assert _err(got["fe"], ref["fe"]) <= KLT_FE_POSE, k
        assert _err(got["X"], ref["X"]) <= KLT_POSE, k
        np.testing.assert_array_equal(got["H_ok"], ref["H_ok"])
        v = ref["H_ok"]
        np.testing.assert_allclose(got["H"][v][:, :3, 3], ref["H"][v][:, :3, 3], rtol=0, atol=KLT_MOTION)
        n_motions += int(v.sum())
        for a, b in zip(got["flags"], ref["flags"]):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    assert n_motions > 0


def test_klt_parting_is_a_near_tie_jax_takes_under_one_ulp(klt_runs):
    """On identical inputs the port equals JAX through frame TIE_FRAME - 1;
    at TIE_FRAME the frontend's camera parts from JAX's by more than
    TIE_APART, and one ulp on every RGB value of JAX's input takes JAX to
    the port's branch."""
    port, jx, ulp = klt_runs["port"], klt_runs["jax"], klt_runs["jax_ulp"]
    for k in range(TIE_FRAME):
        assert _err(port[k]["fe"], jx[k]["fe"]) <= KLT_FE_POSE, k
    assert _err(port[TIE_FRAME]["fe"], jx[TIE_FRAME]["fe"]) > TIE_APART
    assert _err(ulp[TIE_FRAME]["fe"], jx[TIE_FRAME]["fe"]) > TIE_APART
    assert _err(port[TIE_FRAME]["fe"], ulp[TIE_FRAME]["fe"]) <= KLT_FE_POSE


def test_stereo_imu_fused_step_on_tracked_scene_matches_reference(monkeypatch):
    """Stereo + IMU (rotation prior) on the tracked scene's right images,
    1.15x depth and IMU windows: poses, motions and valid flags follow JAX
    on the same frames in every frame through three advances."""
    runs = _runs(monkeypatch, stereo_imu=True, ulp_run=False)
    n_motions = 0
    for k, (got, ref) in enumerate(zip(runs["port"], runs["jax"])):
        assert _err(got["X"], ref["X"]) <= SI_POSE, k
        np.testing.assert_array_equal(got["H_ok"], ref["H_ok"])
        v = ref["H_ok"]
        np.testing.assert_allclose(got["H"][v][:, :3, 3], ref["H"][v][:, :3, 3], rtol=0, atol=SI_MOTION)
        n_motions += int(v.sum())
        for a, b in zip(got["flags"], ref["flags"]):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    assert n_motions > 0


@pytest.mark.parametrize("name", sorted(TRACKED_FILES))
def test_tracked_reference_files_hold_the_smokes_scene(name):
    """Each tracked-scene reference was run on the scene chip_smoke.py
    renders: its ground_y and forward_m are the constants, its frames the
    smoke's, and the reference's own ground-truth errors are recorded."""
    z = np.load(os.path.join(TESTDATA, name))
    assert float(z["ground_y"]) == tbench.TRACKED_GROUND_Y
    assert float(z["forward_m"]) == tbench.TRACKED_FORWARD_M
    n = TRACKED_FILES[name]
    assert z["X_world_cam"].shape[0] == z["gt_trans"].shape[0] == z["gt_rot"].shape[0] == n
    assert np.isfinite(z["X_world_cam"]).all() and np.isfinite(z["gt_trans"]).all()
