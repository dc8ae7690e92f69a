"""The port's IMU preintegration (frontend/imu.py) and the simulator's IMU
source (Scenario.imu_window / camera_velocity) against the JAX reference.

The port batches the S rotation increments exp((w - bg) dt) before its loop
where the reference takes one per scan step; the arithmetic per sample is
the same. Measured on these inputs: rotations and velocities agree to
~1e-7, positions to ~1e-7 m; held to 1e-6. The simulator's windows agree
to an ulp (specific forces of ~13 m/s^2 to 1.9e-6); held to 1e-6 + 1e-6
relative.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dynosam_tpu.dataproviders.simulator import Scenario as JScenario
from dynosam_tpu.frontend import imu as jimu
from dynosam_tpu_torch.dataproviders.simulator import ObjectSpec, Scenario, ScenarioSpec
from dynosam_tpu_torch.frontend import imu as timu
from dynosam_tpu_torch.utils import lie as tlie
from torch_port_util import jax_spec, t

torch.set_num_threads(1)
TOL = 1e-6


def _samples(seed=0, S=32, n_valid=27):
    rng = np.random.default_rng(seed)
    s = np.zeros((S, 7), np.float32)
    s[:, 0] = rng.uniform(0.002, 0.005, S)
    s[:, 1:4] = rng.normal(0, 2.0, (S, 3)) + np.array([0.0, 9.81, 0.0])
    s[:, 4:7] = rng.normal(0, 0.5, (S, 3))
    valid = np.arange(S) < n_valid
    return s, valid


def _params(j=False):
    kw = dict(gravity=(0.0, 9.81, 0.0), accel_bias=(0.05, -0.02, 0.01), gyro_bias=(0.003, 0.001, -0.002))
    if j:
        return jimu.ImuParams.create(gravity=kw["gravity"], accel_bias=jnp.asarray(kw["accel_bias"]),
                                     gyro_bias=jnp.asarray(kw["gyro_bias"]))
    return timu.ImuParams.create(**kw, device="cpu")


def test_preintegrate_matches_reference():
    s, valid = _samples()
    ref = jimu.preintegrate(jnp.asarray(s), jnp.asarray(valid), _params(j=True))
    got = timu.preintegrate(t(s), t(valid), _params())
    for name in ("dR", "dv", "dp", "dt"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=TOL,
                                   rtol=0, err_msg=name)
    # invalid rows count with dt = 0
    assert abs(float(got.dt) - s[valid, 0].sum()) < 1e-7
    np.testing.assert_array_equal(timu.rotation_prior(got).numpy(), got.dR.numpy())


def test_predict_matches_reference():
    s, valid = _samples(1)
    X_prev = tlie.se3_exp(torch.tensor([0.02, -0.1, 0.05, 0.4, -0.2, 3.0]))
    v_prev = np.array([0.3, -0.1, 7.5], np.float32)
    jp, tp = _params(j=True), _params()
    jpim = jimu.preintegrate(jnp.asarray(s), jnp.asarray(valid), jp)
    tpim = timu.preintegrate(t(s), t(valid), tp)
    X_ref, v_ref = jimu.predict(jnp.asarray(X_prev.numpy()), jnp.asarray(v_prev), jpim, jp)
    X_got, v_got = timu.predict(X_prev, t(v_prev), tpim, tp)
    np.testing.assert_allclose(X_got.numpy(), np.asarray(X_ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_ref), atol=TOL, rtol=0)


def test_imu_buffer_matches_reference():
    jb, tb = jimu.ImuBuffer(window_capacity=8), timu.ImuBuffer(window_capacity=8)
    rng = np.random.default_rng(2)
    for i in range(30):
        a, g = rng.normal(size=3), rng.normal(size=3)
        jb.add(0.01 * i, a, g)
        tb.add(0.01 * i, a, g)
    for t0, t1 in ((0.0, 0.05), (0.043, 0.2), (0.5, 0.6)):
        (rs, rm), (gs, gm) = jb.window(t0, t1), tb.window(t0, t1)
        np.testing.assert_array_equal(gs, rs)
        np.testing.assert_array_equal(gm, rm)
    assert tb.window(0.0, 0.05)[1].sum() == 5 and tb.window(0.043, 0.2)[1].sum() == 8


def _scenarios():
    spec = ScenarioSpec(
        num_frames=6, frame_dt=0.05,
        camera_motion_xi=np.array([[0.01, 0.02 * k, -0.01, 0.1, 0.0, 0.4 + 0.05 * k] for k in range(5)]),
        objects=[ObjectSpec(1, np.array([0.0, 0.0, 0.0, 1.0, 0.0, 10.0]), np.array([0.0, 0.01, 0.0, 0.2, 0.0, 0.0]))],
    )
    return JScenario(jax_spec(spec)), Scenario(spec, device="cpu")


def test_scenario_imu_window_and_velocity_match_reference():
    jsc, tsc = _scenarios()
    for k in range(6):
        rs, rm = jsc.imu_window(k, 16)
        gs, gm = tsc.imu_window(k, 16)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tsc.camera_velocity(k).numpy(), np.asarray(jsc.camera_velocity(k)),
                                   atol=TOL, rtol=0)
    assert not tsc.imu_window(0, 16)[1].any() and tsc.imu_window(3, 16)[1].all()


def test_exact_imu_window_predicts_the_next_pose():
    """The exact measurements of a constant-twist interval, preintegrated and
    propagated from the true pose and velocity, land on the next true pose
    (the midpoint samples leave ~1e-4 m over 0.05 s)."""
    _, tsc = _scenarios()
    params = timu.ImuParams.create(gravity=(0.0, 9.81, 0.0), device="cpu")
    for k in range(1, 6):
        s, v = tsc.imu_window(k, 32)
        pim = timu.preintegrate(s, v, params)
        X_pred, _ = timu.predict(tsc.X_gt[k - 1], tsc.camera_velocity(k - 1), pim, params)
        assert float(torch.linalg.norm(X_pred[:3, 3] - tsc.X_gt[k][:3, 3])) < 1e-3
        np.testing.assert_allclose(X_pred[:3, :3].numpy(), tsc.X_gt[k][:3, :3].numpy(), atol=1e-5)
