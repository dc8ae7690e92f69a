"""Parity of the port's hybrid backend with the JAX reference, on packets
from the JAX frontend over the dense test scene: graph ingestion, the
reduced normal equations, the error and the decoupled two-phase LM — on a
partly filled window and on a state taken after a reference window advance
(marginal prior active)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import graph as jgraph
from dynosam_tpu.backend import hybrid as jhybrid
from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.backend import window as jwindow
from dynosam_tpu.backend.backend import RegularBackend as JRegularBackend
from dynosam_tpu.config import OptimizerParams
from dynosam_tpu.dataproviders.simulator import Scenario as JScenario
from dynosam_tpu.dataproviders.simulator import ScenarioSpec as JScenarioSpec
from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario
from dynosam_tpu.frontend.frontend import empty_frontend_state, frontend_step
from dynosam_tpu_torch.backend import graph as tgraph
from dynosam_tpu_torch.backend import hybrid as thybrid
from dynosam_tpu_torch.backend import solver as tsolver
from dynosam_tpu_torch.backend.backend import RegularBackend
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.cv import camera as tcam
from dynosam_tpu_torch.frontend.types import VisionPacket
from torch_port_util import assert_tree_matches, fused_step_readings, np_tree, packet_backend_cfg, port_cfg, port_intr, small_cfg, to_port

torch.set_num_threads(1)
NUM_FRAMES = 5        # 4 fill the window, the 5th follows a reference advance


def _backend_cfg(cfg):
    """The backend settings the fused step uses in incremental mode."""
    b = cfg.backend
    return dataclasses.replace(
        b, optimizer=dataclasses.replace(b.optimizer, accept_reject=True, max_iterations=2)
    )


@pytest.fixture(scope="module")
def run():
    """Reference run: per frame, the graph before and after ingestion and the
    packet; the window advances before the 5th packet."""
    cfg = small_cfg(max_frames=4).normalized()
    bcfg = _backend_cfg(cfg)
    dense = default_dense_scenario(num_frames=NUM_FRAMES)
    jintr = dense.intr
    fe = jax.jit(lambda s, f: frontend_step(s, f, jintr, cfg.frontend))
    upd = jax.jit(lambda g, p: jgraph.update_from_packet_hybrid(g, p, jintr, bcfg))
    opt = jax.jit(lambda g: jhybrid.optimize(g, bcfg))
    adv = jax.jit(lambda g: jwindow.advance_hybrid(g, bcfg))
    fs, g = empty_frontend_state(cfg.frontend), jgraph.empty_graph(bcfg)
    records = []
    for k in range(NUM_FRAMES):
        fs, packet = fe(fs, dense.frame(k))
        if k == 4:
            g = adv(g)
        g_in = g
        g = upd(g, packet)
        records.append((g_in, packet, g))
        g = opt(g)
    tintr = tcam.CameraIntrinsics.create(
        float(jintr.fx), float(jintr.fy), float(jintr.cx), float(jintr.cy),
        width=jintr.width, height=jintr.height, baseline=jintr.baseline,
    )
    return bcfg, tintr, records


def _graph(jg):
    return to_port(GraphState, jg)


@pytest.mark.parametrize("k", range(NUM_FRAMES))
def test_update_from_packet_hybrid(run, k):
    bcfg, intr, records = run
    g_in, packet, g_out = records[k]
    got = tgraph.update_from_packet_hybrid(_graph(g_in), to_port(VisionPacket, packet), intr, port_cfg(bcfg))
    ref = np_tree(g_out)
    if k == NUM_FRAMES - 1:
        assert bool(ref["prior_valid"])
    assert_tree_matches(ref, dataclass_to_numpy(got), atol=1e-5, rtol=1e-6)


# frame 3: window partly optimised, all slots but none slid; frame 4: after
# an advance, so the marginal prior terms are live
STATES = [3, 4]


@pytest.mark.parametrize("dynamic_scale", [0.0, 1.0])
@pytest.mark.parametrize("k", STATES)
def test_linearize(run, k, dynamic_scale):
    bcfg, _, records = run
    jg = records[k][2]
    lam = 1e-3
    ref = jhybrid.linearize(jg, bcfg, jnp.asarray(lam, jnp.float32), dynamic_scale=dynamic_scale)
    got = thybrid.linearize(_graph(jg), port_cfg(bcfg), torch.tensor(lam), dynamic_scale=dynamic_scale)
    for name in ("S", "rhs"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("dynamic_scale", [0.0, 1.0])
@pytest.mark.parametrize("k", STATES)
def test_total_error(run, k, dynamic_scale):
    bcfg, _, records = run
    jg = records[k][2]
    ref = float(jhybrid.total_error(jg, bcfg, dynamic_scale=dynamic_scale))
    got = float(thybrid.total_error(_graph(jg), port_cfg(bcfg), dynamic_scale=dynamic_scale))
    assert got == pytest.approx(ref, rel=1e-4)


@pytest.mark.parametrize("k", STATES)
def test_optimize_decoupled(run, k):
    bcfg, _, records = run
    jg = records[k][2]
    ref = jhybrid.optimize_decoupled(jg, bcfg)
    got = thybrid.optimize_decoupled(_graph(jg), port_cfg(bcfg))
    # H loosened from 1e-4 to 5e-4: the object phase is ill-conditioned on
    # these few-frame states — the reference itself moves H[0, 3] by 8e-5
    # when its input poses are scaled by (1 + 1e-7), one f32 rounding
    atol = {"X": 1e-4, "H": 5e-4, "ms": 1e-4, "m_hyb": 1e-4}
    for name, tol in atol.items():
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=tol, err_msg=name
        )


def test_chol_solve_failure_is_nan_not_an_error():
    S = torch.tensor([[1.0, 0.0], [0.0, -1.0]])
    assert bool(torch.isnan(thybrid.chol_solve(S, torch.ones(2))).all())


def test_f2f_motion(run):
    _, _, records = run
    jg = records[3][2]
    for f in range(4):
        np.testing.assert_allclose(
            thybrid.f2f_motion(_graph(jg), f).numpy(), np.asarray(jhybrid.f2f_motion(jg, f)), atol=1e-5
        )


@pytest.mark.parametrize("gated", [False, True])
def test_step_gating_and_clipping(gated):
    F, J = 4, 3
    thr = dict(x_update_threshold_rot=1e-3, x_update_threshold_trans=1e-2,
               h_update_threshold_rot=1e-3, h_update_threshold_trans=1e-2) if gated else {}
    op = OptimizerParams(**thr)
    rng = np.random.default_rng(9)
    n = 6 * F + 6 * J * F
    dx = (rng.standard_normal(n) * rng.choice([1e-4, 1.0], n)).astype(np.float32)
    ref = jsolver.gate_dx_by_type(jnp.asarray(dx), F, op)
    got = tsolver.gate_dx_by_type(torch.from_numpy(dx), F, port_cfg(op))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(
        thybrid._clip_step(torch.from_numpy(dx), 0.2).numpy(),
        np.asarray(jhybrid._clip_step(jnp.asarray(dx), 0.2)), atol=1e-7,
    )


@pytest.mark.parametrize("ok", [False, True])
def test_damping_update(ok):
    op = OptimizerParams()
    ref = jsolver.damping_update(jnp.asarray(ok), jnp.asarray(1e-2, jnp.float32), op, 1e-4)
    got = tsolver.damping_update(torch.tensor(ok), torch.tensor(1e-2), port_cfg(op), 1e-4)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)


# ---------------------------------------------------------------------------
# The joint hybrid solve and the marginal covariances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accept_reject", [True, False])
@pytest.mark.parametrize("k", STATES)
def test_optimize_joint(run, k, accept_reject):
    """decoupled_object_solve=False: one solve of camera and motions, LM with
    accept/reject or the damped GN scan."""
    bcfg, _, records = run
    cfg = dataclasses.replace(bcfg, decoupled_object_solve=False,
                              optimizer=dataclasses.replace(bcfg.optimizer, accept_reject=accept_reject))
    jg = records[k][2]
    ref = jhybrid.optimize(jg, cfg)
    got = thybrid.optimize(_graph(jg), port_cfg(cfg))
    # the bounds of test_optimize_decoupled
    for name, tol in {"X": 1e-4, "H": 5e-4, "ms": 1e-4, "m_hyb": 1e-4}.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=tol,
                                   err_msg=name)


# read at most 1.1e-3 (cov_X) and 3.4e-3 (cov_H)
COV_REL = 1e-2


@pytest.mark.parametrize("k", STATES)
def test_marginal_covariances(run, k):
    bcfg, _, records = run
    jg = records[k][2]
    rX, rH = (np.asarray(a) for a in jhybrid.marginal_covariances(jg, bcfg))
    tX, tH = thybrid.marginal_covariances(_graph(jg), port_cfg(bcfg))
    # the gathers of the reference put the indexed axes first
    assert tuple(tX.shape) == rX.shape == (4, 6, 6) and tuple(tH.shape) == rH.shape == (4, 4, 6, 6)
    # one f32 inverse of a system whose entries span 1e-5 to 1e8, so the
    # bound is relative to each block's largest entry
    for r, g, name in ((rX, tX.numpy(), "cov_X"), (rH, tH.numpy(), "cov_H")):
        scale = np.abs(r).max(axis=(-1, -2), keepdims=True)
        rel = float((np.abs(g - r) / scale).max())
        print(f"{name} frame {k}: {rel:.2e} of the block's largest entry")
        assert rel <= COV_REL, (name, rel)


def test_marginal_covariances_singular_is_nan(run, monkeypatch):
    """A singular reduced system gives NaN blocks, as jnp.linalg.inv does,
    and no error (nor a host read of the inverse's status)."""
    bcfg, _, records = run
    tg = _graph(records[3][2])
    lin = thybrid.linearize(tg, port_cfg(bcfg), torch.tensor(0.0))
    monkeypatch.setattr(thybrid, "linearize", lambda *a, **kw: lin._replace(S=torch.zeros_like(lin.S)))
    cov_X, cov_H = thybrid.marginal_covariances(tg, port_cfg(bcfg))
    assert bool(torch.isnan(cov_X).all()) and bool(torch.isnan(cov_H).all())


# ---------------------------------------------------------------------------
# RegularBackend on the WCME and WCPE formulations
# ---------------------------------------------------------------------------

MODES = {"full_batch": 0, "sliding_window": 1, "incremental": 2}
BACKEND_FRAMES = 6
# largest |port - reference| over the run (m and matrix entries) of the
# camera poses, object motions and object poses. WCPE is ill-conditioned in
# f32 (the object-pose gauge, tests/test_torch_wcpe.py): the reference's own
# LM moves X 2.2e-3 and H 1.9e-2 when its inputs are scaled by (1 +- 1e-7);
# the port read X 1.3e-3, H 1.4e-2, L 4.0e-3 over the three modes. WCME
# read X 1.1e-4, H 1.2e-3 (sliding window) and L 1.7e-4.
BACKEND_TOL = {0: {"X": 1e-3, "H": 1e-2, "L": 2e-3}, 1: {"X": 5e-3, "H": 5e-2, "L": 2e-2}}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("enum", [0, 1])
def test_regular_backend(enum, mode):
    """RegularBackend over the simulator's noisy packets (made by the
    reference, handed to both), in each mode: the per-frame outputs, the
    mature poses and matured motions after finalize_matured, and motion_at."""
    m = MODES[mode]
    cfg = packet_backend_cfg(max_frames=BACKEND_FRAMES if m == 0 else 4, backend_updater_enum=enum,
                             optimization_mode=m)
    scn = JScenario(JScenarioSpec.default_two_objects(num_frames=BACKEND_FRAMES, pixel_noise=0.4,
                                                      depth_noise=0.02, seed=5))
    jb = JRegularBackend(cfg, scn.intr)
    tb = RegularBackend(port_cfg(cfg), port_intr(scn.intr), device="cpu")
    err = {"X": 0.0, "H": 0.0, "L": 0.0}
    for k in range(BACKEND_FRAMES):
        p = scn.measurements(k, cfg.max_objects)
        jo, to = jb.step(p), tb.step(to_port(VisionPacket, p))
        np.testing.assert_array_equal(to.object_ids, np.asarray(jo.object_ids))
        v = np.asarray(jo.object_motion_valid)
        np.testing.assert_array_equal(to.object_motion_valid, v)
        err["X"] = max(err["X"], np.abs(to.X_world_cam - np.asarray(jo.X_world_cam)).max())
        err["H"] = max(err["H"], np.abs(to.object_motions[v] - np.asarray(jo.object_motions)[v]).max(initial=0))
        err["L"] = max(err["L"], np.abs(to.object_poses - np.asarray(jo.object_poses)).max())
    if m == 0:
        jb.finish()
        tb.finish()
    jb.finalize_matured()
    tb.finalize_matured()
    for k in range(BACKEND_FRAMES):
        err["X"] = max(err["X"], np.abs(tb.pose_at(k) - np.asarray(jb.pose_at(k))).max())
    assert sorted(tb.matured_motion) == sorted(jb.matured_motion)
    assert len(jb.matured_motion) >= 2 * (BACKEND_FRAMES - 2)
    for key, H in jb.matured_motion.items():
        err["H"] = max(err["H"], np.abs(tb.matured_motion[key] - np.asarray(H)).max())
        got = tb.motion_at(*key)
        np.testing.assert_array_equal(got, tb.matured_motion[key])
    print(f"enum {enum} {mode}: {err}")
    for name, tol in BACKEND_TOL[enum].items():
        assert err[name] <= tol, (name, err[name], tol)


def test_fused_step_joint_hybrid():
    """The fused step with the joint hybrid solve (decoupled_object_solve
    off), 7 frames of the dense test scene at max_frames=4: three advances."""
    cfg = small_cfg(max_frames=4).with_overrides({"backend.decoupled_object_solve": False})
    pose_err, motion_err, n_motions, tg, jg = fused_step_readings(cfg, 7)
    print(f"joint hybrid fused step: poses {pose_err:.2e}, {n_motions} motions {motion_err:.2e}")
    assert n_motions > 0 and bool(tg.prior_valid)
    # the bounds of the decoupled fused step (test_torch_window.py)
    assert pose_err <= 1e-4 and motion_err <= 1e-3
