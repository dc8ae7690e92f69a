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
from dynosam_tpu.config import OptimizerParams
from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario
from dynosam_tpu.frontend.frontend import empty_frontend_state, frontend_step
from dynosam_tpu_torch.backend import graph as tgraph
from dynosam_tpu_torch.backend import hybrid as thybrid
from dynosam_tpu_torch.backend import solver as tsolver
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.cv import camera as tcam
from dynosam_tpu_torch.frontend.types import VisionPacket
from torch_port_util import assert_tree_matches, np_tree, small_cfg, to_port

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
    got = tgraph.update_from_packet_hybrid(_graph(g_in), to_port(VisionPacket, packet), intr, bcfg)
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
    got = thybrid.linearize(_graph(jg), bcfg, torch.tensor(lam), dynamic_scale=dynamic_scale)
    for name in ("S", "rhs"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("dynamic_scale", [0.0, 1.0])
@pytest.mark.parametrize("k", STATES)
def test_total_error(run, k, dynamic_scale):
    bcfg, _, records = run
    jg = records[k][2]
    ref = float(jhybrid.total_error(jg, bcfg, dynamic_scale=dynamic_scale))
    got = float(thybrid.total_error(_graph(jg), bcfg, dynamic_scale=dynamic_scale))
    assert got == pytest.approx(ref, rel=1e-4)


@pytest.mark.parametrize("k", STATES)
def test_optimize_decoupled(run, k):
    bcfg, _, records = run
    jg = records[k][2]
    ref = jhybrid.optimize_decoupled(jg, bcfg)
    got = thybrid.optimize_decoupled(_graph(jg), bcfg)
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
    got = tsolver.gate_dx_by_type(torch.from_numpy(dx), F, op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(
        thybrid._clip_step(torch.from_numpy(dx), 0.2).numpy(),
        np.asarray(jhybrid._clip_step(jnp.asarray(dx), 0.2)), atol=1e-7,
    )


@pytest.mark.parametrize("ok", [False, True])
def test_damping_update(ok):
    op = OptimizerParams()
    ref = jsolver.damping_update(jnp.asarray(ok), jnp.asarray(1e-2, jnp.float32), op, 1e-4)
    got = tsolver.damping_update(torch.tensor(ok), torch.tensor(1e-2), op, 1e-4)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
