"""Parity of the port's world-centric motion (WCME) backend with the JAX
reference on the simulator's two-object scene (noisy packets, made by the
reference and handed to both): graph ingestion, the robust error, the
reduced normal equations, the update with its chain back-substitution, both
optimizer branches (accept/reject LM and the damped GN scan), and the window
advance (the departing information and the rolled state with its marginal
prior), on a partly filled window and on states past two advances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import graph as jgraph
from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.backend import window as jwindow
from dynosam_tpu.dataproviders.simulator import Scenario, ScenarioSpec
from dynosam_tpu_torch.backend import graph as tgraph
from dynosam_tpu_torch.backend import solver as tsolver
from dynosam_tpu_torch.backend import window as twindow
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.frontend.types import VisionPacket
from torch_port_util import (
    assert_tree_matches,
    check_advanced,
    fused_step_readings,
    np_tree,
    packet_backend_cfg,
    port_cfg,
    port_intr,
    reference_window_run,
    small_cfg,
    to_port,
)

torch.set_num_threads(1)
F = 5
NUM_FRAMES = 7        # 5 fill the window, the 6th and 7th follow advances
# frame 3: a partly filled window, no marginal prior; frame 6: two advances
# in, the marginal prior live
STATES = [3, 6]
LAM = 1e-3
FUSED_POSE_TOL, FUSED_MOTION_TOL = 1e-4, 1e-3   # the hybrid fused step's (test_torch_window.py)


@pytest.fixture(scope="module")
def run():
    cfg = packet_backend_cfg(max_frames=F, backend_updater_enum=0, optimization_mode=1)
    scn = Scenario(ScenarioSpec.default_two_objects(num_frames=NUM_FRAMES, pixel_noise=0.4,
                                                    depth_noise=0.02, seed=5))
    packets = [scn.measurements(k, cfg.max_objects) for k in range(NUM_FRAMES)]
    records, windows = reference_window_run(cfg, packets, scn.intr, jgraph.update_from_packet,
                                            jsolver.optimize, jwindow.advance)
    return cfg, port_intr(scn.intr), records, windows


@pytest.fixture(scope="module")
def ref(run):
    """The reference's functions, jitted once for the module."""
    cfg = run[0]
    return dict(
        linearize=jax.jit(lambda g, lam: jsolver.linearize(g, cfg, lam)),
        total_error=jax.jit(lambda g: jsolver.total_error(g, cfg)),
        departing=jax.jit(lambda g: jwindow._departing_information(g, cfg)),
        advance=jax.jit(lambda g: jwindow.advance(g, cfg)),
    )


def _graph(jg):
    return to_port(GraphState, jg)


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


@pytest.mark.parametrize("k", range(NUM_FRAMES))
def test_update_from_packet(run, k):
    cfg, intr, records, _ = run
    g_in, packet, g_out = records[k]
    got = tgraph.update_from_packet(_graph(g_in), to_port(VisionPacket, packet), intr, port_cfg(cfg))
    assert_tree_matches(np_tree(g_out), dataclass_to_numpy(got), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("k", STATES)
def test_total_error(run, ref, k):
    cfg, _, records, _ = run
    jg = records[k][2]
    r = float(ref["total_error"](jg))
    got = float(tsolver.total_error(_graph(jg), port_cfg(cfg)))
    # f32 sums of ~2e3 terms in another order
    assert got == pytest.approx(r, rel=1e-4)


@pytest.mark.parametrize("k", STATES)
def test_linearize(run, ref, k):
    cfg, _, records, _ = run
    jg = records[k][2]
    jlin = ref["linearize"](jg, jnp.asarray(LAM, jnp.float32))
    got = tsolver.linearize(_graph(jg), port_cfg(cfg), torch.tensor(LAM))
    # Schur terms of ~1e6 weights subtract in f32 (solver.py:480-486), so
    # the bound is relative to the largest entry: rhs read 1.7e-5 of it
    for name in ("S", "rhs"):
        r, g = np.asarray(getattr(jlin, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)
    # g_d adds ternary weights up to 1e6 (sigma 1 mm) times residuals whose
    # f32 rounding is ~2e-6 m at 20 m, through Huber weights that move with
    # them: read 3.8 against entries ~1.3e3 (the jitted reference; 1.9e-2
    # against the eager one), so relative to the largest; Bx_blk and Bh_*
    # carry the Huber weights (read 19 of 1.9e5, 2.7e3 of 1.9e7)
    for name, rel in {"Dp_inv": 1e-5, "Wm": 1e-5, "g_d": 5e-3, "Bx_blk": 5e-4, "Bh_curr": 5e-4,
                      "Bh_prev": 5e-4}.items():
        r, g = np.asarray(getattr(jlin, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=rel * _scale(r), err_msg=name)


@pytest.mark.parametrize("k", STATES)
def test_apply_update(run, ref, k):
    """The same step on both sides, each with its own linearisation: the
    retractions and both landmark back-substitutions."""
    cfg, _, records, _ = run
    jg = records[k][2]
    jlin = ref["linearize"](jg, jnp.asarray(LAM, jnp.float32))
    dx = np.asarray(jnp.linalg.solve(jlin.S, jlin.rhs))
    r = jsolver._apply_update(jg, jlin, jnp.asarray(dx))
    tg = _graph(jg)
    got = tsolver._apply_update(tg, tsolver.linearize(tg, port_cfg(cfg), torch.tensor(LAM)),
                                torch.from_numpy(dx))
    for name in ("X", "H", "ms", "md"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(r, name)),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("accept_reject", [True, False])
@pytest.mark.parametrize("k", STATES)
def test_optimize(run, k, accept_reject):
    cfg, _, records, _ = run
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, accept_reject=accept_reject))
    jg = records[k][2]
    ref = jsolver.optimize(jg, cfg)
    got = tsolver.optimize(_graph(jg), port_cfg(cfg))
    # three iterations from noisy ingestion amplify f32 rounding: the
    # reference itself moves X 1.2e-5, H 8.1e-5, ms 4.7e-4 and md 2.0e-4 (m
    # and entries) when its input poses are scaled by (1 + 1e-7); the port
    # read H 2.2e-4 against it. Bounds ~4x the larger reading.
    for name, tol in {"X": 1e-4, "H": 1e-3, "ms": 2e-3, "md": 1e-3}.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=tol, err_msg=name)
    assert float(tsolver.total_error(got, port_cfg(cfg))) <= float(tsolver.total_error(_graph(jg), port_cfg(cfg)))


@pytest.mark.parametrize("i", range(NUM_FRAMES - F))
def test_departing_information(run, ref, i):
    cfg, _, _, windows = run
    jg = windows[i]
    Mr, gr = (np.asarray(a) for a in ref["departing"](jg))
    M, g = twindow._departing_information(_graph(jg), port_cfg(cfg))
    # g sums per-tracklet terms that cancel: the reference's own moves 1.8
    # and 2.2 (of entries ~5e3) under (1 +- 1e-7) input scales; the port read
    # 0.34 and 0.29
    np.testing.assert_allclose(M.numpy(), Mr, rtol=1e-4, atol=1e-5 * _scale(Mr))
    np.testing.assert_allclose(g.numpy(), gr, rtol=1e-4, atol=3e-4 * _scale(gr))


@pytest.mark.parametrize("i", range(NUM_FRAMES - F))
def test_advance(run, ref, i):
    cfg, _, _, windows = run
    jg = windows[i]
    r = ref["advance"](jg)
    got = twindow.advance(_graph(jg), port_cfg(cfg))
    assert got.num_frames == F - 1 and bool(got.prior_valid)
    # prior_b solves against the factor's rows: the reference's own moves
    # 1.6e-3 (of entries ~1.3) under a (1 + 1e-7) input scale, the port read
    # 8.6e-3; the prior's information and gradient agree to ~1e-5
    check_advanced(r, got, prior_b=2e-2)


def test_fused_step_past_the_window():
    """The fused step with backend_updater_enum=0 (WCME), 7 frames of
    the dense test scene at max_frames=4: three advances."""
    cfg = small_cfg(max_frames=4).with_overrides({"backend.backend_updater_enum": 0})
    pose_err, motion_err, n_motions, tg, jg = fused_step_readings(cfg, 7)
    print(f"WCME fused step: poses {pose_err:.2e}, {n_motions} motions {motion_err:.2e}")
    assert n_motions > 0 and bool(tg.prior_valid)
    assert pose_err <= FUSED_POSE_TOL and motion_err <= FUSED_MOTION_TOL
    ref = np_tree(jg)
    for name in ("frame_ids", "obj_ids", "H_valid", "d_obj", "d_valid"):
        np.testing.assert_array_equal(dataclass_to_numpy(tg)[name], ref[name], err_msg=name)
