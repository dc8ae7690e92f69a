"""Parity of the port's world-centric object-pose (WCPE) backend
(backend/wcpe.py, window.advance_wcpe) with the JAX reference on the
simulator's two-object scene (noisy packets, made by the reference and
handed to both): ingestion with the pose initialisation, the robust error,
the reduced normal equations, the update with its chain back-substitution,
both optimizer branches (accept/reject LM and the damped GN scan), the F2F
motions, and the window advance, on a partly filled window and on states
past two advances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import wcpe as jwcpe
from dynosam_tpu.backend import window as jwindow
from dynosam_tpu.dataproviders.simulator import Scenario, ScenarioSpec
from dynosam_tpu_torch.backend import wcpe as twcpe
from dynosam_tpu_torch.backend import window as twindow
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.frontend.types import VisionPacket
from torch_port_util import (
    assert_tree_matches,
    check_advanced,
    fused_step_readings,
    xla_cholesky,
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
    cfg = packet_backend_cfg(max_frames=F, backend_updater_enum=1, optimization_mode=1)
    scn = Scenario(ScenarioSpec.default_two_objects(num_frames=NUM_FRAMES, pixel_noise=0.4,
                                                    depth_noise=0.02, seed=5))
    packets = [scn.measurements(k, cfg.max_objects) for k in range(NUM_FRAMES)]
    records, windows = reference_window_run(cfg, packets, scn.intr, jwcpe.update_from_packet_wcpe,
                                            jwcpe.optimize, jwindow.advance_wcpe)
    return cfg, port_intr(scn.intr), records, windows


@pytest.fixture(scope="module")
def ref(run):
    """The reference's functions, jitted once for the module."""
    cfg = run[0]
    return dict(
        linearize=jax.jit(lambda g, lam: jwcpe.linearize(g, cfg, lam)),
        total_error=jax.jit(lambda g: jwcpe.total_error(g, cfg)),
        departing=jax.jit(lambda g: jwindow._departing_information_wcpe(g, cfg)),
        advance=jax.jit(lambda g: jwindow.advance_wcpe(g, cfg)),
    )


def _graph(jg):
    return to_port(GraphState, jg)


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


@pytest.mark.parametrize("k", range(NUM_FRAMES))
def test_update_from_packet(run, k):
    cfg, intr, records, _ = run
    g_in, packet, g_out = records[k]
    got = twcpe.update_from_packet_wcpe(_graph(g_in), to_port(VisionPacket, packet), intr, port_cfg(cfg))
    assert_tree_matches(np_tree(g_out), dataclass_to_numpy(got), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("k", STATES)
def test_total_error(run, ref, k):
    cfg, _, records, _ = run
    jg = records[k][2]
    r = float(ref["total_error"](jg))
    got = float(twcpe.total_error(_graph(jg), port_cfg(cfg)))
    # f32 sums of ~2e3 terms in another order
    assert got == pytest.approx(r, rel=1e-4)


@pytest.mark.parametrize("k", STATES)
def test_linearize(run, ref, k):
    cfg, _, records, _ = run
    jg = records[k][2]
    jlin = ref["linearize"](jg, jnp.asarray(LAM, jnp.float32))
    got = twcpe.linearize(_graph(jg), port_cfg(cfg), torch.tensor(LAM))
    # Schur terms of ~1e6 weights subtract in f32 (solver.py:480-486), so
    # the bound is relative to the largest entry: rhs read 1.7e-5 of it
    for name in ("S", "rhs"):
        r, g = np.asarray(getattr(jlin, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)
    # g_d adds motion-pose weights up to 1e6 (sigma 1 mm) times residuals
    # whose f32 rounding is ~2e-6 m at 20 m, through Huber weights that move
    # with them: read 1.9 against entries ~1.3e3, so relative to the largest;
    # Bx and Bl carry such weights too (read 22 of 1.8e5, 280 of 2.2e6)
    for name, rel in {"Dp_inv": 1e-5, "Wm": 1e-5, "g_d": 5e-3, "Bx": 5e-4, "Bl": 5e-4}.items():
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
    r = jwcpe._apply_update(jg, jlin, jnp.asarray(dx))
    tg = _graph(jg)
    got = twcpe._apply_update(tg, twcpe.linearize(tg, port_cfg(cfg), torch.tensor(LAM)),
                                torch.from_numpy(dx))
    for name in ("X", "H", "ms", "md"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(r, name)),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("accept_reject", [True, False])
@pytest.mark.parametrize("k", STATES)
def test_optimize(run, k, accept_reject, monkeypatch):
    """Both branches, the port factoring with XLA's Cholesky: the object
    poses have a gauge (the factors see only L_k L_{k-1}^{-1}) that only the
    damping lifts, so the reduced system sits at the edge of f32 positive
    definiteness. At frame 3, lambda 1e-4, XLA's factorisation passes where
    LAPACK's fails, and the LM then takes another path
    (test_optimize_own_cholesky runs the port's own)."""
    xla_cholesky(monkeypatch)
    cfg, _, records, _ = run
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, accept_reject=accept_reject))
    jg = records[k][2]
    ref = jwcpe.optimize(jg, cfg)
    got = twcpe.optimize(_graph(jg), port_cfg(cfg))
    # the reference itself, its inputs scaled by (1 +- 1e-7), moves X up to
    # 2.2e-3, H 1.9e-2 (frame 3, LM: the object gauge), ms 6.9e-3 and md
    # 6.0e-3 over these four cases; the port read X 5.8e-5, H 1.6e-2, ms
    # 8.5e-4 and md 3.3e-4. Bounds ~3x the port's readings, H's at the
    # reference's own spread.
    for name, tol in {"X": 2e-4, "H": 5e-2, "ms": 3e-3, "md": 1e-3}.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=tol, err_msg=name)
    assert float(twcpe.total_error(got, port_cfg(cfg))) <= float(twcpe.total_error(_graph(jg), port_cfg(cfg)))


@pytest.mark.parametrize("k", STATES)
def test_optimize_own_cholesky(run, k):
    """The port's LM on its own factorisation: a failed Cholesky gives NaN,
    which the accept/reject rejects; the estimate stays finite and its
    error falls."""
    cfg, _, records, _ = run
    tg = _graph(records[k][2])
    got = twcpe.optimize(tg, port_cfg(cfg))
    for name in ("X", "H", "ms", "md"):
        assert bool(torch.isfinite(getattr(got, name)).all()), name
    assert float(twcpe.total_error(got, port_cfg(cfg))) < float(twcpe.total_error(tg, port_cfg(cfg)))


@pytest.mark.parametrize("i", range(NUM_FRAMES - F))
def test_departing_information(run, ref, i):
    cfg, _, _, windows = run
    jg = windows[i]
    Mr, gr = (np.asarray(a) for a in ref["departing"](jg))
    M, g = twindow._departing_information_wcpe(_graph(jg), port_cfg(cfg))
    np.testing.assert_allclose(M.numpy(), Mr, rtol=1e-4, atol=1e-5 * _scale(Mr))
    # g sums per-tracklet terms J_L^T w r of ~1e4 that cancel to ~1e2: the
    # reference's own moves 59 (of entries ~82) when its poses, motions or
    # points are scaled by (1 +- 1e-7); the port read 91.5. M read 4 of 8e7.
    np.testing.assert_allclose(g.numpy(), gr, rtol=1e-4, atol=3e-6 * _scale(Mr))


@pytest.mark.parametrize("i", range(NUM_FRAMES - F))
def test_advance(run, ref, i):
    cfg, _, _, windows = run
    jg = windows[i]
    r = ref["advance"](jg)
    got = twindow.advance_wcpe(_graph(jg), port_cfg(cfg))
    assert got.num_frames == F - 1 and bool(got.prior_valid)
    # the departing gradient's cancellation (test_departing_information)
    # carries into the prior: under (1 +- 1e-7) input scales the reference's
    # own prior_L moves 0.19 (of entries ~41), prior_b 1.9e-5, the
    # information 11 (of ~1.7e3) and the gradient 5.9e-4; the port read 0.11,
    # 3.0e-5, 8.1 and 9.2e-4
    check_advanced(r, got, prior_L=1e-2, prior_b=2e-2, info=2e-2, grad=3e-3)


@pytest.mark.parametrize("k", STATES)
def test_f2f_motion(run, k):
    _, _, records, _ = run
    jg = records[k][2]
    for f in range(F):
        np.testing.assert_allclose(twcpe.f2f_motion(_graph(jg), f).numpy(), np.asarray(jwcpe.f2f_motion(jg, f)),
                                   atol=1e-5)


def test_fused_step_past_the_window():
    """The fused step with backend_updater_enum=1 (WCPE), 7 frames of
    the dense test scene at max_frames=4: three advances."""
    cfg = small_cfg(max_frames=4).with_overrides({"backend.backend_updater_enum": 1})
    pose_err, motion_err, n_motions, tg, jg = fused_step_readings(cfg, 7)
    print(f"WCPE fused step: poses {pose_err:.2e}, {n_motions} motions {motion_err:.2e}")
    assert n_motions > 0 and bool(tg.prior_valid)
    assert pose_err <= FUSED_POSE_TOL and motion_err <= FUSED_MOTION_TOL
    ref = np_tree(jg)
    for name in ("frame_ids", "obj_ids", "H_valid", "d_obj", "d_valid"):
        np.testing.assert_array_equal(dataclass_to_numpy(tg)[name], ref[name], err_msg=name)
