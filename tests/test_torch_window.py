"""Parity of the port's window advance (backend/window.py::advance_hybrid)
with the JAX reference: the departing information, the marginal prior
(prior_L, prior_b), every rolled table and slot recycling, on the full
windows of a reference run over the dense test scene; the rare eigh branch,
forced on both sides; and the fused step past the window."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import graph as jgraph
from dynosam_tpu.backend import hybrid as jhybrid
from dynosam_tpu.backend import window as jwindow
from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
from dynosam_tpu.frontend.frontend import empty_frontend_state, frontend_step
from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu_torch.backend import window as twindow
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from dynosam_tpu_torch.parallel import batched as tbatched
from torch_port_util import check_advanced, np_tree, port_cfg, small_cfg, to_port

torch.set_num_threads(1)
F = 4
ADVANCES = 2          # before frames 4 and 5


def _backend_cfg(cfg):
    b = cfg.backend
    return dataclasses.replace(
        b, optimizer=dataclasses.replace(b.optimizer, accept_reject=True, max_iterations=2)
    )


@pytest.fixture(scope="module")
def full_windows():
    """Reference run; the optimised full window before each advance."""
    cfg = small_cfg(max_frames=F).normalized()
    bcfg = _backend_cfg(cfg)
    dense = j_dense(num_frames=F + ADVANCES)
    intr = dense.intr
    fe = jax.jit(lambda s, f: frontend_step(s, f, intr, cfg.frontend))
    upd = jax.jit(lambda g, p: jgraph.update_from_packet_hybrid(g, p, intr, bcfg))
    opt = jax.jit(lambda g: jhybrid.optimize(g, bcfg))
    adv = jax.jit(lambda g: jwindow.advance_hybrid(g, bcfg))
    fs, g = empty_frontend_state(cfg.frontend), jgraph.empty_graph(bcfg)
    windows = []
    for k in range(F + ADVANCES):
        fs, packet = fe(fs, dense.frame(k))
        if k >= F:
            windows.append(g)
            g = adv(g)
        g = opt(upd(g, packet))
    return bcfg, windows


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


@pytest.mark.parametrize("i", range(ADVANCES))
def test_departing_information(full_windows, i):
    bcfg, windows = full_windows
    jg = windows[i]
    Mr, gr = (np.asarray(a) for a in jwindow._departing_information_hybrid(jg, bcfg))
    M, g = twindow._departing_information_hybrid(to_port(GraphState, jg), port_cfg(bcfg))
    # f32 sums of up to Ld terms in another order; entries span the 1e8
    # gauge scale down to pixel information, so the bound is relative
    np.testing.assert_allclose(M.numpy(), Mr, rtol=1e-4, atol=1e-5 * _scale(Mr))
    np.testing.assert_allclose(g.numpy(), gr, rtol=1e-4, atol=1e-5 * _scale(gr))


@pytest.mark.parametrize("i", range(ADVANCES))
def test_advance_hybrid(full_windows, i):
    bcfg, windows = full_windows
    jg = windows[i]
    ref = jwindow.advance_hybrid(jg, bcfg)
    got = twindow.advance_hybrid(to_port(GraphState, jg), port_cfg(bcfg))
    assert got.num_frames == F - 1
    check_advanced(ref, got)


def test_slot_recycling_frees_an_unreferenced_object(full_windows):
    bcfg, windows = full_windows
    jg = windows[0]
    # drop every tracklet and motion of object slot 1 and move its keyframe
    # out of the window: the advance must free and re-open the slot
    d_obj = jnp.where(jg.d_obj == 1, -1, jg.d_obj)
    jg = jg.replace(d_obj=d_obj, H_valid=jg.H_valid.at[1].set(False),
                    kf_slot=jg.kf_slot.at[1].set(-1))
    assert int(jg.obj_ids[1]) > 0
    ref = jwindow.advance_hybrid(jg, bcfg)
    got = twindow.advance_hybrid(to_port(GraphState, jg), port_cfg(bcfg))
    assert int(ref.obj_ids[1]) == -1 and bool(ref.slot_open[1])
    for name in ("obj_ids", "kf_valid", "kf_slot", "slot_open"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))


def test_eigh_branch_forced(full_windows, monkeypatch):
    """Both sides take the rare eigendecomposition path when the full
    factorisation breaks down; here the breakdown is injected."""
    bcfg, windows = full_windows
    jg = windows[1]
    D = to_port(GraphState, jg).D
    j_chol, t_chol_ex = jnp.linalg.cholesky, torch.linalg.cholesky_ex
    used = []

    def j_break(a, *args, **kw):
        L = j_chol(a, *args, **kw)
        return jnp.full_like(L, jnp.nan) if a.shape[-1] == D else L

    def t_break(a, *args, **kw):
        L, info = t_chol_ex(a, *args, **kw)
        if a.shape[-1] == D:
            used.append("broken")
            return L, torch.ones_like(info)
        used.append("eigh")
        return L, info

    monkeypatch.setattr(jnp.linalg, "cholesky", j_break)
    monkeypatch.setattr(torch.linalg, "cholesky_ex", t_break)
    ref = jwindow.advance_hybrid(jg, bcfg)
    got = twindow.advance_hybrid(to_port(GraphState, jg), port_cfg(bcfg))
    assert used == ["broken", "eigh"]
    assert np.isfinite(np.asarray(ref.prior_L)).all()
    check_advanced(ref, got, unique_sqrt=False)


def test_fused_step_past_the_window():
    """7 frames at max_frames=4: three advances, poses and object motions
    held to the reference's fused step."""
    n = 7
    cfg = small_cfg(max_frames=F)
    jd, td = j_dense(num_frames=n), t_dense(num_frames=n, device="cpu")
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr))
    js = jbatched.init_pipeline_state(cfg)
    tcfg = port_cfg(cfg)
    tstep = tbatched.make_fused_step(tcfg, td.intr, torch.Generator().manual_seed(0))
    ts = tbatched.init_pipeline_state(tcfg, "cpu")
    n_motions = 0
    for k in range(n):
        js, jo = jstep(js, jd.frame(k))
        ts, to = tstep(ts, td.frame(k))
        assert ts.graph.num_frames == min(k + 1, F)
        # the noise-free scene: RANSAC's outcome does not depend on the draws
        np.testing.assert_allclose(to["X_world_cam"].numpy(), np.asarray(jo["X_world_cam"]), atol=1e-4)
        np.testing.assert_array_equal(to["object_ids"].numpy(), np.asarray(jo["object_ids"]))
        v = np.asarray(jo["object_motion_valid"])
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        np.testing.assert_allclose(to["object_motions"].numpy()[v], np.asarray(jo["object_motions"])[v],
                                   atol=1e-3)
        n_motions += int(v.sum())
    assert n_motions > 0
    assert bool(ts.graph.prior_valid)
    ref = np_tree(js.graph)
    got = dataclass_to_numpy(ts.graph)
    for name in ("frame_ids", "obj_ids", "H_valid", "kf_slot", "slot_open"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
