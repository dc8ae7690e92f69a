"""The batched step (`make_batched_pipeline`) on every backend formulation
against the JAX reference: WCME (backend_updater_enum 0), WCPE (1) and the
joint hybrid solve (decoupled_object_solve off), each over B=3 sequences of
the noise-free dense scene, sequence b starting b frames later, through two
window advances; and the batched backend functions of each formulation
against `jax.vmap` of the reference's on one batched window.

The harness is tests/test_torch_parallel.py's: the reference's own RANSAC
draws (one key per sequence, the reference's `_init_batch`) are injected
stacked on the batch axis, and the port's unbatched runs take the same
draws. What is left is f32 rounding, which a batch axis reorders; each
bound below states the readings it was set from (this CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.backend import wcpe as jwcpe
from dynosam_tpu.backend import window as jwindow
from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.backend import hybrid as thybrid
from dynosam_tpu_torch.backend import solver as tsolver
from dynosam_tpu_torch.backend import wcpe as twcpe
from dynosam_tpu_torch.backend import window as twindow
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from dynosam_tpu_torch.parallel import batched as tbatched
from test_torch_parallel import _inject, _rot_trans, _seq, _stack_frames
from torch_port_util import (
    assert_tree_matches,
    np_tree,
    packet_backend_cfg,
    port_cfg,
    port_intr,
    reference_draws,
    small_cfg,
)

torch.set_num_threads(1)
B = 3
F = 4                      # window slots
N = 6                      # frames per sequence: the last two advance the window
FORMS = {"wcme": {"backend.backend_updater_enum": 0}, "wcpe": {"backend.backend_updater_enum": 1},
         "joint": {"backend.decoupled_object_solve": False}}
ADVANCE = {"wcme": twindow.advance, "wcpe": twindow.advance_wcpe, "joint": twindow.advance_hybrid}
LINEARIZE = {"wcme": (tsolver.linearize, tsolver._apply_update),
             "wcpe": (twcpe.linearize, twcpe._apply_update),
             "joint": (thybrid.linearize, thybrid._apply_update)}
# batched vs unbatched port runs, test_torch_parallel.py's bounds: the
# largest camera-pose and object-motion entry differences read 2.4e-7 and
# 1.6e-5 (WCME), 2.6e-7 and 1.6e-5 (WCPE), 5.9e-6 and 4.5e-5 (joint)
POSE_TOL, MOTION_TOL = 1e-5, 2e-4
# the batched advance against the unbatched one, relative to each table's
# largest entry (at least 1): 1e-5, but prior_b, which solves against the
# factor's rows, read 5.3e-5 (WCME, entries ~0.04); the reference's own
# moves 1.6e-3 under a (1 + 1e-7) input scale (test_torch_wcme.py)
ADVANCE_REL = {"prior_b": 1e-3}
_RUNS = {}


def _run(name):
    """Both packages' batched runs of formulation `name` and the port's
    unbatched runs, cached for the module."""
    if name in _RUNS:
        return _RUNS[name]
    cfg = small_cfg(max_frames=F).with_overrides(FORMS[name])
    tcfg = port_cfg(cfg)
    n_scene = N + B - 1
    jd, td = j_dense(num_frames=n_scene), t_dense(num_frames=n_scene, device="cpu")

    jstep, jinit = jbatched.make_batched_pipeline(cfg, jd.intr)
    js = jinit(B)
    draws = [reference_draws(js.frontend.key[b], cfg.frontend, N) for b in range(B)]
    jouts, jfull = [], None
    for k in range(N):
        if k == F:
            jfull = js.graph
        fr = jax.tree.map(lambda *x: jnp.stack(x), *[jd.frame(k + b) for b in range(B)])
        js, jo = jstep(js, fr)
        jouts.append({n: np.asarray(v) for n, v in jo.items()})

    tstep, _ = tbatched.make_batched_pipeline(tcfg, td.intr)
    ts = convert.pipeline_state_from_numpy(np_tree(jinit(B)), "cpu", batched=True)
    touts, full = [], None
    with pytest.MonkeyPatch.context() as mp:
        queue = _inject(mp, [np.stack([d[i] for d in draws]) for i in range(2 * N)])
        for k in range(N):
            if k == F:
                full = ts.graph
            ts, to = tstep(ts, _stack_frames([td.frame(k + b) for b in range(B)]))
            touts.append(to)
        assert not queue

        uouts = []
        for b in range(B):
            queue = _inject(mp, draws[b])
            ustep = tbatched.make_fused_step(tcfg, td.intr)
            us = tbatched.init_pipeline_state(tcfg, "cpu")
            seq = []
            for k in range(N):
                us, uo = ustep(us, td.frame(k + b))
                seq.append(uo)
            uouts.append(seq)
            assert not queue
    _RUNS[name] = dict(cfg=cfg, tcfg=tcfg, td=td, draws=draws, jouts=jouts, touts=touts, uouts=uouts,
                       full=full, jfull=jfull, ts=ts)
    return _RUNS[name]


@pytest.fixture(scope="module", params=list(FORMS))
def runs(request):
    return request.param, _run(request.param)


def test_batched_step_matches_reference(runs):
    """(1) The port's batched step against jax.jit(make_batched_pipeline)
    of the same formulation, at the single-sequence fused-step tests'
    bounds (test_torch_wcme.py, test_torch_wcpe.py): camera poses within
    1e-4 m / rad, object ids and motion validity equal, valid motions
    within 1e-3."""
    name, r = runs
    n_valid = 0
    for k, (jo, to) in enumerate(zip(r["jouts"], r["touts"])):
        assert to["X_world_cam"].shape == (B, 4, 4)
        for key in ("X_world_cam", "frontend_pose"):
            rot, trans = _rot_trans(to[key].numpy(), jo[key])
            assert trans.max() < 1e-4 and rot.max() < 1e-4, (name, k, key, trans, rot)
        np.testing.assert_array_equal(to["object_ids"].numpy(), jo["object_ids"])
        v = jo["object_motion_valid"]
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        np.testing.assert_allclose(to["object_motions"].numpy()[v], jo["object_motions"][v], atol=1e-3)
        n_valid += int(v.sum())
    assert n_valid > 0
    assert r["ts"].graph.num_frames == F and bool(r["ts"].graph.prior_valid.all())


def _seq_errors(out_b, uo, where):
    for key in ("object_ids", "object_motion_valid"):
        np.testing.assert_array_equal(out_b[key].numpy(), uo[key].numpy(), err_msg=f"{where} {key}")
    pose = max(float((out_b[key] - uo[key]).abs().max()) for key in ("X_world_cam", "frontend_pose"))
    return pose, float((out_b["object_motions"] - uo["object_motions"]).abs().max())


def test_batched_step_equals_unbatched_runs(runs):
    """(2) Sequence b of the batch equals the unbatched step run alone on
    the same frames with the same draws."""
    name, r = runs
    errs = [_seq_errors(_seq(r["touts"][k], b), r["uouts"][b][k], f"{name} seq {b} frame {k}")
            for b in range(B) for k in range(N)]
    pose, motion = max(e[0] for e in errs), max(e[1] for e in errs)
    print(f"{name}: batched vs unbatched poses {pose:.2e}, motions {motion:.2e}")
    assert pose <= POSE_TOL and motion <= MOTION_TOL, (name, pose, motion)


def test_batch_of_one_equals_unbatched(runs, monkeypatch):
    """(3) B=1 is the unbatched step with a unit batch axis."""
    name, r = runs
    step, init = tbatched.make_batched_pipeline(r["tcfg"], r["td"].intr)
    queue = _inject(monkeypatch, [d[None] for d in r["draws"][0]])
    st = init(1, "cpu")
    for k in range(N):
        st, out = step(st, _stack_frames([r["td"].frame(k)]))
        pose, motion = _seq_errors(_seq(out, 0), r["uouts"][0][k], f"{name} B=1 frame {k}")
        assert pose <= POSE_TOL and motion <= MOTION_TOL, (name, k, pose, motion)
    assert not queue


def test_mixed_cholesky_and_eigh_advance(runs, monkeypatch):
    """(4) One advance of the full batched window in which sequence 1's
    factorisation breaks down (forced) and the others' does not: one host
    read, the eigh route for sequence 1 alone, each sequence equal to its
    own unbatched advance (1e-5 of each table's largest entry; for the eigh
    route the prior's information and gradient), as
    test_torch_parallel.py::test_mixed_cholesky_and_eigh_advance holds the
    hybrid advance. WCME and WCPE advance the simulator's packet window
    (_packet_window): on the dense scene's WCME window every sequence's f32
    factorisation breaks down by itself (info 52, 52, 68), so nothing there
    would mix."""
    name, r = runs
    full, bcfg = (r["full"], r["tcfg"].backend) if name == "joint" else _packet_window(name)[2:]
    advance = ADVANCE[name]
    D = full.D
    orig_chol, orig_eigh = torch.linalg.cholesky_ex, torch.linalg.eigh
    forced = {"on": False}
    eigh_batches = []

    def chol(a, *args, **kw):
        L, info = orig_chol(a, *args, **kw)
        if a.shape[-1] == D:
            if a.ndim == 3:
                info = info.clone()
                info[1] = 1
            elif forced["on"]:
                info = torch.ones_like(info)
        return L, info

    def eigh(a, *args, **kw):
        eigh_batches.append(tuple(a.shape[:-2]))
        return orig_eigh(a, *args, **kw)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", chol)
    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    got = advance(full, bcfg)
    assert eigh_batches == [(1,)]
    for b in range(B):
        forced["on"] = b == 1
        eigh_batches.clear()
        ref = advance(_seq(full, b), bcfg)
        assert eigh_batches == ([(1,)] if b == 1 else [])
        for fld in dataclasses.fields(GraphState):
            rv, gv = getattr(ref, fld.name), getattr(got, fld.name)
            if not torch.is_tensor(rv):
                assert rv == gv
                continue
            gv = gv[b]
            if rv.dtype in (torch.bool, torch.int32, torch.int64):
                assert torch.equal(gv, rv), (name, b, fld.name)
            elif not (b == 1 and fld.name in ("prior_L", "prior_b")):
                tol = ADVANCE_REL.get(fld.name, 1e-5) * max(float(rv.abs().max()), 1.0)
                assert float((gv - rv).abs().max()) <= tol, (name, b, fld.name, float((gv - rv).abs().max()))
        L, bvec = got.prior_L[b], got.prior_b[b]
        for what, rm, gm in (("info", ref.prior_L.T @ ref.prior_L, L.T @ L),
                             ("grad", ref.prior_L.T @ ref.prior_b, L.T @ bvec)):
            tol = 1e-5 * max(float(rm.abs().max()), 1.0)
            assert float((gm - rm).abs().max()) <= tol, (name, b, what, float((gm - rm).abs().max()))


def test_gn_scan_keeps_only_the_failed_sequence(runs):
    """(5) The damped GN scan (accept_reject off) over the batched window
    with sequence 1's step made non-finite: sequence 1 keeps its state
    exactly, and every other sequence takes steps and equals its own
    unbatched scan (2e-4 of each table's largest entry). WCME and WCPE scan
    the simulator's packet window: on the dense scene's window their f32
    reduced systems fail to factor, so no sequence would move."""
    name, r = runs
    full, bcfg = (r["full"], r["tcfg"].backend) if name == "joint" else _packet_window(name)[2:]
    bcfg = dataclasses.replace(bcfg, optimizer=dataclasses.replace(bcfg.optimizer, accept_reject=False))
    linearize, apply = LINEARIZE[name]
    F_ = full.F

    def solve(lin):
        return tsolver.gate_dx_by_type(tsolver.chol_solve(lin.S, lin.rhs), F_, bcfg.optimizer)

    def solve_nan(lin):
        dx = solve(lin).clone()
        dx[1] = torch.nan
        return dx

    got = tsolver.gn_scan(full, bcfg, linearize, apply, solve_nan)
    for fld in ("X", "H", "ms", "md", "m_hyb"):
        assert torch.equal(getattr(got, fld)[1], getattr(full, fld)[1]), (name, fld)
    moved = 0.0
    for b in (0, 2):
        ref = tsolver.gn_scan(_seq(full, b), bcfg, linearize, apply, solve)
        for fld in ("X", "H", "ms", "md", "m_hyb"):
            rv, gv = getattr(ref, fld), getattr(got, fld)[b]
            assert torch.isfinite(gv).all(), (name, b, fld)
            # three GN iterations amplify the batch's reordered sums: H read
            # 2.4e-5 (WCME); the reference itself moves H 8.1e-5 under a
            # (1 + 1e-7) input scale (test_torch_wcme.py::test_optimize)
            tol = 2e-4 * max(float(rv.abs().max()), 1.0)
            assert float((gv - rv).abs().max()) <= tol, (name, b, fld, float((gv - rv).abs().max()))
        moved = max(moved, float((ref.X - getattr(full, "X")[b]).abs().max()))
    assert moved > 0.0, name


# ---------------------------------------------------------------------------
# The batched backend functions against jax.vmap of the reference's
# ---------------------------------------------------------------------------

LAM = 1e-3
_WINDOWS = {}


def _packet_window(name):
    """A full batched window of formulation `name` ("wcme" or "wcpe") on
    the simulator's noisy packets (the scene of test_torch_wcme.py and
    test_torch_wcpe.py, one seed per sequence): the reference's vmapped
    ingestion and optimizer over F frames -> (JAX BackendParams, the JAX
    window, the port's copy of it, the port's BackendParams)."""
    if name in _WINDOWS:
        return _WINDOWS[name]
    from dynosam_tpu.backend import graph as jgraph

    enum = FORMS[name]["backend.backend_updater_enum"]
    cfg = packet_backend_cfg(max_frames=F, backend_updater_enum=enum, optimization_mode=1)
    jupd, jopt = ((jgraph.update_from_packet, jsolver.optimize) if name == "wcme"
                  else (jwcpe.update_from_packet_wcpe, jwcpe.optimize))
    scns = _scenarios(F)
    intr = scns[0].intr
    step = jax.jit(jax.vmap(lambda g, p: jopt(jupd(g, p, intr, cfg), cfg)))
    jg = jax.vmap(lambda _: jgraph.empty_graph(cfg))(jnp.arange(B))
    for k in range(F):
        jg = step(jg, _stack_packets(scns, k, cfg))
    _WINDOWS[name] = (cfg, jg, convert.dataclass_from_numpy(GraphState, np_tree(jg), "cpu", batched=True),
                      port_cfg(cfg))
    return _WINDOWS[name]


def _scenarios(n):
    from dynosam_tpu.dataproviders.simulator import Scenario, ScenarioSpec

    return [Scenario(ScenarioSpec.default_two_objects(num_frames=n, pixel_noise=0.4, depth_noise=0.02,
                                                      seed=5 + b)) for b in range(B)]


def _stack_packets(scns, k, cfg):
    return jax.tree.map(lambda *x: jnp.stack(x), *[s.measurements(k, cfg.max_objects) for s in scns])


def _window(name):
    cfg, jg, tg, _ = _packet_window(name)
    return cfg, jg, tg


def _scale(a):
    return max(float(np.abs(a).max()), 1.0)


@pytest.mark.parametrize("name", ["wcme", "wcpe"])
def test_total_error_at_b(name):
    cfg, jg, tg = _window(name)
    jmod, tmod = (jsolver, tsolver) if name == "wcme" else (jwcpe, twcpe)
    ref = np.asarray(jax.vmap(lambda g: jmod.total_error(g, cfg))(jg))
    got = tmod.total_error(tg, port_cfg(cfg)).numpy()
    assert got.shape == (B,)
    # f32 sums in another order (test_torch_wcme.py, test_torch_wcpe.py)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


@pytest.mark.parametrize("name", ["wcme", "wcpe"])
def test_linearize_at_b(name):
    """At the single-sequence tests' bounds (test_torch_wcme.py,
    test_torch_wcpe.py: relative to each array's largest entry)."""
    cfg, jg, tg = _window(name)
    jmod, tmod = (jsolver, tsolver) if name == "wcme" else (jwcpe, twcpe)
    lam = np.array([LAM, 10 * LAM, LAM], np.float32)       # per-sequence damping
    jlin = jax.vmap(lambda g, l: jmod.linearize(g, cfg, l))(jg, jnp.asarray(lam))
    got = tmod.linearize(tg, port_cfg(cfg), torch.from_numpy(lam))
    # WCPE's rhs: its Schur corrections cancel (J_L^T w r of ~1e4 to ~1e2):
    # the reference's own vmapped and jitted linearisations differ by up to
    # 6.0e-4 of the largest entry, the port read 8.4e-4 against the vmapped
    # one (WCME: 6.4e-4 and 6.2e-6)
    rel = {"S": 1e-4, "rhs": 1e-4 if name == "wcme" else 2e-3, "Dp_inv": 1e-5, "Wm": 1e-5, "g_d": 5e-3}
    # WCPE's Bl carries the motion-pose weights through Huber weights that
    # move with f32 residuals: the port's unbatched linearisation reads
    # 8.6e-4 of the largest entry against the reference's jitted one on
    # sequence 2 (the reference's vmapped vs jitted 2.1e-4), so 3e-3 there
    rel.update({"Bx_blk": 5e-4, "Bh_curr": 5e-4, "Bh_prev": 5e-4} if name == "wcme" else {"Bx": 5e-4, "Bl": 3e-3})
    for field, bound in rel.items():
        r, g = np.asarray(getattr(jlin, field)), getattr(got, field).numpy()
        assert g.shape == r.shape, field
        for b in range(B):
            np.testing.assert_allclose(g[b], r[b], rtol=1e-4, atol=bound * _scale(r[b]), err_msg=f"{field} {b}")
    # each sequence equals the port's own unbatched linearisation (read
    # 2.1e-7 of the largest entry at most)
    for b in range(B):
        one = tmod.linearize(_seq(tg, b), port_cfg(cfg), torch.tensor(lam[b]))
        for field in rel:
            u, g = getattr(one, field), getattr(got, field)[b]
            assert float((g - u).abs().max()) <= 1e-6 * _scale(u.numpy()), (field, b)


@pytest.mark.parametrize("name", ["wcme", "wcpe"])
def test_apply_update_at_b(name):
    """The same per-sequence step on both sides, each with its own
    linearisation (test_torch_wcme.py's bound, 1e-4)."""
    cfg, jg, tg = _window(name)
    jmod, tmod = (jsolver, tsolver) if name == "wcme" else (jwcpe, twcpe)
    jlin = jax.vmap(lambda g: jmod.linearize(g, cfg, jnp.float32(LAM)))(jg)
    dx = np.asarray(jax.vmap(jnp.linalg.solve)(jlin.S, jlin.rhs))
    ref = jax.vmap(lambda g, l, d: jmod._apply_update(g, l, d))(jg, jlin, jnp.asarray(dx))
    got = tmod._apply_update(tg, tmod.linearize(tg, port_cfg(cfg), torch.tensor(LAM)), torch.from_numpy(dx))
    for field in ("X", "H", "ms", "md"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                                   atol=1e-4, err_msg=field)


@pytest.mark.parametrize("name", ["wcme", "wcpe"])
def test_advance_at_b(name):
    """The WCME and WCPE advances at B against the vmapped reference: the
    rolled tables within f32 rounding, the prior's information and
    gradient at the single-sequence tests' bounds (test_torch_wcme.py,
    test_torch_wcpe.py::test_advance)."""
    cfg, jg, tg = _window(name)
    jfn = jwindow.advance if name == "wcme" else jwindow.advance_wcpe
    tfn = twindow.advance if name == "wcme" else twindow.advance_wcpe
    ref = np_tree(jax.vmap(lambda g: jfn(g, cfg))(jg))
    got = tfn(tg, port_cfg(cfg))
    assert got.num_frames == F - 1 and bool(got.prior_valid.all())
    rel = {"info": 1e-4, "grad": 1e-4} if name == "wcme" else {"info": 2e-2, "grad": 3e-3}
    gn = convert.dataclass_to_numpy(got, B)
    for field, g in gn.items():
        r = ref[field]
        if field in ("prior_L", "prior_b", "num_frames"):
            continue
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=field)
        else:
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-6, err_msg=field)
    for b in range(B):
        L_r, b_r = ref["prior_L"][b].astype(np.float64), ref["prior_b"][b].astype(np.float64)
        L, bv = gn["prior_L"][b].astype(np.float64), gn["prior_b"][b].astype(np.float64)
        info_r, grad_r = L_r.T @ L_r, L_r.T @ b_r
        np.testing.assert_allclose(L.T @ L, info_r, rtol=1e-3, atol=rel["info"] * _scale(info_r), err_msg=f"info {b}")
        np.testing.assert_allclose(L.T @ bv, grad_r, rtol=1e-3, atol=rel["grad"] * _scale(grad_r), err_msg=f"grad {b}")


def test_wcpe_f2f_motion_at_b():
    cfg, jg, tg = _window("wcpe")
    for f in range(F):
        ref = np.asarray(jax.vmap(lambda g: jwcpe.f2f_motion(g, f))(jg))
        np.testing.assert_allclose(twcpe.f2f_motion(tg, f).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("name", ["wcme", "wcpe"])
def test_update_from_packet_at_b(name):
    """The WCME / WCPE ingestion at B against the vmapped reference, over
    three frames of the simulator's noisy packets (one seed per sequence):
    integer and bool tables equal, float tables within f32 rounding
    (test_torch_wcme.py::test_update_from_packet's bounds)."""
    from dynosam_tpu.backend import graph as jgraph
    from dynosam_tpu_torch.backend import graph as tgraph
    from dynosam_tpu_torch.frontend.types import VisionPacket

    jupd, tupd = ((jgraph.update_from_packet, tgraph.update_from_packet) if name == "wcme"
                  else (jwcpe.update_from_packet_wcpe, twcpe.update_from_packet_wcpe))
    cfg = packet_backend_cfg(max_frames=F, backend_updater_enum=FORMS[name]["backend.backend_updater_enum"])
    scns = _scenarios(3)
    intr = scns[0].intr
    jg = jax.vmap(lambda _: jgraph.empty_graph(cfg))(jnp.arange(B))
    tg = convert.dataclass_from_numpy(GraphState, np_tree(jg), "cpu", batched=True)
    upd = jax.jit(jax.vmap(lambda g, p: jupd(g, p, intr, cfg)))
    for k in range(3):
        pk = _stack_packets(scns, k, cfg)
        jg = upd(jg, pk)
        tg = tupd(tg, convert.dataclass_from_numpy(VisionPacket, np_tree(pk), "cpu"), port_intr(intr),
                  port_cfg(cfg))
        assert tg.num_frames == k + 1
        assert_tree_matches(np_tree(jg), convert.dataclass_to_numpy(tg, B), atol=1e-5, rtol=1e-6)


def test_block_tridiag_takes_a_sequence_axis():
    """ops/block_tridiag.py on (B, Ld, F, 3, 3) chains, as the batched WCME
    and WCPE give it: each sequence's factors, solve and dense inverse
    equal its own unbatched call bit for bit, and jax.vmap of the
    reference's within test_torch_block_tridiag.py's bounds."""
    from dynosam_tpu.ops import block_tridiag as jbt
    from dynosam_tpu_torch.ops import block_tridiag as tbt

    rng = np.random.default_rng(7)
    Ld = 5
    A = rng.standard_normal((B, Ld, F, 3, 3)).astype(np.float32)
    diag = A @ np.swapaxes(A, -1, -2) + 6.0 * np.eye(3, dtype=np.float32)
    upper = rng.standard_normal((B, Ld, F, 3, 3)).astype(np.float32)
    upper[..., F - 1, :, :] = 0.0
    rhs = rng.standard_normal((B, Ld, F, 3, 1)).astype(np.float32)
    d, u, r = (torch.from_numpy(np.ascontiguousarray(x)) for x in (diag, upper, rhs))
    Dp, W = tbt.factorize(d, u)
    x = tbt.solve_factored(Dp, W, u, r)
    inv = tbt.full_inverse(d, u)
    for b in range(B):
        Db, Wb = tbt.factorize(d[b], u[b])
        assert torch.equal(Dp[b], Db) and torch.equal(W[b], Wb)
        assert torch.equal(x[b], tbt.solve_factored(Db, Wb, u[b], r[b]))
        assert torch.equal(inv[b], tbt.full_inverse(d[b], u[b]))
    ref = np.asarray(jax.vmap(jbt.full_inverse)(jnp.asarray(diag), jnp.asarray(upper)))
    np.testing.assert_allclose(inv.numpy(), ref, rtol=1e-5, atol=1e-5)
    xr = np.asarray(jax.vmap(jbt.solve)(jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs)))
    np.testing.assert_allclose(x.numpy(), xr, rtol=1e-5, atol=1e-5)
