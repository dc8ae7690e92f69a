"""The port's parallel slice against the JAX reference: the batched fused
step (`make_batched_pipeline`) over B=3 sequences of the noise-free dense
scene, sequence b starting b frames later, through one window advance; and
the landmark-chunked backend assembly (`parallel/sharded.py`) against the
reference's landmark-sharded one on the conftest's virtual CPU mesh.

Both batched runs take the reference's own RANSAC draws, one key per
sequence from `jax.random.split(PRNGKey(0), B)` (the reference's
`_init_batch`), injected stacked on the batch axis; the port's unbatched
runs take the same draws. What is left is f32 rounding, which a batch axis
reorders: on these frames the reference's own vmapped step differed from
its unbatched step by up to 8.2e-7 in the camera poses and 6.6e-5 in the
object-motion entries; the port's batched step differed from its unbatched
step by up to 1.5e-6 and 4.6e-5 (both measured on this CPU). Hence the
batched-vs-unbatched bounds below: poses 1e-5, motions 2e-4 (3x the
reference's spread), every integer, bool and validity output equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu.parallel import sharded as jsharded
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.backend import hybrid as thybrid
from dynosam_tpu_torch.backend import window as twindow
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from dynosam_tpu_torch.ops import ransac
from dynosam_tpu_torch.parallel import batched as tbatched
from dynosam_tpu_torch.parallel import sharded as tsharded
from dynosam_tpu_torch.utils import lie as tlie
from torch_port_util import np_tree, port_cfg, reference_draws, small_cfg, t, to_port
from torch_port_util import seq_of as _seq
from torch_port_util import stack_frames as _stack_frames

torch.set_num_threads(1)
B = 3
F = 4                      # window slots
N = 5                      # frames per sequence: the last one advances the window
POSE_TOL, MOTION_TOL = 1e-5, 2e-4          # batched vs unbatched (module docstring)
_SAMPLE = ransac._sample_indices


def _inject(mp, draws):
    """Feed `draws` to the port's RANSAC, one array per call, in order."""
    queue = list(draws)

    def sample(generator, valid, num_hypotheses, sample_size, uniforms=None):
        return _SAMPLE(generator, valid, num_hypotheses, sample_size, uniforms=t(queue.pop(0)))

    mp.setattr(ransac, "_sample_indices", sample)
    return queue


@pytest.fixture(scope="module")
def runs():
    cfg = small_cfg(max_frames=F)
    tcfg = port_cfg(cfg)
    n_scene = N + B - 1
    jd, td = j_dense(num_frames=n_scene), t_dense(num_frames=n_scene, device="cpu")

    # the reference: one jitted vmapped program
    jstep, jinit = jbatched.make_batched_pipeline(cfg, jd.intr)
    js = jinit(B)
    draws = [reference_draws(js.frontend.key[b], cfg.frontend, N) for b in range(B)]
    jouts = []
    for k in range(N):
        fr = jax.tree.map(lambda *x: jnp.stack(x), *[jd.frame(k + b) for b in range(B)])
        js, jo = jstep(js, fr)
        jouts.append({n: np.asarray(v) for n, v in jo.items()})

    # the port, batched, from the reference's initial batch
    tstep, tinit = tbatched.make_batched_pipeline(tcfg, td.intr)
    ts = convert.pipeline_state_from_numpy(np_tree(jinit(B)), "cpu", batched=True)
    touts, full = [], None
    with pytest.MonkeyPatch.context() as mp:
        queue = _inject(mp, [np.stack([d[i] for d in draws]) for i in range(2 * N)])
        for k in range(N):
            if k == F:
                full = ts.graph                   # the full window the last frame advances
            ts, to = tstep(ts, _stack_frames([td.frame(k + b) for b in range(B)]))
            touts.append(to)
        assert not queue

        # the port, unbatched, each sequence with its own draws
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
    return dict(cfg=cfg, tcfg=tcfg, td=td, draws=draws, tinit=tinit, jouts=jouts, touts=touts,
                uouts=uouts, full=full, ts=ts, js=js)


def _rot_trans(A, B_):
    dR = torch.as_tensor(np.swapaxes(A[..., :3, :3], -1, -2) @ B_[..., :3, :3])
    rot = torch.linalg.norm(tlie.so3_log(dR), dim=-1).numpy()
    return rot, np.linalg.norm(A[..., :3, 3] - B_[..., :3, 3], axis=-1)


def test_init_matches_reference_batch(runs):
    """init_fn(B) is the reference's _init_batch: the converted reference
    batch round-trips, and the port's own batch equals it (the RANSAC key
    aside, which the port does not carry)."""
    ref = np_tree(jbatched.make_batched_pipeline(runs["cfg"], j_dense(num_frames=1).intr)[1](B))
    got = convert.pipeline_state_to_numpy(runs["tinit"](B, "cpu"), batched=True)

    def check(r, g, path=""):
        if isinstance(g, dict):
            for k in g:
                check(r[k], g[k], f"{path}.{k}")
        else:
            assert g.shape == r.shape, path
            np.testing.assert_array_equal(g, r, err_msg=path)

    check(ref, got)


def test_batched_step_matches_reference(runs):
    """(a) The port's batched step against jax.jit(make_batched_pipeline)
    on the same frames, at the single-sequence fused-step tests' bounds
    (test_torch_slice.py): camera poses within 1e-4 m / rad, object ids and
    motion validity equal, valid motions within 1e-3."""
    n_valid = 0
    for k, (jo, to) in enumerate(zip(runs["jouts"], runs["touts"])):
        assert to["X_world_cam"].shape == (B, 4, 4)
        for key in ("X_world_cam", "frontend_pose"):
            rot, trans = _rot_trans(to[key].numpy(), jo[key])
            assert trans.max() < 1e-4 and rot.max() < 1e-4, (k, key, trans, rot)
        np.testing.assert_array_equal(to["object_ids"].numpy(), jo["object_ids"])
        v = jo["object_motion_valid"]
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        np.testing.assert_allclose(to["object_motions"].numpy()[v], jo["object_motions"][v], atol=1e-3)
        n_valid += int(v.sum())
    assert n_valid > 0
    assert runs["ts"].graph.num_frames == F and bool(runs["ts"].graph.prior_valid.all())


def _assert_seq_equal(out_b, uo, where):
    for key in ("object_ids", "object_motion_valid"):
        np.testing.assert_array_equal(out_b[key].numpy(), uo[key].numpy(), err_msg=f"{where} {key}")
    for key in ("X_world_cam", "frontend_pose"):
        err = float((out_b[key] - uo[key]).abs().max())
        assert err <= POSE_TOL, (where, key, err)
    err = float((out_b["object_motions"] - uo["object_motions"]).abs().max())
    assert err <= MOTION_TOL, (where, err)


def test_batched_step_equals_unbatched_runs(runs):
    """(b) Sequence b of the batch equals the unbatched step run alone on
    the same frames with the same draws."""
    for b in range(B):
        for k in range(N):
            _assert_seq_equal(_seq(runs["touts"][k], b), runs["uouts"][b][k], f"seq {b} frame {k}")


def test_batch_of_one_equals_unbatched(runs, monkeypatch):
    """(c) B=1 is the unbatched step with a unit batch axis."""
    step, init = tbatched.make_batched_pipeline(runs["tcfg"], runs["td"].intr)
    queue = _inject(monkeypatch, [d[None] for d in runs["draws"][0]])
    st = init(1, "cpu")
    for k in range(N):
        st, out = step(st, _stack_frames([runs["td"].frame(k)]))
        _assert_seq_equal(_seq(out, 0), runs["uouts"][0][k], f"B=1 frame {k}")
    assert not queue


def test_mixed_cholesky_and_eigh_advance(runs, monkeypatch):
    """(d) One advance of the full batched window in which sequence 1's
    factorisation breaks down (forced, as test_torch_window.py's
    test_eigh_branch_forced forces it for one state) and the others' does
    not: one host read, the eigh route for sequence 1 alone, each sequence
    equal to its own unbatched advance (1e-5 of each table's largest
    entry; the prior's information and gradient for the eigh route)."""
    full = runs["full"]
    bcfg = runs["tcfg"].backend
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
    got = twindow.advance_hybrid(full, bcfg)
    assert eigh_batches == [(1,)]
    for b in range(B):
        forced["on"] = b == 1
        eigh_batches.clear()
        ref = twindow.advance_hybrid(_seq(full, b), bcfg)
        # one sequence advances as a batch of one
        assert eigh_batches == ([(1,)] if b == 1 else [])
        for fld in dataclasses.fields(GraphState):
            r, g = getattr(ref, fld.name), getattr(got, fld.name)
            if not torch.is_tensor(r):
                assert r == g
                continue
            g = g[b]
            if r.dtype in (torch.bool, torch.int32, torch.int64):
                assert torch.equal(g, r), (b, fld.name)
            elif not (b == 1 and fld.name in ("prior_L", "prior_b")):
                tol = 1e-5 * max(float(r.abs().max()), 1.0)
                assert float((g - r).abs().max()) <= tol, (b, fld.name, float((g - r).abs().max()))
        # the eigh route's rows are eigenvectors, fixed only up to sign and
        # rotation within an eigenspace (tests/torch_port_util.py,
        # check_advanced): there the information and gradient are compared
        L, bvec = got.prior_L[b], got.prior_b[b]
        for name, r, g in (("info", ref.prior_L.T @ ref.prior_L, L.T @ L),
                           ("grad", ref.prior_L.T @ ref.prior_b, L.T @ bvec)):
            tol = 1e-5 * max(float(r.abs().max()), 1.0)
            assert float((g - r).abs().max()) <= tol, (b, name, float((g - r).abs().max()))


@pytest.fixture(scope="module")
def chunk_state(runs):
    """Sequence 0's graph after the run (a window past its first advance,
    marginal prior on) on both sides."""
    jg = jax.tree.map(lambda x: x[0], runs["js"].graph)
    return jg, to_port(GraphState, jg)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_chunked_linearize(runs, chunk_state, P):
    """(e) The chunked assembly against the reference's sharded one on P
    virtual CPU devices, at the port's linearize parity bounds
    (test_torch_backend.py: rtol 1e-4, atol 1e-4 of the largest entry), and
    against the port's unchunked linearize within the reference's own
    sharded-vs-unsharded drift bound (tests/test_sharded.py: 1e-5 of the
    largest entry)."""
    jg, tg = chunk_state
    bcfg = runs["cfg"].backend
    lam = 1e-4
    mesh = Mesh(np.array(jax.devices()[:P]), ("points",))
    ref_S, ref_rhs = jax.jit(lambda s, l: jsharded.sharded_linearize(s, bcfg, l, mesh))(
        jsharded.shard_state(jg, mesh), jnp.float32(lam))
    S, rhs = tsharded.chunked_linearize(tg, port_cfg(bcfg), torch.tensor(lam), P)
    whole = thybrid.linearize(tg, port_cfg(bcfg), torch.tensor(lam))
    for got, ref, mine in ((S, ref_S, whole.S), (rhs, ref_rhs, whole.rhs)):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * scale)
        np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=0, atol=1e-5 * scale)


def test_chunked_optimize(runs, chunk_state):
    """(f) Five plain GN iterations with chunked assembly against the
    reference's sharded_optimize (P=4), at tests/test_sharded.py's bounds
    for the same optimum: poses within 2e-4, motions within 2e-3."""
    jg, tg = chunk_state
    bcfg = runs["cfg"].backend
    P = 4
    mesh = Mesh(np.array(jax.devices()[:P]), ("points",))
    ref = jax.jit(lambda s: jsharded.sharded_optimize(s, bcfg, mesh, iterations=5))(
        jsharded.shard_state(jg, mesh))
    got = tsharded.chunked_optimize(tg, port_cfg(bcfg), P, iterations=5)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), atol=2e-4)
    assert np.abs(got.H.numpy() - np.asarray(ref.H)).max() < 2e-3
    assert np.isfinite(got.ms.numpy()).all() and np.isfinite(got.m_hyb.numpy()).all()


def test_unbatched_configurations_raise(runs):
    """The batched step refuses what the reference's batch cannot run: KLT
    (ValueError when it is built, the type the reference's
    empty_frontend_state raises, as its batch is built without an
    image_shape) and mask propagation (a state carrying the previous mask,
    which the reference's batch never carries). The detector's ByteTrack
    relabelling, the IMU and stereo (frames carrying a right image) build
    and step, as every backend formulation builds."""
    cfg = runs["tcfg"]
    td = runs["td"]
    with pytest.raises(ValueError, match="built without an image_shape"):
        tbatched.make_batched_pipeline(
            cfg.with_overrides({"frontend.tracker.prefer_provided_optical_flow": False}), td.intr)
    for over in ({"backend.backend_updater_enum": 0}, {"backend.backend_updater_enum": 1},
                 {"backend.decoupled_object_solve": False}):
        tbatched.make_batched_pipeline(cfg.with_overrides(over), td.intr)

    from dynosam_tpu_torch.frontend.frontend import empty_frontend_state, frontend_step

    frames = _stack_frames([td.frame(0), td.frame(1)])
    one = empty_frontend_state(cfg.frontend, "cpu", image_shape=tuple(frames.rgb.shape[1:3]))
    batched = tbatched._map_tensors(lambda x: x.expand((2,) + x.shape).clone(), one)
    with pytest.raises(NotImplementedError, match="never runs batched"):    # mask propagation
        frontend_step(batched, frames, td.intr, cfg.frontend)

    imu = [td.scn.imu_window(k, 8) for k in (0, 1)]
    modes = {
        "bytetrack": ({"frontend.tracker.prefer_provided_object_detection": False}, frames),
        "imu": ({"frontend.use_imu": True, "frontend.imu.use_rotation_prior": True},
                dataclasses.replace(frames, imu_samples=torch.stack([w for w, _ in imu]),
                                    imu_valid=torch.stack([v for _, v in imu]))),
        "stereo": ({}, dataclasses.replace(frames, right=frames.rgb)),
    }
    for name, (over, fr) in modes.items():
        step, init = tbatched.make_batched_pipeline(cfg.with_overrides(over), td.intr,
                                                    torch.Generator().manual_seed(0))
        st, out = step(init(2, "cpu"), fr)
        assert out["X_world_cam"].shape == (2, 4, 4) and st.graph.num_frames == 1, name
        assert bool(torch.isfinite(out["X_world_cam"]).all()), name
