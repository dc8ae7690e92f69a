"""The port's multi-device path against the JAX reference's mesh versions,
on the CPU: ranks are processes joined by gloo (`parallel/group.py`), one
torch thread each; the reference runs on the conftest's virtual 8-device
CPU mesh.

  * `sharded_linearize` at P=2 and P=4 on tests/test_sharded.py's scene:
    against the port's unsharded `linearize` (and its single-process
    chunked sum) within that file's sharded-vs-unsharded bound, 1e-5 of the
    largest entry (read 2.1e-7 / 4.9e-7 on rhs / S, as the reference's own
    sharding reads 1.2e-7 / 3.2e-7); against JAX's `sharded_linearize` on
    the virtual mesh within the port's linearize parity bound
    (tests/test_torch_backend.py: 1e-4 of the largest entry). That one
    reads 1.6e-5 on rhs at P=2 and 4: the port's whole `linearize` reads
    the same against JAX's whole one on this noisy scene, so it is the
    implementations' float32 rounding, not the sharding. And `sharded_optimize` (P=4, five iterations) against
    JAX's at that file's bounds (poses 2e-4, motions 2e-3); every rank's
    system and every iteration's step equal to rank 0's (0 difference).
  * The sharded batched step, B=4 sequences over P=2 ranks, a few-slot
    configuration with a 3-frame window, four frames (the last advances
    it; the reference's advance fails to trace at a 2-frame window), each rank taking the reference's draws for the whole batch and
    keeping its rows: against JAX's `make_batched_pipeline(mesh=Mesh(4
    devices, ("data",)))` at the batched step's parity bounds
    (tests/test_torch_parallel.py: poses 1e-4 m / rad, ids and validity
    equal, valid motions 1e-3), and against the port's unsharded batched
    run on the same draws, where every output read 0 difference on this
    CPU (held to 0).
  * The draws: a group of one draws what the ungrouped step draws, and
    rank r of P keeps rows [r B/P, (r + 1) B/P) of the whole batch's draw.
  * A rank that raises ends the run with its exception in the caller.
  * `python -m dynosam_tpu_torch.multichip --device cpu --ranks 2` at a
    reduced size exits 0 and prints the OK line.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dynosam_tpu.backend import graph as jgraph
from dynosam_tpu.config import BackendParams, NoiseParams
from dynosam_tpu.dataproviders.simulator import Scenario, ScenarioSpec
from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu.parallel import sharded as jsharded
from dynosam_tpu_torch import multichip
from dynosam_tpu_torch.backend import hybrid as thybrid
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from dynosam_tpu_torch.ops import ransac
from dynosam_tpu_torch.parallel import batched as tbatched
from dynosam_tpu_torch.parallel import group as tgroup
from torch_port_util import port_cfg, reference_draws, small_cfg, to_port
from torch_port_util import stack_frames as _stack_frames

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIN_REL = 1e-5                      # tests/test_sharded.py
LIN_PARITY = 1e-4                   # tests/test_torch_backend.py
OPT_POSE, OPT_MOTION = 2e-4, 2e-3   # tests/test_sharded.py
B, P_DATA, F, N = 4, 2, 3, 4        # sequences, ranks, window slots, frames


def _cpu_spawn(fn, world, args):
    return tgroup.spawn(fn, world, "cpu", "gloo", args=args, threads=1)


@pytest.fixture(scope="module")
def backend_case():
    """tests/test_sharded.py's scene and configuration, filled on the JAX
    side and converted; plain GN (no accept/reject), five iterations."""
    scn = Scenario(ScenarioSpec.default_two_objects(num_frames=6, pixel_noise=0.4, depth_noise=0.02, seed=5))
    cfg = BackendParams(
        max_frames=6, max_objects=4, max_static_landmarks=256, max_dynamic_landmarks=96,
        backend_updater_enum=3, noise=NoiseParams(use_range_dependent_noise=False),
    )
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, accept_reject=False,
                                                                 max_iterations=5))
    st = jgraph.empty_graph(cfg)
    for k in range(6):
        st = jgraph.update_from_packet_hybrid(st, scn.measurements(k, 4), scn.intr, cfg)
    runs = {P: _cpu_spawn(multichip.sharded_rank, P, (to_port(GraphState, st), port_cfg(cfg), 5, True))
            for P in (2, 4)}
    return dict(cfg=cfg, st=st, runs=runs)


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_linearize_matches_reference(backend_case, P):
    cfg, st = backend_case["cfg"], backend_case["st"]
    mesh = Mesh(np.array(jax.devices()[:P]), ("points",))
    ref_S, ref_rhs = jax.jit(lambda s, lam: jsharded.sharded_linearize(s, cfg, lam, mesh))(
        jsharded.shard_state(st, mesh), jnp.float32(1e-4))
    r0 = backend_case["runs"][P][0]
    whole = thybrid.linearize(to_port(GraphState, st), port_cfg(cfg), torch.tensor(1e-4))
    for got, ref, mine in ((r0["S"], ref_S, whole.S), (r0["rhs"], ref_rhs, whole.rhs)):
        ref, mine = np.asarray(ref), mine.numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=LIN_PARITY * np.abs(ref).max())
        np.testing.assert_allclose(got, mine, rtol=0, atol=LIN_REL * np.abs(mine).max())
    # and the port's single-process chunked sum at the same P, in rank 0
    assert r0["diffs"]["S_rel"] <= LIN_REL and r0["diffs"]["rhs_rel"] <= LIN_REL, r0["diffs"]


def test_sharded_optimize_matches_reference(backend_case):
    cfg, st = backend_case["cfg"], backend_case["st"]
    P = 4
    mesh = Mesh(np.array(jax.devices()[:P]), ("points",))
    ref = jax.jit(lambda s: jsharded.sharded_optimize(s, cfg, mesh, iterations=5))(jsharded.shard_state(st, mesh))
    r0 = backend_case["runs"][P][0]
    np.testing.assert_allclose(r0["X"], np.asarray(ref.X), atol=OPT_POSE)
    assert np.abs(r0["H"] - np.asarray(ref.H)).max() < OPT_MOTION
    assert r0["finite"]
    assert r0["diffs"]["X"] <= OPT_POSE and r0["diffs"]["H"] <= OPT_MOTION, r0["diffs"]


@pytest.mark.parametrize("P", [2, 4])
def test_every_rank_holds_the_same_step(backend_case, P):
    """After the all_reduce every rank's system, and each iteration's step
    dx, equals rank 0's broadcast copy exactly; each rank holds Ls/P and
    Ld/P landmarks."""
    runs = backend_case["runs"][P]
    assert [r["rank"] for r in runs] == list(range(P))
    for r in runs:
        assert r["spread"] == {"S": 0.0, "rhs": 0.0, "dx": 0.0}, (r["rank"], r["spread"])
        assert tuple(r["landmarks"]) == (256 // P, 96 // P)


@pytest.fixture(scope="module")
def batched_case():
    cfg = small_cfg(max_frames=F)
    tcfg = port_cfg(cfg)
    jd, td = j_dense(num_frames=N + B - 1), t_dense(num_frames=N + B - 1, device="cpu")

    mesh = Mesh(np.array(jax.devices()[:B]), ("data",))
    jstep, jinit = jbatched.make_batched_pipeline(cfg, jd.intr, mesh=mesh)
    js = jinit(B)
    per_seq = [reference_draws(js.frontend.key[b], cfg.frontend, N) for b in range(B)]
    draws = [np.stack([d[i] for d in per_seq]) for i in range(2 * N)]
    jouts = []
    for k in range(N):
        fr = jax.tree.map(lambda *x: jnp.stack(x), *[jd.frame(k + b) for b in range(B)])
        js, jo = jstep(js, fr)
        jouts.append({n: np.asarray(v) for n, v in jo.items()})
    frames = [_stack_frames([td.frame(k + b) for b in range(B)]) for k in range(N)]
    runs = _cpu_spawn(multichip.batched_rank, P_DATA, (tcfg, td.intr, frames, 0, draws, True))
    return dict(tcfg=tcfg, td=td, jouts=jouts, runs=runs, draws=draws)


def _rot_trans(A, B_):
    from dynosam_tpu_torch.utils import lie as tlie

    dR = torch.as_tensor(np.swapaxes(A[..., :3, :3], -1, -2) @ B_[..., :3, :3])
    rot = torch.linalg.norm(tlie.so3_log(dR), dim=-1).numpy()
    return rot, np.linalg.norm(A[..., :3, 3] - B_[..., :3, 3], axis=-1)


def test_sharded_batched_step_matches_reference_mesh(batched_case):
    r0 = batched_case["runs"][0]
    outs = r0["outputs"]
    n_valid = 0
    for k, jo in enumerate(batched_case["jouts"]):
        assert outs["X_world_cam"][k].shape == (B, 4, 4)
        for key in ("X_world_cam", "frontend_pose"):
            rot, trans = _rot_trans(outs[key][k], jo[key])
            assert trans.max() < 1e-4 and rot.max() < 1e-4, (k, key, trans, rot)
        np.testing.assert_array_equal(outs["object_ids"][k], jo["object_ids"])
        v = jo["object_motion_valid"]
        np.testing.assert_array_equal(outs["object_motion_valid"][k], v)
        np.testing.assert_allclose(outs["object_motions"][k][v], jo["object_motions"][v], atol=1e-3)
        n_valid += int(v.sum())
    assert n_valid > 0


def test_sharded_batched_step_equals_unsharded(batched_case):
    """Rank 0's gathered outputs against the port's unsharded batched run
    on the same draws: equal (0 on this CPU), every output; each rank
    stepped B/P sequences."""
    runs = batched_case["runs"]
    r0 = runs[0]
    assert r0["diffs"] == {"X_world_cam": 0.0, "object_ids": 0, "object_motions": 0.0,
                           "object_motion_valid": 0, "frontend_pose": 0.0}, r0["diffs"]
    assert r0["over"] == {}
    assert [r["rows"] for r in runs] == [B // P_DATA] * P_DATA
    assert all(len(r["times"]) == N for r in runs)


def _solo_group():
    return tgroup.Group(rank=0, world=1, device=torch.device("cpu"), backend="gloo", pg=None)


def test_group_of_one_draws_as_today(batched_case):
    """make_batched_pipeline with a group of one (the draws made for the
    whole batch through BatchRows) steps bit for bit as without a group."""
    tcfg, td = batched_case["tcfg"], batched_case["td"]
    frames = [_stack_frames([td.frame(k + b) for b in range(B)]) for k in range(N)]
    outs = []
    for group in (None, _solo_group()):
        step, init = tbatched.make_batched_pipeline(tcfg, td.intr, torch.Generator().manual_seed(3), group=group)
        st = init(B, "cpu")
        seq = []
        for fr in frames:
            st, o = step(st, tbatched.shard_rows(fr, group))
            seq.append(o)
        outs.append(seq)
    for a, b in zip(*outs):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("world", [1, 2, 4])
def test_rank_rows_of_the_batch_draw(world):
    """Rank r's draw is rows [r n, (r + 1) n) of the draw the whole batch
    takes from an identically seeded generator; a plain generator's draw
    is torch.rand's, as before."""
    shape = (2, 3, 16)
    full = torch.rand((2 * world,) + shape[1:], generator=torch.Generator().manual_seed(7))
    for r in range(world):
        got = ransac.draw_uniform(ransac.BatchRows(torch.Generator().manual_seed(7), world, r), shape, "cpu")
        assert torch.equal(got, full[2 * r:2 * (r + 1)])
    assert torch.equal(ransac.draw_uniform(torch.Generator().manual_seed(7), (2 * world,) + shape[1:], "cpu"), full)
    replay = ransac.BatchRows(ransac.ReplayDraws([full.numpy()]), world, world - 1)
    assert torch.equal(replay.rand(shape, "cpu"), full[2 * (world - 1):])


def test_batch_must_divide_over_the_ranks(batched_case):
    group = tgroup.Group(rank=1, world=3, device=torch.device("cpu"), backend="gloo", pg=None)
    _, init = tbatched.make_batched_pipeline(batched_case["tcfg"], batched_case["td"].intr, group=group)
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        init(B, "cpu")


def test_failed_rank_raises_in_the_caller(backend_case):
    """Capacities that do not divide over 3 ranks: every rank raises in
    shard_state, and spawn raises (no rank's failure is hidden)."""
    st = to_port(GraphState, backend_case["st"])
    with pytest.raises(Exception, match="does not divide into 3 chunks"):
        _cpu_spawn(multichip.sharded_rank, 3, (st, port_cfg(backend_case["cfg"]), 1, False))


def test_multichip_entry_point_on_the_cpu():
    """The entry point, two gloo ranks on the CPU, at a reduced size: (a) on
    the small dense scene, 4 sequences over 6 frames (the 4-frame window
    advances twice), (b) at J=4, F=6, 256 dynamic landmarks."""
    proc = subprocess.run(
        [sys.executable, "-m", "dynosam_tpu_torch.multichip", "--device", "cpu", "--ranks", "2", "--small",
         "--sequences", "4", "--frames", "6", "--J", "4", "--F", "6", "--dyn", "256"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "multichip OK: 2 rank(s) (gloo on cpu), 6 steps" in proc.stdout
