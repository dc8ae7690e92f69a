"""The pipelined fused step (`make_fused_step(..., pipelined=True)`: frontend
k, then the optimizer on the window through k-1, the advance if full and
frame k's ingestion) against the JAX reference's, with the hybrid
(decoupled) and the WCME formulations, over 7 frames of the noise-free
dense scene at max_frames=4 (three advances). The scene is noise-free, so
RANSAC's outcome does not depend on the draws and each side samples its
own."""

import jax
import numpy as np
import pytest
import torch

from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from dynosam_tpu_torch.parallel import batched as tbatched
from torch_port_util import np_tree, port_cfg, small_cfg

torch.set_num_threads(1)
F = 4
N = 7
# the sequential fused step's bounds (test_torch_wcme.py,
# test_torch_window.py): camera poses 1e-4, valid motions 1e-3 (entries)
POSE_TOL, MOTION_TOL = 1e-4, 1e-3
FORMS = {"hybrid": {}, "wcme": {"backend.backend_updater_enum": 0}}


@pytest.mark.parametrize("name", list(FORMS))
def test_pipelined_step_matches_reference(name):
    cfg = small_cfg(max_frames=F).with_overrides(FORMS[name])
    jd, td = j_dense(num_frames=N), t_dense(num_frames=N, device="cpu")
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr, pipelined=True))
    js = jbatched.init_pipeline_state(cfg)
    tcfg = port_cfg(cfg)
    tstep = tbatched.make_fused_step(tcfg, td.intr, torch.Generator().manual_seed(0), pipelined=True)
    ts = tbatched.init_pipeline_state(tcfg, "cpu")
    pose_err = motion_err = 0.0
    n_motions = 0
    for k in range(N):
        js, jo = jstep(js, jd.frame(k))
        ts, to = tstep(ts, td.frame(k))
        # the window fill: ingestion comes last in both orders
        assert ts.graph.num_frames == min(k + 1, F)
        pose_err = max(pose_err, float(np.abs(to["X_world_cam"].numpy() - np.asarray(jo["X_world_cam"])).max()))
        np.testing.assert_array_equal(to["object_ids"].numpy(), np.asarray(jo["object_ids"]))
        v = np.asarray(jo["object_motion_valid"])
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        d = np.abs(to["object_motions"].numpy()[v] - np.asarray(jo["object_motions"])[v])
        motion_err = max(motion_err, float(d.max(initial=0.0)))
        n_motions += int(v.sum())
    print(f"{name} pipelined: poses {pose_err:.2e}, {n_motions} motions {motion_err:.2e}")
    assert n_motions > 0 and bool(ts.graph.prior_valid)
    assert pose_err <= POSE_TOL and motion_err <= MOTION_TOL
    ref, got = np_tree(js.graph), dataclass_to_numpy(ts.graph)
    for field in ("frame_ids", "obj_ids", "H_valid", "d_obj", "d_valid", "s_valid"):
        np.testing.assert_array_equal(got[field], ref[field], err_msg=field)
    np.testing.assert_allclose(got["X"], ref["X"], atol=POSE_TOL)


@pytest.mark.parametrize("pipelined", [False, True])
def test_backend_order(monkeypatch, pipelined):
    """The window fill each backend stage sees per frame: sequential (the
    default) advances a full window, ingests frame k and optimizes the
    window through k; pipelined optimizes the window through k-1 first,
    then advances a full window and ingests frame k."""
    from dynosam_tpu_torch.backend import graph as tgraph
    from dynosam_tpu_torch.backend import hybrid as thybrid
    from dynosam_tpu_torch.backend import window as twindow

    seen = []

    def record(stage, fn):
        def wrapped(g, *args):
            seen.append((stage, g.num_frames))
            return fn(g, *args)
        monkeypatch.setattr(mod[stage], fn.__name__, wrapped)

    mod = {"advance": twindow, "update": tgraph, "optimize": thybrid}
    record("advance", twindow.advance_hybrid)
    record("update", tgraph.update_from_packet_hybrid)
    record("optimize", thybrid.optimize)
    cfg = port_cfg(small_cfg(max_frames=F))
    td = t_dense(num_frames=F + 2, device="cpu")
    kw = {"pipelined": True} if pipelined else {}
    step = tbatched.make_fused_step(cfg, td.intr, torch.Generator().manual_seed(0), **kw)
    st = tbatched.init_pipeline_state(cfg, "cpu")
    for k in range(F + 2):
        before = len(seen)
        st, _ = step(st, td.frame(k))
        n = min(k, F)                      # the fill before frame k
        if pipelined:
            want = [("optimize", n)] + ([("advance", F)] if n == F else []) + [("update", min(n, F - 1))]
        else:
            want = ([("advance", F)] if n == F else []) + [("update", min(n, F - 1)), ("optimize", min(n + 1, F))]
        assert seen[before:] == want, (k, seen[before:])
