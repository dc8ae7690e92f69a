"""The port of scripts/profile_breakdown.py (dynosam_tpu_torch/
profile_breakdown.py): after the fill (max_frames + 2 fused steps of the
dense test scene at max_frames=4), each stage the program times, run by the
port's `stages()` on the reference's filled state and packet, against the
reference's same stage (scripts/profile_breakdown.py:62-82: the updater's
functions under the incremental optimizer settings) for updaters 3, 1 and
0; and the stages leave the state they are given unchanged (its digest).
WCME's window advance is ill-conditioned on that filled state, so its
prior is held to the reference on test_torch_wcme.py's windows instead, at
that test's bounds (the program's advance stage on both)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import graph as jgraph
from dynosam_tpu.backend import hybrid as jhybrid
from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.backend import wcpe as jwcpe
from dynosam_tpu.backend import window as jwindow
from dynosam_tpu.dataproviders.simulator import Scenario, ScenarioSpec
from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
from dynosam_tpu.frontend.frontend import frontend_step as j_frontend_step
from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu_torch import convert
from dynosam_tpu_torch import profile_breakdown as tpb
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from dynosam_tpu_torch.frontend.types import VisionPacket
from torch_port_util import (
    assert_tree_matches,
    check_advanced,
    np_tree,
    packet_backend_cfg,
    port_cfg,
    port_intr,
    reference_window_run,
    small_cfg,
    to_port,
)

torch.set_num_threads(1)
UPDATERS = [3, 1, 0]
STAGES = ["fused step", "frontend_step", "graph update", "window advance", "optimize"]
# the window advance's bounds, relative to each quantity's largest entry.
# The square-root rows are compared through the information and gradient
# only: where a Cholesky breaks down, the eigh branch's rows are fixed only
# up to sign and rotation. Hybrid and WCPE: the bounds of their own advance
# tests (test_torch_window.py, test_torch_wcpe.py). WCME: on the filled
# state its advance is ill-conditioned (the first Cholesky breaks down at
# column 70 of 120; the reference's own information moves by 413-512 of
# 4326 under (1 +- 1e-7) scales of its input, at max_frames 4, 5 and 6
# alike), so there only its rolled tables are compared; its prior is held
# on test_torch_wcme.py's windows (WCME_WINDOWS) at that test's bounds.
ADVANCE_REL = {3: {}, 1: {"prior_L": 1e-2, "prior_b": 2e-2, "info": 2e-2, "grad": 3e-3}}
WCME_F, WCME_FRAMES, WCME_REL = 5, 7, {"prior_b": 2e-2}
_RUNS = {}


def _reference_stages(cfg, intr):
    """scripts/profile_breakdown.py's stage functions, jitted."""
    enum = cfg.backend.backend_updater_enum
    if enum == 3:
        update_fn, optimize_fn, advance_fn = (jgraph.update_from_packet_hybrid, jhybrid.optimize,
                                              jwindow.advance_hybrid)
    elif enum == 1:
        update_fn, optimize_fn, advance_fn = jwcpe.update_from_packet_wcpe, jwcpe.optimize, jwindow.advance_wcpe
    else:
        update_fn, optimize_fn, advance_fn = jgraph.update_from_packet, jsolver.optimize, jwindow.advance
    bcfg = dataclasses.replace(cfg.backend, optimizer=dataclasses.replace(
        cfg.backend.optimizer, accept_reject=True, max_iterations=min(3, cfg.backend.optimizer.max_iterations)))
    return (jax.jit(lambda st, inp: j_frontend_step(st, inp, intr, cfg.frontend)),
            jax.jit(lambda g, pkt: update_fn(g, pkt, intr, bcfg)),
            jax.jit(lambda g: advance_fn(g, bcfg)),
            jax.jit(lambda g: optimize_fn(g, bcfg)))


def stage_run(updater):
    """Both packages' stages on the reference's filled state and frame 0
    (the program's frame), cached per updater -> (reference outputs, port
    outputs, digests of the port's inputs before and after)."""
    if updater in _RUNS:
        return _RUNS[updater]
    cfg = small_cfg(4).with_overrides({"backend.backend_updater_enum": updater}).normalized()
    n_fill = cfg.backend.max_frames + 2
    jd, td = j_dense(num_frames=n_fill), t_dense(num_frames=n_fill, device="cpu")
    jstep = jax.jit(jbatched.make_fused_step(cfg, jd.intr))
    js = jbatched.init_pipeline_state(cfg)
    for k in range(n_fill):
        js, _ = jstep(js, jd.frame(k))
    fe_j, up_j, adv_j, op_j = _reference_stages(cfg, jd.intr)
    jframe = jd.frame(0)
    _, jpacket = fe_j(js.frontend, jframe)
    jadv = adv_j(js.graph)
    ref = {"fused step": jstep(js, jframe), "frontend_step": fe_j(js.frontend, jframe),
           "graph update": up_j(jadv, jpacket), "window advance": jadv, "optimize": op_j(js.graph)}

    _, _, fns = tpb.stages(port_cfg(cfg), td.intr, torch.Generator().manual_seed(0))
    ctx = {"state": convert.pipeline_state_from_numpy(np_tree(js), "cpu"), "packet": to_port(VisionPacket, jpacket),
           "frame": td.frame(0), "advanced": to_port(GraphState, jadv)}
    before = tpb.digest(ctx)
    got = {name: fns[name](ctx) for name in STAGES}
    for name in STAGES:          # again, as the program calls them again and again
        fns[name](ctx)
    _RUNS[updater] = (ref, got, before, tpb.digest(ctx))
    return _RUNS[updater]


def wcme_windows():
    """test_torch_wcme.py's run (default_two_objects, seed 5, window 5, 7
    frames): the reference's full windows before each advance, each
    advanced by the reference's and by the port's advance stage of the
    program -> [(reference, port)]."""
    if "wcme" in _RUNS:
        return _RUNS["wcme"]
    bcfg = packet_backend_cfg(max_frames=WCME_F, backend_updater_enum=0, optimization_mode=1)
    scn = Scenario(ScenarioSpec.default_two_objects(num_frames=WCME_FRAMES, pixel_noise=0.4, depth_noise=0.02,
                                                    seed=5))
    packets = [scn.measurements(k, bcfg.max_objects) for k in range(WCME_FRAMES)]
    _, windows = reference_window_run(bcfg, packets, scn.intr, jgraph.update_from_packet, jsolver.optimize,
                                      jwindow.advance)
    # the program's configuration: incremental mode over that backend
    cfg = dataclasses.replace(small_cfg(WCME_F), backend=dataclasses.replace(bcfg, optimization_mode=2))
    adv_j = _reference_stages(cfg, scn.intr)[2]
    advance = tpb.stages(port_cfg(cfg), port_intr(scn.intr), torch.Generator().manual_seed(0))[1]
    _RUNS["wcme"] = [(adv_j(jg), advance(to_port(GraphState, jg))) for jg in windows]
    return _RUNS["wcme"]


@pytest.mark.parametrize("updater", UPDATERS)
def test_stages_leave_their_inputs_unchanged(updater):
    _, _, before, after = stage_run(updater)
    assert before == after


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("updater", UPDATERS)
def test_stage_matches_reference(updater, stage):
    ref, got = stage_run(updater)[:2]
    r, g = ref[stage], got[stage]
    if stage == "fused step":
        # the fused-step bounds of test_torch_slice.py: poses 1e-4, motions
        # 1e-3, ids and validity equal
        (_, jo), (_, to) = r, g
        np.testing.assert_array_equal(to["object_ids"].numpy(), np.asarray(jo["object_ids"]))
        v = np.asarray(jo["object_motion_valid"])
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        for key in ("X_world_cam", "frontend_pose"):
            np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]), atol=1e-4, err_msg=key)
        np.testing.assert_allclose(to["object_motions"].numpy()[v], np.asarray(jo["object_motions"])[v], atol=1e-3)
    elif stage == "frontend_step":
        # f32 rounding of the same arithmetic: the packet within 1e-5 (read:
        # every entry within 1e-6), the tracker's positions within 1e-4 px
        # of ~200 (read 1.9e-6)
        (jfs, jp), (tfs, tp) = r, g
        assert_tree_matches(np_tree(jp), convert.dataclass_to_numpy(tp), atol=1e-5, rtol=1e-6)
        assert_tree_matches(np_tree(jfs), convert.dataclass_to_numpy(tfs), atol=1e-4, rtol=1e-6)
    elif stage == "graph update":
        # ingestion into the same advanced window: tables equal, values
        # within f32 rounding (read 3.8e-6 on depths of ~40 m)
        assert_tree_matches(np_tree(r), convert.dataclass_to_numpy(g), atol=1e-5, rtol=1e-6)
    elif stage == "window advance" and updater == 0:
        # on the filled state the rolled tables, within f32 rounding of the
        # ingestion (check_advanced's bounds for them); the prior on
        # test_torch_wcme.py's windows at that test's bounds
        rt, gt = np_tree(r), convert.dataclass_to_numpy(g)
        for name in ("prior_L", "prior_b"):
            rt.pop(name), gt.pop(name)
        assert_tree_matches(rt, gt, atol=1e-5, rtol=1e-6)
        for rw, gw in wcme_windows():
            check_advanced(rw, gw, **WCME_REL)
    elif stage == "window advance":
        check_advanced(r, g, unique_sqrt=False, **ADVANCE_REL[updater])
    else:
        # the bound of test_torch_slice.py::test_fused_step_state_after_window
        assert_tree_matches(np_tree(r), convert.dataclass_to_numpy(g), atol=1e-3)
