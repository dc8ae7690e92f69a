"""Parity of the port's ByteTrack (nn/bytetrack.py) and the tracker's
relabelling branch with the JAX reference: the Kalman functions, the box
conversions and IoU, greedy assignment (ties included), bytetrack_step over
the box sequences of tests/test_bytetrack.py, masks_to_detections, and
track_frame with prefer_provided_object_detection=False."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario
from dynosam_tpu.frontend import tracker as jtracker
from dynosam_tpu.frontend.frontend import _to_gray
from dynosam_tpu.nn import bytetrack as jbt
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.frontend import tracker as ttracker
from dynosam_tpu_torch.nn import bytetrack as tbt
from torch_port_util import assert_tree_matches, np_tree, port_cfg, small_cfg, t, to_port

torch.set_num_threads(1)
TOL = 1e-4     # f32 Kalman algebra: ~1e-6 relative on box coordinates ~1e2


def _xyah(rng, n):
    return np.stack([rng.uniform(20, 600, n), rng.uniform(20, 360, n),
                     rng.uniform(0.3, 3.0, n), rng.uniform(10, 200, n)], -1).astype(np.float32)


def test_kalman_functions():
    rng = np.random.default_rng(0)
    z = _xyah(rng, 6)
    jm, jc = jbt.kf_initiate(jnp.asarray(z))
    tm, tc = tbt.kf_initiate(t(z))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    jm, jc = jbt.kf_predict(jm, jc)
    tm, tc = tbt.kf_predict(tm, tc)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    z2 = z + rng.normal(0, 2.0, z.shape).astype(np.float32)
    jm, jc = jbt.kf_update(jm, jc, jnp.asarray(z2))
    tm, tc = tbt.kf_update(tm, tc, t(z2))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=TOL)


def test_boxes_and_iou():
    rng = np.random.default_rng(1)
    s = _xyah(rng, 8)
    jb = np.asarray(jbt.xyah_to_tlbr(jnp.asarray(s)))
    tb = tbt.xyah_to_tlbr(t(s)).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-6)
    np.testing.assert_allclose(tbt.tlbr_to_xyah(t(tb)).numpy(),
                               np.asarray(jbt.tlbr_to_xyah(jnp.asarray(jb))), rtol=1e-6)
    np.testing.assert_allclose(tbt.iou_matrix(t(tb[:5]), t(tb)).numpy(),
                               np.asarray(jbt.iou_matrix(jnp.asarray(jb[:5]), jnp.asarray(jb))),
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_greedy_assign(kind):
    rng = np.random.default_rng(2)
    cost = rng.random((10, 7)).astype(np.float32)
    if kind == "ties":   # few distinct values: the first index must win
        cost = np.round(cost * 3) / 3
    row_ok = rng.random(10) > 0.2
    col_ok = rng.random(7) > 0.2
    ref = jbt.greedy_assign(jnp.asarray(cost), jnp.asarray(row_ok), jnp.asarray(col_ok), 0.3, 7)
    got = tbt.greedy_assign(t(cost), t(row_ok), t(col_ok), 0.3, 7)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _boxes(*tlbrs):
    out = np.zeros((8, 4), np.float32)
    valid = np.zeros((8,), bool)
    for i, b in enumerate(tlbrs):
        out[i] = b
        valid[i] = True
    return out, valid


def _sequences():
    """(boxes, scores, valid) per step, for the cases of tests/test_bytetrack.py."""
    two = [(*_boxes([10 + 5 * k, 10, 30 + 5 * k, 40], [200 - 5 * k, 50, 230 - 5 * k, 90]),
            np.full(8, 0.9, np.float32)) for k in range(6)]
    b, v = _boxes([10, 10, 30, 40])
    hi = np.full(8, 0.9, np.float32)
    occl = [(b, v, hi), (b, np.zeros(8, bool), hi), (b, np.zeros(8, bool), hi),
            (*_boxes([12, 10, 32, 40]), hi)]
    low = [(b, v, hi), (b, v, np.full(8, 0.3, np.float32))]
    return {"two_objects": two, "occlusion": occl, "low_score": low}


@pytest.mark.parametrize("case", ["two_objects", "occlusion", "low_score"])
def test_bytetrack_step_sequence(case):
    js, ts = jbt.empty_state(16), tbt.empty_state(16, device="cpu")
    step = jax.jit(jbt.bytetrack_step)
    for b, v, s in _sequences()[case]:
        js, jids = step(js, jnp.asarray(b), jnp.asarray(s), jnp.asarray(v))
        ts, tids = tbt.bytetrack_step(ts, t(b), t(s), t(v))
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        assert_tree_matches(np_tree(js), dataclass_to_numpy(ts), atol=TOL, rtol=1e-5)


def test_masks_to_detections():
    m = np.zeros((40, 60), np.int32)
    m[5:15, 10:25] = 2
    m[20:30, 40:50] = 5
    m[0, 59] = 8            # a single pixel at the corner, the last label
    m[39, 0] = 9            # above max_dets: ignored
    ref = jbt.masks_to_detections(jnp.asarray(m), max_dets=8)
    got = tbt.masks_to_detections(t(m), max_dets=8)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def relabel_frames():
    """Dense-scene frames whose instance labels are scrambled per frame, as
    an untracked detector would give them."""
    dense = default_dense_scenario(num_frames=4)
    frames = []
    for k in range(4):
        fr = dense.frame(k)
        m = np.asarray(fr.mask)
        perm = np.array([0, (k % 3) + 3, ((k + 1) % 3) + 5])   # labels 1, 2 -> per-frame ids
        frames.append((np.asarray(_to_gray(fr.rgb)), np.asarray(fr.depth), np.asarray(fr.flow),
                       perm[np.clip(m, 0, 2)].astype(np.int32)))
    return frames


def test_track_frame_relabels_untracked_masks(relabel_frames):
    cfg = small_cfg()
    params = dataclasses.replace(
        cfg.frontend,
        tracker=dataclasses.replace(cfg.frontend.tracker, prefer_provided_object_detection=False),
    )
    jstep = jax.jit(
        lambda s, g, d, fl, m, first: jtracker.track_frame(s, g, d, fl, m, params, first_frame=first)
    )
    jstate = jtracker.empty_tracker_state(params)
    ids = []
    for k, (gray, depth, flow, mask) in enumerate(relabel_frames):
        tstate = to_port(ttracker.TrackerState, jstate)
        jstate = jstep(jstate, gray, depth, flow, mask, jnp.asarray(k == 0))
        tnew = ttracker.track_frame(tstate, t(gray), t(depth), t(flow), t(mask), port_cfg(params),
                                    first_frame=torch.tensor(k == 0))
        assert_tree_matches(np_tree(jstate), dataclass_to_numpy(tnew), atol=1e-4)
        o = tnew.obj_ids.numpy()
        ids.append(sorted(o[o > 0].tolist()))
    # the scrambled per-frame labels (3..7) became ByteTrack ids, kept from
    # frame 0 to frame 1 (later frames follow the reference wherever it goes)
    assert ids[0] == ids[1] == [1, 2]
