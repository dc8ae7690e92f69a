"""Parity of the port's tracker and Shi-Tomasi kernel module with the JAX
reference: the plain corner response against tracker.shi_tomasi_response
(whole frame) and the Pallas kernel in interpret mode (interior), per-cell
argmax ties, and track_frame over 4 frames of the dense test scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario
from dynosam_tpu.frontend import tracker as jtracker
from dynosam_tpu.frontend.frontend import _to_gray
from dynosam_tpu.ops.pallas.shi_tomasi import shi_tomasi_response_pallas
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.frontend import tracker as ttracker
from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
from torch_port_util import assert_tree_matches, np_tree, small_cfg, t, to_port

torch.set_num_threads(1)


def _image(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w), np.float32)


def test_plain_response_matches_xla_reference_whole_frame():
    img = _image(96, 128)
    ref = np.asarray(jtracker.shi_tomasi_response(jnp.asarray(img)))
    out = st.shi_tomasi_response_reference(t(img)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


def test_plain_response_matches_pallas_interior():
    # the Pallas kernel zero-pads rows, so it differs within 2 px of the edge
    img = _image(128, 256, seed=1)
    ref = np.asarray(shi_tomasi_response_pallas(jnp.asarray(img), interpret=True))
    out = st.shi_tomasi_response_reference(t(img)).numpy()
    np.testing.assert_allclose(out[2:-2, 2:-2], ref[2:-2, 2:-2], atol=1e-5)


def test_batched_plain_response_has_no_leak_between_images():
    imgs = np.stack([_image(64, 96, seed=s) for s in range(3)])
    batched = st.shi_tomasi_response_reference(t(imgs))
    for b in range(3):
        torch.testing.assert_close(batched[b], st.shi_tomasi_response_reference(t(imgs[b])),
                                   rtol=0, atol=0)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    img = t(_image(32, 48))
    before = st.shi_tomasi_response.launches
    torch.testing.assert_close(st.shi_tomasi_response(img),
                               st.shi_tomasi_response_reference(img), rtol=0, atol=0)
    assert st.shi_tomasi_response.launches == before


@pytest.mark.parametrize(
    "bad", ["float64", "rank1", "noncontiguous"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    img = t(_image(32, 48))
    arg = {
        "float64": img.double(),
        "rank1": img.reshape(-1),
        "noncontiguous": img.t(),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        st.shi_tomasi_response(arg)


@pytest.mark.parametrize("kind", ["constant", "plateaus"])
def test_cell_reduce_ties_take_the_first_index(kind):
    if kind == "constant":
        score = np.full((32, 48), 0.25, np.float32)
    else:  # equal maxima at several pixels of every cell
        score = np.zeros((32, 48), np.float32)
        score[1::3, 2::5] = 1.0
    jb = [np.asarray(a) for a in jtracker._cell_reduce(jnp.asarray(score), 8)]
    tb = [a.numpy() for a in ttracker._cell_reduce(t(score), 8)]
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def scene_frames():
    dense = default_dense_scenario(num_frames=4)
    return [dense.frame(k) for k in range(4)]


def test_track_frame_matches_reference_over_four_frames(scene_frames):
    params = small_cfg().frontend
    jstep = jax.jit(
        lambda s, g, d, fl, m, first: jtracker.track_frame(s, g, d, fl, m, params, first_frame=first)
    )
    jstate = jtracker.empty_tracker_state(params)
    for k, fr in enumerate(scene_frames):
        gray = _to_gray(fr.rgb)
        first = k == 0
        # both sides start from the same state, carried over from the reference
        tstate = to_port(ttracker.TrackerState, jstate)
        jstate = jstep(jstate, gray, fr.depth, fr.flow, fr.mask, jnp.asarray(first))
        tnew = ttracker.track_frame(
            tstate, t(gray), t(fr.depth), t(fr.flow), t(fr.mask), params,
            first_frame=torch.tensor(first),
        )
        got = dataclass_to_numpy(tnew)
        ref = np_tree(jstate)
        assert int(ref["s_valid"].sum()) > 0 and int(ref["d_valid"].sum()) > 0
        # uv within 1e-4 px; other floats (depths, IoU, areas) likewise tight
        assert_tree_matches(ref, got, atol=1e-4)
