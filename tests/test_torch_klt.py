"""The port's pyramidal KLT (ops/lk.py) and CLAHE (ops/clahe.py,
tracker._clahe_padded) against the JAX reference on the CPU.

LK samples by direct gathers where the reference samples inside strips; the
arithmetic is the same, the sums of the 49-pixel normal equations may round
in another order. Measured on these inputs: a single level moves d by the
same amount to within 2e-6 of the step (1e-4 px on steps of ~30 px, where
the search window's clamp binds); tracked points that pass agree to 3e-5 px.
Tracks that fail may diverge (an ill-conditioned G amplifies the rounding),
so positions are compared on passing tracks only, and the pass flags are
equal except where the forward-backward error lies within 1e-3 px of the
threshold (counted). CLAHE differs by the rounding of the 256-bin prefix
sum: measured 1.2e-7, held to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.frontend import tracker as jtracker
from dynosam_tpu.ops import clahe as jclahe
from dynosam_tpu.ops import lk as jlk
from dynosam_tpu_torch.frontend import tracker as ttracker
from dynosam_tpu_torch.ops import clahe as tclahe
from dynosam_tpu_torch.ops import lk as tlk
from torch_port_util import t

torch.set_num_threads(1)
UV_TOL = 1e-3            # px, positions of tracks that pass in both
FB_NEAR = 1e-3           # px, |fb error - threshold| under which flags may differ
CLAHE_TOL = 1e-6


def _texture(h, w, shift=(0.0, 0.0)):
    """A smooth two-octave texture, translated by `shift` (x, y) px."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = x - shift[0], y - shift[1]
    g = (np.sin(x * 0.31) * np.sin(y * 0.27) + 0.5 * np.sin(x * 0.11 + y * 0.07)
         + 0.3 * np.sin(0.05 * x - 0.09 * y))
    return ((g - g.min()) / (g.max() - g.min())).astype(np.float32)


def _keypoints(h, w, n, seed):
    """Random keypoints over the image and a margin past it, plus points on
    every border."""
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(-3, w + 2, n), rng.uniform(-3, h + 2, n)], -1)
    edge = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [1.5, h / 2], [w - 2.5, h / 2],
                     [w / 2, 0.5], [w / 2, h - 1.5], [w - 0.2, 3.3], [2.2, h - 0.7]])
    uv = np.concatenate([uv, edge]).astype(np.float32)
    valid = rng.random(uv.shape[0]) < 0.9
    valid[-len(edge):] = True
    return uv, valid


def test_build_pyramid_wraps_like_reference():
    img = np.random.default_rng(0).random((45, 77)).astype(np.float32)
    ref = jlk.build_pyramid(jnp.asarray(img), 4)
    got = tlk.build_pyramid(t(img), 4)
    assert [tuple(g.shape) for g in got] == [(45, 77), (23, 39), (12, 20), (6, 10)]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("margin", [6, 12])
@pytest.mark.parametrize("hw", [(72, 200), (20, 90)])
def test_lk_level_matches_reference_where_the_window_clamps(hw, margin):
    """One level, two iterations, from random flows of ~15 px: most search
    samples clamp to their window's edge."""
    h, w = hw
    rng = np.random.default_rng(1)
    g0, g1 = rng.random((h, w)).astype(np.float32), rng.random((h, w)).astype(np.float32)
    uv, _ = _keypoints(h, w, 300, 2)
    d = rng.normal(0, 15, uv.shape).astype(np.float32)
    jd, jok = jlk._lk_level(jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(uv), jnp.asarray(d),
                            3, 2, 1e-4, margin=margin)
    td, tok = tlk._lk_level(t(g0), t(g1), t(uv), t(d), 3, 2, 1e-4, margin=margin)
    step = np.abs(np.asarray(jd) - d).max()
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= 1e-5 * step
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("shift", [2.3, 30.0, 70.0], ids=["small", "past_fine_margin", "past_window"])
@pytest.mark.parametrize("hw", [(72, 200), (60, 300), (48, 100)], ids=["w200", "w300", "w100"])
def test_lk_track_matches_reference(hw, shift):
    """Widths not a multiple of 128 and under 256 (the column window covers
    the padded image); shifts within the margins and past them."""
    h, w = hw
    g0, g1 = _texture(h, w), _texture(h, w, (shift, -0.6 * shift))
    uv, valid = _keypoints(h, w, 300, 3)
    ju, jok = jlk.lk_track(jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(uv), jnp.asarray(valid))
    tu, tok = tlk.lk_track(t(g0), t(g1), t(uv), t(valid))
    ju, jok, tu, tok = np.asarray(ju), np.asarray(jok), tu.numpy(), tok.numpy()
    # the reference's forward-backward error, to find the near-threshold cases
    p0, p1 = jlk.build_pyramid(jnp.asarray(g0), 3), jlk.build_pyramid(jnp.asarray(g1), 3)
    back, _ = jlk.lk_flow(p1, p0, jnp.asarray(ju), jnp.asarray(valid))
    fb = np.linalg.norm(ju + np.asarray(back) - uv, axis=-1)
    near = np.abs(fb - 1.0) < FB_NEAR
    differ = tok != jok
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert differ.sum() <= 2, differ.sum()
    both = jok & tok
    assert both.sum() > 20
    np.testing.assert_allclose(tu[both], ju[both], atol=UV_TOL, rtol=0)


@pytest.mark.parametrize("shape,grid", [((64, 128), 8), ((72, 136), 8), ((36, 52), 4)],
                         ids=["even_half_tiles", "odd_half_tiles", "grid4_odd"])
def test_clahe_matches_reference(shape, grid):
    """Both of the reference's paths: even half-tiles take its quadrant
    reduce, odd ones its per-pixel gathers."""
    img = (np.random.default_rng(4).random(shape) ** 2).astype(np.float32)
    th, tw = shape[0] // grid, shape[1] // grid
    assert ((th % 2 == 0) and (tw % 2 == 0)) == (shape == (64, 128))
    ref = np.asarray(jclahe.clahe(jnp.asarray(img), grid=grid))
    got = tclahe.clahe(t(img), grid=grid).numpy()
    np.testing.assert_allclose(got, ref, atol=CLAHE_TOL, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 1.0 and np.unique(got).size > 100


def test_clahe_padded_matches_reference_at_a_non_multiple_shape():
    img = _texture(70, 131)
    ref = np.asarray(jtracker._clahe_padded(jnp.asarray(img), 8, 2.0))
    got = ttracker._clahe_padded(t(img), 8, 2.0).numpy()
    assert got.shape == (70, 131)
    np.testing.assert_allclose(got, ref, atol=CLAHE_TOL, rtol=0)


@pytest.mark.parametrize("missing", ["prev_gray", "gray_lk"])
def test_track_frame_klt_needs_its_lk_pair(missing):
    """KLT mode without the previous frame, or with CLAHE on and no
    equalized current frame, raises as the reference does."""
    from dynosam_tpu_torch.config import FrontendParams, TrackerParams
    from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario

    params = FrontendParams(max_objects=4, tracker=TrackerParams(
        prefer_provided_optical_flow=False, max_features_per_frame=32, max_dynamic_features_per_frame=32))
    fr = default_dense_scenario(num_frames=1, device="cpu").frame(0)
    gray = fr.rgb[..., 0].contiguous()
    kw = {"prev_gray": gray, "gray_lk": gray}
    kw[missing] = None
    state = ttracker.empty_tracker_state(params, "cpu")
    with pytest.raises(ValueError, match=missing):
        ttracker.track_frame(state, gray, fr.depth, fr.flow, fr.mask, params, torch.tensor(True), **kw)
