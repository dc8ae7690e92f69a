"""The port's stereo module (cv/stereo.py) against the JAX reference: the
host rectification (a copy of the reference's numpy, so bit for bit), the
remap grids as tensors, `remap_bilinear`, sparse `stereo_track` and the
dense block matcher.

`remap_bilinear` blends as the reference does: measured equal or within an
ulp; held to 1e-6. `stereo_track` is lk_track plus gates (see
test_torch_klt.py for its tolerances); depths of matches that pass in both
agree to 1e-4 relative. `dense_disparity` sums its box windows in the
reference's reduce_window order, with its zero padding; measured equal in
every pixel; held to 1e-5 where valid, the valid maps equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.cv import stereo as jstereo
from dynosam_tpu_torch.cv import stereo as tstereo
from torch_port_util import t

torch.set_num_threads(1)


def _rig(model):
    """A rectification with a rotated, distorted right camera."""
    dist_l = [0.05, -0.01, 0.001, -0.0005] if model == "radtan" else [0.02, -0.005, 0.001, 0.0]
    out = []
    for mod in (jstereo, tstereo):
        left = mod.MonoCalibration.create(300.0, 298.0, 80.5, 60.2, 160, 120, dist=dist_l, model=model)
        right = mod.MonoCalibration.create(302.0, 301.0, 79.0, 61.0, 160, 120,
                                           dist=[v * 0.5 for v in dist_l], model=model)
        out.append((left, right))
    T = np.eye(4)
    T[:3, :3] = jstereo._rodrigues(np.array([0.01, -0.02, 0.005]))
    T[:3, 3] = [0.54, 0.01, -0.005]
    return out, T


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_rectification_and_maps_match_reference(model):
    (jl_jr, tl_tr), T = _rig(model)
    ref = jstereo.stereo_rectify(*jl_jr, T)
    got = tstereo.stereo_rectify(*tl_tr, T)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    jcam, tcam = jstereo.StereoCamera(*jl_jr, T), tstereo.StereoCamera(*tl_tr, T, device="cpu")
    np.testing.assert_array_equal(tcam.map_left.numpy(), np.asarray(jcam.map_left))
    np.testing.assert_array_equal(tcam.map_right.numpy(), np.asarray(jcam.map_right))
    ji, ti = jcam.intrinsics(), tcam.intrinsics()
    for f in ("fx", "fy", "cx", "cy", "baseline"):
        assert float(getattr(ti, f)) == pytest.approx(float(getattr(ji, f)), rel=1e-7), f
    assert (ti.width, ti.height) == (160, 120)
    d = np.linspace(0.5, 40.0, 12).astype(np.float32)
    np.testing.assert_allclose(tcam.depth_from_disparity(t(d)).numpy(),
                               np.asarray(jcam.depth_from_disparity(jnp.asarray(d))), rtol=1e-6)


@pytest.mark.parametrize("channels", [0, 3])
def test_remap_bilinear_matches_reference(channels):
    rng = np.random.default_rng(0)
    shape = (40, 56) + ((channels,) if channels else ())
    img = rng.random(shape).astype(np.float32)
    src = np.stack([rng.uniform(-4, 60, (30, 50)), rng.uniform(-4, 44, (30, 50))], -1).astype(np.float32)
    ref = np.asarray(jstereo.remap_bilinear(jnp.asarray(img), jnp.asarray(src)))
    got = tstereo.remap_bilinear(t(img), t(src)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _stereo_pair(h, w, disp):
    """Left texture and the right image: the texture shifted left by `disp`."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def tex(xx):
        g = np.sin(xx * 0.37) * np.sin(y * 0.29) + 0.5 * np.sin(xx * 0.13 + y * 0.09) + 0.3 * np.sin(0.061 * xx)
        return ((g + 1.8) / 3.6).astype(np.float32)

    return tex(x), tex(x + disp)


def test_stereo_track_matches_reference():
    left, right = _stereo_pair(64, 200, 7.3)
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(0, 199, 256), rng.uniform(0, 63, 256)], -1).astype(np.float32)
    valid = rng.random(256) < 0.9
    kw = dict(levels=3, half=3, iters=8)
    rd, ru, rok = jstereo.stereo_track(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv),
                                       jnp.asarray(valid), 180.0, 0.54, **kw)
    gd, gu, gok = tstereo.stereo_track(t(left), t(right), t(uv), t(valid), 180.0, 0.54, **kw)
    rd, ru, rok = np.asarray(rd), np.asarray(ru), np.asarray(rok)
    gd, gu, gok = gd.numpy(), gu.numpy(), gok.numpy()
    assert (gok != rok).sum() <= 2 and rok.sum() > 100
    both = gok & rok
    np.testing.assert_allclose(gu[both], ru[both], atol=1e-3, rtol=0)
    np.testing.assert_allclose(gd[both], rd[both], rtol=1e-4)
    # the matches triangulate the rendered disparity
    assert np.median(np.abs(gd[both] / (180.0 * 0.54 / 7.3) - 1.0)) < 0.01


@pytest.mark.parametrize("subpixel", [True, False])
def test_dense_disparity_matches_reference(subpixel):
    left, right = _stereo_pair(48, 96, 9.0)
    kw = dict(num_disparities=24, block_size=5, subpixel=subpixel)
    rd, rv = jstereo.dense_disparity(jnp.asarray(left), jnp.asarray(right), **kw)
    gd, gv = tstereo.dense_disparity(t(left), t(right), **kw)
    rd, rv, gd, gv = np.asarray(rd), np.asarray(rv), gd.numpy(), gv.numpy()
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_allclose(gd, rd, atol=1e-5, rtol=0)
    assert rv.mean() > 0.5 and np.median(gd[gv]) == pytest.approx(9.0, abs=0.5)
    depth = tstereo.dense_stereo_depth(t(left), t(right), 180.0, 0.54, **kw).numpy()
    ref_depth = np.asarray(jstereo.dense_stereo_depth(jnp.asarray(left), jnp.asarray(right), 180.0, 0.54, **kw))
    np.testing.assert_allclose(depth, ref_depth, rtol=1e-6, atol=0)


def test_box_filter_pads_with_zeros_like_reduce_window():
    x = np.random.default_rng(2).random((3, 11, 13)).astype(np.float32)
    ref = np.stack([np.asarray(jstereo._box_filter(jnp.asarray(a), 2)) for a in x])
    got = tstereo._box_filter(t(x), 2).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)
    assert got[0, 0, 0] == pytest.approx(x[0, :3, :3].sum() / 25, rel=1e-6)
