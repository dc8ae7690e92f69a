"""The reference's public helpers that no pipeline path calls, each against
its JAX twin on the same inputs (numpy, `default_rng(0)`): the camera's
`backproject_uvz`, `bearing`, `depth_to_disparity`, `disparity_to_depth`
and `CameraIntrinsics.matrix`; `interp.sample_bilinear` (grey and colour
images, points past every border); `kabsch.alignment_error`;
`yolov8.init_params` / `strides_for` (the port's state dict has the
reference's parameters name for name and shape for shape, through
nn/weights.py's flax mapping); the detector's `load_checkpoint` (the
committed checkpoint's parameters, equal leaf for leaf, and its metadata);
`DynoConfig.to_dict`; `TrackTable.empty` /
`.capacity`, `VisionPacket.empty`; and `imu.Pim.identity`. Floats within
1e-6 of the reference's (1e-4 + 1e-5 relative for the bilinear samples of a
0-255 image, 1e-5 for the alignment errors of 5 m points), integers, bools
and shapes equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dynosam_tpu import config as jconfig
from dynosam_tpu.cv import camera as jcam
from dynosam_tpu.frontend import imu as jimu
from dynosam_tpu.frontend import types as jtypes
from dynosam_tpu.ops import interp as jinterp
from dynosam_tpu.ops import kabsch as jkabsch
from dynosam_tpu_torch.cv import camera as tcam
from dynosam_tpu_torch.frontend import imu as timu
from dynosam_tpu_torch.frontend import types as ttypes
from dynosam_tpu_torch.nn import weights as tweights
from dynosam_tpu_torch.nn import yolov8 as tyolo
from dynosam_tpu_torch.ops import interp as tinterp
from dynosam_tpu_torch.ops import kabsch as tkabsch
from dynosam_tpu_torch.utils import lie as tlie
from torch_port_util import port_cfg, small_cfg, t

torch.set_num_threads(1)
TOL = 1e-6
INTR = dict(fx=410.5, fy=405.25, cx=318.0, cy=241.5, width=640, height=480, baseline=0.12)


def _close(got, ref, atol=TOL, rtol=0.0):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def _intr():
    return jcam.CameraIntrinsics.create(**INTR), tcam.CameraIntrinsics.create(**INTR)


def _uv(rng, n=(5, 7)):
    return np.stack([rng.uniform(-20.0, 660.0, n), rng.uniform(-20.0, 500.0, n)], -1).astype(np.float32)


def case_backproject_uvz(rng):
    ji, ti = _intr()
    uvz = np.concatenate([_uv(rng), rng.uniform(0.5, 40.0, (5, 7, 1))], -1).astype(np.float32)
    _close(tcam.backproject_uvz(t(uvz), ti), jcam.backproject_uvz(jnp.asarray(uvz), ji))


def case_bearing(rng):
    ji, ti = _intr()
    uv = _uv(rng)
    got = tcam.bearing(t(uv), ti)
    _close(got, jcam.bearing(jnp.asarray(uv), ji))
    _close(torch.linalg.norm(got, dim=-1), np.ones((5, 7), np.float32))


def case_depth_to_disparity(rng):
    ji, ti = _intr()
    depth = rng.uniform(0.0, 60.0, (4, 9)).astype(np.float32)
    depth[0, :3] = [0.0, 1e-8, -1.0]             # clamped like the reference
    _close(tcam.depth_to_disparity(t(depth), ti), jcam.depth_to_disparity(jnp.asarray(depth), ji), rtol=1e-6)


def case_disparity_to_depth(rng):
    ji, ti = _intr()
    disparity = rng.uniform(0.0, 120.0, (4, 9)).astype(np.float32)
    disparity[0, :3] = [0.0, 1e-8, -1.0]         # clamped like the reference
    _close(tcam.disparity_to_depth(t(disparity), ti), jcam.disparity_to_depth(jnp.asarray(disparity), ji),
           rtol=1e-6)


def case_intrinsics_matrix(rng):
    ji, ti = _intr()
    _close(ti.matrix(device="cpu"), ji.matrix())


def _bilinear(rng, channels):
    shape = (48, 64) if channels is None else (48, 64, channels)
    img = rng.uniform(0.0, 255.0, shape).astype(np.float32)
    uv = np.stack([rng.uniform(-5.0, 70.0, (6, 11)), rng.uniform(-5.0, 54.0, (6, 11))], -1).astype(np.float32)
    uv[0, :4] = [[0.0, 0.0], [63.0, 47.0], [63.5, 10.0], [-3.0, 47.9]]
    _close(tinterp.sample_bilinear(t(img), t(uv)), jinterp.sample_bilinear(jnp.asarray(img), jnp.asarray(uv)),
           atol=1e-4, rtol=1e-5)


def case_sample_bilinear(rng):
    _bilinear(rng, None)
    _bilinear(rng, 3)


def case_alignment_error(rng):
    xi = rng.normal(0.0, 0.4, (3, 6)).astype(np.float32)
    T = tlie.se3_exp(t(xi))
    p = rng.normal(0.0, 5.0, (3, 20, 3)).astype(np.float32)
    q = p + rng.normal(0.0, 0.1, p.shape).astype(np.float32)
    _close(tkabsch.alignment_error(T, t(p), t(q)),
           jkabsch.alignment_error(jnp.asarray(T.numpy()), jnp.asarray(p), jnp.asarray(q)), atol=1e-5)


def case_yolov8_init_params(rng):
    from dynosam_tpu.nn import yolov8 as jyolo

    hw = (64, 96)
    jmodel, variables = jyolo.init_params(jax.random.PRNGKey(0), num_classes=3, scale="t", input_hw=hw)
    ref = tweights.state_dict_from_flax(serialization.to_state_dict(variables))
    model, sd = tyolo.init_params(0, num_classes=3, scale="t", input_hw=hw, device="cpu")
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert tuple(sd[k].shape) == tuple(ref[k].shape), k
    # the seed decides the weights; the global generator is left alone
    state = torch.random.get_rng_state()
    _, again = tyolo.init_params(0, num_classes=3, scale="t", device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    assert tuple(tyolo.strides_for(hw)) == tuple(jyolo.strides_for(hw))
    out = model.eval()(torch.zeros((1, hw[0], hw[1], 3)))
    jout = jmodel.apply(variables, jnp.zeros((1, hw[0], hw[1], 3)))
    assert tuple(out["proto"].shape) == tuple(jout["proto"].shape)


def case_detector_load_checkpoint(rng):
    from dynosam_tpu.nn import detector as jdetector
    from dynosam_tpu_torch.nn import detector as tdetector

    params, meta = tdetector.load_checkpoint()
    jparams, jmeta = jdetector.load_checkpoint()
    assert meta == jmeta
    ref = tweights.state_dict_from_flax(serialization.to_state_dict(jparams))
    got = {k: v for k, v in params.items() if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu", k
        _close(got[k], ref[k].numpy(), atol=0.0)
    model = tyolo.YoloV8Seg(num_classes=meta["num_classes"], scale=meta["scale"])
    model.load_state_dict(params, strict=True)


def case_config_to_dict(rng):
    j = small_cfg()
    assert port_cfg(j).to_dict() == j.to_dict()
    assert jconfig.DynoConfig().to_dict() == type(port_cfg(j))().to_dict()


def case_track_table_empty(rng):
    got, ref = ttypes.TrackTable.empty(11, device="cpu"), jtypes.TrackTable.empty(11)
    for f in dataclasses.fields(ttypes.TrackTable):
        _close(getattr(got, f.name), getattr(ref, f.name))
    assert got.capacity == ref.capacity == 11


def case_vision_packet_empty(rng):
    got, ref = ttypes.VisionPacket.empty(7, 5, 3, device="cpu"), jtypes.VisionPacket.empty(7, 5, 3)
    for f in dataclasses.fields(ttypes.VisionPacket):
        g, r = getattr(got, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(g):
            for ff in dataclasses.fields(g):
                _close(getattr(g, ff.name), getattr(r, ff.name))
        else:
            _close(g, r)


def case_pim_identity(rng):
    got, ref = timu.Pim.identity(device="cpu"), jimu.Pim.identity()
    for f in dataclasses.fields(timu.Pim):
        _close(getattr(got, f.name), getattr(ref, f.name))


CASES = [name[len("case_"):] for name in list(globals()) if name.startswith("case_")]


@pytest.mark.parametrize("case", CASES)
def test_helper_matches_reference(case):
    globals()[f"case_{case}"](np.random.default_rng(0))
