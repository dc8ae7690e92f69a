"""Parity of the port's one-step label image (K2's entry B on the card, its
plain composition here) with the JAX reference's pair
`combine_masks` + `masks_to_label_image` (nn/postprocess.py, XLA path),
with `box_pad` 0 and 2; the K2 wrapper's CPU contract for the network's
NCHW prototype view; and the detector checkpoint's held-out evaluation
(scripts/train_detector.py eval_iou) on three scenes on both sides.

Label images are compared under the rule chip_smoke.py holds the kernel
to: equal at every pixel but those where some valid detection, inside its
padded box, has an interpolated mask value within NEAR of the threshold
(JAX resizes with a weight matrix, the port with PyTorch's bilinear
kernel, so values there round either way); those may be at most 1e-4 of
the pixels."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dynosam_tpu.nn import detector as jdet
from dynosam_tpu.nn import postprocess as jpp
from dynosam_tpu_torch import bench_config as tbench
from dynosam_tpu_torch.eval import detector_heldout as dh
from dynosam_tpu_torch.nn import detector as tdet
from dynosam_tpu_torch.nn import postprocess as tpp
from dynosam_tpu_torch.ops.cuda import mask_combine as mc
from torch_port_util import t

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import train_detector  # noqa: E402  (the reference's scene generator and eval loop)

torch.set_num_threads(1)
NEAR = 1e-5
NEAR_SHARE = 1e-4


def _jax_pair(d, proto, out_hw, box_pad, thr=0.5):
    """JAX's label image and its interpolated mask values (K, H, W)."""
    jd = jpp.Detections(**{k: jnp.asarray(v) for k, v in d.items()})
    masks = jpp.combine_masks(jd, jnp.asarray(proto), out_hw, mask_threshold=thr, use_pallas=False,
                              box_pad=box_pad)
    label = np.asarray(jpp.masks_to_label_image(masks, jd.scores))
    low = jax.nn.sigmoid(jd.mcoef @ jnp.asarray(proto).reshape(-1, proto.shape[-1]).T)
    vals = jax.image.resize(low.reshape(-1, *proto.shape[:2]), (low.shape[0], *out_hw), method="bilinear")
    return label, np.asarray(vals)


def _near(d, vals, out_hw, box_pad, thr=0.5):
    """(H, W) pixels where a valid detection inside its padded box lies
    within NEAR of the threshold."""
    H, W = out_hw
    ys, xs = np.arange(H, dtype=np.float32)[:, None], np.arange(W, dtype=np.float32)[None, :]
    near = np.zeros((H, W), bool)
    pad = np.float32(box_pad)
    for k, (x1, y1, x2, y2) in enumerate(d["boxes"]):
        if not d["valid"][k]:
            continue
        inside = (xs >= x1 - pad) & (xs <= x2 + pad) & (ys >= y1 - pad) & (ys <= y2 + pad)
        near |= inside & (np.abs(vals[k] - thr) <= NEAR)
    return near


def assert_labels_agree(got, ref, near):
    differ = got != ref
    assert not (differ & ~near).any(), f"{int((differ & ~near).sum())} pixels differ away from the threshold"
    assert near.mean() <= NEAR_SHARE


def _random_case(K, hp, wp, H, W, seed):
    """Random prototypes and coefficients, boxes crossing the border and
    each other, a fifth of the rows invalid (their coefficients NaN), and
    rows 1 and 3 overlapping with equal scores."""
    rng = np.random.default_rng(seed)
    proto = rng.normal(size=(hp, wp, 32)).astype(np.float32)
    coef = rng.normal(size=(K, 32)).astype(np.float32)
    c = rng.uniform(-0.1, 1.1, (K, 2)) * [W, H]
    wh = rng.uniform(0.05, 0.6, (K, 2)) * [W, H]
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes[3] = boxes[1] + np.float32(5.0)          # the tied pair overlaps
    scores = rng.uniform(0.3, 1.0, K).astype(np.float32)
    scores[3] = scores[1]
    valid = rng.random(K) > 0.2
    valid[[1, 3]] = True
    coef[~valid] = np.nan
    d = dict(boxes=boxes, scores=np.where(valid, scores, 0).astype(np.float32),
             classes=np.where(valid, 0, -1).astype(np.int32), mcoef=coef, valid=valid)
    return d, proto


@pytest.fixture(scope="module")
def frame0():
    """The detector scene's frame 0 through the port's network and NMS on
    the CPU: its detection table and the prototypes as the network returns
    them (a (96, 160, 32) view)."""
    _, intr = tbench.detector_config()
    rgb = tbench.detector_scene(intr, 1, device="cpu").frame(0).rgb
    eng = tdet.YoloV8DetectorEngine(device="cpu")
    with torch.no_grad():
        out = eng.model(rgb[None])
        single = {k: [a[0] for a in v] if isinstance(v, list) else v[0] for k, v in out.items()}
        det = tpp.nms(*tpp.decode_all(single), max_detections=eng.max_detections,
                      score_threshold=eng.score_threshold, iou_threshold=eng.iou_threshold,
                      class_ids=eng.class_ids)
    d = {k: getattr(det, k).numpy() for k in ("boxes", "scores", "classes", "mcoef", "valid")}
    return d, single["proto"]


@pytest.mark.parametrize("box_pad", [0.0, 2.0])
@pytest.mark.parametrize("case", ["frame0", "ragged", "random"])
def test_mask_label_matches_the_jax_pair(frame0, case, box_pad):
    if case == "frame0":
        d, proto_t = frame0
        assert d["valid"].sum() >= 2
        out_hw = (384, 640)
    elif case == "ragged":
        d, proto = _random_case(5, 37, 61, 148, 244, seed=1)
        proto_t, out_hw = t(proto), (148, 244)
    else:
        d, proto = _random_case(32, 96, 160, 384, 640, seed=2)
        proto_t, out_hw = t(proto), (384, 640)
    proto = proto_t.numpy()
    ref, vals = _jax_pair(d, proto, out_hw, box_pad)
    near = _near(d, vals, out_hw, box_pad)
    td = tpp.Detections(**{k: t(v) for k, v in d.items()})
    plain = mc.mask_label_reference(proto_t, td.mcoef, td.boxes, td.scores, td.valid, out_hw,
                                    box_pad=box_pad).numpy()
    before = mc.mask_label.launches
    got = tpp.mask_label_image(td, proto_t, out_hw, box_pad=box_pad).numpy()
    assert mc.mask_label.launches == before
    assert got.dtype == np.int32 and got.shape == out_hw
    np.testing.assert_array_equal(got, plain)
    assert_labels_agree(got, ref, near)
    assert len(np.unique(ref)) >= 3


def test_combine_masks_box_pad_matches_jax():
    d, proto = _random_case(8, 24, 40, 96, 160, seed=3)
    jd = jpp.Detections(**{k: jnp.asarray(v) for k, v in d.items()})
    ref = np.asarray(jpp.combine_masks(jd, jnp.asarray(proto), (96, 160), use_pallas=False, box_pad=2.0))
    td = tpp.Detections(**{k: t(v) for k, v in d.items()})
    got = tpp.combine_masks(td, t(proto), (96, 160), box_pad=2.0).numpy()
    unpadded = tpp.combine_masks(td, t(proto), (96, 160)).numpy()
    assert (got & ~unpadded).any()                 # the pad widens some crop
    _, vals = _jax_pair(d, proto, (96, 160), 2.0)
    near = np.stack([np.abs(v - 0.5) <= NEAR for v in vals])
    assert not ((got != ref) & ~near).any()


def test_wrappers_take_the_networks_nchw_view_on_the_cpu_and_count_nothing():
    rng = np.random.default_rng(4)
    nchw = t(rng.normal(size=(1, 32, 24, 40)).astype(np.float32))
    view = nchw.permute(0, 2, 3, 1)[0]                      # (24, 40, 32), strides (40, 1, 960)
    assert view.stride() == (40, 1, 960)
    assert mc.proto_strides(view) == (1, 960)
    assert mc.proto_strides(view.contiguous()) == (32, 1)
    d, _ = _random_case(6, 24, 40, 96, 160, seed=5)
    td = tpp.Detections(**{k: t(v) for k, v in d.items()})
    before = (mc.mask_combine.launches, mc.mask_label.launches)
    torch.testing.assert_close(mc.mask_combine(view, td.mcoef), mc.mask_combine(view.contiguous(), td.mcoef),
                               rtol=0, atol=0, equal_nan=True)
    a = mc.mask_label(view, td.mcoef, td.boxes, td.scores, td.valid, (96, 160), box_pad=2.0)
    b = mc.mask_label(view.contiguous(), td.mcoef, td.boxes, td.scores, td.valid, (96, 160), box_pad=2.0)
    assert torch.equal(a, b)
    assert (mc.mask_combine.launches, mc.mask_label.launches) == before


@pytest.mark.parametrize("view", ["channels_strided", "interleaved_unaligned"])
def test_proto_views_other_than_the_two_layouts_are_refused(view):
    """Neither planar (pixel stride 1) nor interleaved (channel stride 1,
    pixel stride a multiple of 4, 16-byte aligned): both entries refuse."""
    g = torch.Generator().manual_seed(7)
    proto = {"channels_strided": torch.randn((8, 16, 64), generator=g)[:, :, ::2],
             "interleaved_unaligned": torch.randn((8 * 16 * 32 + 1,), generator=g)[1:].view(8, 16, 32)}[view]
    coef = torch.randn((4, 32), generator=g)
    boxes, scores, valid = torch.zeros((4, 4)), torch.zeros(4), torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        mc.proto_strides(proto)
    with pytest.raises(ValueError):
        mc.mask_combine(proto, coef)
    with pytest.raises(ValueError):
        mc.mask_label(proto, coef, boxes, scores, valid, (32, 64))
    assert mc.proto_strides(proto.clone(memory_format=torch.contiguous_format)) == (32, 1)


@pytest.mark.parametrize("bad", ["stride", "boxes_shape", "valid_dtype", "scores_float64", "coef_noncontiguous"])
def test_mask_label_rejects_what_the_kernel_does_not_take(bad):
    d, proto = _random_case(6, 24, 40, 96, 160, seed=6)
    p, c, b, s, v = t(proto), t(d["mcoef"]), t(d["boxes"]), t(d["scores"]), t(d["valid"])
    args = {
        "stride": (p.transpose(0, 1), c, b, s, v),
        "boxes_shape": (p, c, b[:, :3].contiguous(), s, v),
        "valid_dtype": (p, c, b, s, v.to(torch.uint8)),
        "scores_float64": (p, c, b, s.double(), v),
        "coef_noncontiguous": (p, c.T.contiguous().T, b, s, v),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        mc.mask_label(*args, (96, 160))


@pytest.fixture(scope="module")
def jax_heldout_variables():
    """The committed checkpoint's variables, as eval_iou takes them."""
    with open(jdet.CKPT_PATH, "rb") as fh:
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), serialization.msgpack_restore(fh.read()))


def test_heldout_scenes_match_the_reference(jax_heldout_variables):
    """The first three held-out scenes: the reference's eval_iou and the
    port's evaluate give the same totals, the port's draws equal the
    reference's, and each instance's IoU and class hit agree."""
    n = 3
    miou, cacc, count, extra = train_detector.eval_iou(jax_heldout_variables, num_scenes=n)
    got = dh.evaluate(n, device="cpu")
    assert got["instances"] == count >= 5
    assert got["class_accuracy"] == cacc
    # a label pixel may flip where a mask value sits within f32 rounding of
    # the threshold: IoUs agree to 1e-3 (an instance has >= 40 pixels)
    np.testing.assert_allclose(got["mean_mask_iou"], miou, atol=1e-3)
    np.testing.assert_allclose(got["mean_detected_iou"], extra["mean_detected_iou"], atol=1e-3)
    assert got["missed_rate"] == extra["missed_rate"]

    # per instance: the reference's scenes through eval_iou's engine, scored
    # as eval_iou scores them
    engine = jdet.YoloV8DetectorEngine(jax_heldout_variables, num_classes=train_detector.NUM_CLASSES,
                                       scale=train_detector.SCALE, input_hw=(dh.IMG_H, dh.IMG_W),
                                       max_detections=8, score_threshold=0.25, class_ids=None,
                                       use_pallas_masks=False)
    rng = np.random.default_rng(dh.SEED)
    ious, hits = [], []
    for _ in range(n):
        scn = train_detector.random_scene(rng)
        cm = train_detector._cls_of_oid(scn)
        fr = scn.frame(int(rng.integers(0, scn.scn.spec.num_frames)))
        label, det = engine.detect(jnp.asarray(fr.rgb))
        i, h = dh.score_frame(np.asarray(fr.mask), np.asarray(label), np.asarray(det.classes), cm)
        ious += i
        hits += h
    prng, jrng = np.random.default_rng(dh.SEED), np.random.default_rng(dh.SEED)
    for _ in range(n):
        ps, js = dh.random_scene(prng, device="cpu"), train_detector.random_scene(jrng)
        assert ps.object_classes == js.object_classes and ps.obj_extents == js.obj_extents
        assert ps.ground_y == js.ground_y and ps.far_depth == js.far_depth
        assert int(prng.integers(0, 4)) == int(jrng.integers(0, 4))
    assert got["instances"] == len(ious)
    np.testing.assert_array_equal(got["class_hit"], hits)
    np.testing.assert_allclose(got["iou"], ious, atol=1e-3)
