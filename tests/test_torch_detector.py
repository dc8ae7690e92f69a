"""Parity of the port's detector stack with the JAX reference: the pure-Python
checkpoint reader against flax.serialization, YOLOv8-seg with the committed
weights against YoloV8Seg.apply, DFL decode, NMS (valid rows), mask
combination against the XLA path and the Pallas kernel in interpret mode,
the label image, the three resizes, the K2 wrapper's CPU contract, and the
engine end to end on a textured frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dynosam_tpu.nn import detector as jdet
from dynosam_tpu.nn import postprocess as jpp
from dynosam_tpu.nn import yolov8 as jyolo
from dynosam_tpu.ops.pallas.mask_combine import mask_combine_pallas
from dynosam_tpu_torch import bench_config as tbench
from dynosam_tpu_torch.nn import detector as tdet
from dynosam_tpu_torch.nn import postprocess as tpp
from dynosam_tpu_torch.nn import weights as tweights
from dynosam_tpu_torch.ops.cuda import mask_combine as mc
from torch_port_util import jax_dense, t

torch.set_num_threads(1)
H, W = 96, 160


@pytest.fixture(scope="module")
def checkpoint():
    """(flax variables as float32 jnp arrays, metadata, port model)."""
    with open(jdet.CKPT_PATH, "rb") as fh:
        tree = serialization.msgpack_restore(fh.read())
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    model, meta = tweights.load_flax_checkpoint(tdet.CKPT_PATH)
    return variables, meta, model


def test_checkpoint_path_is_the_reference_file():
    assert tdet.CKPT_PATH == jdet.CKPT_PATH


def test_reader_equals_flax_serialization():
    with open(jdet.CKPT_PATH, "rb") as fh:
        raw = fh.read()
    got = tweights.read_flax_msgpack(tdet.CKPT_PATH)
    ref = serialization.from_bytes(got, raw)        # flax's decode, restored into the same tree
    leaves = 0
    for (pg, g), (pr, r) in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves_with_path(ref)):
        assert pg == pr
        assert g.dtype == r.dtype and g.shape == r.shape, pg
        np.testing.assert_array_equal(g, r)
        leaves += 1
    assert leaves == len(jax.tree_util.tree_leaves(serialization.msgpack_restore(raw)))


def test_reader_rejects_unknown_extension(tmp_path):
    p = tmp_path / "bad.msgpack"
    p.write_bytes(bytes([0x81, 0xA1, 0x61, 0xD4, 0x05, 0x00]))   # {"a": fixext1 type 5}
    with pytest.raises(ValueError, match="extension type 5"):
        tweights.read_flax_msgpack(str(p))


def _image(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w, 3), np.float32)


@pytest.fixture(scope="module")
def forward(checkpoint):
    variables, meta, model = checkpoint
    x = _image(H, W)[None]
    jm = jyolo.YoloV8Seg(num_classes=meta["num_classes"], scale=meta["scale"])
    ref = jax.tree.map(np.asarray, jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = jax.tree.map(lambda a: a.numpy(), model(t(x)))
    return ref, got


@pytest.mark.parametrize("key", ["boxes", "cls", "mcoef", "proto"])
def test_yolov8_forward(forward, key):
    ref, got = forward
    refs = ref[key] if key != "proto" else [ref[key]]
    gots = got[key] if key != "proto" else [got[key]]
    for r, g in zip(refs, gots):
        assert g.shape == r.shape
        # f32 convolutions summed in another order through ~60 layers:
        # 1e-5 of the output's range (measured ~1e-6)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())


def _single(out):
    return {k: [a[0] for a in v] if isinstance(v, list) else v[0] for k, v in out.items()}


def test_decode_all(forward):
    ref, _ = forward
    single = _single(ref)
    jr = jpp.decode_all(jax.tree.map(jnp.asarray, single))
    tr = tpp.decode_all(jax.tree.map(t, single))
    for r, g in zip(jr, tr):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-4)


def _candidates(n=600, nc=3, seed=7):
    """A decoded candidate table: boxes clustered around 12 objects (so
    suppression chains form), random class scores, most under threshold."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform([20, 20], [620, 360], (12, 2))
    c = centres[rng.integers(0, 12, n)] + rng.normal(0, 4, (n, 2))
    wh = rng.uniform(20, 80, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = (rng.random((n, nc)) ** 3).astype(np.float32)
    return boxes, scores, rng.normal(size=(n, 32)).astype(np.float32)


@pytest.mark.parametrize("class_ids", [None, (1,)])
def test_nms_valid_rows(class_ids):
    boxes, scores, mcoef = _candidates()
    kw = dict(max_detections=32, score_threshold=0.25, iou_threshold=0.6, class_ids=class_ids)
    jd = jpp.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mcoef), **kw)
    td = tpp.nms(t(boxes), t(scores), t(mcoef), **kw)
    v = np.asarray(jd.valid)
    assert v.sum() > 0
    np.testing.assert_array_equal(td.valid.numpy(), v)   # survivors first, then padding
    for name in ("boxes", "scores", "classes", "mcoef"):
        np.testing.assert_array_equal(getattr(td, name).numpy()[v], np.asarray(getattr(jd, name))[v])


@pytest.mark.parametrize("case", ["overlaps", "chain"])
def test_nms_suppression_cases(case):
    if case == "overlaps":
        boxes = [[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]]
        thr = 0.5
    else:   # A>B and B>C overlap, A/C disjoint: greedy keeps A and C
        boxes = [[0, 0, 10, 10], [4, 0, 14, 10], [8, 0, 18, 10]]
        thr = 0.3
    b = np.asarray(boxes, np.float32)
    s = np.asarray([[0.9], [0.8], [0.7]], np.float32)
    m = np.zeros((3, 32), np.float32)
    kw = dict(max_detections=8, pre_topk=3, score_threshold=0.1, iou_threshold=thr, class_ids=None)
    jd = jpp.nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(m), **kw)
    td = tpp.nms(t(b), t(s), t(m), **kw)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(td.boxes.numpy(), np.asarray(jd.boxes))


def _proto_coef(k=5, hp=24, wp=40, nm=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(hp, wp, nm)).astype(np.float32), rng.normal(size=(k, nm)).astype(np.float32)


def test_mask_combine_plain_matches_xla_and_pallas():
    proto, coef = _proto_coef()
    got = mc.mask_combine_reference(t(proto), t(coef)).numpy()
    xla = np.asarray(jax.nn.sigmoid(jnp.asarray(coef) @ jnp.asarray(proto).reshape(-1, 32).T)).reshape(5, 24, 40)
    pallas = np.asarray(mask_combine_pallas(jnp.asarray(proto), jnp.asarray(coef), interpret=True))
    # sigmoid of f32 dot products of 32 terms: 1e-6 absolute
    np.testing.assert_allclose(got, xla, atol=1e-6)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


def test_mask_combine_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    proto, coef = _proto_coef()
    before = mc.mask_combine.launches
    torch.testing.assert_close(mc.mask_combine(t(proto), t(coef)),
                               mc.mask_combine_reference(t(proto), t(coef)), rtol=0, atol=0)
    assert mc.mask_combine.launches == before


@pytest.mark.parametrize("bad", ["float64", "coef_rank", "noncontiguous", "nm_mismatch"])
def test_mask_combine_rejects_what_the_kernel_does_not_take(bad):
    proto, coef = (t(a) for a in _proto_coef())
    args = {
        "float64": (proto.double(), coef),
        "coef_rank": (proto, coef.reshape(-1)),
        "noncontiguous": (proto.transpose(0, 1), coef),
        "nm_mismatch": (proto, coef[:, :16].contiguous()),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        mc.mask_combine(*args)


def _detections(boxes, valid, coef):
    k = len(valid)
    return dict(boxes=np.asarray(boxes, np.float32), scores=np.linspace(0.9, 0.5, k).astype(np.float32),
                classes=np.zeros(k, np.int32), mcoef=coef, valid=np.asarray(valid))


def test_combine_masks_matches_xla_path():
    proto, coef = _proto_coef()
    d = _detections([[0, 0, 160, 96], [10, 5, 80, 60], [100, 30, 150, 90], [0, 0, 160, 96],
                     [-5, -5, 40, 200]], [True, True, True, False, True], coef)
    ref = np.asarray(jpp.combine_masks(jpp.Detections(**{k: jnp.asarray(v) for k, v in d.items()}),
                                       jnp.asarray(proto), (96, 160), use_pallas=False, box_pad=0.0))
    got = tpp.combine_masks(tpp.Detections(**{k: t(v) for k, v in d.items()}), t(proto), (96, 160)).numpy()
    assert not got[3].any()
    # thresholding at 0.5 may flip a pixel whose probability is within f32
    # rounding of it: at most 1 in 10^4
    assert (got != ref).mean() <= 1e-4


@pytest.mark.parametrize("size", [(96, 160), (20, 30), (37, 61)])
def test_mask_upsample_x4_matches_jax(size):
    """The x4 bilinear upsample of combine_masks, edges included."""
    low = np.random.default_rng(3).random((4, *size), np.float32)
    out = (4 * size[0], 4 * size[1])
    ref = np.asarray(jax.image.resize(jnp.asarray(low), (4, *out), method="bilinear"))
    got = torch.nn.functional.interpolate(t(low)[None], size=out, mode="bilinear", align_corners=False)[0]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("src, dst", [((120, 200), (96, 160)), ((384, 1280), (96, 160)),
                                      ((61, 97), (96, 160)), ((96, 160), (96, 160))])
def test_input_resize_matches_jax(src, dst):
    """The engine's input resize: bilinear, antialiased when it shrinks."""
    img = _image(*src, seed=4)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (*dst, 3), method="bilinear"))
    got = tdet.resize_image(t(img), dst).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)


@pytest.mark.parametrize("src, dst", [((96, 160), (120, 200)), ((96, 160), (384, 1280)),
                                      ((96, 160), (61, 97)), ((96, 160), (96, 160))])
def test_label_resize_matches_jax(src, dst):
    """The engine's label resize back to the caller's size: nearest at
    half-pixel centres, source index floor((i + 0.5) m / n). Jitted JAX
    computes that position one f32 ulp low on the CPU, so where it is an
    exact integer (every 5th pixel at 160 -> 200) it takes the pixel before;
    the port takes the exact floor. Those pixels are held to the exact
    formula, all others to JAX."""
    lab = np.random.default_rng(5).integers(0, 9, src).astype(np.int32)
    ref = np.asarray(jax.image.resize(jnp.asarray(lab, jnp.float32), dst, method="nearest")).astype(np.int32)
    got = tdet.resize_labels(t(lab), dst).numpy()

    def exact(m, n):
        i = np.arange(n)
        return (2 * i + 1) * m // (2 * n), ((2 * i + 1) * m) % (2 * n) == 0

    (rows, r_int), (cols, c_int) = exact(src[0], dst[0]), exact(src[1], dst[1])
    np.testing.assert_array_equal(got, lab[rows][:, cols])
    off_grid = ~(r_int[:, None] | c_int[None, :])
    np.testing.assert_array_equal(got[off_grid], ref[off_grid])


def test_masks_to_label_image():
    rng = np.random.default_rng(6)
    masks = rng.random((5, 20, 30)) > 0.6
    scores = np.asarray([0.5, 0.9, 0.9, 0.3, 0.7], np.float32)    # a tie between 1 and 2
    ref = np.asarray(jpp.masks_to_label_image(jnp.asarray(masks), jnp.asarray(scores)))
    got = tpp.masks_to_label_image(t(masks), t(scores)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_engine_end_to_end_on_a_textured_frame(checkpoint):
    """Frame 0 of the detector scene (384 x 640, the checkpoint's camera)
    through both engines with the committed weights."""
    variables, meta, model = checkpoint
    _, intr = tbench.detector_config()
    scene = tbench.detector_scene(intr, num_frames=1, device="cpu")
    rgb = np.asarray(jax_dense(scene).frame(0).rgb)
    # the renderers agree on the textured frame
    np.testing.assert_allclose(scene.frame(0).rgb.numpy(), rgb, atol=1e-5)
    kw = dict(input_hw=(intr.height, intr.width), class_ids=None)
    jeng = jdet.YoloV8DetectorEngine(variables, num_classes=meta["num_classes"], scale=meta["scale"],
                                     use_pallas_masks=False, **kw)
    teng = tdet.YoloV8DetectorEngine(model, device="cpu", **kw)
    jlab, jd = jeng.detect(jnp.asarray(rgb))
    tlab, td = teng.detect(t(rgb))
    v = np.asarray(jd.valid)
    assert v.sum() >= 2
    np.testing.assert_array_equal(td.valid.numpy(), v)
    np.testing.assert_allclose(td.boxes.numpy()[v], np.asarray(jd.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy()[v], np.asarray(jd.scores)[v], atol=1e-5)
    # labels: equal but for pixels whose mask probability sits within f32
    # rounding of the threshold
    assert (tlab.numpy() != np.asarray(jlab)).mean() <= 1e-4


def test_engine_box_pad_matches_jax(checkpoint):
    """The engine with box_pad=2 (each box widened by 2 px before the mask
    crop) against JAX's YoloV8DetectorEngine(box_pad=2) on the textured
    frame, and the pad's effect against the unpadded engine."""
    variables, meta, model = checkpoint
    _, intr = tbench.detector_config()
    rgb = np.asarray(jax_dense(tbench.detector_scene(intr, num_frames=1, device="cpu")).frame(0).rgb)
    kw = dict(input_hw=(intr.height, intr.width), class_ids=None)
    jeng = jdet.YoloV8DetectorEngine(variables, num_classes=meta["num_classes"], scale=meta["scale"],
                                     use_pallas_masks=False, box_pad=2.0, **kw)
    teng = tdet.YoloV8DetectorEngine(model, device="cpu", box_pad=2.0, **kw)
    jlab, jd = jeng.detect(jnp.asarray(rgb))
    tlab, td = teng.detect(t(rgb))
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    # labels: equal but for pixels whose mask probability sits within f32
    # rounding of the threshold
    assert (tlab.numpy() != np.asarray(jlab)).mean() <= 1e-4
    unpadded = tdet.YoloV8DetectorEngine(model, device="cpu", **kw).process(t(rgb))
    assert int((tlab != unpadded).sum()) > 0
