"""The port's dataset reading against the JAX reference: the numpy/zlib PNG
decoder against OpenCV (every fixture PNG, and synthetic PNGs of every row
filter), the .flo / txt-mask / disparity parsers against the reference's
native library, the KITTI provider's frames and ground truth bit for bit,
the simulator's ground truth and its backend packets, and the dataset
factory."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from dynosam_tpu import native as jnative
from dynosam_tpu.dataproviders.kitti import KittiDataProvider as JaxKitti
from dynosam_tpu.dataproviders.simulator import Scenario as JaxScenario
from dynosam_tpu.dataproviders.simulator import ScenarioSpec as JaxScenarioSpec
from dynosam_tpu_torch import native
from dynosam_tpu_torch.dataproviders.base import DatasetType, create_dataset
from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider
from dynosam_tpu_torch.dataproviders.simulator import Scenario, ScenarioSpec
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario
from dynosam_tpu_torch.convert import dataclass_to_numpy
from torch_port_util import assert_tree_matches, jax_spec, np_tree, port_spec, reference_native, scenario_uniforms

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "kitti_fixture")


def _fixture_pngs(folder):
    d = os.path.join(FIXTURE, folder)
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".png")]


@pytest.mark.parametrize("folder", ["image_0", "depth"])
def test_png_decoder_equals_opencv_on_the_fixture(folder):
    paths = _fixture_pngs(folder)
    assert len(paths) == 60
    for p in paths:
        got = native.read_png(p)
        if folder == "image_0":
            ref = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        else:
            ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert got.dtype == ref.dtype and got.shape == ref.shape, p
        np.testing.assert_array_equal(got, ref, err_msg=p)


# ---------------------------------------------------------------------------
# synthetic PNGs, written here with zlib, one row filter (or all in turn)

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filter_row(ftype, row, prev, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


def _chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def _write_png(path, img, filters, colour=None, depth=None, interlace=0):
    h, w = img.shape[:2]
    if img.dtype == np.uint16:
        raw, bpp = img.astype(">u2").tobytes(), 2
        depth, colour = depth or 16, 0 if colour is None else colour
    else:
        raw, bpp = img.astype(np.uint8).tobytes(), img.shape[2] if img.ndim == 3 else 1
        depth, colour = depth or 8, (2 if img.ndim == 3 else 0) if colour is None else colour
    stride = w * bpp
    prev = bytes(stride)
    data = b""
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        data += _filter_row(filters[y % len(filters)], row, prev, bpp)
        prev = row
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_decoder_every_row_filter(tmp_path, kind, filters):
    rng = np.random.default_rng(len(filters) * 10 + filters[0])
    if kind == "rgb8":
        img = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
        img[2] = img[1]                                  # runs that the filters flatten
    else:
        img = rng.integers(0, 65536, (7, 9), dtype=np.uint16)
        img[:, 3] = 65535
    path = str(tmp_path / "t.png")
    _write_png(path, img, filters)
    got = native.read_png(path)
    np.testing.assert_array_equal(got, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if kind == "rgb8":
        ref = cv2.cvtColor(ref, cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got, ref)


def test_png_decoder_rejects_other_formats(tmp_path):
    """What the decoder does not read raises ValueError: an invalid bit
    depth for the colour type, an unknown colour type, interlace method 2,
    a palette PNG without PLTE, a tRNS chunk on a non-palette PNG, a bad
    signature or CRC, an unknown row filter. (RGBA, 8-bit grey, 16-bit RGB
    and Adam7 are read: tests/test_torch_codecs.py.)"""
    cases = {
        "rgb4": dict(img=np.zeros((3, 4, 3), np.uint8), depth=4),
        "colour5": dict(img=np.zeros((3, 4), np.uint8), colour=5),
        "interlace2": dict(img=np.zeros((3, 4, 3), np.uint8), interlace=2),
        "palette_no_plte": dict(img=np.zeros((3, 4), np.uint8), colour=3),
    }
    for name, kw in cases.items():
        path = str(tmp_path / f"{name}.png")
        _write_png(path, kw.pop("img"), [0], **kw)
        with pytest.raises(ValueError):
            native.read_png(path)
    good = str(tmp_path / "good.png")
    _write_png(good, np.zeros((3, 4, 3), np.uint8), [0])
    data = bytearray(open(good, "rb").read())
    for name, edit in {"signature": (0, 0x00), "crc": (40, data[40] ^ 0xFF)}.items():
        bad = bytearray(data)
        bad[edit[0]] = edit[1]
        path = str(tmp_path / f"bad_{name}.png")
        open(path, "wb").write(bytes(bad))
        with pytest.raises(ValueError):
            native.read_png(path)
    # a tRNS chunk on an RGB PNG
    path = str(tmp_path / "trns.png")
    open(path, "wb").write(bytes(data[:33]) + _chunk(b"tRNS", bytes(6)) + bytes(data[33:]))
    with pytest.raises(ValueError, match="tRNS"):
        native.read_png(path)
    # an unknown row filter
    path = str(tmp_path / "filter5.png")
    ihdr = struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0)
    open(path, "wb").write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                           + _chunk(b"IDAT", zlib.compress(bytes([5, 1, 2, 3])))
                           + _chunk(b"IEND", b""))
    with pytest.raises(ValueError):
        native.read_png(path)


def test_parsers_equal_the_native_library(tmp_path):
    reference_native(tmp_path)
    assert jnative.available()
    h, w = 96, 320
    for k in (0, 29, 58):
        flo = os.path.join(FIXTURE, "flow", f"{k:06d}.flo")
        np.testing.assert_array_equal(native.read_flo(flo, h, w), jnative.read_flo(flo, h, w))
        txt = os.path.join(FIXTURE, "motion", f"{k:06d}.txt")
        np.testing.assert_array_equal(native.read_txt_mask(txt, h, w), jnative.read_txt_mask(txt, h, w))
        raw = cv2.imread(os.path.join(FIXTURE, "depth", f"{k:06d}.png"), cv2.IMREAD_UNCHANGED)
        for base_line, scale in ((99.8581314086914, 256.0), (387.5744, 100.0)):
            got = native.disparity_to_depth(raw, base_line, scale)
            ref = jnative.disparity_to_depth(raw, base_line, scale)
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    with pytest.raises(ValueError):
        native.read_flo(os.path.join(FIXTURE, "flow", "000000.flo"), h, w + 1)
    with pytest.raises(ValueError):
        native.read_txt_mask(os.path.join(FIXTURE, "motion", "000000.txt"), h, w + 1)


@pytest.fixture(scope="module")
def providers():
    return JaxKitti(FIXTURE), KittiDataProvider(FIXTURE, device="cpu")


def test_provider_metadata_matches_reference(providers):
    j, t = providers
    assert len(t) == len(j) == 60
    assert (t.base_line, t.depth_scale_factor, t.mask_folder) == (j.base_line, j.depth_scale_factor, j.mask_folder)
    ji, ti = j.intrinsics(), t.intrinsics()
    for f in ("fx", "fy", "cx", "cy"):
        assert getattr(ti, f) == float(np.float32(getattr(ji, f)))
    assert (ti.width, ti.height) == (int(ji.width), int(ji.height)) == (320, 96)
    assert ti.baseline == pytest.approx(float(ji.baseline), rel=1e-6)


@pytest.mark.parametrize("k", [0, 1, 30, 59])
def test_frames_and_ground_truth_bit_for_bit(providers, k):
    j, t = providers
    jf, tf = j.frame(k), t.frame(k)
    for name in ("frame_id", "rgb", "depth", "flow", "mask"):
        a, b = np.asarray(getattr(jf, name)), getattr(tf, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
        assert getattr(tf, name).device.type == "cpu"
    jg, tg = j.ground_truth(k), t.ground_truth(k)
    for name in ("X_world_cam", "object_ids", "object_poses", "object_motions", "object_valid"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name)
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_padding_matches_reference():
    j = JaxKitti(FIXTURE, pad_to_multiple=64)
    t = KittiDataProvider(FIXTURE, pad_to_multiple=64, device="cpu")
    assert (t.intrinsics().height, t.intrinsics().width) == (128, 320)
    jf, tf = j.frame(3), t.frame(3)
    for name in ("rgb", "depth", "flow", "mask"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)))


def test_frame_host_is_the_frame_on_the_host():
    t = KittiDataProvider(FIXTURE, device="cpu")
    a, b = t.frame_host(7), t.frame(7)
    for name in ("frame_id", "rgb", "depth", "flow", "mask"):
        assert torch.equal(getattr(a, name), getattr(b, name))


def test_simulator_ground_truth_matches_reference():
    scene = default_dense_scenario(num_frames=5, device="cpu")
    jscn = JaxScenario(jax_spec(scene.scn.spec))
    for k in (0, 3):
        jg, tg = jscn.ground_truth(k, max_objects=6), scene.scn.ground_truth(k, max_objects=6)
        np.testing.assert_array_equal(tg.object_ids, np.asarray(jg.object_ids))
        np.testing.assert_array_equal(tg.object_valid, np.asarray(jg.object_valid))
        for name in ("X_world_cam", "object_poses", "object_motions"):
            np.testing.assert_allclose(getattr(tg, name), np.asarray(getattr(jg, name)), atol=1e-5)


@pytest.mark.parametrize("max_objects", [4, 16])
def test_simulator_packets_match_reference(max_objects):
    """default_two_objects' VisionPackets (the backend harness), the port
    drawing its landmark clouds from the reference's uniforms: ids, masks
    and visibility equal, pixels within 2e-3 px and depths within 1e-5 m
    (the pose chains are f32 products in another order)."""
    jspec = JaxScenarioSpec.default_two_objects(num_frames=6)
    spec = ScenarioSpec.default_two_objects(num_frames=6)
    for a, b in ((port_spec(jspec), spec), (port_spec(jspec).objects[1], spec.objects[1])):
        for name, v in vars(a).items():
            if name != "objects":
                np.testing.assert_array_equal(np.asarray(getattr(b, name)), np.asarray(v), err_msg=name)
    jscn = JaxScenario(jspec)
    scn = Scenario(spec, device="cpu", uniforms=scenario_uniforms(jspec))
    assert scn.num_dynamic_points() == jscn.num_dynamic_points() == 96
    packets = scn.packets(max_objects)
    assert len(packets) == 6
    for k, got in enumerate(packets):
        ref = np_tree(jscn.measurements(k, max_objects))
        got = dataclass_to_numpy(got)
        for table in ("static_tracks", "dynamic_tracks"):
            for name in ("uv", "depth"):
                r, g = ref[table].pop(name), got[table].pop(name)
                np.testing.assert_allclose(g, r, rtol=1e-6, atol=2e-3 if name == "uv" else 1e-5,
                                           err_msg=f"{k} {table}.{name}")
        assert_tree_matches(ref, got, atol=1e-5, rtol=1e-6)
        assert int(got["dynamic_tracks"]["valid"].sum()) > 60


def test_create_dataset():
    ds = create_dataset(0, FIXTURE, device="cpu")
    assert isinstance(ds, KittiDataProvider) and ds.device == torch.device("cpu")
    # every on-disk type has a reader now (tests/test_torch_datasets.py opens
    # each on its own format); on the KITTI fixture each either opens or
    # fails for want of its own files, never as unported
    for t in DatasetType:
        if t == DatasetType.SYNTHETIC:
            continue
        try:
            create_dataset(int(t), FIXTURE, device="cpu")
        except (OSError, IndexError, ValueError, StopIteration):
            pass
    with pytest.raises(NotImplementedError):
        create_dataset(100, FIXTURE, device="cpu")
    # png masks are read; the fixture has txt masks only
    with pytest.raises(FileNotFoundError, match="000000.png"):
        KittiDataProvider(FIXTURE, mask_format="png", device="cpu").frame(0)
