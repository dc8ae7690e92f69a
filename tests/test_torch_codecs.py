"""The port's image codecs (dynosam_tpu_torch/native.py PNG,
dynosam_tpu_torch/jpeg.py baseline JPEG) against OpenCV and PIL, and the
golden byte-level cases of tests/test_golden_decode.py on the port's
functions.

Tolerances: none. Every case is held to equality:
  * the PNG decoder equals cv2.imread (IMREAD_UNCHANGED and the default
    flag, both channel orders) and PIL's "P" indices on every colour type
    and bit depth, Adam7 or not, every row filter; write_png reads back
    equal through cv2 and PIL;
  * the JPEG decoder equals cv2.imdecode pixel for pixel (libjpeg-turbo's
    islow IDCT, fancy upsampling and fixed-point colour tables) at quality
    75 / 90 / 98, sampling 4:4:4 / 4:2:2 / 4:2:0, grey, a restart interval,
    sizes 375x1242 down to 2x3;
  * the JPEG encoder writes the bytes cv2.imwrite writes (so cv2's decode
    of the two files is equal);
  * the progressive decoder (spectral selection, successive approximation,
    end-of-band runs) equals cv2.imdecode pixel for pixel on the files
    cv2.imwrite writes with IMWRITE_JPEG_PROGRESSIVE: quality 50 / 75 / 90
    / 100, sampling 4:4:4 / 4:2:2 / 4:2:0, grey, a restart interval, sizes
    375x1242 down to 1x1; and a Virtual KITTI 2 frame whose rgb is
    re-encoded progressive reads equal through the JAX reader and the
    port's;
  * arithmetic-coded files raise NotImplementedError.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from dynosam_tpu_torch import jpeg, native

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filtered(rows, bpp, filters):
    out = b""
    prev = bytes(len(rows[0]))
    for y, row in enumerate(rows):
        ftype = filters[y % len(filters)]
        enc = bytearray(len(row))
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            enc[i] = (x - (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]) & 0xFF
        out += bytes([ftype]) + bytes(enc)
        prev = row
    return out


def _pack(samples, depth):
    """(h, w, c) sample values -> packed scanlines (list of bytes)."""
    h = samples.shape[0]
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    if depth == 8:
        return [samples[y].astype(np.uint8).tobytes() for y in range(h)]
    rows = []
    for y in range(h):
        bits = np.unpackbits(samples[y, :, 0].astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
        rows.append(np.packbits(bits.reshape(-1)).tobytes())
    return rows


def _png(path, samples, depth, colour, filters=(0, 1, 2, 3, 4), interlace=0, palette=None, trns=None):
    h, w = samples.shape[:2]
    bpp = max(1, _CHANNELS[colour] * depth // 8)
    data = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filtered(_pack(sub, depth), bpp, filters)
    chunks = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        chunks += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        chunks += _chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunks + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _check_png(path, index=False):
    for color, flag in ((False, cv2.IMREAD_UNCHANGED), (True, cv2.IMREAD_COLOR)):
        ref = cv2.imread(path, flag)
        got = native.read_png(path, order="bgr", color=color)
        assert got.dtype == ref.dtype and got.shape == ref.shape, (path, color, got.shape, ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=f"{path} color={color}")
        rgb = native.read_png(path, order="rgb", color=color)
        if ref.ndim == 3:
            np.testing.assert_array_equal(rgb[..., :3], ref[..., 2::-1])
            np.testing.assert_array_equal(rgb[..., 3:], ref[..., 3:])
    if index:
        np.testing.assert_array_equal(native.read_png_index(path), np.asarray(Image.open(path)))


CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
         (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1], ids=["sequential", "adam7"])
@pytest.mark.parametrize("colour,depth", CASES, ids=[f"type{c}-{d}bit" for c, d in CASES])
def test_png_decoder_equals_opencv_and_pil(tmp_path, colour, depth, interlace):
    rng = np.random.default_rng(colour * 100 + depth + 7 * interlace)
    for h, w in ((11, 13), (1, 1), (3, 17), (9, 2)):
        top = (1 << depth) - 1
        samples = rng.integers(0, top + 1, (h, w, _CHANNELS[colour]))
        samples[h // 2] = samples[0]                      # runs the filters flatten
        path = str(tmp_path / f"t{h}x{w}.png")
        palette = trns = None
        if colour == 3:
            palette = rng.integers(0, 256, (top + 1, 3))
            trns = bytes(rng.integers(0, 256, min(top + 1, 5)).astype(np.uint8)) if depth == 8 else None
        _png(path, samples, depth, colour, interlace=interlace, palette=palette, trns=trns)
        _check_png(path, index=colour == 3 or (colour == 0 and depth == 8))


def test_png_decoder_on_files_opencv_and_pil_write(tmp_path):
    rng = np.random.default_rng(3)
    for h, w in ((7, 9), (61, 37)):
        for arr in (rng.integers(0, 256, (h, w), dtype=np.uint8), rng.integers(0, 65536, (h, w), dtype=np.uint16),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                    rng.integers(0, 65536, (h, w, 3), dtype=np.uint16),
                    rng.integers(0, 256, (h, w, 4), dtype=np.uint8),
                    rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)):
            path = str(tmp_path / "cv.png")
            cv2.imwrite(path, arr)
            _check_png(path, index=arr.ndim == 2 and arr.dtype == np.uint8)
            np.testing.assert_array_equal(native.read_png(path, order="bgr"), arr)
        # PIL writes short palettes at 1, 2 and 4 bits
        for n in (2, 4, 16, 200):
            im = Image.fromarray(rng.integers(0, n, (h, w), dtype=np.uint8), "P")
            im.putpalette(rng.integers(0, 256, 3 * n).tolist())
            path = str(tmp_path / f"pil_p{n}.png")
            im.save(path)
            _check_png(path, index=True)
        for mode, shape in (("LA", (h, w, 2)), ("RGBA", (h, w, 4)), ("L", (h, w))):
            path = str(tmp_path / f"pil_{mode}.png")
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path)
            _check_png(path, index=mode == "L")
        path = str(tmp_path / "pil_1.png")
        Image.fromarray(rng.integers(0, 2, (h, w)).astype(np.uint8) * 255).convert("1").save(path)
        _check_png(path)


def test_write_png_reads_back_through_opencv_and_pil(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "w.png")
    for arr in (rng.integers(0, 256, (13, 7), dtype=np.uint8), rng.integers(0, 65536, (13, 7), dtype=np.uint16),
                rng.integers(0, 256, (13, 7, 3), dtype=np.uint8), rng.integers(0, 65536, (13, 7, 3), dtype=np.uint16),
                rng.integers(0, 256, (13, 7, 4), dtype=np.uint8), rng.integers(0, 65536, (13, 7, 4), dtype=np.uint16)):
        native.write_png(path, arr, order="bgr")
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), arr)
        native.write_png(path, arr)                       # RGB(A) order
        np.testing.assert_array_equal(native.read_png(path), arr)
        if arr.dtype == np.uint8:
            np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    idx = rng.integers(0, 40, (13, 7), dtype=np.uint8)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    native.write_png(path, idx, palette=pal)
    im = Image.open(path)
    assert im.mode == "P" and im.getpalette()[:768] == pal.reshape(-1).tolist()
    np.testing.assert_array_equal(np.asarray(im), idx)
    np.testing.assert_array_equal(cv2.imread(path), pal[idx][..., ::-1])
    for bad in (np.zeros((3, 4, 2), np.uint8), np.zeros((3, 4), np.float32)):
        with pytest.raises(ValueError):
            native.write_png(path, bad)
    with pytest.raises(ValueError):
        native.write_png(path, np.full((3, 4), 9, np.uint8), palette=pal[:4])


def test_gray_from_bgr_equals_opencv():
    rng = np.random.default_rng(5)
    bgr = rng.integers(0, 256, (37, 61, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.gray_from_bgr(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    bgra = rng.integers(0, 256, (37, 61, 4), dtype=np.uint8)
    np.testing.assert_array_equal(native.gray_from_bgr(bgra), cv2.cvtColor(bgra, cv2.COLOR_BGRA2GRAY))


# ---------------------------------------------------------------------------
# JPEG

def _scene(h, w, seed):
    """A textured RGB image: smooth gradients, edges and noise."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.random((h, w, 3)) * 255, (2, 2, 0)) * 1.5 - 60 + rng.normal(0, 8, (h, w, 3))
    x[h // 3: h // 2, w // 4: w // 2] = (250, 20, 90)
    return np.clip(x, 0, 255).astype(np.uint8)


SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(375, 1242), (61, 37), (17, 33), (8, 8), (2, 3), (1, 1)]


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_jpeg_decoder_equals_opencv(size):
    img = _scene(*size, seed=size[0])
    for quality in (75, 90, 98):
        for name, samp in SAMPLINGS.items():
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp])
            ref = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            got = jpeg.decode_jpeg(buf.tobytes())
            np.testing.assert_array_equal(got[..., ::-1], ref, err_msg=f"q{quality} {name}")
    ok, buf = cv2.imencode(".jpg", img[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90])     # grey
    np.testing.assert_array_equal(jpeg.decode_jpeg(buf.tobytes())[..., ::-1], cv2.imdecode(buf, cv2.IMREAD_COLOR))
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    assert b"\xff\xdd" in buf.tobytes()
    np.testing.assert_array_equal(jpeg.decode_jpeg(buf.tobytes())[..., ::-1], cv2.imdecode(buf, cv2.IMREAD_COLOR))


def test_read_jpeg_gives_rgb(tmp_path):
    img = _scene(40, 56, seed=1)
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 98])
    np.testing.assert_array_equal(jpeg.read_jpeg(path), cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_jpeg_encoder_writes_what_opencv_writes(size, tmp_path):
    img = _scene(*size, seed=size[1])
    for quality in (75, 90, 98):
        ok, buf = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
        path = str(tmp_path / "p.jpg")
        jpeg.write_jpeg(path, img, quality=quality)
        ours = open(path, "rb").read()
        np.testing.assert_array_equal(cv2.imread(path), cv2.imdecode(buf, cv2.IMREAD_COLOR))
        assert ours == buf.tobytes()
    ok, buf = cv2.imencode(".jpg", img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert jpeg.encode_jpeg(img[..., 0], 90) == buf.tobytes()


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_jpeg_progressive_decoder_equals_opencv(size):
    img = _scene(*size, seed=size[0] + 1)
    prog = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    for quality in (50, 75, 90, 100):
        for name, samp in SAMPLINGS.items():
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp] + prog)
            assert b"\xff\xc2" in buf.tobytes()
            np.testing.assert_array_equal(jpeg.decode_jpeg(buf.tobytes())[..., ::-1],
                                          cv2.imdecode(buf, cv2.IMREAD_COLOR), err_msg=f"q{quality} {name}")
    for extra, what in (([], "grey"), ([cv2.IMWRITE_JPEG_RST_INTERVAL, 3], "restart")):
        src = img[..., 1] if what == "grey" else img
        ok, buf = cv2.imencode(".jpg", src, [cv2.IMWRITE_JPEG_QUALITY, 90] + prog + extra)
        if what == "restart":
            assert b"\xff\xdd" in buf.tobytes()
        np.testing.assert_array_equal(jpeg.decode_jpeg(buf.tobytes())[..., ::-1],
                                      cv2.imdecode(buf, cv2.IMREAD_COLOR), err_msg=what)


def test_vkitti_progressive_rgb_reads_as_reference(tmp_path):
    """A Virtual KITTI 2 sequence (the JAX writer) whose frame-1 rgb is
    re-encoded progressive: the JAX reader (cv2) and the port's read the
    same frame."""
    import glob

    import torch

    from dynosam_tpu.dataproviders import fixture_writers as jfw
    from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario
    from dynosam_tpu.dataproviders.vkitti import VirtualKittiDataProvider as JaxVkitti
    from dynosam_tpu_torch.dataproviders.vkitti import VirtualKittiDataProvider

    out = str(tmp_path / "vkitti")
    jfw.write_vkitti_sequence(default_dense_scenario(num_frames=3), out)
    (path,) = glob.glob(os.path.join(out, "**", "rgb_00001.jpg"), recursive=True)
    ok, buf = cv2.imencode(".jpg", cv2.imread(path), [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with open(path, "wb") as f:
        f.write(buf.tobytes())
    jf, tf = JaxVkitti(out).frame(1), VirtualKittiDataProvider(out, device="cpu").frame(1)
    assert isinstance(tf.rgb, torch.Tensor)
    np.testing.assert_array_equal(tf.rgb.numpy(), np.asarray(jf.rgb))


def test_jpeg_unsupported_files_raise():
    img = _scene(32, 48, seed=2)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = buf.tobytes()
    sof = data.index(b"\xff\xc0")
    arith = data[:sof + 1] + b"\xc9" + data[sof + 2:]            # SOF9: arithmetic coding
    with pytest.raises(NotImplementedError, match="arithmetic"):
        jpeg.decode_jpeg(arith)
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(b"\x89PNG" + data[4:])
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(img.astype(np.float32))


# ---------------------------------------------------------------------------
# the golden cases of tests/test_golden_decode.py on the port's functions

def test_golden_flo(tmp_path):
    import io

    buf = io.BytesIO()
    buf.write(struct.pack("<fii", 202021.25, 3, 2))
    vals = [(0.5, -1.25), (100.0, 0.0), (-3.75, 7.5), (0.0, 0.0), (-0.001953125, 2.0), (65504.0, -65504.0)]
    for u, v in vals:
        buf.write(struct.pack("<ff", u, v))
    p = tmp_path / "f.flo"
    p.write_bytes(buf.getvalue())
    flow = native.read_flo(str(p), 2, 3)
    assert flow.shape == (2, 3, 2) and flow.dtype == np.float32
    np.testing.assert_array_equal(flow, np.array(vals, np.float32).reshape(2, 3, 2))
    p.write_bytes(struct.pack("<fii", 202021.0, 1, 1) + b"\0" * 8)
    with pytest.raises(ValueError):
        native.read_flo(str(p), 1, 1)


def test_golden_disparity():
    raw = np.array([[256, 512, 1, 0], [25600, 65535, 387, 2560]], np.uint16)
    depth = native.disparity_to_depth(raw, base_line=387.5744, scale=256.0)
    expect = np.array([[387.5744, 387.5744 / 2.0, 387.5744 * 256.0, 0.0],
                       [387.5744 / 100.0, 387.5744 / (65535.0 / 256.0), 387.5744 / (387.0 / 256.0),
                        387.5744 / 10.0]], np.float32)
    np.testing.assert_allclose(depth, expect, rtol=1e-6)


def test_golden_vkitti_flow_and_depth():
    from dynosam_tpu_torch.dataproviders.vkitti import decode_vkitti_flow

    bgr = np.zeros((2, 4, 3), np.uint16)
    bgr[0, 0] = (1, 65535, 65535)
    bgr[0, 1] = (7, 0, 0)
    bgr[0, 2] = (1, 13107, 52428)
    bgr[0, 3] = (0, 65535, 65535)
    bgr[1, 0] = (9, 39321, 26214)
    flow = decode_vkitti_flow(bgr)
    expect = np.zeros((2, 4, 2), np.float32)
    expect[0, 0] = (3.0, 1.0)
    expect[0, 1] = (-3.0, -1.0)
    expect[0, 2] = (0.6 * 3.0, -0.6)
    expect[1, 0] = (-0.2 * 3.0, 0.2)
    assert flow.dtype == np.float32
    np.testing.assert_allclose(flow, expect, atol=1e-4)
    cm = np.array([[100, 655, 65535, 1]], np.uint16)
    np.testing.assert_allclose(cm.astype(np.float32) / np.float32(100.0), [[1.0, 6.55, 655.35, 0.01]], rtol=1e-6)


def test_golden_object_rotations():
    from dynosam_tpu_torch.dataproviders.kitti import _yaw_pose
    from dynosam_tpu_torch.dataproviders.omd import _axis_angle

    T = _yaw_pose(np.array([1.5, -0.25, 12.0]), 0.3)
    y = 0.3 + np.pi / 2
    expect = np.array([[np.cos(y), 0.0, np.sin(y), 1.5], [0.0, 1.0, 0.0, -0.25],
                       [-np.sin(y), 0.0, np.cos(y), 12.0], [0.0, 0.0, 0.0, 1.0]])
    np.testing.assert_allclose(T, expect, atol=1e-7)
    np.testing.assert_allclose(_axis_angle(np.array([0.0, np.pi / 2, 0.0])),
                               [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]], atol=1e-12)
    r = 0.5 * np.array([1.0, 2.0, 2.0]) / 3.0
    kx, ky, kz = 1 / 3, 2 / 3, 2 / 3
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    np.testing.assert_allclose(_axis_angle(r), np.eye(3) + np.sin(0.5) * K + (1 - np.cos(0.5)) * (K @ K),
                               atol=1e-12)
    np.testing.assert_array_equal(_axis_angle(np.zeros(3)), np.eye(3))
