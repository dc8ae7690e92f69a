"""On-disk formats of the datasets, decoded and encoded with numpy and zlib
(port of the parsers of dynosam_tpu/native.py and of the image reads and
writes the reference's readers and writers make through OpenCV and PIL).

The port loads no native library and needs neither OpenCV nor PIL:

  * `read_png`: every PNG colour type at every bit depth the format allows
    (grey 1/2/4/8/16, RGB 8/16, palette 1/2/4/8, grey+alpha and RGBA 8/16),
    Adam7-interlaced or not, all five row filters, returned as
    `cv2.imread` returns it: with `color=False` as under
    `cv2.IMREAD_UNCHANGED`, with `color=True` as under its default flag;
    the colour channels in `order` ("rgb" or "bgr", alpha last). None/Sub/Up
    rows are vectorised (a Sub row is a per-byte-lane cumulative sum mod
    256); Average and Paeth rows loop over bytes. A PNG this reader does not
    read (another compression, filter method or interlace, a tRNS chunk on a
    non-palette image) raises ValueError.
  * `read_png_index`: a palette PNG's indices, as PIL's "P" mode gives them.
  * `write_png`: grey / RGB / RGBA at 8 or 16 bits, or 8-bit palette
    indices with their palette; zlib, row filter 0.
  * `read_flo`: Middlebury .flo optical flow -> (H, W, 2) float32.
  * `read_txt_mask`: whitespace-separated integer grid -> (H, W) int32.
  * `disparity_to_depth`: uint16 disparity -> metric depth in float32
    arithmetic, base_line / (raw / scale), bit for bit as the reference's
    native library computes it.
  * `gray_from_bgr`: OpenCV's fixed-point BGR(A) -> grey conversion.

JPEG is in `dynosam_tpu_torch/jpeg.py`. All of these run on the host;
`zlib.decompress` and the numpy kernels release the GIL, so a prefetch
thread decodes while the device computes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes, path: str):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without IEND")


def _unfilter_average(x: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray(x)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((left + prev[i]) >> 1)) & 0xFF
    return bytes(out)


def _unfilter_paeth(x: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray(x)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return bytes(out)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """(h * (stride + 1),) filtered scanlines -> (h, stride) uint8."""
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, x = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = x
        elif ftype == 1:
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = x
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:
            cur = x + prev
        elif ftype == 3:
            cur = np.frombuffer(_unfilter_average(x.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(_unfilter_paeth(x.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, w, channels) samples, uint8 for
    depths up to 8 (sub-byte samples as their values), uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :w * channels].astype(np.uint16).reshape(h, w, channels)
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    # 1, 2 or 4 bits: one channel (grey or palette), most significant first
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w].reshape(h, w, 1)


def _decode_png(path: str):
    """-> (samples (H, W, C) at the stored depth, colour type, bit depth,
    palette (N, 3) uint8 or None, tRNS bytes or None)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, trns, idat = None, None, None, []
    for ctype, body in _png_chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, compression, filt, interlace = header
    if colour not in _PNG_TYPES or depth not in _PNG_TYPES[colour][1]:
        raise ValueError(f"{path}: invalid PNG (bit depth {depth}, colour type {colour})")
    if compression or filt or interlace > 1:
        raise ValueError(f"{path}: unsupported PNG (compression {compression}, filter method {filt}, "
                         f"interlace {interlace})")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    if trns is not None and colour != 3:
        raise ValueError(f"{path}: tRNS on colour type {colour} is not read")
    channels = _PNG_TYPES[colour][0]
    bits = channels * depth
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.empty((h, w, channels), dtype)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-(pw * bits) // 8)
        n = ph * (stride + 1)
        if pos + n > raw.size:
            raise ValueError(f"{path}: PNG data holds {raw.size} bytes, fewer than its image needs")
        rows = _unfilter(raw[pos:pos + n], ph, stride, bpp, path)
        img[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        pos += n
    if pos != raw.size:
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected {pos}")
    return img, colour, depth, palette, trns


def _order(img: np.ndarray, order: str) -> np.ndarray:
    """RGB(A) samples -> `order`, alpha staying last."""
    if order == "rgb":
        return img
    if order != "bgr":
        raise ValueError(f"order must be 'rgb' or 'bgr', not {order!r}")
    return np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)


def read_png(path: str, order: str = "rgb", color: bool = False) -> np.ndarray:
    """Decode a PNG as `cv2.imread` decodes it, colour channels in `order`.

    color=False (cv2.IMREAD_UNCHANGED): grey (H, W) at 8 or 16 bits (1/2/4
    bits scaled to 8); grey+alpha (H, W, 4) [g, g, g, a]; RGB (H, W, 3) and
    RGBA (H, W, 4) at 8 or 16 bits; palette expanded to its colours, (H, W,
    3), or (H, W, 4) with a tRNS chunk. color=True (the default flag):
    always (H, W, 3) uint8, grey replicated, alpha dropped, 16 bits >> 8."""
    img, colour, depth, palette, trns = _decode_png(path)
    if colour == 3:
        idx = img[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index beyond the {len(palette)}-entry PLTE")
        rgb = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:len(palette)]
            rgb = np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
        img = rgb
    elif colour in (0, 4):
        if depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
        grey = img[..., :1]
        img = grey[..., 0] if colour == 0 else np.concatenate([grey, grey, grey, img[..., 1:]], axis=-1)
    if color:
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        img = np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img[..., :3]
    return np.ascontiguousarray(_order(img, order)) if img.ndim == 3 else img


def read_png_index(path: str) -> np.ndarray:
    """(H, W) uint8 palette indices of a palette PNG, as PIL's "P" mode
    gives them; an 8-bit grey PNG's values (PIL converts "L" to "P" with
    the identity palette). Other PNGs raise ValueError."""
    img, colour, depth, _, _ = _decode_png(path)
    if colour == 3 or (colour == 0 and depth == 8):
        return img[..., 0]
    raise ValueError(f"{path}: no palette indices in a PNG of colour type {colour}, bit depth {depth}")


def write_png(path: str, img: np.ndarray, order: str = "rgb", palette=None) -> None:
    """Encode `img` as a PNG (zlib at level 1, the speed OpenCV writes at;
    row filter 0): (H, W) grey,
    (H, W, 3) colour or (H, W, 4) colour + alpha, uint8 or uint16, colour
    channels in `order`; with `palette` ((N <= 256, 3) uint8), `img` is
    (H, W) uint8 indices into it, written as an 8-bit palette PNG."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3):
        raise ValueError(f"write_png takes (H, W[, 3|4]) uint8 or uint16, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    chunks = []
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if img.ndim != 2 or img.dtype != np.uint8 or not 0 < len(palette) <= 256:
            raise ValueError("a palette PNG takes (H, W) uint8 indices and 1-256 palette entries")
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError("palette index beyond the palette")
        colour, depth = 3, 8
        chunks.append((b"PLTE", palette.tobytes()))
    else:
        channels = 1 if img.ndim == 2 else img.shape[2]
        colour = {1: 0, 3: 2, 4: 6}.get(channels)
        if colour is None:
            raise ValueError(f"write_png takes 1, 3 or 4 channels, not {channels}")
        depth = 16 if img.dtype == np.uint16 else 8
        if channels > 1:
            img = _order(img, order)      # the inverse permutation is the same
    rows = np.ascontiguousarray(img).astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    data = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    chunks = ([(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))] + chunks
              + [(b"IDAT", zlib.compress(data, 1)), (b"IEND", b"")])
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        for ctype, body in chunks:
            f.write(struct.pack(">I", len(body)) + ctype + body
                    + struct.pack(">I", zlib.crc32(ctype + body)))


def gray_from_bgr(img: np.ndarray) -> np.ndarray:
    """(H, W, 3|4) uint8 BGR(A) -> (H, W) uint8 grey as OpenCV's
    COLOR_BGR2GRAY / COLOR_BGRA2GRAY compute it: fixed point with 15
    fractional bits, (3735 B + 19235 G + 9798 R + 16384) >> 15."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + 16384) >> 15).astype(np.uint8)


def read_flo(path: str, h: int, w: int) -> np.ndarray:
    """Middlebury .flo reader -> (h, w, 2) float32; the file must hold an
    h x w field."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != 202021.25:
            raise ValueError(f"Invalid .flo file: {path}")
        fw = int(np.fromfile(f, np.int32, count=1)[0])
        fh = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * fw * fh)
    if (fh, fw) != (h, w):
        raise ValueError(f"{path}: flow is {fh}x{fw}, expected {h}x{w}")
    if data.size != 2 * fw * fh:
        raise ValueError(f"{path}: truncated .flo file")
    return data.reshape(fh, fw, 2)


def read_txt_mask(path: str, h: int, w: int) -> np.ndarray:
    """Whitespace-separated integer mask -> (h, w) int32."""
    with open(path, "rb") as f:
        vals = np.array(f.read().split(), dtype=np.int32)
    if vals.size != h * w:
        raise ValueError(f"{path}: mask holds {vals.size} values, expected {h}x{w}")
    return vals.reshape(h, w)


def disparity_to_depth(raw: np.ndarray, base_line: float, scale: float) -> np.ndarray:
    """uint16 disparity -> float32 depth base_line / (raw / scale), 0 where
    raw is 0; every operation rounds to float32."""
    raw = np.ascontiguousarray(raw, np.uint16)
    disp = raw.astype(np.float32) / np.float32(scale)
    with np.errstate(divide="ignore"):
        depth = np.float32(base_line) / disp
    return np.where(raw > 0, depth, np.float32(0.0)).astype(np.float32)
