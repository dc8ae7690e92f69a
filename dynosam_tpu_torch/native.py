"""On-disk formats of the dyno-KITTI layout, decoded with numpy and zlib
(port of the parsers of dynosam_tpu/native.py and dataproviders/kitti.py).

The port loads no native library and needs neither OpenCV nor PIL:

  * `read_png`: 8-bit RGB (colour type 2) and 16-bit grey (colour type 0)
    PNGs, non-interlaced, all five row filters. None/Sub/Up rows are
    vectorised (a Sub row is a per-byte-lane cumulative sum mod 256);
    Average and Paeth rows loop over pixels. Any other format raises
    ValueError.
  * `read_flo`: Middlebury .flo optical flow -> (H, W, 2) float32.
  * `read_txt_mask`: whitespace-separated integer grid -> (H, W) int32.
  * `disparity_to_depth`: uint16 disparity -> metric depth in float32
    arithmetic, base_line / (raw / scale), bit for bit as the reference's
    native library computes it.

All of these run on the host; `zlib.decompress` and the numpy kernels
release the GIL, so a prefetch thread decodes while the device computes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> (bytes per pixel, channels, numpy dtype)
_PNG_FORMATS = {
    (8, 2): (3, 3, np.dtype(np.uint8)),
    (16, 0): (2, 1, np.dtype(">u2")),
}


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


def _unfilter_average(x, prev, bpp):
    out = np.zeros_like(x)
    left = np.zeros(bpp, np.int32)
    for i in range(0, x.shape[0], bpp):
        px = (x[i:i + bpp].astype(np.int32) + (left + prev[i:i + bpp]) // 2) & 0xFF
        out[i:i + bpp] = px
        left = px
    return out


def _unfilter_paeth(x, prev, bpp):
    out = np.zeros_like(x)
    a = np.zeros(bpp, np.int32)
    c = np.zeros(bpp, np.int32)
    for i in range(0, x.shape[0], bpp):
        b = prev[i:i + bpp].astype(np.int32)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        px = (x[i:i + bpp].astype(np.int32) + pred) & 0xFF
        out[i:i + bpp] = px
        a, c = px, b
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG -> (H, W, 3) uint8 RGB or (H, W) uint16 grey."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, body in _png_chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, compression, filt, interlace = header
    if (depth, colour) not in _PNG_FORMATS or compression or filt or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}); only non-interlaced 8-bit RGB and 16-bit grey are read"
        )
    bpp, channels, dtype = _PNG_FORMATS[(depth, colour)]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, x = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = x
        elif ftype == 1:
            cur = np.cumsum(x.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = x + prev
        elif ftype == 3:
            cur = _unfilter_average(x, prev, bpp)
        elif ftype == 4:
            cur = _unfilter_paeth(x, prev, bpp)
        else:
            raise ValueError(f"{path}: PNG row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    img = out.view(dtype).reshape(h, w, channels) if channels > 1 else out.view(dtype).reshape(h, w)
    return img.astype(dtype.newbyteorder("="))


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
