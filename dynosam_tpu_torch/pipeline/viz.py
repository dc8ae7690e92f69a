"""Visualization: tracking overlays, top-down trajectory plots and a video
of the tracking frames (port of dynosam_tpu/pipeline/viz.py).

The reference draws with OpenCV. The port draws with numpy, pixel for pixel
as OpenCV's LINE_8 rasteriser where that is cheap to match: the filled
feature dots (cv2.circle, thickness -1), the 1-px object boxes
(cv2.rectangle) and the 1-px object trails (cv2.line). Two things differ:
the camera trail, which the reference draws 2 px thick with OpenCV's
thick-line polygon, is the 1-px line widened by one pixel right and down;
and the object ids, which the reference writes with cv2.putText in the
Hershey simplex font (whose glyph table is not in this repository), use
the port's own 5x7 pixel digits at the same text origin.

PNGs are written with the port's own encoder (`native.write_png`). The
reference's `write_video` encodes an MP4 with OpenCV's mp4v codec, which
the port has no encoder for; the port writes the same frames as a
Motion-JPEG AVI (each frame one baseline JPEG from `jpeg.encode_jpeg`) and
returns that path. `read_avi_frames` reads such a file back.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np
import torch

from dynosam_tpu_torch import jpeg, native

# distinct object colours (BGR), index by object_id % len
_COLOURS = [
    (66, 135, 245), (52, 235, 86), (235, 64, 52), (235, 192, 52),
    (168, 52, 235), (52, 235, 222), (235, 52, 155), (130, 235, 52),
]

# 5x7 digits, one string of 7 rows of 5 columns per digit
_DIGITS = {
    "0": "01110100011001110101110011000101110", "1": "00100011000010000100001000010001110",
    "2": "01110100010000100010001000100011111", "3": "11111000100010000010000011000101110",
    "4": "00010001100101010010111110001000010", "5": "11111100001111000001000011000101110",
    "6": "00110010001000011110100011000101110", "7": "11111000010001000100010000100001000",
    "8": "01110100011000101110100011000101110", "9": "01110100011000101111000010001001100",
    "-": "00000000000000011111000000000000000",
}
_GLYPH_W, _GLYPH_H, _ADVANCE = 5, 7, 6


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _circle_spans(radius: int):
    """The horizontal spans (dy, x0, x1) of OpenCV's filled LINE_8 circle
    of `radius` about the origin (drawing.cpp's Circle with fill: a
    midpoint walk whose every step fills rows +-dy over +-dx and rows +-dx
    over +-dy)."""
    spans = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, half in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            spans.append((y, -half, half))
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return spans


def _fill_circle(img, cx: int, cy: int, radius: int, colour):
    h, w = img.shape[:2]
    for dy, x0, x1 in _circle_spans(radius):
        y = cy + dy
        if 0 <= y < h:
            a, b = max(cx + x0, 0), min(cx + x1, w - 1)
            if a <= b:
                img[y, a:b + 1] = colour


def _line_pixels(p0, p1):
    """The pixels of OpenCV's LINE_8 line from p0 to p1, endpoints included
    (its LineIterator, left to right): the major axis steps every pixel,
    the minor axis when the error turns negative."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        (x0, y0), (x1, y1) = (x1, y1), (x0, y0)
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    out = [(x, y)]
    for _ in range(major):
        neg = err < 0
        err += -2 * minor + (2 * major if neg else 0)
        if steep:
            y += sy
            x += 1 if neg else 0
        else:
            x += 1
            y += sy if neg else 0
        out.append((x, y))
    return out


def _draw_line(img, p0, p1, colour, width: int = 1):
    """A LINE_8 line; `width` 2 widens every pixel by one pixel right and
    down (see the module docstring). Pixels outside the image are
    dropped."""
    h, w = img.shape[:2]
    for x, y in _line_pixels(p0, p1):
        for oy in range(width):
            for ox in range(width):
                if 0 <= x + ox < w and 0 <= y + oy < h:
                    img[y + oy, x + ox] = colour


def _draw_rectangle(img, p0, p1, colour):
    (x0, y0), (x1, y1) = p0, p1
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        _draw_line(img, a, b, colour)


def _draw_text(img, text: str, org, colour):
    """Digits (and '-') with the bottom-left of the text at `org`, as
    cv2.putText places it."""
    h, w = img.shape[:2]
    x0, base = org
    for i, ch in enumerate(text):
        bits = np.array([int(c) for c in _DIGITS[ch]], bool).reshape(_GLYPH_H, _GLYPH_W)
        ys, xs = np.nonzero(bits)
        ys = base - _GLYPH_H + 1 + ys
        xs = x0 + i * _ADVANCE + xs
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = colour


def text_box(text: str, org):
    """(x0, y0, x1, y1), inclusive, of the pixels _draw_text may set."""
    return org[0], org[1] - _GLYPH_H + 1, org[0] + len(text) * _ADVANCE - 1, org[1]


def render_tracking_image(rgb, packet, radius: int = 2) -> np.ndarray:
    """Overlay a frame's tracked features on its image: static features are
    green dots, dynamic ones coloured by object id, each object boxed by
    its features' extent with its id above the box. `rgb` (H, W, 3) in
    0..1 (a tensor or an array), `packet` a VisionPacket. Returns an
    (H, W, 3) uint8 BGR image (OpenCV's channel order)."""
    img = np.ascontiguousarray((np.clip(_host(rgb), 0, 1) * 255).astype(np.uint8)[..., ::-1])

    st = packet.static_tracks
    uv = _host(st.uv)
    for i in np.nonzero(_host(st.valid))[0]:
        _fill_circle(img, int(uv[i, 0]), int(uv[i, 1]), radius, (0, 200, 0))

    dt = packet.dynamic_tracks
    uv = _host(dt.uv)
    oids = _host(dt.object_id)
    valid = _host(dt.valid)
    for i in np.nonzero(valid)[0]:
        _fill_circle(img, int(uv[i, 0]), int(uv[i, 1]), radius, _COLOURS[int(oids[i]) % len(_COLOURS)])

    # object bounding boxes from their feature extents
    for oid in np.unique(oids[valid]):
        if oid <= 0:
            continue
        pts = uv[(oids == oid) & valid]
        x1, y1 = pts.min(axis=0)
        x2, y2 = pts.max(axis=0)
        c = _COLOURS[int(oid) % len(_COLOURS)]
        _draw_rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), c)
        _draw_text(img, str(int(oid)), (int(x1), int(y1) - 3), c)
    return img


def render_trajectory_topdown(
    trajectory,
    object_poses: Optional[dict] = None,
    size: int = 512,
    margin: float = 0.1,
) -> np.ndarray:
    """Top-down (x-z) trajectory plot of (K, 4, 4) camera poses, with
    optional {object_id: (K_j, 4, 4)} trails; (size, size, 3) uint8 BGR."""
    img = np.full((size, size, 3), 255, np.uint8)
    pts = [_host(trajectory)[:, [0, 2], 3]]
    if object_poses:
        pts += [_host(v)[:, [0, 2], 3] for v in object_poses.values()]
    allp = np.concatenate(pts, axis=0)
    lo = allp.min(axis=0)
    hi = allp.max(axis=0)
    span = np.maximum(hi - lo, 1e-3)
    scale = size * (1 - 2 * margin) / span.max()

    def to_px(p):
        q = (p - lo) * scale + size * margin
        return int(q[0]), size - int(q[1])

    cam = pts[0]
    for a, b in zip(cam[:-1], cam[1:]):
        _draw_line(img, to_px(a), to_px(b), (180, 60, 0), width=2)
    if object_poses:
        for oid, traj in object_poses.items():
            c = _COLOURS[int(oid) % len(_COLOURS)]
            t = _host(traj)[:, [0, 2], 3]
            for a, b in zip(t[:-1], t[1:]):
                _draw_line(img, to_px(a), to_px(b), c)
    return img


class DisplayWriter:
    """Dumps per-frame tracking images and a final trajectory plot to
    `output_path`/viz, and assembles the tracking images into a video."""

    def __init__(self, output_path: str, every: int = 1):
        self.path = os.path.join(output_path, "viz")
        os.makedirs(self.path, exist_ok=True)
        self.every = every
        self._count = 0

    def write_tracking(self, rgb, packet):
        if self._count % self.every == 0:
            img = render_tracking_image(rgb, packet)
            native.write_png(os.path.join(self.path, f"tracking_{self._count:06d}.png"), img, order="bgr")
        self._count += 1

    def write_trajectory(self, trajectory, object_poses=None):
        img = render_trajectory_topdown(np.stack([_host(x) for x in trajectory]), object_poses)
        native.write_png(os.path.join(self.path, "trajectory_topdown.png"), img, order="bgr")

    def write_video(self, fps: float = 10.0, name: str = "tracking.avi", quality: int = 95):
        """The dumped tracking frames as a Motion-JPEG AVI -> its path, or
        None when there are none."""
        frames = sorted(f for f in os.listdir(self.path) if f.startswith("tracking_") and f.endswith(".png"))
        if not frames:
            return None
        jpegs = [jpeg.encode_jpeg(native.read_png(os.path.join(self.path, f), color=True, order="rgb"),
                                  quality=quality) for f in frames]
        h, w = native.read_png(os.path.join(self.path, frames[0]), color=True).shape[:2]
        out_path = os.path.join(self.path, name)
        write_mjpeg_avi(out_path, jpegs, w, h, fps)
        return out_path


# ---------------------------------------------------------------------------
# Motion-JPEG AVI (RIFF) container
# ---------------------------------------------------------------------------

def _chunk(fourcc: bytes, data: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(data)) + data + (b"\0" if len(data) % 2 else b"")


def _list(kind: bytes, data: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(data) + 4) + kind + data


def write_mjpeg_avi(path: str, frames: List[bytes], width: int, height: int, fps: float) -> None:
    """An AVI of one MJPG video stream whose frames are the JPEG files
    `frames`, with its idx1 index."""
    n = len(frames)
    rate, scale = int(round(fps * 1000)), 1000
    big = max(len(f) for f in frames)
    avih = struct.pack("<10I4I", int(1e6 / fps), big * int(fps + 1), 0, 0x10, n, 0, 1, big,
                       width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, scale, rate, 0, n, big,
                       0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG", width * height * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi_body, index, offset = b"", b"", 4
    for f in frames:
        c = _chunk(b"00dc", f)
        index += struct.pack("<4sIII", b"00dc", 0x10, offset, len(f))
        movi_body += c
        offset += len(c)
    body = b"AVI " + hdrl + _list(b"movi", movi_body) + _chunk(b"idx1", index)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def read_avi_frames(path: str) -> List[bytes]:
    """The video frames (the '00dc' chunks of the 'movi' list) of an AVI
    written by write_mjpeg_avi, in order."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    frames = []

    def walk(pos, end):
        while pos + 8 <= end:
            fourcc, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if fourcc == b"LIST":
                walk(pos + 12, pos + 8 + size)
            elif fourcc == b"00dc":
                frames.append(data[pos + 8:pos + 8 + size])
            pos += 8 + size + (size % 2)

    walk(12, len(data))
    return frames
