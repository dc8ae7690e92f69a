"""JPEG codec in numpy, for the datasets whose images are JPEG (Virtual
KITTI 2's `rgb_%05d.jpg`). The reference reads and writes these through
OpenCV; the port may not, so this module reproduces what OpenCV's
libjpeg-turbo computes at its defaults, stage by stage:

  * `decode_jpeg` / `read_jpeg`: baseline sequential and progressive
    Huffman, 8-bit, one or three components, sampling 4:4:4, 4:2:2 (h2v1)
    or 4:2:0 (h2v2), restart intervals, any size. Progressive files
    (T.81 Annex G: spectral selection, successive approximation,
    end-of-band runs) collect every scan's coefficients as libjpeg-turbo's
    `jdphuff.c` does, then take the same stages as baseline ones: the
    integer IDCT of `jidctint.c` (jpeg_idct_islow), the "fancy" triangular
    chroma upsampling of `jdsample.c` (h2v1_fancy_upsample /
    h2v2_fancy_upsample, edges replicated) and the fixed-point YCbCr -> RGB
    tables of `jdcolor.c` (build_ycc_rgb_table), so the pixels equal
    `cv2.imdecode`'s. A grey file decodes to three equal channels, as cv2's
    default flag gives it. Lossless, hierarchical, 12-bit and
    arithmetic-coded files, and other samplings, raise NotImplementedError.
  * `encode_jpeg` / `write_jpeg`: what `cv2.imwrite(..., [IMWRITE_JPEG_QUALITY,
    q])` writes at its defaults: the Annex K tables scaled by libjpeg's
    quality curve (jcparam.c), RGB -> YCbCr in fixed point (jccolor.c), h2v2
    downsampling with libjpeg's alternating bias (jcsample.c) for 4:2:0,
    edge replication to whole blocks and MCUs, the `jfdctint.c` forward DCT
    (jpeg_fdct_islow) and libjpeg-turbo's reciprocal quantiser
    (jcdctmgr.c compute_reciprocal), entropy-coded with the Annex K Huffman
    tables (libjpeg's defaults when optimize_coding is off).

Huffman decoding is a Python loop over symbols (the one sequential stage);
everything else is vectorised over blocks. Encoding is vectorised whole.
"""

from __future__ import annotations

import struct

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)   # zigzag k -> natural

# jidctint.c / jfdctint.c constants (CONST_BITS 13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172

ROADMAP_ENTRY = "ROADMAP.md item 22: arithmetic-coded JPEG is not decoded; neither cv2 nor PIL writes one to test against"


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# integer DCTs, vectorised over a leading block axis: (N, 8, 8) int64

def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7):
    """The even/odd butterflies of jpeg_idct_islow on one axis -> the eight
    un-descaled outputs (tmp10 + tmp3, ...), in output order."""
    z1 = (s2 + s6) * _F0541
    tmp2 = z1 - s6 * _F1847
    tmp3 = z1 + s2 * _F0765
    tmp0 = (s0 + s4) << _CONST_BITS
    tmp1 = (s0 - s4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s7, s5, s3, s1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients (N, 8, 8) [row v, col u] -> (N, 8, 8) uint8
    samples, jpeg_idct_islow's arithmetic and range limit. Its zero-AC
    shortcuts give the same values as the full butterflies."""
    c = coef.astype(np.int64)
    cols = _idct_1d(*(c[:, k, :] for k in range(8)))            # pass 1: columns
    ws = np.stack([_descale(v, _CONST_BITS - _PASS1_BITS) for v in cols], axis=1)
    rows = _idct_1d(*(ws[:, :, k] for k in range(8)))           # pass 2: rows
    out = np.stack([_descale(v, _CONST_BITS + _PASS1_BITS + 3) for v in rows], axis=2)
    return _IDCT_RANGE[out & 1023]


def _idct_range_table() -> np.ndarray:
    """prepare_range_limit_table (jdmaster.c) seen from the IDCT's
    `range_limit + CENTERJSAMPLE`, indexed by `x & RANGE_MASK`."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_IDCT_RANGE = _idct_range_table()


def _fdct_1d(d0, d1, d2, d3, d4, d5, d6, d7, first: bool):
    """jpeg_fdct_islow on one axis: pass 1 (rows) when `first`, pass 2."""
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if first:
        o0, o4 = (tmp10 + tmp11) << _PASS1_BITS, (tmp10 - tmp11) << _PASS1_BITS
        n = _CONST_BITS - _PASS1_BITS
    else:
        o0, o4 = _descale(tmp10 + tmp11, _PASS1_BITS), _descale(tmp10 - tmp11, _PASS1_BITS)
        n = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    o2 = _descale(z1 + tmp13 * _F0765, n)
    o6 = _descale(z1 - tmp12 * _F1847, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o7 = _descale(tmp4 + z1 + z3, n)
    o5 = _descale(tmp5 + z2 + z4, n)
    o3 = _descale(tmp6 + z2 + z3, n)
    o1 = _descale(tmp7 + z1 + z4, n)
    return o0, o1, o2, o3, o4, o5, o6, o7


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 8, 8) int64 coefficients scaled by 8
    (jpeg_fdct_islow after convsamp's - CENTERJSAMPLE)."""
    d = blocks.astype(np.int64) - 128
    rows = _fdct_1d(*(d[:, :, k] for k in range(8)), first=True)
    d = np.stack(rows, axis=2)
    cols = _fdct_1d(*(d[:, k, :] for k in range(8)), first=False)
    return np.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# colour, sampling

def _ycc_rgb_tables():
    """build_ycc_rgb_table (jdcolor.c), SCALEBITS 16."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_rgb_tables()


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _rgb_to_ycc(rgb: np.ndarray):
    """rgb_ycc_convert (jccolor.c) -> Y, Cb, Cr uint8 planes."""
    def fix(v):
        return int(v * 65536 + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


def _upsample_h2(x: np.ndarray):
    """Each column's left and right neighbours along the last axis, the
    edge columns replicated -> (left, right)."""
    left = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    return left, right


def _fancy_h2v1(plane: np.ndarray, out_w: int) -> np.ndarray:
    """h2v1_fancy_upsample (jdsample.c): (h, w) -> (h, out_w)."""
    x = plane.astype(np.int64)
    h, w = x.shape
    out = np.empty((h, 2 * w), np.int64)
    left, right = _upsample_h2(x)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out[:, :out_w].astype(np.uint8)


def _fancy_h2v2(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """h2v2_fancy_upsample (jdsample.c): (h, w) -> (out_h, out_w); the rows
    above the first and below the last replicate them (the decoder's
    context rows)."""
    x = plane.astype(np.int64)
    h, w = x.shape
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * h, 2 * w), np.int64)
    for r, nb in ((0, above), (1, below)):
        col = 3 * x + nb                          # thiscolsum per column
        o = out[r::2]
        left, right = _upsample_h2(col)
        o[:, 0::2] = (3 * col + left + 8) >> 4
        o[:, 1::2] = (3 * col + right + 7) >> 4
        o[:, 0] = (col[:, 0] * 4 + 8) >> 4
        o[:, -1] = (col[:, -1] * 4 + 7) >> 4
    return out[:out_h, :out_w].astype(np.uint8)


# ---------------------------------------------------------------------------
# decoding

class _Huffman:
    """A DHT table as a 16-bit lookup: peek -> (code length << 8) | symbol."""

    def __init__(self, counts, symbols):
        self.lut = [0] * 65536
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                sym = symbols[k]
                k += 1
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                entry = (length << 8) | sym
                self.lut[lo:hi] = [entry] * (hi - lo)
                code += 1
            code <<= 1


def _unstuff(data: bytes, path: str):
    """An entropy-coded segment -> (bytes without the 0xFF00 stuffing and
    restart markers, list of the byte offsets where each restart interval
    starts, offset in `data` after the segment)."""
    out = bytearray()
    starts = [0]
    i, n = 0, len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0:
            raise ValueError(f"{path}: JPEG ends inside its scan data")
        out += data[i:j]
        nxt = data[j + 1] if j + 1 < n else None
        if nxt == 0x00:
            out.append(0xFF)
            i = j + 2
        elif nxt == 0xFF:
            i = j + 1                      # fill byte
        elif nxt is not None and 0xD0 <= nxt <= 0xD7:
            starts.append(len(out))
            i = j + 2
        else:
            return bytes(out), starts, j


def _decode_scan(seg: bytes, starts, comps, mcux, mcuy, restart, path):
    """Huffman-decode a baseline interleaved scan -> per component an
    (blocks_y, blocks_x, 64) int32 array of zigzag-ordered coefficients."""
    out = [np.zeros((c["by"], c["bx"], 64), np.int32) for c in comps]
    flat = [o.reshape(-1) for o in out]
    data = seg + b"\x00\x00\x00\x00"
    units = mcux * mcuy
    interval = restart or units
    single = len(comps) == 1
    pos_interval = 0
    for first in range(0, units, interval):
        bytepos = starts[pos_interval] if pos_interval < len(starts) else len(seg)
        pos_interval += 1
        acc, nbits = 0, 0
        pred = [0] * len(comps)
        for m in range(first, min(first + interval, units)):
            my, mx = divmod(m, mcux)
            for ci, c in enumerate(comps):
                dc_lut, ac_lut = c["dc"].lut, c["ac"].lut
                h, v = (1, 1) if single else (c["h"], c["v"])
                for by in range(v):
                    for bx in range(h):
                        yy, xx = my * v + by, mx * h + bx
                        base = (yy * c["bx"] + xx) * 64
                        if nbits < 16:
                            acc = (acc << 24) | (data[bytepos] << 16) | (data[bytepos + 1] << 8) | data[bytepos + 2]
                            bytepos += 3
                            nbits += 24
                        e = dc_lut[(acc >> (nbits - 16)) & 0xFFFF]
                        if not e:
                            raise ValueError(f"{path}: bad Huffman code in the scan")
                        nbits -= e >> 8
                        s = e & 0xFF
                        diff = 0
                        if s:
                            if nbits < s:
                                acc = (acc << 24) | (data[bytepos] << 16) | (data[bytepos + 1] << 8) | data[bytepos + 2]
                                bytepos += 3
                                nbits += 24
                            nbits -= s
                            diff = (acc >> nbits) & ((1 << s) - 1)
                            if diff < (1 << (s - 1)):
                                diff -= (1 << s) - 1
                        pred[ci] += diff
                        if yy < c["by"] and xx < c["bx"]:
                            dst = flat[ci]
                            dst[base] = pred[ci]
                        else:
                            dst = None
                        k = 1
                        while k < 64:
                            if nbits < 16:
                                acc = (acc << 24) | (data[bytepos] << 16) | (data[bytepos + 1] << 8) | data[bytepos + 2]
                                bytepos += 3
                                nbits += 24
                            e = ac_lut[(acc >> (nbits - 16)) & 0xFFFF]
                            if not e:
                                raise ValueError(f"{path}: bad Huffman code in the scan")
                            nbits -= e >> 8
                            rs = e & 0xFF
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break             # EOB
                                k += 16
                                continue
                            k += r
                            if k > 63:
                                raise ValueError(f"{path}: AC coefficients beyond the block")
                            if nbits < s:
                                acc = (acc << 24) | (data[bytepos] << 16) | (data[bytepos + 1] << 8) | data[bytepos + 2]
                                bytepos += 3
                                nbits += 24
                            nbits -= s
                            val = (acc >> nbits) & ((1 << s) - 1)
                            if val < (1 << (s - 1)):
                                val -= (1 << s) - 1
                            if dst is not None:
                                dst[base + k] = val
                            k += 1
                        acc &= (1 << nbits) - 1
    return out


class _Bits:
    """MSB-first reader of an unstuffed entropy-coded segment; past its end
    it reads zero bits, as libjpeg's fill does."""

    def __init__(self, seg: bytes):
        self.data = seg + bytes(16)
        self.end = len(seg)
        self.reset(0)

    def reset(self, bytepos: int):
        self.pos, self.acc, self.n = bytepos, 0, 0

    def _fill(self, want: int):
        while self.n < want:
            self.acc = (self.acc << 8) | (self.data[self.pos] if self.pos < self.end else 0)
            self.pos += 1
            self.n += 8

    def get(self, k: int) -> int:
        if k == 0:
            return 0
        if self.n < k:
            self._fill(k)
        self.n -= k
        v = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        return v

    def symbol(self, lut, path: str) -> int:
        if self.n < 16:
            self._fill(16)
        e = lut[self.acc >> (self.n - 16)]
        if not e:
            raise ValueError(f"{path}: bad Huffman code in the scan")
        self.n -= e >> 8
        self.acc &= (1 << self.n) - 1
        return e & 0xFF

    def extend(self, s: int) -> int:
        """receive + HUFF_EXTEND (T.81 F.2.2.1) of an s-bit magnitude."""
        v = self.get(s)
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _decode_progressive_scan(seg, starts, comps, coefs, ss, se, ah, al, mcux, mcuy, restart, path):
    """One scan of a progressive file (T.81 Annex G; libjpeg-turbo's
    jdphuff.c), accumulated into `coefs`, each component's (blocks_y,
    blocks_x, 64) int32 zigzag coefficients. DC scans may interleave
    components; AC scans carry one. Spectral selection [ss, se] and
    successive approximation (ah, al): first scans write coefficients
    shifted left by al, refinement scans add the bit of weight 2^al, the
    AC refinement also placing newly nonzero coefficients and skipping
    through end-of-band runs as jdphuff.c's decode_mcu_AC_refine does."""
    bits = _Bits(seg)
    single = len(comps) == 1
    if single:
        c = comps[0]
        # a non-interleaved scan covers the component's own blocks only
        units_x, units_y = c["bw"], c["bh"]
    else:
        units_x, units_y = mcux, mcuy
    units = units_x * units_y
    interval = restart or units
    p1, m1 = 1 << al, -(1 << al)
    for n_int, first in enumerate(range(0, units, interval)):
        bits.reset(starts[n_int] if n_int < len(starts) else len(seg))
        pred = [0] * len(comps)
        eobrun = 0
        for m in range(first, min(first + interval, units)):
            my, mx = divmod(m, units_x)
            for ci, c in enumerate(comps):
                h, v = (1, 1) if single else (c["h"], c["v"])
                dst = coefs[c["index"]]
                for by in range(v):
                    for bx in range(h):
                        blk = dst[my * v + by, mx * h + bx]
                        if ss == 0:                           # DC
                            if ah == 0:
                                s = bits.symbol(c["dc"].lut, path)
                                pred[ci] += bits.extend(s)
                                blk[0] = pred[ci] << al
                            elif bits.get(1):
                                blk[0] |= p1
                            continue
                        lut = c["ac"].lut
                        if ah == 0:                           # AC first
                            if eobrun:
                                eobrun -= 1
                                continue
                            k = ss
                            while k <= se:
                                rs = bits.symbol(lut, path)
                                r, s = rs >> 4, rs & 15
                                if s:
                                    k += r
                                    if k > 63:
                                        raise ValueError(f"{path}: AC coefficients beyond the block")
                                    blk[k] = bits.extend(s) << al
                                    k += 1
                                elif r == 15:
                                    k += 16
                                else:
                                    eobrun = (1 << r) + bits.get(r) - 1
                                    break
                            continue
                        k = ss                                # AC refinement
                        if not eobrun:
                            while k <= se:
                                rs = bits.symbol(lut, path)
                                r, s = rs >> 4, rs & 15
                                if s:
                                    s = p1 if bits.get(1) else m1
                                elif r != 15:
                                    eobrun = (1 << r) + bits.get(r)
                                    break
                                # skip r zero coefficients (ZRL: 16), refining
                                # the nonzero ones passed on the way
                                while k <= se:
                                    coef = int(blk[k])
                                    if coef:
                                        if bits.get(1) and not coef & p1:
                                            blk[k] = coef + (p1 if coef >= 0 else m1)
                                    else:
                                        if r == 0:
                                            break
                                        r -= 1
                                    k += 1
                                if s:
                                    if k > 63:
                                        raise ValueError(f"{path}: AC coefficients beyond the block")
                                    blk[k] = s
                                k += 1
                        if eobrun:
                            # the rest of the band: one correction bit per
                            # nonzero coefficient, read together
                            nz = np.flatnonzero(blk[k:se + 1])
                            if nz.size:
                                word = bits.get(int(nz.size))
                                for i, z in enumerate(nz):
                                    if (word >> (nz.size - 1 - i)) & 1:
                                        coef = int(blk[k + z])
                                        if not coef & p1:
                                            blk[k + z] = coef + (p1 if coef >= 0 else m1)
                            eobrun -= 1


def _frame_layout(frame, height, width):
    """Sampling checks and block geometry of a frame's components: each
    gets `index`, its MCU-padded block array (by, bx), its samples (ch, cw)
    and its own blocks (bh, bw), the extent of a non-interleaved scan ->
    (hmax, vmax, mcux, mcuy)."""
    sampling = tuple((c["h"], c["v"]) for c in frame)
    if len(frame) not in (1, 3):
        raise NotImplementedError(f"{len(frame)} components are not decoded")
    if len(frame) == 3 and sampling not in (((1, 1),) * 3, ((2, 1), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1))):
        raise NotImplementedError(f"sampling {sampling} is not decoded (4:4:4, 4:2:2, 4:2:0 are)")
    if len(frame) == 1:
        frame[0]["h"] = frame[0]["v"] = 1
    hmax = max(c["h"] for c in frame)
    vmax = max(c["v"] for c in frame)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for i, c in enumerate(frame):
        ch, cw = -(-height * c["v"] // vmax), -(-width * c["h"] // hmax)     # the component's samples
        c.update(index=i, by=mcuy * c["v"], bx=mcux * c["h"], ch=ch, cw=cw, bh=-(-ch // 8), bw=-(-cw // 8))
    return hmax, vmax, mcux, mcuy


def _scan_components(body, by_id, dht, path):
    ns = body[0]
    comps = []
    for k in range(ns):
        c = dict(by_id[body[1 + 2 * k]])
        td, ta = body[2 + 2 * k] >> 4, body[2 + 2 * k] & 15
        c.update(dc=dht.get((0, td)), ac=dht.get((1, ta)))
        comps.append(c)
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    return comps, ss, se, a >> 4, a & 15


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A baseline or progressive JPEG -> (H, W, 3) uint8 RGB, pixel for
    pixel as libjpeg-turbo decodes it at cv2's defaults (islow IDCT, fancy
    upsampling)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qt, dht, frame, restart, progressive, coefs = {}, {}, None, 0, False, None
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: JPEG marker expected at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:
            if coefs is None:
                raise ValueError(f"{path}: JPEG ends before its scan")
            break
        if pos + 4 > len(data):
            raise ValueError(f"{path}: JPEG marker expected at byte {pos}")
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in (0xC1, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            kind = "arithmetic-coded" if marker >= 0xC9 else (
                "hierarchical" if marker >= 0xC5 else "non-baseline")
            raise NotImplementedError(f"{path}: {kind} JPEG (SOF{marker - 0xC0}) is not decoded "
                                      f"({ROADMAP_ENTRY})")
        if marker == 0xCC:
            raise NotImplementedError(f"{path}: arithmetic-coded JPEG (DAC) is not decoded ({ROADMAP_ENTRY})")
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    raise NotImplementedError(f"{path}: 16-bit quantisation tables are not decoded")
                zz = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = zz
                qt[tq] = q.reshape(8, 8)
                i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                dht[(tc, th)] = _Huffman(counts, list(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif marker in (0xC0, 0xC2):
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"{path}: {precision}-bit JPEG is not decoded")
            if height == 0:
                raise NotImplementedError(f"{path}: a JPEG whose height follows in a DNL marker is not decoded")
            progressive = marker == 0xC2
            frame = [dict(id=body[6 + 3 * k], h=body[7 + 3 * k] >> 4, v=body[7 + 3 * k] & 15,
                          tq=body[8 + 3 * k]) for k in range(nc)]
            try:
                hmax, vmax, mcux, mcuy = _frame_layout(frame, height, width)
            except NotImplementedError as e:
                raise NotImplementedError(f"{path}: {e}") from None
            coefs = [np.zeros((c["by"], c["bx"], 64), np.int32) for c in frame]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            comps, ss, se, ah, al = _scan_components(body, {c["id"]: c for c in frame}, dht, path)
            seg, starts, end = _unstuff(data[pos:], path)
            if not progressive:
                if len(comps) != len(frame):
                    raise NotImplementedError(f"{path}: {len(frame)} components in {len(comps)} scans are not "
                                              "decoded")
                if (ss, se, ah, al) != (0, 63, 0, 0):
                    raise NotImplementedError(f"{path}: the scan is not baseline sequential")
                # (a single-component frame has one block per MCU, so its
                # MCU-padded blocks are its own)
                for c, out in zip(comps, _decode_scan(seg, starts, comps, mcux, mcuy, restart, path)):
                    coefs[c["index"]] = out
                break
            if ss > se or se > 63 or (ss == 0) != (se == 0) or (ss and len(comps) != 1):
                raise ValueError(f"{path}: invalid progressive scan (Ss {ss}, Se {se}, {len(comps)} components)")
            _decode_progressive_scan(seg, starts, comps, coefs, ss, se, ah, al, mcux, mcuy, restart, path)
            pos += end
    planes = []
    for c, zz in zip(frame, coefs):
        nat = np.zeros(zz.shape, np.int64)
        nat[..., _ZIGZAG] = zz
        deq = nat.reshape(-1, 8, 8) * qt[c["tq"]]
        blocks = _idct_islow(deq).reshape(zz.shape[0], zz.shape[1], 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(zz.shape[0] * 8, zz.shape[1] * 8)
        planes.append(plane[:c["ch"], :c["cw"]])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    y, cb, cr = planes
    if cb.shape[1] <= 2 and (hmax, vmax) != (1, 1):
        # libjpeg-turbo upsamples fewer than three columns by replication
        # (jinit_upsampler: fancy only where downsampled_width > 2)
        cb, cr = (np.repeat(np.repeat(c, vmax, 0), hmax, 1)[:height, :width] for c in (cb, cr))
    elif (hmax, vmax) == (2, 1):
        cb, cr = _fancy_h2v1(cb, width), _fancy_h2v1(cr, width)
    elif (hmax, vmax) == (2, 2):
        cb, cr = _fancy_h2v2(cb, height, width), _fancy_h2v2(cr, height, width)
    return _ycc_to_rgb(y, cb, cr)


def read_jpeg(path: str) -> np.ndarray:
    """A baseline or progressive JPEG file -> (H, W, 3) uint8 RGB, the pixels of
    `cv2.imread(path)` (which returns them in BGR order)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


# ---------------------------------------------------------------------------
# encoding

# ITU-T T.81 Annex K: the quantisation tables (zigzag order) and the
# Huffman table specifications (16 counts, then the symbols), as libjpeg
# writes them
_STD_QUANT_ZZ = (
    bytes.fromhex("100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933383740485c"
                  "4e404457453738506d51575f626768673e4d71797064785c656763"),
    bytes.fromhex("1112121815182f1a1a2f63423842" + "63" * 50),
)
_STD_HUFF = {
    (0, 0): bytes.fromhex("00010501010101010100000000000000000102030405060708090a0b"),
    (1, 0): bytes.fromhex(
        "0002010303020403050504040000017d01020300041105122131410613516107227114328191a1082342b1c115"
        "52d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a535455565758595a63"
        "6465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5"
        "b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (0, 1): bytes.fromhex("00030101010101010101010000000000000102030405060708090a0b"),
    (1, 1): bytes.fromhex(
        "00020102040403040705040400010277000102031104052131061241510761711322328108144291a1b1c10923"
        "3352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a"
        "636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3"
        "b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
_JFIF = bytes.fromhex("4a46494600010100000100010000")


def _quant_tables(quality: int):
    """jpeg_set_quality(quality, force_baseline=TRUE) (jcparam.c) -> the
    luminance and chrominance tables, (8, 8) int64 in natural order."""
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be 1-100, not {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    out = []
    for zz in _STD_QUANT_ZZ:
        base = np.frombuffer(zz, np.uint8).astype(np.int64)
        q = np.clip((base * scale + 50) // 100, 1, 255)
        nat = np.zeros(64, np.int64)
        nat[_ZIGZAG] = q
        out.append(nat.reshape(8, 8))
    return out


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantize with compute_reciprocal's divisors (jcdctmgr.c,
    16-bit DCTELEM): |x| -> ((|x| + corr) * recip) >> shift, sign restored."""
    divisor = (qtable.reshape(-1) * 8).astype(np.int64)
    b = np.floor(np.log2(divisor)).astype(np.int64)
    r = 16 + b
    fq = (np.int64(1) << r) // divisor
    fr = (np.int64(1) << r) % divisor
    c = divisor // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > divisor // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= divisor // 2), c + 1, c)
    x = coef.reshape(len(coef), 64)
    q = ((np.abs(x) + c) * fq) >> r
    return np.where(x < 0, -q, q).reshape(coef.shape)


def _huff_codes(spec: bytes):
    """A Huffman table specification -> (code, length) per symbol (256,)."""
    counts, symbols = spec[:16], spec[16:]
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _bit_size(x: np.ndarray) -> np.ndarray:
    a = np.abs(x)
    s = np.zeros(a.shape, np.int64)
    while (a >> s).any():
        s += (a >> s) > 0
    return s


def _entropy_code(blocks: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Quantised blocks (N, 8, 8) in scan order, their component index (N,)
    and per component (DC codes, AC codes) -> the byte-stuffed scan."""
    n = len(blocks)
    zz = blocks.reshape(n, 64)[:, _ZIGZAG]
    # DC differences against the previous block of the same component
    diff = zz[:, 0].copy()
    for ci in np.unique(comp):
        sel = np.nonzero(comp == ci)[0]
        diff[sel[1:]] = zz[sel[1:], 0] - zz[sel[:-1], 0]
    items = []                                  # (key, component, symbol, extra, n extra, ac)
    s = _bit_size(diff)
    extra = np.where(diff < 0, diff + (np.int64(1) << s) - 1, diff)
    items.append((np.arange(n) * 256, comp, s, extra, s, np.zeros(n, bool)))
    b, p = np.nonzero(zz[:, 1:])
    p = p + 1
    v = zz[b, p]
    first = np.r_[True, b[1:] != b[:-1]]
    prev = np.where(first, 0, np.r_[0, p[:-1]])
    run = p - prev - 1
    nzrl = run // 16
    sv = _bit_size(v)
    items.append((b * 256 + p * 4 + 3, comp[b], (run % 16) * 16 + sv,
                  np.where(v < 0, v + (np.int64(1) << sv) - 1, v), sv, np.ones(len(b), bool)))
    zb = np.repeat(np.arange(len(b)), nzrl)
    zj = np.arange(len(zb)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    items.append((b[zb] * 256 + p[zb] * 4 + zj, comp[b[zb]], np.full(len(zb), 0xF0),
                  np.zeros(len(zb), np.int64), np.zeros(len(zb), np.int64), np.ones(len(zb), bool)))
    last = np.full(n, 0)
    if len(b):
        last[b] = p                              # the last write per block wins
    eob = np.nonzero(last < 63)[0]
    items.append((eob * 256 + 255, comp[eob], np.zeros(len(eob), np.int64),
                  np.zeros(len(eob), np.int64), np.zeros(len(eob), np.int64), np.ones(len(eob), bool)))
    key, ci, sym, ext, next_, ac = (np.concatenate([it[k] for it in items]) for k in range(6))
    order = np.argsort(key, kind="stable")
    ci, sym, ext, next_, ac = ci[order], sym[order], ext[order], next_[order], ac[order]
    code = np.zeros(len(sym), np.int64)
    clen = np.zeros(len(sym), np.int64)
    for c in np.unique(ci):
        for is_ac in (False, True):
            sel = (ci == c) & (ac == is_ac)
            code_of, len_of = tables[c][int(is_ac)]
            code[sel], clen[sel] = code_of[sym[sel]], len_of[sym[sel]]
    if (clen == 0).any():
        raise ValueError("a symbol without a Huffman code")
    val = (code << next_) | ext
    length = clen + next_
    # every field's bits, most significant first, then 1-padding to a byte
    width = int(length.max(initial=1))
    j = np.arange(width)
    bits = (val[:, None] >> (length[:, None] - 1 - j)) & 1
    bits = bits[j < length[:, None]]
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _pad_edges(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the last row and column out to (h, w)."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])), mode="edge")


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB (sampled 4:2:0) or (H, W) uint8 grey -> the
    baseline JPEG that cv2.imwrite writes for it at IMWRITE_JPEG_QUALITY
    `quality` (cv2 takes BGR: pass the same image in RGB)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a baseline JPEG holds at most 65535 x 65535 pixels, not {h} x {w}")
    qtabs = _quant_tables(quality)
    tables = [(_huff_codes(_STD_HUFF[(0, t)]), _huff_codes(_STD_HUFF[(1, t)])) for t in (0, 1)]
    if img.ndim == 2:
        comps = [(1, 1, 1, 0)]                    # id, h, v, table
        bx, by = -(-w // 8), -(-h // 8)
        plane = _pad_edges(img, by * 8, bx * 8)
        blocks = plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        coef = _quantize(_fdct_islow(blocks), qtabs[0])
        comp = np.zeros(len(coef), np.int64)
        scan_tables = [tables[0]]
    else:
        comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
        y, cb, cr = _rgb_to_ycc(img)
        mx, my = -(-w // 16), -(-h // 16)
        ybx, yby = -(-w // 8), -(-h // 8)           # Y's real blocks
        yp = _pad_edges(y, my * 16, mx * 16)
        yblocks = yp.reshape(my * 2, 8, mx * 2, 8).transpose(0, 2, 1, 3)
        ycoef = _quantize(_fdct_islow(yblocks.reshape(-1, 8, 8)), qtabs[0]).reshape(my * 2, mx * 2, 8, 8)
        # dummy blocks past the image's blocks: zero AC, the DC of the block
        # before them in the MCU (jccoefct.c compress_data)
        if ybx < mx * 2:
            ycoef[:, ybx:] = 0
            ycoef[:, ybx:, 0, 0] = ycoef[:, ybx - 1, 0, 0][:, None]
        if yby < my * 2:
            ycoef[yby:] = 0
            ycoef[yby:, :, 0, 0] = ycoef[yby - 1, 1::2, 0, 0].repeat(2)[None, :]
        chroma = []
        for c in (cb, cr):
            # h2v2_downsample: edges replicated, bias 1, 2, 1, 2, ... per row
            cp = _pad_edges(c, -(-h // 2) * 2, mx * 16).astype(np.int64)
            bias = np.tile([1, 2], mx * 4)
            down = (cp[0::2, 0::2] + cp[0::2, 1::2] + cp[1::2, 0::2] + cp[1::2, 1::2] + bias) >> 2
            down = _pad_edges(down.astype(np.uint8), my * 8, mx * 8)
            cblocks = down.reshape(my, 8, mx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
            chroma.append(_quantize(_fdct_islow(cblocks), qtabs[1]).reshape(my, mx, 8, 8))
        # MCU order: Y00 Y01 Y10 Y11 Cb Cr
        yq = ycoef.reshape(my, 2, mx, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5).reshape(my, mx, 4, 8, 8)
        coef = np.concatenate([yq, chroma[0][:, :, None], chroma[1][:, :, None]], axis=2).reshape(-1, 8, 8)
        comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
        scan_tables = [tables[0], tables[1], tables[1]]
    scan = _entropy_code(coef, comp, scan_tables)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = [b"\xff\xd8", seg(0xE0, _JFIF)]
    for t in sorted({c[3] for c in comps}):
        out.append(seg(0xDB, bytes([t]) + qtabs[t].reshape(-1)[_ZIGZAG].astype(np.uint8).tobytes()))
    out.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, len(comps))
                   + b"".join(bytes([cid, (ch << 4) | cv, t]) for cid, ch, cv, t in comps)))
    for t in sorted({c[3] for c in comps}):
        out.append(seg(0xC4, bytes([0x00 | t]) + _STD_HUFF[(0, t)]))
        out.append(seg(0xC4, bytes([0x10 | t]) + _STD_HUFF[(1, t)]))
    out.append(seg(0xDA, bytes([len(comps)]) + b"".join(bytes([cid, (t << 4) | t]) for cid, _, _, t in comps)
                   + b"\x00\x3f\x00"))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write `img` ((H, W, 3) RGB or (H, W) grey) as `cv2.imwrite(path,
    bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])` writes the same image."""
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)
