"""A JPEG writer for the kinds PIL reads but does not write, and the cases
of tests/test_torch_jpeg_kinds.py.

`write_jpeg(pixels, **spec)` encodes an (H, W, C) uint8 array, C = 1, 3
or 4, with numpy and the standard library only (chip_smoke.py runs it on
the card's host, which has no PIL).  Its channels are the file's
component samples as they stand: the writer converts no colour, so the
markers (JFIF, Adobe and its transform, the component ids) alone say
what the decoder makes of them.  It writes:

  - any sampling factors (1-4, integral ratios or not) on 1, 3 or 4
    components, each scan interleaved or not;
  - sequential and progressive Huffman frames, with optimal tables
    (a DHT before each scan), the T.81 Annex K.3 tables in a DHT, or no
    DHT at all (Motion-JPEG's frames, whose decoder supplies those
    tables);
  - arithmetic-coded frames (T.81 Annex D's QM coder, Annex F / G's
    models), sequential or progressive, with DAC conditioning;
  - lossless frames (SOF3, Annex H): predictors 1-7 and a point
    transform;
  - restart intervals in every kind.

CASES names each case: its seeded image and its spec.  REFUSED names the
files PIL refuses (a precision other than 8, a hierarchical or lossless
arithmetic frame, fractional sampling, 2 components).  `python
tests/golden/jpeg_kinds/write_fixtures.py` writes one file per case here
and digests.json: the mode, shape and sha256 of PIL's decode of each
file, with the PIL and libjpeg-turbo versions that made them.  Only that
needs PIL.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "digests.json")

# the natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# T.81 Annex K.1, natural order
_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
    99]), np.array([
        17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
        + [99] * 32))

# T.81 Annex K.3: (counts of code lengths 1-16, symbols) of the tables a
# decoder supplies for a scan whose table 0 or 1 no DHT defined
STD_HUFFMAN = {
    ("dc", 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                tuple(range(12))),
    ("dc", 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                tuple(range(12))),
    ("ac", 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), (
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
        0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
        0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
        0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
        0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
        0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
        0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
        0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
        0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
        0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA)),
    ("ac", 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
        0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
        0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
        0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
        0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
        0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
        0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
        0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
        0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
        0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
        0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
        0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
        0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA)),
}

# T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS; the last
# row is the fixed probability 0.5 of T.851
_QE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]
FIXED_BIN = 113  # the state of the bin coded at probability 0.5

# libjpeg's progressive script (jcparam.c's jpeg_simple_progression) for
# three components; for another count its DC and luma scans with every
# component's AC scans
def simple_progression(ncomp: int):
    if ncomp == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    script = [(tuple(range(ncomp)), 0, 0, 0, 1)]
    for c in range(ncomp):
        script += [((c,), 1, 5, 0, 2), ((c,), 6, 63, 0, 2),
                   ((c,), 1, 63, 2, 1)]
    script.append((tuple(range(ncomp)), 0, 0, 1, 0))
    script += [((c,), 1, 63, 1, 0) for c in range(ncomp)]
    return script


def quant_table(quality: int, chroma: bool) -> np.ndarray:
    """jcparam.c's jpeg_set_quality scaling of Annex K.1's table,
    natural order, entries clamped to 1-255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = (_QUANT[int(chroma)] * scale + 50) // 100
    return np.clip(q, 1, 255)


def _nbits(v: int) -> int:
    return int(v).bit_length()


# ---- the MCU grid ------------------------------------------------------------

class _Frame:
    """Sizes of a frame's components (T.81 A.1.1) for a data unit of 8
    (DCT) or 1 (lossless) samples."""

    def __init__(self, width, height, sampling, unit):
        self.width, self.height, self.unit = width, height, unit
        self.sampling = sampling
        self.max_h = max(h for h, _ in sampling)
        self.max_v = max(v for _, v in sampling)
        self.mcus_x = -(-width // (unit * self.max_h))
        self.mcus_y = -(-height // (unit * self.max_v))
        self.ds = [(-(-width * h // self.max_h), -(-height * v // self.max_v))
                   for h, v in sampling]
        # (units across, units down) with data, and to the MCU grid
        self.units = [(-(-w // unit), -(-hh // unit)) for w, hh in self.ds]
        self.padded = [(self.mcus_x * h, self.mcus_y * v)
                       for h, v in sampling]

    def mcus(self, comps):
        """Each MCU of a scan over comps: [(position in the scan, component,
        unit row, unit column), ...]."""
        if len(comps) == 1:
            c = comps[0]
            bw, bh = self.units[c]
            for by in range(bh):
                for bx in range(bw):
                    yield [(0, c, by, bx)]
            return
        for my in range(self.mcus_y):
            for mx in range(self.mcus_x):
                mcu = []
                for i, c in enumerate(comps):
                    h, v = self.sampling[c]
                    for y in range(v):
                        for x in range(h):
                            mcu.append((i, c, my * v + y, mx * h + x))
                yield mcu

    def mcus_per_row(self, comps):
        return self.units[comps[0]][0] if len(comps) == 1 else self.mcus_x


def _downsample(channel: np.ndarray, frame: _Frame, c: int) -> np.ndarray:
    """The component's samples: box means over an integral ratio, the
    nearest sample over another."""
    h, v = frame.sampling[c]
    ds_w, ds_h = frame.ds[c]
    rh, rv = frame.max_h // h, frame.max_v // v
    if frame.max_h % h == 0 and frame.max_v % v == 0:
        pad = np.pad(channel.astype(np.float64),
                     ((0, ds_h * rv - channel.shape[0]),
                      (0, ds_w * rh - channel.shape[1])), mode="edge")
        mean = pad.reshape(ds_h, rv, ds_w, rh).mean(axis=(1, 3))
        return np.clip(np.rint(mean), 0, 255).astype(np.int64)
    ys = np.minimum(np.arange(ds_h) * frame.max_v // v, frame.height - 1)
    xs = np.minimum(np.arange(ds_w) * frame.max_h // h, frame.width - 1)
    return channel[ys][:, xs].astype(np.int64)


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) * 0.5
    m[0] *= np.sqrt(0.5)
    return m


_DCT = _dct_matrix()


def _coefficients(samples, frame: _Frame, c: int, quant) -> np.ndarray:
    """(blocks down, blocks across, 64) quantised DCT coefficients, natural
    order, over the MCU grid (the samples' edges repeated)."""
    bw, bh = frame.padded[c]
    pad = np.pad(samples.astype(np.float64),
                 ((0, 8 * bh - samples.shape[0]),
                  (0, 8 * bw - samples.shape[1])), mode="edge") - 128.0
    blocks = pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT).reshape(
        bh, bw, 64)
    q = np.rint(coef / quant).astype(np.int64)
    q[..., 1:] = np.clip(q[..., 1:], -1023, 1023)
    return q


# ---- Huffman coding ----------------------------------------------------------

class _Bits:
    """The entropy-coded segment of a Huffman scan: bits MSB first, FF
    stuffed with 00, padded with ones before a marker."""

    def __init__(self, out: bytearray):
        self.out = out
        self.acc = 0
        self.n = 0

    def put(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _codes(counts, symbols) -> dict:
    """symbol -> (code, length) of a table given as (counts, symbols)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def optimal_table(freq: dict):
    """jchuff.c's jpeg_gen_optimal_table: (counts, symbols) of a code no
    longer than 16 bits, with the all-ones code of any length unused."""
    f = [0] * 257
    for s, n in freq.items():
        f[s] = n
    f[256] = 1  # the reserved code point
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v1 = v2 = None
        for i in range(257):
            if f[i]:
                if v1 is None or f[i] <= v1:
                    v2, c2, v1, c1 = v1, c1, f[i], i
                elif v2 is None or f[i] <= v2:
                    v2, c2 = f[i], i
        if c2 < 0:
            break
        f[c1] += f[c2]
        f[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = [s for size in range(1, 33) for s in range(256)
               if codesize[s] == size]
    return tuple(bits[1:17]), tuple(symbols)


class _HuffmanScan:
    """Symbol and bit sinks of one Huffman scan: a counting pass (for
    optimal tables) or the writing pass."""

    def __init__(self, out=None, tables=None):
        self.bits = _Bits(out) if out is not None else None
        self.tables = tables
        self.freq = {}

    def sym(self, table, s) -> None:
        if self.bits is None:
            f = self.freq.setdefault(table, {})
            f[s] = f.get(s, 0) + 1
        else:
            code, length = self.tables[table][s]
            self.bits.put(code, length)

    def put(self, value, n) -> None:
        if self.bits is not None:
            self.bits.put(value, n)


def _huff_value(scan, table, v) -> None:
    """A DC difference, or a lossless sample difference: its magnitude
    category, then its bits."""
    s = _nbits(abs(v))
    scan.sym(table, s)
    if s and s < 16:
        scan.put(v if v >= 0 else v - 1, s)


class _HuffmanCoder:
    """One Huffman scan's state: DC predictors, the EOB run and its
    correction bits (jcphuff.c)."""

    def __init__(self, sink, ncomp, max_eobrun):
        self.s = sink
        self.max_eobrun = max_eobrun
        self.reset(ncomp)

    def reset(self, ncomp):
        self.last_dc = [0] * ncomp
        self.eobrun = 0
        self.be = []

    def emit_eobrun(self, table):
        if self.eobrun > 0:
            n = _nbits(self.eobrun) - 1
            self.s.sym(table, n << 4)
            if n:
                self.s.put(self.eobrun, n)
            self.eobrun = 0
            for b in self.be:
                self.s.put(b, 1)
            self.be = []

    def sequential(self, blk, i, dct, act):
        _huff_value(self.s, dct, int(blk[0]) - self.last_dc[i])
        self.last_dc[i] = int(blk[0])
        zz = blk[ZIGZAG]
        nz = np.flatnonzero(zz[1:]) + 1
        k0 = 0
        for k in nz:
            r = k - k0 - 1
            while r > 15:
                self.s.sym(act, 0xF0)
                r -= 16
            v = int(zz[k])
            s = _nbits(abs(v))
            self.s.sym(act, (r << 4) | s)
            self.s.put(v if v >= 0 else v - 1, s)
            k0 = k
        if k0 < 63:
            self.s.sym(act, 0)

    def dc_first(self, blk, i, dct, al):
        t = int(blk[0]) >> al
        _huff_value(self.s, dct, t - self.last_dc[i])
        self.last_dc[i] = t

    def dc_refine(self, blk, al):
        self.s.put((int(blk[0]) >> al) & 1, 1)

    def ac_first(self, blk, act, ss, se, al):
        r = 0
        for k in range(ss, se + 1):
            v = int(blk[ZIGZAG[k]])
            mag = (-v if v < 0 else v) >> al
            if mag == 0:
                r += 1
                continue
            self.emit_eobrun(act)
            while r > 15:
                self.s.sym(act, 0xF0)
                r -= 16
            s = _nbits(mag)
            self.s.sym(act, (r << 4) + s)
            self.s.put(mag if v >= 0 else ~mag, s)
            r = 0
        if r > 0:
            self.eobrun += 1
            if self.eobrun == self.max_eobrun:
                self.emit_eobrun(act)

    def ac_refine(self, blk, act, ss, se, al):
        mags = [abs(int(blk[ZIGZAG[k]])) >> al for k in range(64)]
        eob = 0
        for k in range(ss, se + 1):
            if mags[k] == 1:
                eob = k
        r = 0
        br = []
        for k in range(ss, se + 1):
            t = mags[k]
            if t == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.emit_eobrun(act)
                self.s.sym(act, 0xF0)
                r -= 16
                for b in br:
                    self.s.put(b, 1)
                br = []
            if t > 1:
                br.append(t & 1)
                continue
            self.emit_eobrun(act)
            self.s.sym(act, (r << 4) + 1)
            self.s.put(0 if blk[ZIGZAG[k]] < 0 else 1, 1)
            for b in br:
                self.s.put(b, 1)
            br = []
            r = 0
        if r > 0 or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == self.max_eobrun or len(self.be) > 937:
                self.emit_eobrun(act)


# ---- arithmetic coding (T.81 Annex D, jcarith.c) ---------------------------

class _QMCoder:
    """The QM encoder of T.81 D.1 with jcarith.c's byte output."""

    def __init__(self, out: bytearray):
        self.out = out
        self.reset()

    def reset(self):
        self.c = 0
        self.a = 0x10000
        self.ct = 11
        self.sc = 0
        self.zc = 0
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def _byte_out(self):
        temp = self.c >> 19
        if temp > 0xFF:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
            self.buffer = temp & 0xFF
        self.c &= 0x7FFFF
        self.ct += 8

    def encode(self, st, i, val):
        sv = st[i]
        qe, nl, nm, switch = _QE[sv & 0x7F]
        mps = sv >> 7
        a = self.a - qe
        if val != mps:  # the less probable symbol
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (mps ^ switch) << 7 | nl
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = sv & 0x80 | nm
        while True:
            a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out()
            if a >= 0x8000:
                break
        self.a = a

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        # the final bytes only where they are not zero: the decoder reads
        # zeros from the marker on
        if self.c & 0x7FFF800:
            self._zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)


class _ArithCoder:
    """One arithmetic scan's models (T.81 F.1.4, G.1.3; jcarith.c)."""

    def __init__(self, out, ncomp, dac):
        self.qm = _QMCoder(out)
        self.dac = dac
        self.dc_stats = {}
        self.ac_stats = {}
        self.fixed = [FIXED_BIN]
        self.last_dc = [0] * ncomp
        self.dc_context = [0] * ncomp

    def reset(self, dc_tables, ac_tables):
        for t in dc_tables:
            self.dc_stats[t] = [0] * 64
        for t in ac_tables:
            self.ac_stats[t] = [0] * 256
        self.last_dc = [0] * len(self.last_dc)
        self.dc_context = [0] * len(self.dc_context)

    def _magnitude(self, st, base, v, ac_k=None):
        """Figures F.8 and F.9 for v = |value| - 1, from bin base."""
        enc = self.qm.encode
        m = 0
        if v:
            enc(st, base, 1)
            m = 1
            v2 = v
            if ac_k is None:  # DC: X1 is bin 20
                base = 20
                while v2 >> 1:
                    v2 >>= 1
                    enc(st, base, 1)
                    m <<= 1
                    base += 1
            else:
                v2 >>= 1
                if v2:
                    enc(st, base, 1)
                    m <<= 1
                    base = ac_k
                    while v2 >> 1:
                        v2 >>= 1
                        enc(st, base, 1)
                        m <<= 1
                        base += 1
        enc(st, base, 0)
        return m, base + 14

    def dc(self, value, i, tbl):
        enc = self.qm.encode
        st = self.dc_stats[tbl]
        s0 = self.dc_context[i]
        v = value - self.last_dc[i]
        if v == 0:
            enc(st, s0, 0)
            self.dc_context[i] = 0
            return
        self.last_dc[i] = value
        enc(st, s0, 1)
        if v > 0:
            enc(st, s0 + 1, 0)
            base = s0 + 2
            ctx = 4
        else:
            v = -v
            enc(st, s0 + 1, 1)
            base = s0 + 3
            ctx = 8
        v -= 1
        m, base = self._magnitude(st, base, v)
        lo, hi = self.dac.get(("dc", tbl), (0, 1))
        if m < (1 << lo) >> 1:
            ctx = 0
        elif m > (1 << hi) >> 1:
            ctx += 8
        self.dc_context[i] = ctx
        while m > 1:
            m >>= 1
            enc(st, base, 1 if m & v else 0)

    def _ac_value(self, st, k, tbl, mag, negative):
        enc = self.qm.encode
        enc(self.fixed, 0, 1 if negative else 0)
        kk = self.dac.get(("ac", tbl), 5)
        m, base = self._magnitude(st, 3 * (k - 1) + 2, mag - 1,
                                  189 if k <= kk else 217)
        v = mag - 1
        while m > 1:
            m >>= 1
            enc(st, base, 1 if m & v else 0)

    def ac(self, blk, tbl, ss, se, al):
        """Sequential (ss 1, se 63, al 0) or a progressive first AC scan."""
        enc = self.qm.encode
        st = self.ac_stats[tbl]
        mags = [(abs(int(blk[ZIGZAG[k]])) >> al) for k in range(64)]
        ke = se
        while ke > 0 and mags[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            enc(st, 3 * (k - 1), 0)
            while mags[k] == 0:
                enc(st, 3 * (k - 1) + 1, 0)
                k += 1
            enc(st, 3 * (k - 1) + 1, 1)
            self._ac_value(st, k, tbl, mags[k], blk[ZIGZAG[k]] < 0)
            k += 1
        if k <= se:
            enc(st, 3 * (k - 1), 1)

    def dc_refine(self, blk, al):
        self.qm.encode(self.fixed, 0, (int(blk[0]) >> al) & 1)

    def ac_refine(self, blk, tbl, ss, se, al):
        enc = self.qm.encode
        st = self.ac_stats[tbl]
        mags = [(abs(int(blk[ZIGZAG[k]])) >> al) for k in range(64)]
        ke = se
        while ke > 0 and mags[ke] == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (mags[kex] >> 1) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            if k > kex:
                enc(st, 3 * (k - 1), 0)
            while True:
                t = mags[k]
                if t:
                    if t >> 1:
                        enc(st, 3 * (k - 1) + 2, t & 1)
                    else:
                        enc(st, 3 * (k - 1) + 1, 1)
                        enc(self.fixed, 0, 1 if blk[ZIGZAG[k]] < 0 else 0)
                    break
                enc(st, 3 * (k - 1) + 1, 0)
                k += 1
            k += 1
        if k <= se:
            enc(st, 3 * (k - 1), 1)


# ---- markers -----------------------------------------------------------------

def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def _dht(tables) -> bytes:
    body = b""
    for (cls, th), (counts, symbols) in sorted(tables.items()):
        body += bytes([(cls == "ac") << 4 | th]) + bytes(counts) + bytes(
            symbols)
    return _segment(0xC4, body)


# ---- the writer --------------------------------------------------------------

def _default_ids(ncomp, ids):
    if ids is not None:
        return list(ids)
    return [1, 2, 3, 4][:ncomp]


def _lossless_diffs(samples, psv, pt, first_rows):
    """Annex H.1.2's differences of one component's samples after the
    point transform: the first row of the scan and of each restart
    interval predicted from 2^(7-pt) and its left neighbour, the first
    column from the sample above, the rest from predictor psv."""
    x = samples >> pt
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
            5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
            7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    for r in first_rows:
        pred[r, 0] = 1 << (7 - pt)
        pred[r, 1:] = x[r, :-1]
    d = (x - pred) & 0xFFFF
    return np.where(d >= 0x8000, d - 0x10000, d)


def write_jpeg(pixels: np.ndarray, *, sampling=None, coding="huffman",
               script=None, dht="optimal", jfif=None, adobe=None, ids=None,
               quality=75, restart=0, dac=None, predictor=1, pt=0,
               precision=8, sof=None, tables=None,
               coefficients=None) -> bytes:
    """The JPEG file of pixels (H, W, C) uint8.

    sampling: (h, v) per component (default all (1, 1)).
    coding: "huffman", "arithmetic" or "lossless".
    script: the scans as (components, Ss, Se, Ah, Al); progressive when
      any scan is not (components, 0, 63, 0, 0) (lossless: Ss is the
      predictor, default one interleaved scan).  Default: one interleaved
      sequential scan.
    dht: "optimal" (a DHT before each scan), "standard" (Annex K.3's
      tables in one DHT) or None (no DHT: the decoder's default tables,
      progressive EOB runs one block long).
    jfif / adobe: write APP0 JFIF (default: for 1 or 3 components without
      an Adobe marker) / APP14 Adobe with this transform.
    ids: the component ids (default 1, 2, 3, 4).
    restart: the restart interval in MCUs (DRI).
    dac: {("dc", table): (L, U), ("ac", table): Kx} for a DAC segment.
    precision, sof: the SOF's precision and marker as written (for the
      files PIL refuses); tables: component -> (DC, AC) table numbers.
    coefficients: a function (frame, component) -> the (blocks down,
      blocks across, 64) quantised coefficients, natural order, written
      in place of the pixels' DCT (the IDCT's out-of-range cases).
    """
    img = pixels if pixels.ndim == 3 else pixels[..., None]
    height, width, ncomp = img.shape
    sampling = list(sampling or [(1, 1)] * ncomp)
    lossless = coding == "lossless"
    frame = _Frame(width, height, sampling, 1 if lossless else 8)
    ids = _default_ids(ncomp, ids)
    tables = tables or {c: (int(c > 0), int(c > 0)) for c in range(ncomp)}
    if jfif is None:
        jfif = adobe is None and ncomp in (1, 3)
    if script is None:
        script = ([(tuple(range(ncomp)), predictor, 0, 0, pt)] if lossless
                  else [(tuple(range(ncomp)), 0, 63, 0, 0)])
    progressive = not lossless and any(
        s[1:] != (0, 63, 0, 0) for s in script)
    if sof is None:
        sof = {("huffman", False): 0xC1, ("huffman", True): 0xC2,
               ("arithmetic", False): 0xC9, ("arithmetic", True): 0xCA,
               ("lossless", False): 0xC3}[(coding, progressive)]
        if sof == 0xC1 and dht != "optimal":
            sof = 0xC0
    samples = [_downsample(img[..., c], frame, c) for c in range(ncomp)]

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                        + bytes([adobe]))
    coefs = None
    if not lossless:
        quants = [quant_table(quality, False), quant_table(quality, True)]
        out += _segment(0xDB, b"".join(
            bytes([t]) + bytes(quants[t][ZIGZAG].astype(np.uint8).tolist())
            for t in range(2)))
        coefs = [coefficients(frame, c) if coefficients else
                 _coefficients(samples[c], frame, c, quants[int(c > 0)])
                 for c in range(ncomp)]
    out += _segment(sof, struct.pack(">BHHB", precision, height, width,
                                     ncomp) + b"".join(
        bytes([ids[c], h << 4 | v, 0 if lossless else int(c > 0)])
        for c, (h, v) in enumerate(sampling)))
    if dac:
        out += _segment(0xCC, b"".join(
            bytes([(cls == "ac") << 4 | t,
                   val if cls == "ac" else val[1] << 4 | val[0]])
            for (cls, t), val in sorted(dac.items())))
    if dht == "standard":
        out += _dht(STD_HUFFMAN)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))

    for scan in script:
        comps, ss, se, ah, al = scan
        sos = _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], tables[c][0] << 4 | tables[c][1]])
            for c in comps) + bytes([ss, se, ah << 4 | al]))
        if coding == "arithmetic":
            out += sos
            _arith_scan(out, frame, coefs, scan, tables, dac or {}, restart,
                        progressive)
            continue
        codes = None
        if dht == "optimal":
            counter = _HuffmanScan()
            _huffman_scan(counter, frame, coefs, samples, scan, tables,
                          restart, lossless, None, 0x7FFF)
            made = {key: optimal_table(f) for key, f in counter.freq.items()}
            out += _dht(made)
            codes = {key: _codes(*t) for key, t in made.items()}
        else:
            # Annex K.3's tables; a table 2 or 3 no DHT defines is
            # written with table 0 or 1's codes
            codes = {(cls, t): _codes(*STD_HUFFMAN[(cls, t & 1)])
                     for cls in ("dc", "ac") for t in range(4)}
        out += sos
        _huffman_scan(_HuffmanScan(out, codes), frame, coefs, samples, scan,
                      tables, restart, lossless, out,
                      0x7FFF if dht == "optimal" else 1)
    out += b"\xff\xd9"
    return bytes(out)


def _restart_points(frame, comps, restart):
    n = 0
    for mcu in frame.mcus(comps):
        rst = None
        if restart and n and n % restart == 0:
            rst = (n // restart - 1) & 7
        yield rst, mcu
        n += 1


def _lossless_fast(sink, frame, comps, diffs, tables):
    """A lossless scan without restarts, vectorised: its differences in
    MCU order (dummy samples 0), their categories and bits packed at
    once."""
    vals, tbls = [], []
    for c in comps:
        d = diffs[c]
        if len(comps) == 1:
            vals.append(d.reshape(-1, 1))
        else:
            h, v = frame.sampling[c]
            pad = np.zeros((frame.mcus_y * v, frame.mcus_x * h), np.int64)
            pad[:d.shape[0], :d.shape[1]] = d
            vals.append(pad.reshape(frame.mcus_y, v, frame.mcus_x, h)
                        .transpose(0, 2, 1, 3).reshape(-1, v * h))
        tbls.append(np.full(vals[-1].shape, tables[c][0]))
    d = np.concatenate(vals, axis=1).reshape(-1)
    tbl = np.concatenate(tbls, axis=1).reshape(-1)
    cat = np.ceil(np.log2(np.abs(d) + 1)).astype(np.int64)
    if sink.bits is None:
        for t in np.unique(tbl):
            f = np.bincount(cat[tbl == t], minlength=17)
            counts = sink.freq.setdefault(("dc", int(t)), {})
            for s, n in enumerate(f.tolist()):
                if n:
                    counts[s] = counts.get(s, 0) + n
        return
    code = np.zeros(d.shape, np.int64)
    length = np.zeros(d.shape, np.int64)
    for t in np.unique(tbl):
        table = sink.tables[("dc", int(t))]
        at = tbl == t
        code[at] = np.array([table.get(s, (0, 0))[0] for s in range(17)])[
            cat[at]]
        length[at] = np.array([table.get(s, (0, 0))[1] for s in range(17)])[
            cat[at]]
    extra = np.where(d >= 0, d, d - 1) & ((1 << cat) - 1)
    value = (code << cat) | extra
    n = length + cat
    out = []
    for lo in range(0, d.size, 1 << 18):  # bits MSB first, in chunks
        v, k = value[lo:lo + (1 << 18)], n[lo:lo + (1 << 18)]
        item = np.repeat(np.arange(v.size), k)
        pos = np.arange(item.size) - np.repeat(np.cumsum(k) - k, k)
        out.append(((v[item] >> (k[item] - 1 - pos)) & 1).astype(np.uint8))
    bits = np.concatenate(out)
    bits = np.concatenate([bits, np.ones(-bits.size % 8, np.uint8)])
    packed = np.packbits(bits)
    stuffed = np.insert(packed, np.flatnonzero(packed == 0xFF) + 1, 0)
    sink.bits.out += stuffed.tobytes()


def _huffman_scan(sink, frame, coefs, samples, scan, tables, restart,
                  lossless, out, max_eobrun):
    comps, ss, se, ah, al = scan
    coder = _HuffmanCoder(sink, len(comps), max_eobrun)
    ac_first = ss > 0 and ah == 0
    diffs = None
    if lossless:
        per_row = frame.mcus_per_row(comps)
        rows = restart // per_row if restart else 0
        diffs = {}
        for c in comps:
            v = frame.sampling[c][1] if len(comps) > 1 else 1
            ds_h = frame.ds[c][1]
            firsts = [0] + ([r * v for r in range(rows, 10 ** 6, rows)
                             if r * v < ds_h] if rows else [])
            diffs[c] = _lossless_diffs(samples[c], ss, al, firsts)
        if not restart:
            _lossless_fast(sink, frame, comps, diffs, tables)
            return

    def end_segment():
        if ss > 0 and not lossless:
            coder.emit_eobrun(("ac", tables[comps[0]][1]))

    for rst, mcu in _restart_points(frame, comps, restart):
        if rst is not None:
            end_segment()
            if sink.bits is not None:
                sink.bits.flush()
                out += bytes([0xFF, 0xD0 + rst])
            coder.reset(len(comps))
        for i, c, by, bx in mcu:
            dct = ("dc", tables[c][0])
            act = ("ac", tables[c][1])
            if lossless:
                d = diffs[c]
                v = int(d[by, bx]) if (by < d.shape[0]
                                       and bx < d.shape[1]) else 0
                _huff_value(sink, dct, v)
                continue
            blk = coefs[c][by, bx]
            if ss == 0 and se == 63 and ah == 0 and al == 0:
                coder.sequential(blk, i, dct, act)
            elif ss == 0:
                if ah == 0:
                    coder.dc_first(blk, i, dct, al)
                else:
                    coder.dc_refine(blk, al)
            elif ac_first:
                coder.ac_first(blk, act, ss, se, al)
            else:
                coder.ac_refine(blk, act, ss, se, al)
    end_segment()
    if sink.bits is not None:
        sink.bits.flush()


def _arith_scan(out, frame, coefs, scan, tables, dac, restart, progressive):
    comps, ss, se, ah, al = scan
    coder = _ArithCoder(out, len(comps), dac)
    dc_tables = {tables[c][0] for c in comps} if (
        not progressive or (ss == 0 and ah == 0)) else set()
    ac_tables = {tables[c][1] for c in comps} if (
        not progressive or se) else set()
    coder.reset(dc_tables, ac_tables)
    for rst, mcu in _restart_points(frame, comps, restart):
        if rst is not None:
            coder.qm.finish()
            out += bytes([0xFF, 0xD0 + rst])
            coder.qm.reset()
            coder.reset(dc_tables, ac_tables)
        for i, c, by, bx in mcu:
            blk = coefs[c][by, bx]
            dtbl, atbl = tables[c]
            if not progressive:
                coder.dc(int(blk[0]), i, dtbl)
                coder.ac(blk, atbl, 1, 63, 0)
            elif ss == 0:
                if ah == 0:
                    coder.dc(int(blk[0]) >> al, i, dtbl)
                else:
                    coder.dc_refine(blk, al)
            elif ah == 0:
                coder.ac(blk, atbl, ss, se, al)
            else:
                coder.ac_refine(blk, atbl, ss, se, al)
    coder.qm.finish()


# ---- the cases -----------------------------------------------------------------

def _pixels(name: str, width: int, height: int, ncomp: int) -> np.ndarray:
    """A seeded image from the case's name: smooth colour waves, noise and
    a saturated checker (IDCT overshoot past 0 and 255)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, ncomp)
    img = np.stack([128 + 100 * np.sin(x / 7.0 + p) * np.cos(y / 5.0 - p)
                    for p in phase], -1)
    img += rng.normal(0.0, 8.0, img.shape)
    checker = ((x // 2 + y // 2) % 2 == 0)[..., None] * 255.0
    box = (x > width * 0.6) & (y < height * 0.4)
    img = np.where(box[..., None], checker, img)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


_Y420 = [(2, 2), (1, 1), (1, 1)]


def large_coefficients(frame, c: int) -> np.ndarray:
    """Seeded coefficients whose dequantised values (at quality 1) leave
    16 bits and whose IDCT leaves [0, 255] far: libjpeg-turbo's SIMD IDCT
    wraps and saturates in 16-bit lanes where jidctint.c's range table
    wraps.  One block in four is DC only, a DC near the 11-bit limit."""
    bw, bh = frame.padded[c]
    rng = np.random.default_rng(7 + c)
    coef = np.zeros((bh, bw, 64), np.int64)
    coef[..., 0] = rng.integers(-250, 251, (bh, bw))
    scale = rng.choice([1, 8, 25], (bh, bw, 1)) * 40
    ac = rng.integers(-1, 2, (bh, bw, 63)) * rng.integers(0, 1 << 10,
                                                            (bh, bw, 63))
    ac = np.clip(ac * scale // 1000, -1023, 1023)
    coef[..., 1:] = ac * (rng.random((bh, bw, 63)) < 0.3)
    dc_only = rng.random((bh, bw)) < 0.25
    coef[dc_only, 1:] = 0
    coef[dc_only, 0] = rng.choice([-1000, 1000], int(dc_only.sum()))
    return coef

_PROG3 = simple_progression(3)
# DC in two steps and AC of the luma only to Al 1: bits libjpeg estimates
_PARTIAL = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 63, 0, 1),
            ((0, 1, 2), 0, 0, 1, 0)]
_DC_ONLY = [((0, 1, 2), 0, 0, 0, 0)]
_LOW_AC = [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 5, 0, 0), ((1,), 1, 5, 0, 0),
           ((2,), 1, 5, 0, 0)]
_SEQ_SPLIT = [((0,), 0, 63, 0, 0), ((1,), 0, 63, 0, 0),
              ((2,), 0, 63, 0, 0)]
_DAC = {("dc", 0): (2, 5), ("dc", 1): (0, 0), ("ac", 0): 2, ("ac", 1): 9}

# name -> (width, height, components, write_jpeg's options)
CASES = {
    # Motion-JPEG: no DHT, the decoder's Annex K.3 tables
    "mjpeg_seq": (67, 45, 3, {"sampling": _Y420, "dht": None}),
    "mjpeg_seq_restart": (67, 45, 3, {"sampling": [(2, 1), (1, 1), (1, 1)],
                                      "dht": None, "restart": 5}),
    "mjpeg_gray": (33, 17, 1, {"dht": None}),
    "standard_dht": (33, 17, 3, {"dht": "standard"}),
    # sampling layouts
    "sampling440": (67, 45, 3, {"sampling": [(1, 2), (1, 1), (1, 1)]}),
    "sampling440_narrow": (2, 9, 3, {"sampling": [(1, 2), (1, 1), (1, 1)]}),
    "sampling411": (67, 45, 3, {"sampling": [(4, 1), (1, 1), (1, 1)]}),
    "sampling410": (67, 45, 3, {"sampling": [(4, 2), (1, 1), (1, 1)]}),
    "sampling_chroma_largest": (53, 39, 3, {
        "sampling": [(1, 1), (2, 2), (1, 2)]}),
    "sampling_h3": (50, 29, 3, {"sampling": [(3, 1), (1, 1), (3, 1)]}),
    "sampling_4x4_split": (67, 45, 3, {
        "sampling": [(4, 4), (1, 1), (2, 1)], "script": _SEQ_SPLIT}),
    "sampling422_narrow": (3, 5, 3, {"sampling": [(2, 1), (1, 1), (1, 1)]}),
    "sampling420_5x3": (5, 3, 3, {"sampling": _Y420}),
    "sampling_gray_2x2": (19, 21, 1, {"sampling": [(2, 2)]}),
    # four components
    "cmyk_adobe": (41, 29, 4, {"adobe": 0}),
    "cmyk_no_adobe": (41, 29, 4, {}),
    "ycck_adobe": (41, 29, 4, {"adobe": 2}),
    "ycck_420": (41, 29, 4, {"adobe": 2, "sampling": [(2, 2), (1, 1),
                                                      (1, 1), (2, 2)]}),
    "adobe_transform1_4comp": (41, 29, 4, {"adobe": 1}),
    "cmyk_progressive": (41, 29, 4, {"adobe": 0,
                                     "script": simple_progression(4)}),
    # three components and the colour-space markers
    "adobe_rgb": (33, 17, 3, {"adobe": 0}),
    "ids_rgb": (33, 17, 3, {"jfif": False, "ids": (82, 71, 66)}),
    "ids_other": (33, 17, 3, {"jfif": False, "ids": (7, 8, 9)}),
    # arithmetic coding
    "arith_seq": (67, 45, 3, {"coding": "arithmetic", "sampling": _Y420}),
    "arith_seq_restart_dac": (67, 45, 3, {
        "coding": "arithmetic", "sampling": [(2, 1), (1, 1), (1, 1)],
        "restart": 3, "dac": _DAC}),
    "arith_progressive": (67, 45, 3, {"coding": "arithmetic",
                                      "sampling": _Y420, "script": _PROG3}),
    "arith_progressive_restart_dac": (67, 45, 3, {
        "coding": "arithmetic", "script": _PROG3, "restart": 2,
        "dac": _DAC}),
    "arith_gray_q95": (31, 23, 1, {"coding": "arithmetic", "quality": 95}),
    "arith_cmyk": (29, 19, 4, {"coding": "arithmetic", "adobe": 0}),
    # lossless: no colour conversion (ids 1, 2, 3 are RGB here)
    **{f"lossless_p{p}": (37, 21, 3, {"coding": "lossless", "jfif": False,
                                      "predictor": p, "pt": p % 3})
       for p in range(1, 8)},
    "lossless_restart_420": (37, 21, 3, {
        "coding": "lossless", "jfif": False, "predictor": 4,
        "sampling": _Y420, "restart": 19 * 2}),
    "lossless_split": (29, 19, 3, {
        "coding": "lossless", "jfif": False,
        "sampling": [(1, 2), (1, 1), (1, 1)],
        "script": [((0,), 5, 0, 0, 1), ((1, 2), 6, 0, 0, 0)],
        "restart": 29 * 2}),
    "lossless_gray": (23, 17, 1, {"coding": "lossless", "predictor": 7,
                                  "dht": "standard"}),
    "lossless_adobe_rgb": (23, 17, 3, {"coding": "lossless", "adobe": 0,
                                       "ids": (7, 8, 9)}),
    "lossless_cmyk": (23, 17, 4, {"coding": "lossless", "pt": 2}),
    # progressive files libjpeg smooths
    "smooth_dc_only": (67, 45, 3, {"sampling": _Y420, "script": _DC_ONLY}),
    "smooth_partial": (67, 45, 3, {"sampling": _Y420, "script": _PARTIAL}),
    "smooth_low_ac": (67, 45, 3, {"script": _LOW_AC}),
    "smooth_17x25_422": (17, 25, 3, {"sampling": [(1, 2), (1, 1), (1, 1)],
                                     "script": _PARTIAL}),
    "smooth_gray_2x2": (23, 40, 1, {"sampling": [(2, 2)],
                                    "script": [((0,), 0, 0, 0, 2)]}),
    # the SIMD IDCT's 16-bit wraps and saturations (PIL on x86-64)
    "idct_saturation_gray": (40, 32, 1, {
        "quality": 1, "coefficients": large_coefficients}),
    "idct_saturation_420": (48, 32, 3, {
        "quality": 1, "sampling": _Y420,
        "coefficients": large_coefficients}),
    "smooth_arith": (45, 37, 3, {"coding": "arithmetic", "sampling": _Y420,
                                 "script": _PARTIAL}),
}

# the files PIL refuses: name -> (width, height, components, options)
REFUSED = {
    "precision12": (16, 16, 3, {"precision": 12}),
    "hierarchical_sof5": (16, 16, 3, {"sof": 0xC5}),
    "lossless_arith_sof11": (16, 16, 3, {"coding": "lossless",
                                         "jfif": False, "sof": 0xCB}),
    "fractional_sampling": (16, 16, 3, {"sampling": [(3, 1), (2, 1),
                                                     (1, 1)]}),
    "two_components": (16, 16, 2, {}),
    # only the sequential Huffman decoder supplies Annex K.3's tables
    "mjpeg_progressive": (24, 16, 3, {"dht": None, "script": _PROG3}),
    "lossless_no_dht": (16, 16, 1, {"coding": "lossless", "dht": None}),
    # a lossless frame converts no colour: YCbCr and YCCK are refused
    "lossless_jfif": (16, 16, 3, {"coding": "lossless", "jfif": True}),
    "lossless_ycck": (16, 16, 4, {"coding": "lossless", "adobe": 2}),
    "huffman_table2_undefined": (16, 16, 3, {
        "dht": None, "tables": {0: (0, 0), 1: (2, 2), 2: (1, 1)}}),
}

# PIL's mode of an image of this many components
MODES = {1: "L", 3: "RGB", 4: "CMYK"}


def case_pixels(name: str) -> np.ndarray:
    width, height, ncomp, _ = {**CASES, **REFUSED}[name]
    return _pixels(name, width, height, ncomp)


def case_bytes(name: str) -> bytes:
    _, _, _, options = {**CASES, **REFUSED}[name]
    return write_jpeg(case_pixels(name), **options)


def write_case(name: str, path: str) -> None:
    with open(path, "wb") as f:
        f.write(case_bytes(name))


def frame_pixels(size: int, ncomp: int, seed: int = 0) -> np.ndarray:
    """A photo-like frame for the timing of each kind: smooth gradients,
    soft discs and mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float64) / size
    img = np.empty((size, size, ncomp))
    for c in range(ncomp):
        a, b, p = rng.uniform(0.5, 3.0, 3)
        img[..., c] = 128 + 60 * np.sin(a * 6 * x + p) * np.cos(b * 5 * y)
        for _ in range(6):
            cx, cy, r, v = rng.uniform(0, 1, 4)
            disc = ((x - cx) ** 2 + (y - cy) ** 2) < (0.05 + 0.2 * r) ** 2
            img[..., c] += np.where(disc, 80 * (v - 0.5), 0)
    img += rng.normal(0.0, 2.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# the kinds chip_smoke.py times at 800x800: name -> (components, options)
TIMED_KINDS = {
    "motion_jpeg": (3, {"sampling": _Y420, "dht": None}),
    "sampling440": (3, {"sampling": [(1, 2), (1, 1), (1, 1)]}),
    "sampling411": (3, {"sampling": [(4, 1), (1, 1), (1, 1)]}),
    "cmyk": (4, {"adobe": 0}),
    "ycck": (4, {"adobe": 2, "sampling": [(2, 2), (1, 1), (1, 1), (2, 2)]}),
    "arithmetic": (3, {"coding": "arithmetic", "sampling": _Y420}),
    "arithmetic_progressive": (3, {"coding": "arithmetic",
                                   "sampling": _Y420, "script": _PROG3}),
    "lossless": (3, {"coding": "lossless", "jfif": False, "predictor": 1}),
    "progressive_smoothed": (3, {"sampling": _Y420, "script": _PARTIAL}),
}


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def fixture_name(name: str) -> str:
    return f"{name}.jpg"


def main() -> None:
    from PIL import Image, features

    files = {}
    for name in CASES:
        path = os.path.join(HERE, fixture_name(name))
        write_case(name, path)
        img = Image.open(path)
        files[fixture_name(name)] = digest(img.mode, np.asarray(img))
    with open(DIGESTS, "w") as f:
        json.dump({"pil": Image.__version__,
                   "libjpeg_turbo": features.version("libjpeg_turbo"),
                   "files": files}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    main()
