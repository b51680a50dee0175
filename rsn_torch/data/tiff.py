"""TIFF frames as PIL 12.1.0 reads them (the port of the `Image.open`
calls in rsn/data/blender.py for TIFF).

`read_tiff(path)` gives what `np.asarray(Image.open(path))` gives: PIL's
mode and the same array, dtype and bytes.  It follows PIL's
TiffImagePlugin, quirks included (PARITY.md: quirks are replicated, not
fixed):

- the header: Pillow's six prefixes (classic and BigTIFF, "II" and
  "MM"); BigTIFF is told by byte 2 alone, as PIL tells it, so a
  big-endian BigTIFF is read as a classic file (and PIL refuses it);
- the first IFD only (frame 0), its tags read as PIL reads them;
- the key (byte order, photometric, sample format, fill order, bits per
  sample, extra samples) to PIL's mode and rawmode through OPEN_INFO, a
  copy of PIL's table for the kinds the port reads;
- uncompressed data through PIL's own raw decoder: its tiles (a strip or
  tile each, planar configuration 2 a band each), its row strides and
  its unpackers (`_unpack`);
- compressed data as libtiff decodes it for PIL's TiffDecode.c: each
  strip or tile decompressed (rsn_torch/data/native/tiff.cpp: PackBits,
  LZW, Deflate; JPEG through rsn_torch/data/native/jpeg.cpp, each strip
  or tile its own stream after the JPEGTables tag's tables, YCbCr
  converted to RGB), FillOrder 2's bits reversed before it, predictor 2
  or 3 undone after it, 16 and 32-bit samples in native order, then
  PIL's unpackers with the rawmode PIL picks for libtiff;
- EXIF orientation applied, as TiffImageFile.load_end applies it.

A TIFF PIL refuses (an unknown pixel mode, missing dimensions, a
truncated strip, a decoder error) raises ValueError naming the file.  The
kinds the port does not read yet raise NotImplementedError naming ROADMAP
Queue 1 and rsn/data/blender.py: YCbCr without JPEG compression, CCITT,
LZMA, ZSTD, old-style JPEG, SGILog, ThunderScan and old-style LZW.  WebP
strips (compression 50001) raise ValueError: the libtiff that Pillow
ships has no WebP codec, so PIL refuses them.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from rsn_torch.data import native
from rsn_torch.data.imagefile import (BITFLIP, CHANNELS, NO_UNPACKER,
                                      RAW_BITS, blank, refused, unpack,
                                      unpremultiply)

II, MM = b"II", b"MM"
# TiffImagePlugin.PREFIXES
PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
            b"MM\x00\x2b", b"II\x2b\x00")

# TiffImagePlugin.OPEN_INFO: (byte order, photometric, sample format, fill
# order, bits per sample, extra samples) -> (mode, rawmode)
OPEN_INFO: Dict[tuple, Tuple[str, str]] = {}


def _both(photo, fmt, fill, bits, extra, mode, rawmode):
    for order in (II, MM):
        OPEN_INFO[(order, photo, fmt, fill, bits, extra)] = (mode, rawmode)


for _photo, _inv in ((0, "I"), (1, "")):
    _both(_photo, (1,), 1, (1,), (), "1", "1;" + _inv if _inv else "1")
    _both(_photo, (1,), 2, (1,), (), "1", f"1;{_inv}R")
    for _b in (2, 4):
        _both(_photo, (1,), 1, (_b,), (), "L", f"L;{_b}{_inv}")
        _both(_photo, (1,), 2, (_b,), (), "L", f"L;{_b}{_inv}R")
    _both(_photo, (1,), 1, (8,), (), "L", "L;I" if _inv else "L")
    _both(_photo, (1,), 2, (8,), (), "L", f"L;{_inv}R" if _inv else "L;R")
_both(1, (2,), 1, (8,), (), "L", "L")
OPEN_INFO.update({
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (2,), 1, (16,), ()): ("I", "I;16S"),
    (MM, 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    (II, 0, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
    (II, 1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (MM, 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    (II, 1, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
})
_both(1, (1,), 1, (8, 8), (2,), "LA", "LA")
_both(2, (1,), 1, (8, 8, 8), (), "RGB", "RGB")
_both(2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R")
_both(2, (1,), 1, (8,) * 4, (), "RGBA", "RGBA")  # missing ExtraSamples
for _extra, _mode, _raw in (((0,), "RGB", "RGBX"), ((1,), "RGBA", "RGBa"),
                            ((2,), "RGBA", "RGBA")):
    for _x in range(3):
        _both(2, (1,), 1, (8,) * (4 + _x), _extra + (0,) * _x, _mode,
              _raw + "X" * _x)
_both(2, (1,), 1, (8,) * 4, (999,), "RGBA", "RGBA")  # Corel Draw 10
for _order, _end in ((II, "L"), (MM, "B")):
    OPEN_INFO.update({
        (_order, 2, (1,), 1, (16,) * 3, ()): ("RGB", f"RGB;16{_end}"),
        (_order, 2, (1,), 1, (16,) * 4, ()): ("RGBA", f"RGBA;16{_end}"),
        (_order, 2, (1,), 1, (16,) * 4, (0,)): ("RGB", f"RGBX;16{_end}"),
        (_order, 2, (1,), 1, (16,) * 4, (1,)): ("RGBA", f"RGBa;16{_end}"),
        (_order, 2, (1,), 1, (16,) * 4, (2,)): ("RGBA", f"RGBA;16{_end}"),
        (_order, 5, (1,), 1, (16,) * 4, ()): ("CMYK", f"CMYK;16{_end}"),
    })
for _b in (1, 2, 4):
    _both(3, (1,), 1, (_b,), (), "P", f"P;{_b}")
    _both(3, (1,), 2, (_b,), (), "P", f"P;{_b}R")
_both(3, (1,), 1, (8,), (), "P", "P")
_both(3, (1,), 1, (8, 8), (0,), "P", "PX")
_both(3, (1,), 1, (8, 8), (2,), "PA", "PA")
_both(3, (1,), 2, (8,), (), "P", "P;R")
_both(5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK")
_both(5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX")
_both(5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX")
_both(6, (1,), 1, (8,), (), "L", "L")
# JPEG-compressed YCbCr: libtiff converts to RGB (rawmode "RGB" then)
_both(6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX")
_both(8, (1,), 1, (8, 8, 8), (), "LAB", "LAB")

# TiffImagePlugin.COMPRESSION_INFO
COMPRESSION_INFO = {
    1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
    50000: "zstd", 50001: "webp"}
# the compressions tiff.cpp decodes, by its codec numbers
_CODECS = {32773: 1, 5: 2, 8: 3, 32946: 3}
_NOT_PORTED = {
    2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
    32771: "CCITT RLEW", 6: "old-style JPEG", 34925: "LZMA", 50000: "ZSTD",
    34676: "SGILog", 34677: "SGILog24",
    32809: "ThunderScan"}

# tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, ORIENTATION, SAMPLES = 266, 273, 274, 277
ROWS_PER_STRIP, STRIP_COUNTS, PLANAR, PREDICTOR = 278, 279, 284, 317
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES, WMP = 338, 339, 347, 0xBC01
# the tags PIL stores as one value (TiffTags' length 1)
_SCALAR = {WIDTH, LENGTH, COMPRESSION, PHOTOMETRIC, FILL_ORDER, ORIENTATION,
           SAMPLES, ROWS_PER_STRIP, PLANAR, PREDICTOR, TILE_WIDTH,
           TILE_LENGTH}
# field type -> (bytes per value, struct code of its numbers); BYTE,
# ASCII and UNDEFINED stay bytes
_TYPES = {1: (1, None), 2: (1, None), 3: (2, "H"), 4: (4, "L"),
          5: (8, "L"), 6: (1, "b"), 7: (1, None), 8: (2, "h"),
          9: (4, "l"), 10: (8, "l"), 11: (4, "f"), 12: (8, "d"),
          13: (4, "L"), 16: (8, "Q"), 17: (8, "q"), 18: (8, "Q")}


def is_tiff(head: bytes) -> bool:
    """TiffImagePlugin._accept."""
    return head.startswith(PREFIXES)


def _not_ported(path: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: a TIFF with {what}; ROADMAP Queue 1: the port decodes "
        "TIFF frames without compression or with PackBits, LZW, Deflate "
        "or JPEG, rsn/data/blender.py reads the other kinds with PIL")


# ---- the IFD -----------------------------------------------------------------------

def _read_ifd(data: bytes, path: str) -> Tuple[str, Dict[int, object]]:
    """PIL's ImageFileDirectory_v2 of frame 0 -> (byte order, tags): a
    scalar for the tags PIL keeps as one value, else a tuple (bytes for
    BYTE, ASCII and UNDEFINED).  A read past the end stops the IFD there,
    keeping the tags before it, as PIL does."""
    order = "<" if data[:2] == II else ">"
    bigtiff = len(data) > 2 and data[2] == 43
    try:
        first = struct.unpack(order + ("Q" if bigtiff else "L"),
                              data[8:16] if bigtiff else data[4:8])[0]
    except struct.error:
        raise refused(path, "a truncated TIFF header") from None
    if not first:
        raise refused(path, "a TIFF without an image")
    if first >= 2 ** 63:
        raise refused(path, "a TIFF whose IFD cannot be sought")
    tags: Dict[int, object] = {}
    pos = first

    def take(n: int) -> bytes:
        nonlocal pos
        chunk = data[pos:pos + n]
        if len(chunk) != n:
            raise EOFError
        pos += n
        return chunk

    try:
        (count,) = struct.unpack(order + ("Q" if bigtiff else "H"),
                                 take(8 if bigtiff else 2))
        for _ in range(count):
            tag, typ, n, raw = struct.unpack(
                order + ("HHQ8s" if bigtiff else "HHL4s"),
                take(20 if bigtiff else 12))
            if typ not in _TYPES:
                continue
            unit, code = _TYPES[typ]
            size = n * unit
            if size > (8 if bigtiff else 4):
                (at,) = struct.unpack(order + ("Q" if bigtiff else "L"),
                                      raw)
                raw = data[at:at + size]
                if len(raw) != size:
                    raise EOFError
            else:
                raw = raw[:size]
            if not raw:
                continue
            value: object = raw  # BYTE, ASCII, UNDEFINED: the bytes
            if code is not None:  # a rational as its two integers
                value = struct.unpack(
                    f"{order}{len(raw) // struct.calcsize(order + code)}"
                    f"{code}", raw)
            if tag in _SCALAR and isinstance(value, tuple):
                value = value[0]
            tags[tag] = value
    except EOFError:
        pass
    return order, tags


def _ints(value, what: str, path: str) -> Tuple[int, ...]:
    vals = value if isinstance(value, tuple) else (value,)
    if isinstance(value, (bytes, str)) or not all(
            isinstance(v, int) for v in vals):
        raise refused(path, f"a TIFF whose {what} is not integers")
    return vals


# ---- the key -----------------------------------------------------------------------

class _Setup:
    """What TiffImageFile._setup makes of the IFD."""

    def __init__(self, data: bytes, path: str):
        order, tags = _read_ifd(data, path)
        self.tags = tags
        self.big_endian = order == ">"
        if WMP in tags:
            raise refused(path, "a Windows Media Photo file")
        code = tags.get(COMPRESSION, 1)
        if code not in COMPRESSION_INFO:
            raise refused(path, f"TIFF compression {code}")
        self.code = code
        self.compression = COMPRESSION_INFO[code]
        self.planar = tags.get(PLANAR, 1)
        photo = tags.get(PHOTOMETRIC, 0)
        if self.compression == "tiff_jpeg":
            photo = 6
        self.photo = photo
        fill = tags.get(FILL_ORDER, 1)
        if WIDTH not in tags or LENGTH not in tags:
            raise refused(path, "a TIFF without its dimensions")
        self.width, self.height = tags[WIDTH], tags[LENGTH]
        if not isinstance(self.width, int) or not isinstance(self.height,
                                                             int):
            raise refused(path, "a TIFF with invalid dimensions")
        fmt = tags.get(SAMPLE_FORMAT, (1,))
        if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bits = tags.get(BITS, (1,))
        extra = tags.get(EXTRA_SAMPLES, ())
        if photo in (2, 6, 8):
            count = 3
        elif photo == 5:
            count = 4
        else:
            count = 1
        self.bps_count = count + len(extra)
        spp = tags.get(SAMPLES, 3 if self.compression == "tiff_jpeg"
                       and photo in (2, 6) else 1)
        max_spp = max(len(k[4]) for k in OPEN_INFO)
        if not isinstance(spp, int) or spp > max_spp:
            raise refused(path, "a TIFF with an invalid samples per pixel")
        if spp < len(bits):
            bits = bits[:spp]
        elif spp > len(bits) and len(bits) == 1:
            bits = bits * spp
        if len(bits) != spp:
            raise refused(path, "a TIFF of an unknown data organization")
        self.spp, self.bits, self.extra = spp, bits, extra
        prefix = MM if self.big_endian else II
        key = (prefix, photo, fmt, fill, bits, extra)
        if key not in OPEN_INFO:
            raise refused(path, f"a TIFF of an unknown pixel mode {key[1:]}")
        self.mode, self.rawmode = OPEN_INFO[key]
        self.fill = fill
        self.libtiff = self.compression != "raw"
        if self.libtiff:
            if fill == 2:
                self.mode, self.rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
            if (photo == 6 and self.compression == "jpeg"
                    and self.planar == 1):
                self.rawmode = "RGB"
            elif self.rawmode == "I;16":
                self.rawmode = "I;16N"
            elif self.rawmode.endswith((";16B", ";16L")):
                self.rawmode = self.rawmode[:-1] + "N"
        self.tiled = TILE_OFFSETS in tags and STRIP_OFFSETS not in tags
        if not self.libtiff and STRIP_OFFSETS not in tags and \
                TILE_OFFSETS not in tags:
            raise refused(path, "a TIFF of an unknown data organization")
        if self.mode in ("P", "PA") and not isinstance(
                tags.get(320), tuple):
            raise refused(path, "a palette TIFF without a colour map")


# ---- the planar-2 bands (PIL's unpackers: rsn_torch.data.imagefile) -----------------

# the band rawmodes of PIL's raw planar-2 tiles: (mode, rawmode[band]) ->
# the band written
_BAND = {("RGB", "R"): 0, ("RGB", "G"): 1, ("RGB", "B"): 2,
         ("RGBA", "R"): 0, ("RGBA", "G"): 1, ("RGBA", "B"): 2,
         ("RGBA", "A"): 3, ("CMYK", "C"): 0, ("CMYK", "M"): 1,
         ("CMYK", "Y"): 2, ("CMYK", "K"): 3, ("LAB", "L"): 0,
         ("LAB", "A"): 1, ("LAB", "B"): 2}
# the band unpackers that offset a signed band by 128
_BAND_SIGNED = {("LAB", "A"), ("LAB", "B")}
# the one-band images' rawmode[0] PIL has an unpacker for
_BAND_ONE = {("1", "1"), ("L", "L"), ("P", "P"), ("F", "F"), ("I", "I")}


# ---- the raw path (ImageFile.load with PIL's raw decoder) ---------------------------

def _raw_tiles(s: _Setup, path: str) -> List[tuple]:
    """TiffImageFile._setup's tiles: (x0, y0, x1, y1, offset, rawmode,
    stride)."""
    tags = s.tags
    if STRIP_OFFSETS in tags:
        offsets = _ints(tags[STRIP_OFFSETS], "strip offsets", path)
        h = tags.get(ROWS_PER_STRIP, s.height)
        w = s.width
    else:
        offsets = _ints(tags[TILE_OFFSETS], "tile offsets", path)
        w, h = tags.get(TILE_WIDTH), tags.get(TILE_LENGTH)
        if not isinstance(w, int) or not isinstance(h, int):
            raise refused(path, "a TIFF with invalid tile dimensions")
    if w == s.width and h == s.height and s.planar != 2:
        offsets = offsets[-1:]
    tiles = []
    x = y = layer = 0
    for offset in offsets:
        stride = w * sum(s.bits) / 8 if x + w > s.width else 0
        rawmode = s.rawmode
        if s.planar == 2:
            rawmode = s.rawmode[layer] if layer < len(s.rawmode) else ""
            stride /= s.bps_count
        tiles.append((x, y, min(x + w, s.width), min(y + h, s.height),
                      offset, rawmode, int(stride)))
        x += w
        if x >= s.width:
            x, y = 0, y + h
            if y >= s.height:
                y = 0
                layer += 1
    return tiles


def _load_raw(s: _Setup, data: bytes, path: str) -> np.ndarray:
    out = blank(s.mode, s.width, s.height, path)
    tiles = sorted(_raw_tiles(s, path), key=lambda t: t[4])
    for x0, y0, x1, y1, offset, rawmode, stride in tiles:
        if x0 < 0 or y0 < 0 or x1 > s.width or y1 > s.height or \
                x1 <= x0 or y1 <= y0:
            raise refused(path, "a TIFF tile outside the image")
        band = None
        if s.planar == 2 and (s.mode, rawmode) in _BAND_ONE:
            bits = RAW_BITS[rawmode]
        elif s.planar == 2:
            band = _BAND.get((s.mode, rawmode))
            if band is None:
                raise refused(path, f"unknown raw mode {rawmode!r} for "
                               f"mode {s.mode!r}")
            bits = 8
        else:
            if (s.mode, rawmode) in NO_UNPACKER:
                raise refused(path, f"unknown raw mode {rawmode!r} for "
                               f"mode {s.mode!r}")
            bits = RAW_BITS[rawmode]
        tw, th = x1 - x0, y1 - y0
        row_bytes = (tw * bits + 7) // 8
        pitch = stride or row_bytes
        if stride and stride < row_bytes:
            raise refused(path, "a TIFF tile of a bad stride")
        need = pitch * (th - 1) + row_bytes
        chunk = data[offset:offset + need]
        if len(chunk) < need:
            raise refused(path, "a truncated TIFF (image file is "
                           "truncated)")
        buf = np.frombuffer(chunk + b"\x00" * (pitch * th - need), np.uint8)
        rows = buf.reshape(th, pitch)[:, :row_bytes]
        if band is not None:
            plane = rows[:, :tw]
            if (s.mode, rawmode) in _BAND_SIGNED:
                plane = plane ^ 0x80
            if out.ndim == 2:
                out[y0:y1, x0:x1] = plane
            else:
                out[y0:y1, x0:x1, band] = plane
            continue
        out[y0:y1, x0:x1] = unpack(s.mode, rawmode, rows, tw)
    return out


# ---- the libtiff path --------------------------------------------------------------

def _chunks(s: _Setup, path: str):
    tags = s.tags
    if s.tiled:
        offsets = _ints(tags[TILE_OFFSETS], "tile offsets", path)
        counts = _ints(tags.get(TILE_COUNTS, ()), "tile byte counts", path)
    else:
        if STRIP_OFFSETS not in tags:
            raise refused(path, "a TIFF without strip offsets")
        offsets = _ints(tags[STRIP_OFFSETS], "strip offsets", path)
        counts = _ints(tags.get(STRIP_COUNTS, ()), "strip byte counts", path)
    if len(counts) != len(offsets):
        raise refused(path, "a TIFF whose byte counts do not match its "
                       "offsets (libtiff cannot read it)")
    return offsets, counts


def _load_libtiff(s: _Setup, data: bytes, path: str) -> np.ndarray:
    if s.code == 50001:
        raise refused(path, "a TIFF of WebP strips or tiles (the libtiff "
                       "Pillow ships has no WebP codec)")
    if s.code in _NOT_PORTED:
        raise _not_ported(path, f"{_NOT_PORTED[s.code]} compression")
    if s.photo == 6 and s.spp != 3:
        raise refused(path, "a YCbCr JPEG TIFF of other than 3 samples")
    tags = s.tags
    # only libtiff's LZW and Deflate codecs set up a predictor; PackBits
    # and JPEG ignore the tag
    predictor = tags.get(PREDICTOR, 1) if s.code in (5, 8, 32946) else 1
    bps = s.bits[0]
    if predictor not in (1, 2, 3):
        predictor = 1
    if predictor == 2 and bps not in (8, 16, 32):
        raise refused(path, f"predictor 2 on {bps}-bit samples "
                       "(libtiff refuses it)")
    if predictor == 3 and s.tags.get(SAMPLE_FORMAT, (1,))[0] != 3:
        raise refused(path, "predictor 3 on samples that are not floats "
                       "(libtiff refuses it)")
    if s.code == 5 and _old_lzw(s, data, path):
        raise _not_ported(path, "old-style LZW compression")
    planes = s.spp if s.planar == 2 else 1
    spp_chunk = 1 if s.planar == 2 else s.spp
    if s.tiled:
        cw, ch = tags.get(TILE_WIDTH), tags.get(TILE_LENGTH)
        if not isinstance(cw, int) or not isinstance(ch, int) or \
                cw <= 0 or ch <= 0:
            raise refused(path, "a TIFF with invalid tile dimensions")
        across, down = -(-s.width // cw), -(-s.height // ch)
    else:
        cw = s.width
        ch = tags.get(ROWS_PER_STRIP, s.height)
        if not isinstance(ch, int) or ch <= 0:
            ch = s.height
        ch = min(ch, s.height) if ch > s.height else ch
        across, down = 1, -(-s.height // ch)
    offsets, counts = _chunks(s, path)
    if len(offsets) < across * down * planes:
        raise refused(path, "a TIFF with fewer strips or tiles than its "
                       "image needs")
    row_bytes = (cw * spp_chunk * bps + 7) // 8
    jpeg = s.compression == "jpeg"
    rgb = jpeg and s.photo == 6
    if rgb:
        row_bytes = cw * 3
    out = blank(s.mode, s.width, s.height, path)
    mode, rawmode = s.mode, s.rawmode
    tables = tags.get(JPEG_TABLES, b"")
    if not isinstance(tables, bytes):
        tables = b""
    for plane in range(planes):
        for j in range(down):
            for i in range(across):
                k = plane * across * down + j * across + i
                rows_in = ch if s.tiled else min(ch, s.height - j * ch)
                size = rows_in * row_bytes
                start, n = offsets[k], counts[k]
                raw = data[start:start + n]
                if len(raw) < n:  # TIFFFillStrip's "Read error on strip"
                    raise refused(path, "a truncated TIFF (strip or tile "
                                   f"{k} ends past the file)")
                if jpeg:
                    buf = native.decode_tiff_jpeg(
                        raw, tables, cw, rows_in, 3 if rgb else spp_chunk,
                        rgb, path)
                else:
                    buf = native.decode_tiff_chunk(
                        raw, _CODECS[s.code], size, predictor, row_bytes,
                        bps, spp_chunk, s.big_endian, s.fill == 2, path)
                rows = buf.reshape(rows_in, row_bytes)
                y0, x0 = j * ch, i * cw
                y1, x1 = min(y0 + rows_in, s.height), min(x0 + cw, s.width)
                rows = rows[:y1 - y0]
                if s.planar == 2:
                    _put_band(out, s, plane, rows, x1 - x0, y0, x0, path)
                else:
                    out[y0:y1, x0:x1] = unpack(mode, rawmode, rows,
                                                x1 - x0)
    if s.planar == 2:
        out = _planar_finish(out, s, path)
    return out


def _old_lzw(s: _Setup, data: bytes, path: str) -> bool:
    """libtiff's LZWPreDecode test on the first strip or tile: old-style
    (LSB-first) codes begin 0x00, then a byte with bit 0 set."""
    offsets, counts = _chunks(s, path)
    if not offsets:
        return False
    head = data[offsets[0]:offsets[0] + 2]
    if s.fill == 2:
        head = bytes(BITFLIP[np.frombuffer(head, np.uint8)])
    return len(head) == 2 and head[0] == 0 and head[1] & 1 == 1


def _put_band(out, s: _Setup, plane: int, rows, width: int, y0: int,
              x0: int, path: str) -> None:
    """One plane of a planar-2 strip or tile into band `plane`: 8-bit
    samples as they are, 16-bit ones by their high byte."""
    bps = s.bits[0]
    if s.spp == CHANNELS[s.mode] and s.spp > 1:
        if bps == 8:
            band = rows[:, :width]
        elif bps == 16:
            band = rows[:, :2 * width].reshape(-1, width, 2)[..., 1]
        else:
            raise refused(path, f"{bps}-bit samples in planes")
        out[y0:y0 + rows.shape[0], x0:x0 + width, plane] = band
        return
    if s.spp == 1:
        out[y0:y0 + rows.shape[0], x0:x0 + width] = unpack(
            s.mode, s.rawmode, rows, width)
        return
    raise _not_ported(path, "planar configuration 2 and samples beyond "
                      f"the {s.mode} bands (extra samples {s.extra})")


def _planar_finish(out: np.ndarray, s: _Setup, path: str) -> np.ndarray:
    """What PIL's planar-2 libtiff decoder makes of the bands: RGBA
    unpremultiplied unless ExtraSamples says 2 (unassociated alpha) or
    999, LA / PA without their alpha, LAB's a and b offset by 128."""
    if s.mode == "RGBA" and s.extra in ((), (1,)):
        return unpremultiply(out[..., :3], out[..., 3])
    if s.mode in ("LA", "PA"):
        out[..., 1] = 0
    elif s.mode == "LAB":
        out[..., 1:] ^= 0x80
    return out


# ---- EXIF orientation (ImageOps.exif_transpose) ----------------------------------

def _orient(arr: np.ndarray, orientation) -> np.ndarray:
    if orientation == 2:
        arr = arr[:, ::-1]
    elif orientation == 3:
        arr = arr[::-1, ::-1]
    elif orientation == 4:
        arr = arr[::-1]
    elif orientation == 5:
        arr = arr.swapaxes(0, 1)
    elif orientation == 6:
        arr = np.rot90(arr, -1)
    elif orientation == 7:
        arr = arr.swapaxes(0, 1)[::-1, ::-1]
    elif orientation == 8:
        arr = np.rot90(arr, 1)
    return np.ascontiguousarray(arr)


def read_tiff(path: str) -> Tuple[str, np.ndarray]:
    """-> (PIL's mode, np.asarray(Image.open(path)))."""
    with open(path, "rb") as f:
        data = f.read()
    if not is_tiff(data[:4]):
        raise NotImplementedError(
            f"{path}: not a TIFF file; ROADMAP Queue 1: read_tiff decodes "
            "TIFF only (rsn_torch.data.jpeg.read_image picks the decoder by "
            "content, as rsn/data/blender.py's Image.open does)")
    s = _Setup(data, path)
    if s.photo == 6 and not (s.compression == "jpeg" and s.planar == 1):
        raise _not_ported(path, "YCbCr data without JPEG compression in "
                          "one plane (PIL reads it through libtiff's "
                          "TIFFRGBAImage or as rawmode RGBX)")
    arr = _load_libtiff(s, data, path) if s.libtiff else _load_raw(s, data,
                                                                   path)
    return s.mode, _orient(arr, s.tags.get(ORIENTATION))
