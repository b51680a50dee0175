"""A TIFF writer for the cases of tests/test_torch_tiff.py, and the
committed fixtures beside this file.

`write_tiff(samples, **spec)` encodes an (H, W, S) array of samples as
the file holds them, with numpy, zlib and the standard library only
(chip_smoke.py runs it on the card's host, which has no PIL).  It writes:

  - classic TIFF and BigTIFF, little-endian ("II") and big-endian ("MM");
  - strips (a partial last strip) and tiles (padded edge tiles), planar
    configuration 1 (samples interleaved) and 2 (one plane per sample);
  - 1, 2, 4, 8, 12, 16 and 32-bit samples, unsigned, signed or float,
    FillOrder 1 or 2, extra samples, a colour map;
  - no compression, PackBits, LZW (libtiff's codes: MSB first, the code
    width grown one code early), Deflate (8 and 32946) and JPEG (each
    strip or tile a JPEG of tests/golden/jpeg_kinds/write_fixtures.py's
    encoder, its tables in a JPEGTables tag), with predictor 2
    (horizontal differences) or 3 (floating point) before compression.

CASES names each committed case: its seeded samples and its spec, which
together cover every key of PIL's TiffImagePlugin.OPEN_INFO on the
ported compressions.  REFUSED_CASES are the kinds the port does not read
yet, and BAD_CASES files PIL refuses (WebP strips among them: Pillow's
libtiff has no WebP codec).  `python
tests/golden/tiff/write_fixtures.py` writes one file per case here and
digests.json: the mode, shape, dtype and sha256 of
`np.asarray(Image.open(f))`, with the PIL and libtiff versions that made
them.  Only that needs PIL.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "digests.json")

# tag numbers
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP = 266, 273, 277, 278
STRIP_COUNTS, PLANAR, PREDICTOR, COLORMAP = 279, 284, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES, SUBSAMPLING = 338, 339, 347, 530
ORIENTATION = 274
# field types: SHORT, LONG, UNDEFINED, LONG8
SHORT, LONG, UNDEFINED, LONG8 = 3, 4, 7, 16
_TYPE_SIZE = {SHORT: 2, LONG: 4, UNDEFINED: 1, LONG8: 8}
_TYPE_CHAR = {SHORT: "H", LONG: "I", UNDEFINED: "B", LONG8: "Q"}


def _jpeg_writer():
    """tests/golden/jpeg_kinds/write_fixtures.py, loaded by path."""
    path = os.path.join(os.path.dirname(HERE), "jpeg_kinds",
                        "write_fixtures.py")
    spec = importlib.util.spec_from_file_location("jpeg_kinds_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the codecs ----------------------------------------------------------------

def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes replicated, the rest in
    literal runs of up to 128."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j + 1 - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        start = i
        while i < n and i - start < 128:
            if i + 2 < n and data[i] == data[i + 1] == data[i + 2]:
                break
            i += 1
        out.append(i - start - 1)
        out += data[start:i]
    return bytes(out)


def lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff's LZWEncode writes it: a Clear code first,
    codes MSB first, 9 to 12 bits, the width grown when the next free
    code reaches 2^width, a Clear when the table fills, EOI last."""
    out = bytearray()
    acc = nacc = 0
    nbits = 9

    def put(code: int) -> None:
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    put(256)
    table = {}
    free = 258
    ent = -1
    for c in data:
        if ent < 0:
            ent = c
            continue
        key = (ent, c)
        if key in table:
            ent = table[key]
            continue
        put(ent)
        ent = c
        table[key] = free
        free += 1
        if free == 4094:
            put(256)
            table.clear()
            free, nbits = 258, 9
        elif free > (1 << nbits) - 1:
            nbits += 1
    if ent >= 0:
        put(ent)
        free += 1
        if free == 4094:
            put(256)
            nbits = 9
        elif free > (1 << nbits) - 1:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                     np.uint8)


def reverse_bits(data: bytes) -> bytes:
    """Each byte's bits reversed (FillOrder 2)."""
    return _REVERSED[np.frombuffer(data, np.uint8)].tobytes()


# ---- samples to bytes ----------------------------------------------------------

def _dtype(bits: int, fmt: int, order: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    return np.dtype(f"{order}{kind}{bits // 8}")


def _predict2(rows: np.ndarray, stride: int, bits: int) -> np.ndarray:
    """Horizontal differences of (h, n) samples, `stride` samples apart,
    modulo 2^bits."""
    wide = rows.astype(np.int64)
    diff = wide.copy()
    diff[:, stride:] = wide[:, stride:] - wide[:, :-stride]
    return (diff % (1 << bits)).astype(np.uint64)


def _pack_rows(rows: np.ndarray, bits: int, fmt: int, order: str,
               predictor: int, stride: int) -> bytes:
    """(h, n) samples of one chunk -> the chunk's bytes, each row padded
    to a byte."""
    h, n = rows.shape
    if predictor == 3:  # libtiff's fpDiff: byte planes MSB first, then
        be = rows.astype(_dtype(bits, fmt, ">")).view(np.uint8)  # diffs
        planes = be.reshape(h, n, bits // 8).transpose(0, 2, 1)
        planes = planes.reshape(h, -1).astype(np.int64)
        diff = planes.copy()
        diff[:, stride:] = planes[:, stride:] - planes[:, :-stride]
        return (diff % 256).astype(np.uint8).tobytes()
    if bits in (8, 16, 32):
        vals = rows.astype(_dtype(bits, fmt, "="))
        if predictor == 2:
            unsigned = np.dtype(f"u{bits // 8}")
            vals = _predict2(vals.view(unsigned), stride, bits)
            return vals.astype(unsigned.newbyteorder(order)).tobytes()
        return vals.astype(_dtype(bits, fmt, order)).tobytes()
    # 1, 2, 4, 12 bits: packed MSB first
    vals = rows.astype(np.uint64)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    bitarr = ((vals[..., None] >> shifts) & 1).astype(np.uint8)
    bitarr = bitarr.reshape(h, n * bits)
    return np.packbits(bitarr, axis=1).tobytes()


# ---- the file ------------------------------------------------------------------

def _compress(raw: bytes, compression: int, fill_order: int) -> bytes:
    if compression == 1:
        data = raw
    elif compression == 5:
        data = lzw(raw)
    elif compression in (8, 32946):
        data = zlib.compress(raw, 6)
    elif compression == 32773:
        data = packbits(raw)
    else:
        raise ValueError(f"the writer does not encode compression "
                         f"{compression}")
    return reverse_bits(data) if fill_order == 2 else data


def _jpeg_chunks(block: np.ndarray, jpeg: dict, jw):
    """One chunk (h, w, c) uint8 as a JPEG stream of the jpeg_kinds
    encoder; with shared tables the DQT segment (and the standard DHT)
    before the first scan is cut out -> (the stream, the tables-only
    stream of the segments cut, or of the DQT and DHT when none is)."""
    opts = {"jfif": False, "dht": "standard", **jpeg}
    shared = opts.pop("shared_tables", True)
    cut = (0xDB,) if opts["dht"] == "optimal" else (0xDB, 0xC4)
    data = jw.write_jpeg(block, **opts)
    pos, kept, tables = 2, bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            kept += data[pos:]
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos:pos + 2 + length]
        if marker in (0xDB, 0xC4):
            tables += seg
            if not shared or marker not in cut:
                kept += seg
        else:
            kept += seg
        pos += 2 + length
    return bytes(kept), bytes(tables) + b"\xff\xd9"


def write_tiff(samples: np.ndarray, *, photometric: int, bits=None,
               sample_format: int = 1, extra=(), order: str = "<",
               bigtiff: bool = False, compression: int = 1,
               predictor: int = 1, planar: int = 1, rows_per_strip=None,
               tile=None, fill_order: int = 1, colormap=None, jpeg=None,
               subsampling=None, tags=None, drop=(), magic=None,
               truncate: int = 0) -> bytes:
    """The TIFF file of `samples` (H, W, S), values as the file holds them.

    bits: bits per sample (default from the dtype); sample_format 1
      unsigned, 2 signed, 3 float; extra: ExtraSamples; order "<" (II) or
      ">" (MM); tile: (width, length) for tiles, else strips of
      rows_per_strip rows (default all); jpeg: write_jpeg's options for
      compression 7 (and "shared_tables": False to keep the tables in
      each stream too); subsampling: the YCbCrSubSampling tag; tags:
      {tag: (type, values)} added or replaced; drop: tags left out;
      magic: the 4 header bytes as written; truncate: bytes cut from the
      end of the file.
    """
    img = samples if samples.ndim == 3 else samples[..., None]
    height, width, spp = img.shape
    bits = bits or img.dtype.itemsize * 8
    if tile is None:
        rps = rows_per_strip or height
        grid = [(0, y, width, min(rps, height - y))
                for y in range(0, height, rps)]
        chunk_w, chunk_h = width, rps
    else:
        chunk_w, chunk_h = tile
        grid = [(x, y, chunk_w, chunk_h) for y in range(0, height, chunk_h)
                for x in range(0, width, chunk_w)]
    planes = [list(range(spp))] if planar == 1 else [[s] for s in
                                                      range(spp)]
    jw = _jpeg_writer() if compression == 7 else None
    chunks, tables = [], None
    for plane in planes:
        for x, y, w, h in grid:
            block = img[y:y + h, x:x + w][..., plane]
            if tile is not None:  # edge tiles padded by repeating the edge
                block = np.pad(block, ((0, h - block.shape[0]),
                                       (0, w - block.shape[1]), (0, 0)),
                               mode="edge")
            if compression == 7:
                data, tables = _jpeg_chunks(np.ascontiguousarray(
                    block.astype(np.uint8)), jpeg or {}, jw)
            else:
                rows = block.reshape(block.shape[0], -1)
                raw = _pack_rows(rows, bits, sample_format, order,
                                 predictor, len(plane))
                data = _compress(raw, compression, fill_order)
            chunks.append(data)

    entries = {
        WIDTH: (LONG, [width]), LENGTH: (LONG, [height]),
        BITS: (SHORT, [bits] * spp), COMPRESSION: (SHORT, [compression]),
        PHOTOMETRIC: (SHORT, [photometric]), SAMPLES: (SHORT, [spp]),
    }
    if fill_order != 1:
        entries[FILL_ORDER] = (SHORT, [fill_order])
    if planar != 1:
        entries[PLANAR] = (SHORT, [planar])
    if predictor != 1:
        entries[PREDICTOR] = (SHORT, [predictor])
    if sample_format != 1:
        entries[SAMPLE_FORMAT] = (SHORT, [sample_format] * spp)
    if extra:
        entries[EXTRA_SAMPLES] = (SHORT, list(extra))
    if colormap is not None:
        entries[COLORMAP] = (SHORT, [int(v) for v in colormap])
    if tables is not None:
        entries[JPEG_TABLES] = (UNDEFINED, list(tables))
    if subsampling is not None:
        entries[SUBSAMPLING] = (SHORT, list(subsampling))
    off_type = LONG8 if bigtiff else LONG
    if tile is None:
        entries[ROWS_PER_STRIP] = (LONG, [chunk_h])
        off_tag, count_tag = STRIP_OFFSETS, STRIP_COUNTS
    else:
        entries[TILE_WIDTH] = (LONG, [chunk_w])
        entries[TILE_LENGTH] = (LONG, [chunk_h])
        off_tag, count_tag = TILE_OFFSETS, TILE_COUNTS
    entries[count_tag] = (off_type, [len(c) for c in chunks])
    entries.update(tags or {})
    for t in drop:
        entries.pop(t, None)

    # the header, the IFD and its out-of-line values, then the chunks
    head = 16 if bigtiff else 8
    entry_size, count_fmt, inline = (20, "Q", 8) if bigtiff else (12, "I", 4)
    if off_tag not in drop:
        entries[off_tag] = (off_type, [0] * len(chunks))
    n = len(entries)
    ifd_len = (8 if bigtiff else 2) + n * entry_size + (8 if bigtiff else 4)
    blob_len = 0
    for typ, values in entries.values():
        size = _TYPE_SIZE[typ] * len(values)
        if size > inline:
            blob_len += size + size % 2
    at = head + ifd_len + blob_len
    body = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(at + len(body))
        body += c
        if len(body) % 2:
            body += b"\x00"
    if off_tag not in drop:
        entries[off_tag] = (off_type, offsets)
    ifd_at, extra_at = head, head + ifd_len
    ifd = bytearray(struct.pack(order + ("Q" if bigtiff else "H"), n))
    blobs = bytearray()
    for tag in sorted(entries):
        typ, values = entries[tag]
        payload = struct.pack(f"{order}{len(values)}{_TYPE_CHAR[typ]}",
                              *values)
        ifd += struct.pack(f"{order}HH{count_fmt}", tag, typ, len(values))
        if len(payload) <= inline:
            ifd += payload + b"\x00" * (inline - len(payload))
        else:
            ifd += struct.pack(order + count_fmt, extra_at + len(blobs))
            blobs += payload
            if len(blobs) % 2:
                blobs += b"\x00"
    ifd += b"\x00" * (8 if bigtiff else 4)  # no next IFD
    bom = b"II" if order == "<" else b"MM"
    if bigtiff:
        header = bom + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = bom + struct.pack(order + "HI", 42, ifd_at)
    if magic is not None:
        header = magic + header[4:]
    out = bytes(header + ifd + blobs + body)
    return out[:len(out) - truncate] if truncate else out


# ---- the cases -----------------------------------------------------------------

def _seeded(name: str, height: int, width: int, spp: int, bits: int,
            fmt: int) -> np.ndarray:
    """Seeded samples for a case: smooth waves plus noise over the
    sample's whole range (floats in [-2, 3])."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, spp)
    wave = np.stack([0.5 + 0.45 * np.sin(x / 3.0 + p) * np.cos(y / 2.0 - p)
                     for p in phase], -1)
    wave = np.clip(wave + rng.normal(0.0, 0.08, wave.shape), 0.0, 1.0)
    if fmt == 3:
        return (wave * 5.0 - 2.0).astype(np.float32)
    top = (1 << bits) - 1
    vals = np.rint(wave * top).astype(np.int64)
    if fmt == 2:
        vals -= 1 << (bits - 1)
        return vals.astype({8: np.int8, 16: np.int16, 32: np.int32}[bits])
    if bits <= 8:
        return vals.astype(np.uint8)
    if bits <= 16:
        return vals.astype(np.uint16)
    return vals.astype(np.uint32)


def _ycbcr(name: str, height: int, width: int) -> np.ndarray:
    """A photo-like YCbCr frame: waves, noise and a saturated checker."""
    return _jpeg_writer()._pixels(name, width, height, 3)


def _colormap(name: str, bits: int) -> list:
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    return rng.integers(0, 65536, 3 * (1 << bits)).tolist()


# the OPEN_INFO keys: (photometric, sample format, fill order, bits per
# sample, extra samples), each written in II and in MM where PIL has it
KEYS = [
    (0, 1, 1, (1,), ()), (0, 1, 2, (1,), ()), (1, 1, 1, (1,), ()),
    (1, 1, 2, (1,), ()), (0, 1, 1, (2,), ()), (0, 1, 2, (2,), ()),
    (1, 1, 1, (2,), ()), (1, 1, 2, (2,), ()), (0, 1, 1, (4,), ()),
    (0, 1, 2, (4,), ()), (1, 1, 1, (4,), ()), (1, 1, 2, (4,), ()),
    (0, 1, 1, (8,), ()), (0, 1, 2, (8,), ()), (1, 1, 1, (8,), ()),
    (1, 2, 1, (8,), ()), (1, 1, 2, (8,), ()),
    (1, 1, 1, (12,), ()), (0, 1, 1, (16,), ()), (1, 1, 1, (16,), ()),
    (1, 1, 2, (16,), ()), (1, 2, 1, (16,), ()), (0, 3, 1, (32,), ()),
    (1, 1, 1, (32,), ()), (1, 2, 1, (32,), ()), (1, 3, 1, (32,), ()),
    (1, 1, 1, (8, 8), (2,)),
    (2, 1, 1, (8, 8, 8), ()), (2, 1, 2, (8, 8, 8), ()),
    (2, 1, 1, (8, 8, 8, 8), ()), (2, 1, 1, (8, 8, 8, 8), (0,)),
    (2, 1, 1, (8,) * 5, (0, 0)), (2, 1, 1, (8,) * 6, (0, 0, 0)),
    (2, 1, 1, (8, 8, 8, 8), (1,)), (2, 1, 1, (8,) * 5, (1, 0)),
    (2, 1, 1, (8,) * 6, (1, 0, 0)), (2, 1, 1, (8, 8, 8, 8), (2,)),
    (2, 1, 1, (8,) * 5, (2, 0)), (2, 1, 1, (8,) * 6, (2, 0, 0)),
    (2, 1, 1, (8, 8, 8, 8), (999,)),
    (2, 1, 1, (16, 16, 16), ()), (2, 1, 1, (16,) * 4, ()),
    (2, 1, 1, (16,) * 4, (0,)), (2, 1, 1, (16,) * 4, (1,)),
    (2, 1, 1, (16,) * 4, (2,)),
    (3, 1, 1, (1,), ()), (3, 1, 2, (1,), ()), (3, 1, 1, (2,), ()),
    (3, 1, 2, (2,), ()), (3, 1, 1, (4,), ()), (3, 1, 2, (4,), ()),
    (3, 1, 1, (8,), ()), (3, 1, 1, (8, 8), (0,)), (3, 1, 1, (8, 8), (2,)),
    (3, 1, 2, (8,), ()),
    (5, 1, 1, (8,) * 4, ()), (5, 1, 1, (8,) * 5, (0,)),
    (5, 1, 1, (8,) * 6, (0, 0)), (5, 1, 1, (16,) * 4, ()),
    (8, 1, 1, (8, 8, 8), ()),
]
# the keys PIL has in II only
II_ONLY = {(1, 1, 1, (12,), ()), (0, 1, 1, (16,), ()), (1, 1, 2, (16,), ()),
           (1, 1, 1, (32,), ())}
# each key's file cycles through these (compression, predictor) pairs
_ROUND = [(1, 1), (32773, 1), (5, 1), (8, 1), (32946, 1), (5, 2),
          (8, 2), (1, 1)]


def _key_name(order: str, key) -> str:
    photo, fmt, fill, bits, extra = key
    return ("key_{}_p{}_f{}_o{}_b{}_e{}".format(
        "ii" if order == "<" else "mm", photo, fmt, fill,
        "-".join(map(str, bits)), "-".join(map(str, extra)) or "none"))


def _key_cases() -> dict:
    cases = {}
    i = 0
    for key in KEYS:
        photo, fmt, fill, bits, extra = key
        for order in ("<", ">"):
            if order == ">" and key in II_ONLY:
                continue
            compression, predictor = _ROUND[i % len(_ROUND)]
            i += 1
            if predictor == 2 and (bits[0] < 8 or bits[0] == 12):
                predictor = 1
            if fmt == 3:  # floats: predictor 3 on the compressed ones
                predictor = 3 if compression != 1 else 1
            if fill == 2 and compression == 1 and (photo, bits) in (
                    (0, (8,)), (3, (1,)), (3, (2,)), (3, (4,))):
                compression = 5  # PIL's raw decoder has no unpacker
            spec = {"photometric": photo, "bits": bits[0],
                    "sample_format": fmt, "extra": extra, "order": order,
                    "fill_order": fill, "compression": compression,
                    "predictor": predictor, "rows_per_strip": 3}
            if photo == 3:
                spec["colormap"] = (bits[0], )
            cases[_key_name(order, key)] = (7 + i % 5, 9 + i % 4,
                                            len(bits), spec)
    return cases


# name -> (width, height, samples per pixel, write_tiff's options; a
# "colormap" of (bits,) is made from the name's seed)
CASES = {
    **_key_cases(),
    # the container
    "bigtiff_ii_lzw": (19, 11, 3, {"photometric": 2, "bigtiff": True,
                                   "compression": 5, "rows_per_strip": 4}),
    "bigtiff_ii_deflate16": (13, 9, 3, {
        "photometric": 2, "bits": 16, "bigtiff": True,
        "compression": 8, "predictor": 2, "rows_per_strip": 2}),
    "bigtiff_raw_tiles": (21, 18, 1, {"photometric": 1, "bigtiff": True,
                                      "tile": (16, 16)}),
    "tiles_rgb_packbits": (37, 21, 3, {"photometric": 2, "tile": (16, 16),
                                       "compression": 32773}),
    "tiles_rgb_lzw_pred2": (37, 21, 3, {
        "photometric": 2, "tile": (16, 16), "compression": 5,
        "predictor": 2}),
    "tiles_rgba_raw": (37, 21, 4, {"photometric": 2, "extra": (2,),
                                   "tile": (16, 16)}),
    "tiles_gray16_mm_deflate": (37, 21, 1, {
        "photometric": 1, "bits": 16, "order": ">", "tile": (16, 32),
        "compression": 32946, "predictor": 2}),
    "tiles_float_pred3": (19, 17, 1, {
        "photometric": 1, "bits": 32, "sample_format": 3, "tile": (16, 16),
        "compression": 8, "predictor": 3}),
    "tiles_bilevel_raw": (37, 21, 1, {"photometric": 1, "bits": 1,
                                      "tile": (32, 16)}),
    "strip_whole_image_raw": (11, 7, 3, {"photometric": 2}),
    "strips_one_row_lzw": (11, 7, 3, {"photometric": 2, "compression": 5,
                                      "rows_per_strip": 1}),
    "strips_rps_past_height": (11, 7, 1, {
        "photometric": 1, "compression": 32773, "rows_per_strip": 100}),
    "orientation_6": (11, 7, 3, {"photometric": 2, "compression": 5,
                                 "tags": {ORIENTATION: (SHORT, [6])}}),
    # planar configuration 2
    "planar_rgb_raw": (13, 9, 3, {"photometric": 2, "planar": 2,
                                  "rows_per_strip": 4}),
    "planar_rgb_lzw_pred2": (13, 9, 3, {
        "photometric": 2, "planar": 2, "compression": 5, "predictor": 2,
        "rows_per_strip": 4}),
    "planar_rgba_deflate": (13, 9, 4, {
        "photometric": 2, "extra": (2,), "planar": 2, "compression": 8,
        "rows_per_strip": 4}),
    "planar_rgb16_mm_packbits": (13, 9, 3, {
        "photometric": 2, "bits": 16, "order": ">", "planar": 2,
        "compression": 32773, "rows_per_strip": 4}),
    "planar_rgb16_ii_deflate_pred2": (13, 9, 3, {
        "photometric": 2, "bits": 16, "planar": 2, "compression": 32946,
        "predictor": 2, "rows_per_strip": 4}),
    "planar_cmyk_tiles_lzw": (21, 18, 4, {
        "photometric": 5, "planar": 2, "compression": 5,
        "tile": (16, 16)}),
    "planar_rgb_tiles_raw": (21, 18, 3, {"photometric": 2, "planar": 2,
                                         "tile": (16, 16)}),
    # predictors at every width and both byte orders
    "pred2_rgb8_lzw": (19, 9, 3, {"photometric": 2, "compression": 5,
                                  "predictor": 2, "rows_per_strip": 4}),
    "pred2_gray16_mm_lzw": (19, 9, 1, {
        "photometric": 1, "bits": 16, "order": ">", "compression": 5,
        "predictor": 2, "rows_per_strip": 4}),
    "pred2_int32_mm_deflate": (19, 9, 1, {
        "photometric": 1, "bits": 32, "sample_format": 2, "order": ">",
        "compression": 8, "predictor": 2, "rows_per_strip": 4}),
    "pred2_uint32_ii_deflate": (19, 9, 1, {
        "photometric": 1, "bits": 32, "compression": 8, "predictor": 2,
        "rows_per_strip": 4}),
    "pred3_float_mm_lzw": (19, 9, 1, {
        "photometric": 1, "bits": 32, "sample_format": 3, "order": ">",
        "compression": 5, "predictor": 3, "rows_per_strip": 4}),
    # libtiff's PackBits sets up no predictor: the tag is ignored
    "pred3_ignored_by_packbits": (19, 9, 1, {
        "photometric": 1, "bits": 32, "sample_format": 3,
        "compression": 32773, "predictor": 3, "rows_per_strip": 4}),
    # JPEG strips and tiles (each its own stream, tables in JPEGTables)
    "jpeg_ycbcr420_strips": (45, 37, 3, {
        "photometric": 6, "compression": 7, "rows_per_strip": 16,
        "subsampling": (2, 2),
        "jpeg": {"sampling": [(2, 2), (1, 1), (1, 1)]}}),
    "jpeg_ycbcr422_tiles": (45, 37, 3, {
        "photometric": 6, "compression": 7, "tile": (32, 16),
        "subsampling": (2, 1),
        "jpeg": {"sampling": [(2, 1), (1, 1), (1, 1)]}}),
    "jpeg_ycbcr444_mm": (29, 19, 3, {
        "photometric": 6, "order": ">", "compression": 7,
        "rows_per_strip": 8, "subsampling": (1, 1), "jpeg": {}}),
    "jpeg_ycbcr420_inline_tables": (33, 20, 3, {
        "photometric": 6, "compression": 7, "rows_per_strip": 16,
        "subsampling": (2, 2),
        "jpeg": {"sampling": [(2, 2), (1, 1), (1, 1)],
                 "shared_tables": False, "dht": "optimal"}}),
    "jpeg_ycbcr420_bigtiff_q95": (40, 24, 3, {
        "photometric": 6, "bigtiff": True, "compression": 7,
        "rows_per_strip": 16, "subsampling": (2, 2),
        "jpeg": {"sampling": [(2, 2), (1, 1), (1, 1)], "quality": 95}}),
    "jpeg_rgb_strips": (29, 19, 3, {"photometric": 2, "compression": 7,
                                    "rows_per_strip": 8, "jpeg": {}}),
    "jpeg_gray_tiles": (37, 21, 1, {"photometric": 1, "compression": 7,
                                    "tile": (16, 16), "jpeg": {}}),
    "jpeg_cmyk_strips": (29, 19, 4, {"photometric": 5, "compression": 7,
                                     "rows_per_strip": 8, "jpeg": {}}),
    "jpeg_rgb_planar": (29, 19, 3, {"photometric": 2, "planar": 2,
                                    "compression": 7, "rows_per_strip": 8,
                                    "jpeg": {}}),
    "jpeg_progressive_ycbcr": (29, 19, 3, {
        "photometric": 6, "compression": 7, "rows_per_strip": 16,
        "subsampling": (2, 2),
        "jpeg": {"sampling": [(2, 2), (1, 1), (1, 1)], "dht": "optimal",
                 "script": "progressive"}}),
}

# the kinds the port refuses with NotImplementedError: name -> (width,
# height, samples per pixel, options)
REFUSED_CASES = {
    "ycbcr_raw": (8, 6, 3, {"photometric": 6, "subsampling": (1, 1)}),
    "ycbcr_lzw": (8, 6, 3, {"photometric": 6, "compression": 5,
                            "subsampling": (1, 1)}),
    "ycbcr_jpeg_planar": (16, 16, 3, {"photometric": 6, "planar": 2,
                                      "compression": 7, "jpeg": {}}),
    "old_lzw": (8, 6, 1, {"photometric": 1, "compression": 5,
                          "old_lzw": True}),
    **{f"compression_{c}": (8, 6, 1, {"photometric": 1, "compression": c,
                                      "raw_payload": True})
       for c in (2, 3, 4, 6, 32771, 32809, 34676, 34677, 34925, 50000)},
}

# files PIL refuses: name -> (width, height, samples, options)
BAD_CASES = {
    # PIL's raw decoder lacks the FillOrder 2 unpacker of these
    "raw_fill2_palette4": (8, 6, 1, {"photometric": 3, "bits": 4,
                                     "fill_order": 2, "colormap": (4,)}),
    "raw_fill2_gray8_inverted": (8, 6, 1, {"photometric": 0,
                                           "fill_order": 2}),
    # PIL reads a big-endian BigTIFF's header as a classic one
    "bigtiff_mm": (8, 6, 3, {"photometric": 2, "order": ">",
                             "bigtiff": True, "compression": 5}),
    "unknown_pixel_mode": (8, 6, 3, {"photometric": 2, "bits": 16,
                                     "sample_format": 2}),
    "mm_gray12": (8, 6, 1, {"photometric": 1, "bits": 12, "order": ">"}),
    "truncated_raw": (16, 12, 3, {"photometric": 2, "truncate": 40}),
    "truncated_lzw": (16, 12, 3, {"photometric": 2, "compression": 5,
                                  "truncate": 40}),
    "truncated_deflate": (16, 12, 3, {"photometric": 2, "compression": 8,
                                      "truncate": 40}),
    "truncated_packbits": (16, 12, 3, {"photometric": 2,
                                       "compression": 32773,
                                       "truncate": 40}),
    "no_width": (8, 6, 1, {"photometric": 1, "drop": (WIDTH,)}),
    "unknown_compression": (8, 6, 1, {"photometric": 1,
                                      "compression": 12345,
                                      "raw_payload": True}),
    # WebP strips (50001): the libtiff Pillow ships has no WebP codec
    # ("WEBP compression support is not configured")
    "webp_strip": (10, 8, 3, {"photometric": 2, "webp_strip": True}),
}


def case_samples(name: str) -> np.ndarray:
    width, height, spp, opts = {**CASES, **REFUSED_CASES,
                                **BAD_CASES}[name]
    bits = opts.get("bits", 8)
    fmt = opts.get("sample_format", 1)
    if opts.get("compression") == 7 and opts.get("photometric") == 6:
        return _ycbcr(name, height, width)
    return _seeded(name, height, width, spp, bits, fmt)


def _jpeg_options(opts: dict) -> dict:
    jpeg = dict(opts["jpeg"])
    if jpeg.get("script") == "progressive":
        jpeg["script"] = _jpeg_writer().simple_progression(3)
    return jpeg


def case_bytes(name: str) -> bytes:
    _, _, _, opts = {**CASES, **REFUSED_CASES, **BAD_CASES}[name]
    opts = dict(opts)
    samples = case_samples(name)
    if "colormap" in opts:
        opts["colormap"] = _colormap(name, opts["colormap"][0])
    if "jpeg" in opts:
        opts["jpeg"] = _jpeg_options(opts)
    if opts.pop("raw_payload", False):  # a payload of the codec's kind is
        compression = opts.pop("compression")  # not needed to be refused
        return write_tiff(samples, **opts, tags={
            COMPRESSION: (SHORT, [compression])})
    if opts.pop("old_lzw", False):  # old-style LZW: its first bytes 0, 1
        data = write_tiff(samples, **opts)
        return _old_lzw(data)
    if opts.pop("webp_strip", False):
        return _webp_strip(write_tiff(samples, **opts), samples)
    return write_tiff(samples, **opts)


def _webp_strip(data: bytes, samples: np.ndarray) -> bytes:
    """A one-strip uncompressed file (II) with its strip replaced by a
    lossless WebP of the samples (tests/golden/webp/write_fixtures.py's
    writer) and its compression set to 50001, WebP."""
    path = os.path.join(os.path.dirname(HERE), "webp", "write_fixtures.py")
    spec = importlib.util.spec_from_file_location("webp_writer", path)
    ww = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ww)
    rgba = np.concatenate([samples, np.full(samples.shape[:2] + (1,), 255,
                                            np.uint8)], -1)
    strip = ww.riff([ww.chunk(b"VP8L", ww.write_vp8l(rgba))])
    out = bytearray(data)
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag = struct.unpack("<H", data[at:at + 2])[0]
        if tag == COMPRESSION:
            struct.pack_into("<HHIHH", out, at, tag, SHORT, 1, 50001, 0)
        elif tag == STRIP_OFFSETS:
            struct.pack_into("<HHII", out, at, tag, LONG, 1, len(data))
        elif tag == STRIP_COUNTS:
            struct.pack_into("<HHII", out, at, tag, LONG, 1, len(strip))
    return bytes(out) + strip


def _old_lzw(data: bytes) -> bytes:
    """The strip of a one-strip LZW file replaced by bytes that begin as
    old-style (LSB-first) LZW does: 0x00, then a byte with bit 0 set."""
    order = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag, typ, count, value = struct.unpack(order + "HHII",
                                               data[at:at + 12])
        if tag == STRIP_OFFSETS:
            return data[:value] + b"\x00\x01" + data[value + 2:]
    raise ValueError("no strip offsets")


def write_case(name: str, path: str) -> None:
    with open(path, "wb") as f:
        f.write(case_bytes(name))


def frame_samples(size: int, spp: int, bits: int = 8,
                  seed: int = 0) -> np.ndarray:
    """A photo-like frame for the timing: smooth gradients, soft discs
    and mild noise, as uint8 or (bits 16) uint16."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float64) / size
    img = np.empty((size, size, spp))
    for c in range(spp):
        a, b, p = rng.uniform(0.5, 3.0, 3)
        img[..., c] = 0.5 + 0.23 * np.sin(a * 6 * x + p) * np.cos(b * 5 * y)
        for _ in range(6):
            cx, cy, r, v = rng.uniform(0, 1, 4)
            disc = ((x - cx) ** 2 + (y - cy) ** 2) < (0.05 + 0.2 * r) ** 2
            img[..., c] += np.where(disc, 0.3 * (v - 0.5), 0)
    img += rng.normal(0.0, 0.008, img.shape)
    top = (1 << bits) - 1
    return np.clip(np.rint(img * top), 0, top).astype(
        np.uint8 if bits == 8 else np.uint16)


# the kinds chip_smoke.py times at 800x800: name -> (samples per pixel,
# bits, write_tiff's options); strips of 8 rows, as libtiff's writers
# size them near 8 KB
TIMED_KINDS = {
    "raw": (3, 8, {"photometric": 2, "rows_per_strip": 8}),
    "packbits": (3, 8, {"photometric": 2, "compression": 32773,
                        "rows_per_strip": 8}),
    "lzw": (3, 8, {"photometric": 2, "compression": 5,
                   "rows_per_strip": 8}),
    "lzw_predictor2": (3, 8, {"photometric": 2, "compression": 5,
                              "predictor": 2, "rows_per_strip": 8}),
    "deflate": (3, 8, {"photometric": 2, "compression": 8,
                       "rows_per_strip": 8}),
    "deflate_predictor2": (3, 8, {"photometric": 2, "compression": 32946,
                                  "predictor": 2, "rows_per_strip": 8}),
    "jpeg_ycbcr420": (3, 8, {"photometric": 6, "compression": 7,
                             "rows_per_strip": 16, "subsampling": (2, 2),
                             "jpeg": {"sampling": [(2, 2), (1, 1),
                                                   (1, 1)],
                                      "quality": 90}}),
    "rgb16_deflate_predictor2": (3, 16, {
        "photometric": 2, "compression": 8, "predictor": 2,
        "rows_per_strip": 4}),
    "planar_lzw": (3, 8, {"photometric": 2, "planar": 2, "compression": 5,
                          "rows_per_strip": 8}),
    "tiled_lzw": (3, 8, {"photometric": 2, "compression": 5,
                         "tile": (256, 256)}),
}


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def fixture_name(name: str) -> str:
    return f"{name}.tif"


def main() -> None:
    from PIL import Image, features

    files = {}
    for name in CASES:
        path = os.path.join(HERE, fixture_name(name))
        write_case(name, path)
        with Image.open(path) as img:
            files[fixture_name(name)] = digest(img.mode, np.asarray(img))
    with open(DIGESTS, "w") as f:
        json.dump({"pil": Image.__version__,
                   "libtiff": features.version("libtiff"),
                   "libjpeg_turbo": features.version("libjpeg_turbo"),
                   "files": files}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    main()
