"""A BMP / DIB writer for the cases of tests/test_torch_bmp.py, and the
committed fixtures beside this file.

Everything here uses numpy and the standard library only (chip_smoke.py
runs it on the card's host, which has no PIL):

  - `info_header(size, width, height, bits, ...)`: the BITMAPCOREHEADER
    (12 bytes), BITMAPINFOHEADER (40), V2 (52) and V3 (56) headers, the
    OS/2 2.x header (64), V4 (108) and V5 (124), with any compression,
    colour count and bitfield masks;
  - `pack_rows(values, bits)`: pixel rows of 1, 4, 8, 16, 24 or 32 bits,
    padded to 4 bytes, bottom-up unless asked otherwise;
  - `rle8(indices)` / `rle4(indices)`: RLE8 and RLE4 streams of runs and
    absolute runs (word aligned), an end of line per row and the end of
    the bitmap; hand-built streams add deltas and early ends;
  - `bmp(header, pixels, ...)`: the file (the "BM" header and its pixel
    offset, or none for a DIB), the masks after a 40-byte header, the
    palette.

CASES names each committed case, REFUSED_CASES files PIL refuses (their
digests.json entry is PIL's error), PIL_CASES the files PIL's own encoder
writes (only `main` needs PIL for those), NEAR_MISSES files Image.open
does not take as BMP or DIB.  `python tests/golden/bmp/write_fixtures.py`
writes one file per case here and digests.json: the mode, shape, dtype
and sha256 of `np.asarray(Image.open(f))`, with the PIL version.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "digests.json")
RAW, RLE8, RLE4, BITFIELDS, JPEG, PNG, ALPHABITFIELDS = range(7)


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(int(hashlib.sha256(name.encode())
                                     .hexdigest()[:8], 16))


def photo(height: int, width: int, name: str = "p", bands: int = 3
          ) -> np.ndarray:
    """Seeded smooth gradients with mild noise, (H, W, bands) uint8."""
    rng = _rng(name)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    out = []
    for _ in range(bands):
        a, b, c = rng.uniform(0.1, 0.6, 3)
        out.append(128 + 90 * np.sin(a * x + c) * np.cos(b * y)
                   + rng.normal(0, 6, (height, width)))
    return np.clip(np.rint(np.stack(out, -1)), 0, 255).astype(np.uint8)


def indices(height: int, width: int, n: int, name: str = "i") -> np.ndarray:
    """Seeded palette indices below n in runs of 1-6, (H, W) uint8."""
    rng = _rng(name)
    out = np.empty((height, width), np.uint8)
    for y in range(height):
        x = 0
        while x < width:
            k = int(rng.integers(1, 7))
            out[y, x:x + k] = rng.integers(0, n)
            x += k
    return out


def info_header(size: int, width: int, height: int, bits: int,
                compression: int = RAW, colors: int = 0,
                masks=(0, 0, 0, 0), planes: int = 1) -> bytes:
    """A DIB header of `size` bytes (12, 40, 52, 56, 64, 108, 124)."""
    if size == 12:
        return struct.pack("<IHHHH", 12, width, height, planes, bits)
    head = struct.pack("<IiiHHIIiiII", size, width, height, planes, bits,
                       compression, 0, 2835, 2835, colors, 0)
    tail = b"".join(struct.pack("<I", m) for m in masks)[:max(0, size - 40)]
    return head + tail + bytes(size - 40 - len(tail))


def palette(colors, pad: int = 4) -> bytes:
    """(n, 3) RGB -> BGR(X) entries."""
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)[:, ::-1]
    if pad == 4:
        colors = np.concatenate([colors, np.zeros((len(colors), 1),
                                                  np.uint8)], 1)
    return colors.tobytes()


def gray_ramp(n: int, pad: int = 4) -> bytes:
    v = np.arange(n) & 255
    return palette(np.stack([v, v, v], -1), pad)


def pack_rows(values: np.ndarray, bits: int, top_down: bool = False
              ) -> bytes:
    """(H, W) indices (bits <= 8), (H, W) 16-bit words, (H, W, 3) BGR or
    (H, W, 4) bytes -> rows padded to 4 bytes, bottom-up by default."""
    h, w = values.shape[:2]
    if bits < 8:
        v = values.astype(np.uint8)
        per = 8 // bits
        v = np.concatenate([v, np.zeros((h, -w % per), np.uint8)], 1)
        v = v.reshape(h, -1, per)
        shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
        rows = (v << shifts).sum(-1, dtype=np.uint8)
    elif bits == 16:
        rows = values.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        rows = values.astype(np.uint8).reshape(h, -1)
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.concatenate([rows, np.zeros((h, stride - rows.shape[1]),
                                          np.uint8)], 1)
    return (rows if top_down else rows[::-1]).tobytes()


def bmp(header: bytes, pixels: bytes, pal: bytes = b"", masks: bytes = b"",
        offset=None, dib: bool = False, gap: bytes = b"") -> bytes:
    """The file: "BM", its size and pixel offset (default: right after the
    palette and `gap`), the header, masks, palette, gap, pixels."""
    body = header + masks + pal + gap
    if dib:
        return body + pixels
    if offset is None:
        offset = 14 + len(body)
    return (b"BM" + struct.pack("<IHHI", 14 + len(body) + len(pixels), 0, 0,
                                offset) + body + pixels)


def _runs(row: np.ndarray):
    """(value, length) runs of a row."""
    cut = np.flatnonzero(np.diff(row.astype(np.int16))) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [row.size]])
    return [(int(row[s]), int(e - s)) for s, e in zip(starts, ends)]


def _rle(rows: np.ndarray, rle4: bool) -> bytes:
    out = bytearray()
    for row in rows:
        literal = []

        def flush():
            while literal:
                part, literal[:] = literal[:254], literal[254:]
                if rle4 and len(part) % 2 and len(part) >= 3:
                    # PIL reads an odd absolute run one pixel short
                    literal.insert(0, part.pop())
                if len(part) < 3:
                    for v in part:
                        out.extend((1, v * 17 if rle4 else v))
                    continue
                out.extend((0, len(part)))
                if rle4:
                    padded = part + [0] * (len(part) % 2)
                    out.extend(padded[k] << 4 | padded[k + 1]
                               for k in range(0, len(padded), 2))
                    n = len(padded) // 2
                else:
                    out.extend(part)
                    n = len(part)
                if n % 2:
                    out.append(0)

        for value, length in _runs(row):
            if length >= 3:
                flush()
                while length:
                    k = min(length, 255)
                    out.extend((k, value * 17 if rle4 else value))
                    length -= k
            else:
                literal.extend([value] * length)
        flush()
        out.extend((0, 0))
    out.extend((0, 1))
    return bytes(out)


def rle8(values: np.ndarray, top_down: bool = False) -> bytes:
    """(H, W) indices -> an RLE8 stream, rows bottom-up by default."""
    return _rle(values if top_down else values[::-1], False)


def rle4(values: np.ndarray) -> bytes:
    """(H, W) indices below 16 -> an RLE4 stream (runs of one index)."""
    return _rle(values[::-1], True)


def _colors(n: int, name: str) -> np.ndarray:
    return _rng(name).integers(0, 256, (n, 3))


def _paletted(name: str, bits: int, w: int, h: int, size: int = 40,
              **kw) -> bytes:
    n = 1 << bits
    pad = 3 if size == 12 else 4
    return bmp(info_header(size, w, h, bits), pack_rows(indices(
        h, w, n, name), bits), palette(_colors(n, name), pad), **kw)


def _true(name: str, bits: int, w: int, h: int, size: int = 40,
          compression: int = RAW, masks=(0, 0, 0, 0), top_down=False,
          after=b"", **kw) -> bytes:
    if bits == 16:
        px = _rng(name).integers(0, 1 << 16, (h, w))
    else:
        px = photo(h, w, name, bits // 8)
    return bmp(info_header(size, w, -h if top_down else h, bits,
                           compression, masks=masks),
               pack_rows(px, bits, top_down), masks=after, **kw)


def _rle_case(name: str, rle4_: bool, w: int, h: int, **kw) -> bytes:
    n = 16 if rle4_ else 256
    idx = indices(h, w, n, name)
    stream = rle4(idx) if rle4_ else rle8(idx)
    return bmp(info_header(40, w, h, 4 if rle4_ else 8,
                           RLE4 if rle4_ else RLE8),
               stream, palette(_colors(n, name)), **kw)


# hand-built RLE8 streams of a 6x4 image: escapes, deltas, early ends
_DELTA8 = bytes([3, 9, 0, 2, 9, 9, 1, 2, 2, 4, 0, 0,     # run, delta (4 bytes)
                 0, 4, 1, 2, 3, 4, 2, 5, 0, 0,           # absolute, run
                 0, 3, 7, 8, 9, 0, 0, 1])                # odd absolute, end
_EARLY_END = bytes([6, 1, 0, 0, 2, 3, 0, 1])            # end in row 2
_PAST_ROW = bytes([9, 4, 0, 0, 0, 8, 1, 2, 3, 4, 5, 6, 7, 8, 0, 0,
                   6, 3, 0, 0, 6, 3, 0, 1])             # clamped, long abs
_RLE4_ODD = bytes([0, 3, 0x12, 0x30, 2, 0x77, 0, 0, 5, 0x9a, 0, 1])
_MASKS32 = {"bgrx": (0xFF0000, 0xFF00, 0xFF, 0),
            "xbgr": (0xFF000000, 0xFF0000, 0xFF00, 0),
            "bgxr": (0xFF000000, 0xFF00, 0xFF, 0),
            "abgr": (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
            "rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
            "bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
            "bgar": (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
            "zero": (0, 0, 0, 0)}
_MASK555, _MASK565 = (0x7C00, 0x3E0, 0x1F, 0), (0xF800, 0x7E0, 0x1F, 0)


def _masks_after(m) -> bytes:
    return struct.pack("<III", *m[:3])


def _gray_file(bits: int, w: int, h: int, n: int, name: str,
               **kw) -> bytes:
    """A gray-ramp palette of n entries at `bits` bits: mode L (1 with
    two entries black and white)."""
    pal = (palette([[0, 0, 0], [255, 255, 255]]) if n == 2
           else gray_ramp(n))
    return bmp(info_header(40, w, h, bits, colors=n), pack_rows(
        indices(h, w, min(n, 1 << bits), name), bits), pal, **kw)


CASES = {
    **{f"core12_{b}bit": (lambda b=b: _paletted(f"c{b}", b, 13, 7, 12))
       for b in (1, 4, 8)},
    "core12_24bit": lambda: bmp(info_header(12, 13, 7, 24), pack_rows(
        photo(7, 13, "c24"), 24)),
    **{f"info40_{b}bit": (lambda b=b: _paletted(f"i{b}", b, 17, 9))
       for b in (1, 4, 8)},
    "info40_16bit": lambda: _true("i16", 16, 17, 9),
    "info40_24bit": lambda: _true("i24", 24, 17, 9),
    "info40_32bit_rgb": lambda: _true("i32", 32, 17, 9),
    "info40_24bit_top_down": lambda: _true("t24", 24, 17, 9, top_down=True),
    "info40_8bit_top_down": lambda: bmp(info_header(40, 11, -5, 8),
                                        pack_rows(indices(5, 11, 256, "t8"),
                                                  8, True),
                                        palette(_colors(256, "t8"))),
    "info40_bitfields_555": lambda: _true("b555", 16, 17, 9,
                                          compression=BITFIELDS,
                                          after=_masks_after(_MASK555)),
    "info40_bitfields_565": lambda: _true("b565", 16, 17, 9,
                                          compression=BITFIELDS,
                                          after=_masks_after(_MASK565)),
    "info40_bitfields_24": lambda: _true(
        "b24", 24, 17, 9, compression=BITFIELDS,
        after=_masks_after((0xFF0000, 0xFF00, 0xFF))),
    **{f"info40_bitfields32_{k}": (lambda k=k: _true(
        f"b32{k}", 32, 17, 9, compression=BITFIELDS,
        after=_masks_after(_MASKS32[k]))) for k in ("bgrx", "xbgr", "zero")},
    "v2_52_bitfields32_bgxr": lambda: _true(
        "v2", 32, 11, 6, 52, BITFIELDS, _MASKS32["bgxr"]),
    **{f"v3_56_bitfields32_{k}": (lambda k=k: _true(
        f"v3{k}", 32, 11, 6, 56, BITFIELDS, _MASKS32[k]))
       for k in ("abgr", "rgba", "bgra", "bgar", "zero")},
    "os2_64_8bit": lambda: _paletted("o8", 8, 13, 7, 64),
    "os2_64_24bit": lambda: _true("o24", 24, 13, 7, 64),
    "v4_108_bitfields565": lambda: _true("v4", 16, 13, 7, 108, BITFIELDS,
                                         _MASK565),
    "v4_108_24bit_top_down": lambda: _true("v4t", 24, 13, 7, 108,
                                           top_down=True),
    "v5_124_32bit_bgra": lambda: _true("v5", 32, 13, 7, 124, BITFIELDS,
                                       _MASKS32["bgra"]),
    "v5_124_8bit": lambda: _paletted("v58", 8, 13, 7, 124),
    "gray_8bit_is_L": lambda: _gray_file(8, 15, 6, 256, "g8"),
    "gray_4bit_ramp_is_L_width3": lambda: _gray_file(4, 3, 4, 16, "g43"),
    "gray_4bit_ramp_is_L_width9": lambda: _gray_file(4, 9, 4, 16, "g49"),
    "gray_4bit_ramp_is_L_width9_trailing": lambda: _gray_file(
        4, 9, 4, 16, "g49t") + bytes(range(40, 60)),
    "bw_1bit_is_mode_1": lambda: _gray_file(1, 21, 5, 2, "bw"),
    "bw_palette_8bit_is_mode_1": lambda: _gray_file(8, 9, 3, 2, "bw8"),
    "gray_8bit_colors_100": lambda: _gray_file(8, 10, 4, 100, "g100"),
    "palette_4bit_colors_5": lambda: bmp(
        info_header(40, 10, 4, 4, colors=5), pack_rows(indices(
            4, 10, 5, "p5"), 4), palette(_colors(5, "p5"))),
    "palette_8bit_colors_300_gray": lambda: bmp(
        info_header(40, 10, 4, 8, colors=300),
        pack_rows(indices(4, 10, 256, "g300"), 8), gray_ramp(300)),
    "offset_right_after_header": lambda: (lambda idx: bmp(
        info_header(40, 8, 3, 8, colors=4), pack_rows(idx, 8),
        palette(_colors(4, "oh")), offset=54))(indices(3, 8, 4, "oh")),
    "offset_zero": lambda: _paletted("oz", 8, 9, 4, offset=0),
    "offset_past_a_gap": lambda: _paletted("og", 4, 9, 4, gap=b"\x77" * 6),
    "trailing_bytes": lambda: _true("tb", 24, 9, 4) + b"\x01" * 33,
    "dib_40_8bit": lambda: _paletted("d8", 8, 12, 5, dib=True),
    "dib_12_24bit": lambda: bmp(info_header(12, 12, 5, 24), pack_rows(
        photo(5, 12, "d12"), 24), dib=True),
    "dib_40_bitfields32_bgrx": lambda: _true(
        "dbgrx", 32, 12, 5, compression=BITFIELDS,
        after=_masks_after(_MASKS32["bgrx"]), dib=True),
    "rle8": lambda: _rle_case("r8", False, 23, 11),
    "rle8_top_down": lambda: bmp(info_header(40, 9, -4, 8, RLE8), rle8(
        indices(4, 9, 256, "r8t"), True), palette(_colors(256, "r8t"))),
    "rle8_gray_is_L": lambda: bmp(info_header(40, 12, 5, 8, RLE8), rle8(
        indices(5, 12, 256, "r8g")), gray_ramp(256)),
    "rle8_delta_escapes": lambda: bmp(info_header(40, 6, 4, 8, RLE8),
                                      _DELTA8, palette(_colors(256, "de"))),
    "rle8_delta_escapes_odd_offset": lambda: bmp(
        info_header(40, 6, 4, 8, RLE8), _DELTA8, palette(_colors(256, "de")),
        gap=b"\x00"),
    "rle8_end_of_bitmap_early_full": lambda: bmp(
        info_header(40, 4, 2, 8, RLE8), bytes([4, 1, 0, 0, 4, 2, 0, 1]),
        palette(_colors(256, "ee"))),
    "rle8_past_row_end": lambda: bmp(info_header(40, 6, 4, 8, RLE8),
                                     _PAST_ROW, palette(_colors(256, "pr"))),
    "rle4": lambda: _rle_case("r4", True, 23, 11),
    "rle4_odd_absolute": lambda: bmp(info_header(40, 5, 2, 4, RLE4),
                                     _RLE4_ODD, palette(_colors(16, "r4o"))),
    "rle8_in_a_4bit_header": lambda: bmp(
        info_header(40, 4, 2, 4, RLE8), bytes([4, 3, 0, 0, 4, 17, 0, 1]),
        palette(_colors(16, "r84"))),
}
_BIG = 2 ** 31 - 1
REFUSED_CASES = {
    "bits_2": lambda: bmp(info_header(40, 8, 2, 2), bytes(8),
                          palette(_colors(4, "b2"))),
    "bits_0": lambda: bmp(info_header(40, 8, 2, 0), bytes(8)),
    "compression_jpeg": lambda: bmp(info_header(40, 8, 2, 24, JPEG),
                                    bytes(48)),
    "compression_png": lambda: bmp(info_header(40, 8, 2, 24, PNG), bytes(48)),
    "alphabitfields": lambda: _true("ab", 32, 4, 2, 56, ALPHABITFIELDS,
                                    _MASKS32["bgra"]),
    "bitfields_other_masks": lambda: _true(
        "om", 32, 4, 2, 56, BITFIELDS, (0x3FF, 0xFFC00, 0x3FF00000, 0)),
    "bitfields_8bit": lambda: bmp(info_header(40, 4, 2, 8, BITFIELDS),
                                  bytes(8), masks=_masks_after(_MASK565)),
    "header_size_20": lambda: b"BM" + struct.pack("<IHHI", 60, 0, 0, 34) + (
        struct.pack("<I", 20) + bytes(16)) + bytes(26),
    "header_truncated": lambda: bmp(info_header(40, 8, 2, 24), b"")[:40],
    "pixels_truncated": lambda: _true("pt", 24, 9, 4)[:-7],
    "palette_300_colours": lambda: bmp(
        info_header(40, 10, 4, 8, colors=300),
        pack_rows(indices(4, 10, 256, "p300"), 8), palette(_colors(
            300, "p300"))),
    "palette_of_no_colours": lambda: bmp(
        info_header(40, 4, 2, 8, colors=70000), bytes(8)),
    "gray_4bit_ramp_truncated": lambda: _gray_file(4, 9, 4, 16, "g4t")[:-3],
    "rle8_short_of_pixels": lambda: bmp(info_header(40, 4, 2, 8, RLE8),
                                        _EARLY_END[:4] + b"\x00\x01",
                                        palette(_colors(256, "sp"))),
    "rle8_end_of_bitmap_early": lambda: bmp(info_header(40, 6, 4, 8, RLE8),
                                            _EARLY_END,
                                            palette(_colors(256, "eb"))),
    "rle8_delta_cut_short": lambda: bmp(info_header(40, 6, 4, 8, RLE8),
                                        bytes([3, 1, 0, 2, 1, 1, 2]),
                                        palette(_colors(256, "dc"))),
    "rle8_black_and_white_palette": lambda: bmp(
        info_header(40, 4, 2, 8, RLE8, colors=2), bytes([4, 1, 0, 0, 4, 0,
                                                         0, 1]),
        palette([[0, 0, 0], [255, 255, 255]])),
    "rle8_24bit": lambda: bmp(info_header(40, 4, 2, 24, RLE8),
                              bytes([4, 1, 0, 0, 4, 0, 0, 1])),
    "decompression_bomb": lambda: bmp(info_header(40, 20000, 20000, 24),
                                      bytes(64)),
}
# files Image.open does not take as BMP or DIB
NEAR_MISSES = {
    "bm_header_cut_at_10": lambda: b"BM" + bytes(8),
    "bm_then_dib_size_cut": lambda: b"BM" + struct.pack(
        "<IHHI", 20, 0, 0, 18) + b"\x28\x00",
    "dib_size_41": lambda: struct.pack("<I", 41) + bytes(60),
    "bm_width_0": lambda: bmp(info_header(40, 0, 2, 24), bytes(8)),
    "bitfields_masks_cut_short": lambda: bmp(info_header(
        40, 4, 2, 16, BITFIELDS), b"")[:60],
}
# the files PIL's own encoder writes: name -> (mode, size)
PIL_CASES = {"pil_1": ("1", (19, 7)), "pil_L": ("L", (19, 7)),
             "pil_P": ("P", (19, 7)), "pil_RGB": ("RGB", (19, 7)),
             "pil_RGBA": ("RGBA", (19, 7))}
FRAMES = [f"frame_{i:05d}" for i in range(5)]  # tests/golden/jpeg's pixels


def case_bytes(name: str) -> bytes:
    return {**CASES, **REFUSED_CASES}[name]()


def pil_source(name: str):
    from PIL import Image

    mode, (w, h) = PIL_CASES[name]
    return Image.fromarray(photo(h, w, name, 4), "RGBA").convert(mode)


# the 800x800 kinds chip_smoke.py times and trains on
def write_24bit(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) RGB frame as a 24-bit BMP (mode RGB, the same
    pixels)."""
    h, w = rgb.shape[:2]
    return bmp(info_header(40, w, h, 24), pack_rows(rgb[..., ::-1], 24))


def write_rle8_gray(gray: np.ndarray) -> bytes:
    """An (H, W) uint8 gray frame as an RLE8 BMP with the gray ramp for
    its palette (mode L, the same values)."""
    h, w = gray.shape
    return bmp(info_header(40, w, h, 8, RLE8), rle8(gray), gray_ramp(256))


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def fixture_name(name: str) -> str:
    return f"{name}.dib" if name.startswith("dib_") else f"{name}.bmp"


def main() -> None:
    from PIL import Image

    files, refused = {}, {}
    for name in {**CASES, **REFUSED_CASES}:
        path = os.path.join(HERE, fixture_name(name))
        with open(path, "wb") as f:
            f.write(case_bytes(name))
        try:
            with Image.open(path) as img:
                files[fixture_name(name)] = digest(img.mode, np.asarray(img))
        except Exception as e:  # noqa: BLE001 - PIL's refusal, recorded
            if name in CASES:
                raise
            refused[fixture_name(name)] = f"{type(e).__name__}: " + str(
                e).replace(path, fixture_name(name))
            continue
        if name in REFUSED_CASES:
            raise RuntimeError(f"{name}: PIL opens it")
    for name in PIL_CASES:
        path = os.path.join(HERE, fixture_name(name))
        pil_source(name).save(path, "BMP")
        with Image.open(path) as img:
            files[fixture_name(name)] = digest(img.mode, np.asarray(img))
    with open(DIGESTS, "w") as f:
        json.dump({"pil": Image.__version__, "files": files,
                   "refused": refused}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    main()
