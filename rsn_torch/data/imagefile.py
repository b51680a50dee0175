"""What the readers of rsn_torch.data that follow a PIL plugin (TIFF,
BMP / DIB, GIF, the PPM family, TGA) share of PIL's ImageFile: a file
read as a plugin reads it, the errors that tell Image.open to try the
next plugin, and PIL's raw decoder and unpackers (libImaging's
RawDecode.c and Unpack.c) in numpy.

`File` is the plugin's fp over the file's bytes: read(n) gives fewer
bytes at the end, seek may pass the end.  `NotThisFormat` is what
Image.open catches from a plugin's _open (SyntaxError, and the
IndexError, TypeError, KeyError, EOFError and struct.error ImageFile
turns into it) to try the next one; any other error refuses the file.

`unpack(mode, rawmode, rows, width)` turns rows of a rawmode's bytes into
the array np.asarray gives of an image of that mode.  `raw_image` is
ImageFile.load on one "raw" tile that covers the image: PIL's raw decoder
(rows `stride` bytes apart, bottom-up when ystep is -1, a truncated file
refused), or, where PIL maps the file instead (a tile whose rawmode is
the image's mode and one of Image._MAPMODES), the rows that map gives,
which may overlap when the stride is shorter than a row.
"""
from __future__ import annotations

import struct

import numpy as np

MAX_PIXELS = 2 * 89478485  # Image.MAX_IMAGE_PIXELS * 2: DecompressionBombError
MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")

BITFLIP = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# rawmode -> bits per pixel (Unpack.c); the band rawmodes of planar 2 are 8
RAW_BITS = {
    "1": 1, "1;I": 1, "1;R": 1, "1;IR": 1, "1;8": 8,
    "L;2": 2, "L;2I": 2, "L;2R": 2, "L;2IR": 2,
    "L;4": 4, "L;4I": 4, "L;4R": 4, "L;4IR": 4,
    "L": 8, "L;I": 8, "L;R": 8, "L;IR": 8,
    "P;1": 1, "P;1R": 1, "P;2": 2, "P;2R": 2, "P;4": 4, "P;4R": 4,
    "P": 8, "P;R": 8, "PX": 16, "PA": 16, "LA": 16,
    "I;12": 12, "I;16": 16, "I;16N": 16, "I;16B": 16, "I;16R": 16,
    "I;16S": 16, "I;16BS": 16, "I;32": 32, "I;32N": 32, "I;32S": 32,
    "I;32BS": 32, "F;32F": 32, "F;32BF": 32, "F": 32, "I": 32,
    "RGB": 24, "RGB;R": 24, "LAB": 24, "RGBX": 32, "RGBXX": 40,
    "RGBXXX": 48, "RGBA": 32, "RGBa": 32, "RGBAX": 40, "RGBAXX": 48,
    "RGBaX": 40, "RGBaXX": 48, "CMYK": 32, "CMYKX": 40, "CMYKXX": 48,
    "BGR;15": 16, "BGR;16": 16, "BGRA;15": 16, "BGRA;15Z": 16,
    "BGR": 24, "BGRX": 32, "XBGR": 32, "BGXR": 32, "BGRA": 32,
    "ABGR": 32, "BGAR": 32,
}
for _suffix in ("L", "B", "N"):
    RAW_BITS.update({f"RGB;16{_suffix}": 48, f"RGBA;16{_suffix}": 64,
                     f"RGBX;16{_suffix}": 64, f"RGBa;16{_suffix}": 64,
                     f"CMYK;16{_suffix}": 64})
# the (mode, rawmode) pairs the readers can meet that Unpack.c lacks
NO_UNPACKER = {("L", "L;IR"), ("P", "P;1R"), ("P", "P;2R"), ("P", "P;4R"),
               ("L", "P"), ("1", "P"), ("RGB", "P"), ("RGBA", "P")}
# the FillOrder 2 rawmodes -> their FillOrder 1 rawmode
REVERSED = {"1;R": "1", "1;IR": "1;I", "L;2R": "L;2", "L;2IR": "L;2I",
            "L;4R": "L;4", "L;4IR": "L;4I", "L;R": "L", "L;IR": "L;I",
            "P;1R": "P;1", "P;2R": "P;2", "P;4R": "P;4", "P;R": "P",
            "RGB;R": "RGB", "I;16R": "I;16"}
# the byte-order rawmodes: each output band's byte within the pixel
_PERMUTED = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1),
             "BGXR": (3, 1, 0), "BGRA": (2, 1, 0, 3),
             "ABGR": (3, 2, 1, 0), "BGAR": (3, 1, 0, 2)}
CHANNELS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1,
            "F": 1, "LA": 2, "PA": 2, "RGB": 3, "LAB": 3, "RGBA": 4,
            "CMYK": 4}
DTYPES = {"1": np.bool_, "I;16": np.dtype("<u2"), "I;16B": np.dtype(">u2"),
          "I": np.dtype("<i4"), "F": np.dtype("<f4")}


class NotThisFormat(Exception):
    """A plugin's _open declined the file: Image.open tries the next."""


# what ImageFile.__init__ and Image.open catch from a plugin's _open
DECLINES = (NotThisFormat, IndexError, TypeError, KeyError, EOFError,
            struct.error)


class File:
    """A plugin's fp over the file's bytes."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int = -1) -> bytes:
        start = min(self.pos, len(self.data))
        end = len(self.data) if n < 0 else min(start + n, len(self.data))
        self.pos = max(self.pos, end)
        return self.data[start:end]

    def seek(self, pos: int) -> None:
        self.pos = pos

    def tell(self) -> int:
        return self.pos


def refused(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what}, which PIL refuses as well "
                      "(rsn/data/blender.py raises on it too)")


def check_size(width: int, height: int, path: str) -> None:
    """Image._decompression_bomb_check's refusal."""
    if max(1, width) * max(1, height) > MAX_PIXELS:
        raise refused(path, f"an image of {width}x{height} pixels (a "
                      "decompression bomb to PIL)")


def blank(mode: str, width: int, height: int, path: str) -> np.ndarray:
    """Image.core.new(mode, size) as np.asarray gives it: zeros."""
    check_size(width, height, path)
    ch = CHANNELS[mode]
    return np.zeros((height, width) + ((ch,) if ch > 1 else ()),
                    DTYPES.get(mode, np.uint8))


def bits_of(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(h, bytes) rows of `depth`-bit samples, MSB first -> (h, width)."""
    h = rows.shape[0]
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    bits = bits.reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint16)
    return (bits * weights).sum(axis=-1, dtype=np.uint16)


def unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Unpack.c's unpackRGBa: c * 255 / a clipped, where 0 < a < 255;
    every band 0 where a is 0."""
    a = alpha.astype(np.int64)[..., None]
    c = rgb.astype(np.int64)
    div = np.minimum(c * 255 // np.maximum(a, 1), 255)
    out = np.where(a == 255, c, div)
    out = np.where(a == 0, 0, out)
    return np.concatenate([out, a], -1).astype(np.uint8)


def _bgr15_16(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """Unpack.c's BGR;15, BGR;16, BGRA;15 and BGRA;15Z: 5 (6 for BGR;16's
    green) bits a band, scaled by 255 / (2^bits - 1) and truncated; the
    top bit for alpha (255 when set, or when clear for 15Z)."""
    px = rows[:, :2 * width].reshape(-1, width, 2).astype(np.int32)
    v = px[..., 0] | px[..., 1] << 8
    if rawmode == "BGR;16":
        bands = [(v >> 11) & 31, (v >> 5) & 63, v & 31]
        tops = (31, 63, 31)
    else:
        bands = [(v >> 10) & 31, (v >> 5) & 31, v & 31]
        tops = (31, 31, 31)
    out = [b * 255 // t for b, t in zip(bands, tops)]
    if rawmode.startswith("BGRA"):
        top = (v >> 15) & 1
        out.append((1 - top if rawmode.endswith("Z") else top) * 255)
    return np.stack(out, -1).astype(np.uint8)


def unpack(mode: str, rawmode: str, rows: np.ndarray,
           width: int) -> np.ndarray:
    """PIL's unpacker (mode, rawmode) on (h, bytes) rows -> the (h, width)
    or (h, width, bands) array np.asarray gives of those pixels."""
    h = rows.shape[0]
    if rawmode in REVERSED:  # FillOrder 2: each byte's bits reversed
        rows = BITFLIP[rows]
        rawmode = REVERSED[rawmode]
    if rawmode in ("1", "1;I"):  # PIL's bytes are 0 and 255
        v = bits_of(rows, width, 1).astype(np.uint8) * 255
        return (255 - v if rawmode == "1;I" else v).view(np.bool_)
    if rawmode == "1;8":
        return ((rows[:, :width] != 0) * np.uint8(255)).view(np.bool_)
    if rawmode.startswith(("L;2", "L;4")):
        depth = int(rawmode[2])
        v = (bits_of(rows, width, depth) * (255 // ((1 << depth) - 1)))
        v = v.astype(np.uint8)
        return 255 - v if rawmode.endswith("I") else v
    if rawmode.startswith(("P;1", "P;2", "P;4")):
        return bits_of(rows, width, int(rawmode[2])).astype(np.uint8)
    if rawmode in ("L", "P", "L;I"):
        v = rows[:, :width]
        return 255 - v if rawmode == "L;I" else v.copy()
    if rawmode.startswith(("BGR;1", "BGRA;1")):
        return _bgr15_16(rows, width, rawmode)
    if rawmode in _PERMUTED:
        n = RAW_BITS[rawmode] // 8
        px = rows[:, :width * n].reshape(h, width, n)
        out = np.empty((h, width, len(_PERMUTED[rawmode])), np.uint8)
        for band, byte in enumerate(_PERMUTED[rawmode]):  # band by band:
            out[..., band] = px[..., byte]  # faster than a reversed view
        return out
    if rawmode == "I;12":
        return bits_of(rows, width, 12).astype("<u2")
    if rawmode.startswith(("I;", "F;")) or rawmode in ("F", "I"):
        src = {"F": "=f4", "I": "=i4", "I;16": "<u2", "I;16N": "=u2",
               "I;16B": ">u2", "I;16S": "<i2", "I;16BS": ">i2",
               "I;32": "<i4", "I;32N": "=u4", "I;32S": "<i4",
               "I;32BS": ">i4", "F;32F": "<f4", "F;32BF": ">f4"}[rawmode]
        dt = np.dtype(src)
        v = rows[:, :width * dt.itemsize].copy().view(dt)
        if mode == "I":
            return v.astype(np.int64).astype(np.uint32).view(np.int32).astype(
                "<i4") if dt.kind == "u" and dt.itemsize == 4 else v.astype(
                "<i4")
        return v.astype(DTYPES[mode])
    if ";16" in rawmode:  # 16-bit RGB(A) / CMYK: the high byte of each
        base, end = rawmode.split(";16")
        n = 4 if base != "RGB" else 3
        pairs = rows[:, :width * n * 2].reshape(h, width, n, 2)
        hi = pairs[..., 0 if end == "B" else 1]  # N: little-endian here
        if base == "RGBa":
            return unpremultiply(hi[..., :3], hi[..., 3])
        if base == "RGBX":
            return hi[..., :3].copy()
        return hi.copy()
    n = RAW_BITS[rawmode] // 8
    px = rows[:, :width * n].reshape(h, width, n)
    if rawmode.startswith("RGBa"):
        return unpremultiply(px[..., :3], px[..., 3])
    keep = CHANNELS[mode]
    return px[..., 0].copy() if keep == 1 else px[..., :keep].copy()


def _map_pixel_bytes(mode: str) -> int:
    """map.c's bytes per pixel of a mapped image (its default stride)."""
    if mode in ("L", "P"):
        return 1
    return 2 if mode.startswith("I;16") else 4


def raw_image(data: bytes, offset: int, mode: str, rawmode: str,
              width: int, height: int, stride: int, ystep: int,
              path: str) -> np.ndarray:
    """ImageFile.load of the tile ("raw", (0, 0, width, height), offset,
    (rawmode, stride, ystep)) of a file opened from a path -> the array.

    PIL maps the file when rawmode is the image's mode and in _MAPMODES:
    row y then starts `stride` bytes (a pixel's bytes times the width when
    stride is 0) after row y - 1, reads a row's bytes from there whatever
    the stride, and reads zeros past the file's end (the rest of its last
    page).  Otherwise RawDecode.c reads rows of the rawmode's bytes,
    `stride` apart, and refuses a stride shorter than a row."""
    if rawmode == mode and mode in MAPMODES:
        pixel = _map_pixel_bytes(mode)
        pitch = stride if stride > 0 else width * pixel
        if stride <= 0 and offset + height * pitch > len(data):
            raise refused(path, "a raw image past the file's end (buffer is "
                          "not large enough)")
        if offset + height * max(stride, 0) <= len(data):
            return unpack(mode, rawmode, _rows(
                data, offset, height, width * pixel, pitch, ystep, True),
                width)
        # the map is too short: PIL falls back to its raw decoder
    if (mode, rawmode) in NO_UNPACKER:
        raise refused(path, f"rawmode {rawmode!r} for mode {mode!r} (unknown "
                      "raw mode)")
    row = (width * RAW_BITS[rawmode] + 7) // 8
    if stride and stride < row:
        raise refused(path, "a row stride shorter than a row (codec "
                      "configuration error)")
    pitch = stride or row
    if offset < 0 or len(data) - offset < pitch * (height - 1) + row:
        raise refused(path, "a truncated file (image file is truncated)")
    return unpack(mode, rawmode, _rows(data, offset, height, row, pitch,
                                       ystep, False), width)


def _rows(data: bytes, offset: int, height: int, row: int, pitch: int,
          ystep: int, zero_past_end: bool) -> np.ndarray:
    """(height, row) bytes, row y at offset + y * pitch (rows may
    overlap), bottom-up when ystep < 0; zeros past the data's end."""
    need = pitch * (height - 1) + row
    buf = np.frombuffer(data, np.uint8, count=min(need, len(data) - offset),
                        offset=offset)
    if zero_past_end and buf.size < need:
        buf = np.concatenate([buf, np.zeros(need - buf.size, np.uint8)])
    rows = np.lib.stride_tricks.as_strided(buf, (height, row), (pitch, 1),
                                           writeable=False)
    return rows[::-1] if ystep < 0 else rows
