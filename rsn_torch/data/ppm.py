"""PBM, PGM, PPM and PFM frames as PIL 12.1.0 reads them (the port of the
`Image.open` calls in rsn/data/blender.py for PpmImagePlugin).

`PpmImage(data, path).load()` gives what `np.asarray(Image.open(path))`
gives, quirks included (PARITY.md):

- the magic number (read up to whitespace or 6 bytes): P1 / P4 (mode
  "1", bool), P2 / P5 ("L", or "I" as int32 when maxval passes 255), P3 /
  P6 ("RGB"), Pf ("F", float32, rows bottom-up, little-endian when the
  scale is negative), and PIL's P0CMYK, PyP, PyRGBA and PyCMYK;
- the header's tokens as PpmImageFile._read_token reads them: comments
  from "#" to the line's end anywhere, even inside a token, which goes on
  after it; a token of more than 10 bytes refused; each read with
  Python's int() (or float() for the scale);
- raw samples: maxval 255 as they are, a PGM's maxval 65535 as
  big-endian 16-bit values, any other maxval rescaled by PpmDecoder,
  round(v / maxval * 255) (65535 for "I"), capped;
- plain (ASCII) samples through PpmPlainDecoder
  (rsn_torch/data/native/raster.cpp): P1's "0" and "1" bytes with or
  without whitespace, P2 / P3's decimal tokens rescaled the same way,
  comments dropped as it drops them, values past maxval refused.

A file PIL refuses (a bad token, maxval 0 or past 65535, a zero or
non-finite scale, too few samples) raises ValueError naming the file.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from rsn_torch.data import native
from rsn_torch.data.imagefile import (CHANNELS, File, NotThisFormat,
                                      check_size, raw_image, refused)

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"  # PpmImagePlugin.b_whitespace
# PpmImagePlugin.MODES
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}


def accept(prefix: bytes) -> bool:
    """PpmImagePlugin._accept."""
    return (len(prefix) >= 2 and prefix.startswith(b"P")
            and prefix[1] in b"0123456fy")


def _magic(f: File) -> bytes:
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in WHITESPACE:
            break
        magic += c
    return magic


def _token(f: File, path: str) -> bytes:
    """PpmImageFile._read_token."""
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise refused(path, "a PPM header cut short (Reached EOF while "
                      "reading header)")
    if len(token) > 10:
        raise refused(path, f"a PPM header token {token!r} of more than 10 "
                      "bytes")
    return token


def _number(kind, token: bytes, path: str):
    try:
        return kind(token)
    except ValueError:
        raise refused(path, f"a PPM header token {token!r} that is not a "
                      "number") from None


class PpmImage:
    """PpmImageFile after _open: mode, size and its tile."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        f = File(data)
        magic = _magic(f)
        if magic not in MODES:
            raise NotThisFormat("not a PPM file")
        mode = self.mode = MODES[magic]
        self.width = _number(int, _token(f, path), path)
        self.height = _number(int, _token(f, path), path)
        self.plain = magic in (b"P1", b"P2", b"P3")
        self.maxval = 255
        if mode == "1":
            self.rawmode, self.ystep = "1;I", 1
        elif mode == "F":
            scale = _number(float, _token(f, path), path)
            if scale == 0.0 or not math.isfinite(scale):
                raise refused(path, "a PFM scale that is zero or not finite")
            self.rawmode = "F;32F" if scale < 0 else "F;32BF"
            self.ystep = -1
        else:
            maxval = _number(int, _token(f, path), path)
            if not 0 < maxval < 65536:
                raise refused(path, f"a PPM maxval of {maxval}")
            if maxval > 255 and mode == "L":
                self.mode = "I"
            self.maxval, self.ystep = maxval, 1
            self.rawmode = mode
            if not self.plain and maxval == 65535 and mode == "L":
                self.rawmode = "I;16B"
        self.offset = f.tell()
        if self.width <= 0 or self.height <= 0:
            raise NotThisFormat("a size of zero")
        check_size(self.width, self.height, path)

    def load(self) -> Tuple[str, np.ndarray]:
        """ImageFile.load -> (mode, np.asarray's array)."""
        mode, w, h, path = self.mode, self.width, self.height, self.path
        bands = CHANNELS[mode]
        shape = (h, w) + ((bands,) if bands > 1 else ())
        if self.plain:
            out_i32 = mode == "I"
            total = w * h * (1 if mode == "1" else bands * (4 if out_i32
                                                             else 1))
            raw = native.decode_ppm_plain(self.data, self.offset, mode == "1",
                                          self.maxval, out_i32, total, path)
            if raw.size < total:
                raise refused(path, "a plain PPM short of its samples (not "
                              "enough image data)")
            if mode == "1":  # 1;8 of 0xff / 0: np.asarray's bytes
                return mode, raw.view(np.bool_).reshape(shape)
            return mode, raw.view("<i4" if out_i32 else np.uint8).reshape(
                shape)
        if self.maxval == 255 or self.rawmode == "I;16B" or mode in (
                "1", "F"):
            return mode, raw_image(self.data, self.offset, mode, self.rawmode,
                                   w, h, 0, self.ystep, path)
        return mode, self._rescaled(shape, bands)

    def _rescaled(self, shape, bands: int) -> np.ndarray:
        """PpmDecoder: samples of 1 byte (maxval < 256) or 2 (big-endian),
        each min(out_max, round(v / maxval * out_max))."""
        size = 1 if self.maxval < 256 else 2
        n = shape[0] * shape[1]
        group = size * bands
        got = min(n, max(0, len(self.data) - self.offset) // group)
        if got < n:
            raise refused(self.path, "a PPM short of its samples (not enough "
                          "image data)")
        v = np.frombuffer(self.data, np.uint8 if size == 1 else ">u2",
                          count=n * bands, offset=self.offset)
        out_max = 65535 if self.mode == "I" else 255
        scaled = np.minimum(out_max, np.rint(v / self.maxval * out_max))
        return scaled.astype("<i4" if self.mode == "I" else np.uint8).reshape(
            shape)

