"""BMP and DIB frames as PIL 12.1.0 reads them (the port of the
`Image.open` calls in rsn/data/blender.py for BmpImagePlugin).

`BmpImage(data, path).load()` gives what `np.asarray(Image.open(path))`
gives, for a BMP ("BM" file header) or a headerless DIB (its header size
first), quirks included (PARITY.md: quirks are replicated, not fixed):

- headers of 12 (OS/2 1.x / BITMAPCOREHEADER), 40, 52, 56, 64 (OS/2 2.x),
  108 and 124 bytes; another size is refused;
- 1, 4 and 8 bits through a palette, 16 (BGR;15), 24 and 32 bits (the
  fourth byte dropped: a 32-bit BI_RGB file reads as RGB); 2 bits and any
  other depth refused;
- a height whose top byte is 0xff (negative) for top-down rows;
- BI_BITFIELDS only for PIL's table of masks (BGR;15 and BGR;16 at 16
  bits, BGR at 24, BGRX / XBGR / BGXR / BGRA / ABGR / RGBA / BGAR at 32,
  and the all-zero masks read as BGRA); the masks of a 40-byte header read
  after it, of 52 and 56-byte headers (and of 64, 108 and 124-byte ones)
  from it;
- RLE8 and RLE4 through BmpRleDecoder (rsn_torch/data/native/raster.cpp):
  its escapes, deltas and unset pixels (0), whatever the depth says;
- a palette of 2 entries black and white gives mode "1", a palette that
  is the gray ramp 0, 1, 2, ... gives "L" (and its indices are read as
  gray levels whatever the depth: 4-bit data of width past 8 pixels a
  row then reads overlapping rows, as PIL's map of the file reads them),
  any other palette "P", whose np.asarray is the indices; a palette of
  more than 256 entries is refused when PIL realises it;
- pixel data announced right after the header of a file of 8 bits or
  less is looked for 4 bytes a colour further on, as PIL looks.

Other compressions (JPEG, PNG, BI_ALPHABITFIELDS), a truncated file and
a bad header raise ValueError naming the file.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from rsn_torch.data import native
from rsn_torch.data.imagefile import (File, NotThisFormat, check_size,
                                      raw_image, refused)

# BmpImagePlugin.BIT2MODE
BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
            16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)  # _dib_accept's
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
# BmpImagePlugin's MASK_MODES (its SUPPORTED lists the same masks)
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def accept(prefix: bytes) -> bool:
    """BmpImagePlugin._accept."""
    return prefix.startswith(b"BM")


def dib_accept(prefix: bytes) -> bool:
    """BmpImagePlugin._dib_accept (i32 of a shorter prefix: struct.error,
    which Image.open lets through only from _open)."""
    return struct.unpack_from("<I", prefix)[0] in HEADER_SIZES


def _i16(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<H", b, at)[0]


def _i32(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<I", b, at)[0]


class BmpImage:
    """BmpImageFile / DibImageFile after _open: mode, size and its tile."""

    def __init__(self, data: bytes, path: str, dib: bool = False,
                 header: int = 0):
        """header: the DIB header's position (CurImagePlugin's bitmap);
        else a DIB from the start, or a BMP after its file header."""
        self.data, self.path = data, path
        f = File(data)
        f.seek(header)
        offset = 0
        if not dib and not header:
            head = f.read(14)
            if not accept(head):
                raise NotThisFormat("not a BMP file")
            offset = _i32(head, 10)
        self._bitmap(f, offset)
        if self.width <= 0 or self.height <= 0:
            raise NotThisFormat("a size of zero")
        check_size(self.width, self.height, path)

    def _bitmap(self, f: File, offset: int) -> None:
        path = self.path
        header_size = _i32(f.read(4))
        want = header_size - 4
        header = f.read(want) if want > 0 else b""
        if len(header) < want:
            raise refused(path, "a truncated BMP header (Truncated File "
                          "Read)")
        direction, colors = -1, 0
        masks = None
        if header_size == 12:
            width, height = _i16(header, 0), _i16(header, 2)
            bits, compression, padding = _i16(header, 6), RAW, 3
        elif header_size in HEADER_SIZES:
            flip = header[7] == 0xFF
            direction = 1 if flip else -1
            width = _i32(header, 0)
            height = 2 ** 32 - _i32(header, 4) if flip else _i32(header, 4)
            bits, compression = _i16(header, 10), _i32(header, 12)
            colors, padding = _i32(header, 28), 4
            if compression == BITFIELDS:
                if len(header) >= 48:
                    n = 4 if len(header) >= 52 else 3
                    masks = [_i32(header, 36 + 4 * k) for k in range(n)]
                else:
                    masks = [_i32(f.read(4)) for _ in range(3)]
                masks += [0] * (4 - len(masks))
        else:
            raise refused(path, f"a BMP header of {header_size} bytes")
        self.width, self.height = width, height
        colors = colors or (1 << bits)
        if offset == 14 + header_size and bits <= 8:
            offset += 4 * colors
        if bits not in BIT2MODE:
            raise refused(path, f"a BMP of {bits} bits a pixel")
        mode, rawmode = BIT2MODE[bits]
        self.rle = None
        if compression == BITFIELDS:
            key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
            if key not in MASK_MODES:
                raise refused(path, f"BMP bitfields {masks} at {bits} bits")
            rawmode = MASK_MODES[key]
            if bits == 32 and "A" in rawmode:
                mode = "RGBA"
        elif compression in (RLE8, RLE4):
            self.rle = compression == RLE4
        elif compression != RAW:
            raise refused(path, f"BMP compression {compression}")
        self.palette_bytes = None
        if mode == "P":
            if not 0 < colors <= 65536:
                raise refused(path, f"a BMP palette of {colors} colours")
            palette = f.read(padding * colors)
            wanted = (0, 255) if colors == 2 else range(colors)
            gray = all(palette[k * padding:k * padding + 3]
                       == bytes((v & 255,)) * 3 for k, v in enumerate(wanted))
            if gray:
                mode = rawmode = "1" if colors == 2 else "L"
            else:
                self.palette_bytes = len(palette), 8 * padding
        self.mode, self.rawmode = mode, rawmode
        self.bits, self.direction = bits, direction
        self.offset = offset or f.tell()

    def load(self) -> Tuple[str, np.ndarray]:
        """ImageFile.load -> (mode, np.asarray's array)."""
        path, w, h = self.path, self.width, self.height
        if self.palette_bytes is not None:
            size, bits = self.palette_bytes  # putpalette("RGB", BGR(X))
            if size * 8 // bits > 256:
                raise refused(path, "a BMP palette of more than 256 colours "
                              "(invalid palette size)")
        if self.rle is None:
            stride = ((w * self.bits + 31) >> 3) & ~3
            arr = raw_image(self.data, self.offset, self.mode, self.rawmode,
                            w, h, stride, self.direction, path)
            return self.mode, arr
        px, length = native.decode_bmp_rle(self.data, self.offset, w, h,
                                           self.rle, path)
        if self.mode not in ("L", "P"):  # set_as_raw's rawmode is L or P
            raise refused(path, f"an RLE BMP of mode {self.mode} (unknown "
                          "raw mode)")
        if length < w * h:
            raise refused(path, "an RLE BMP short of its pixels (not enough "
                          "image data)")
        rows = px.reshape(h, w)
        return self.mode, np.ascontiguousarray(
            rows[::-1] if self.direction < 0 else rows)

