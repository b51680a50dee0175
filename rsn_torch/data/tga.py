"""TGA frames as PIL 12.1.0 reads them (the port of the `Image.open`
calls in rsn/data/blender.py for TgaImagePlugin).

`TgaImage(data, path).load()` gives what `np.asarray(Image.open(path))`
gives, quirks included (PARITY.md):

- image types 1 (colour-mapped), 2 (true colour) and 3 (gray) and their
  RLE forms 9, 10 and 11, at depths 1, 8, 16, 24 and 32 (15 is not a TGA
  to PIL); type 1 at 8 bits gives "P" (np.asarray: the indices; without
  a colour map PIL refuses it), type 3 "1", "L" or "LA" (16 bits), type
  2 "RGB" at 24 bits and "RGBA" at 16 (BGRA;15Z: alpha set where the top
  bit is clear, whatever the attribute bits say) and 32;
- a colour map of 16 or 24-bit entries read after the ID field (its
  first index and entries only size the palette: more than 256 entries
  refused when PIL realises it); 32-bit entries, or a map beside a type
  2 image or a 1-bit one, refused;
- the origin bits: rows bottom-up unless bit 5 is set, mirrored when bit
  4 is set;
- RLE packets through TgaRleDecode.c (rsn_torch/data/native/raster.cpp):
  a literal packet continues on the next rows, a run past a row's end is
  refused (buffer overrun), a 1-bit RLE image reads to the file's end
  and is refused as truncated;
- the ID field skipped; a TGA 2.0 footer, or anything else past the
  pixels, ignored.

TGA has no magic number: PIL tries it only on a file no plugin before it
in Image.open's order takes (rsn_torch.data.formats tells when), and a
header it cannot read is not a TGA to it.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from rsn_torch.data import native
from rsn_torch.data.imagefile import (RAW_BITS, File, NotThisFormat,
                                      check_size, raw_image, refused, unpack)

# TgaImagePlugin.MODES: (image type & 7, depth) -> rawmode
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
         (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
# a colour map's entry depth -> (bytes an entry, the putpalette rawmode's
# bits); 32-bit entries go to putpalette("RGB", "BGRA"), which PIL refuses
MAP_DEPTHS = {16: (2, 16), 24: (3, 24), 32: (4, None)}


class TgaImage:
    """TgaImageFile after _open: mode, size, palette and its tile."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        f = File(data)
        s = f.read(18)
        id_len, colormaptype, imagetype = s[0], s[1], s[2]
        depth, flags = s[16], s[17]
        width, height = struct.unpack_from("<HH", s, 12)
        if (colormaptype not in (0, 1) or width <= 0 or height <= 0
                or depth not in (1, 8, 16, 24, 32)):
            raise NotThisFormat("not a TGA file")
        if imagetype in (3, 11):
            mode = {1: "1", 16: "LA"}.get(depth, "L")
        elif imagetype in (1, 9):
            mode = "P" if colormaptype else "L"
        elif imagetype in (2, 10):
            mode = "RGB" if depth == 24 else "RGBA"
        else:
            raise NotThisFormat("unknown TGA mode")
        orientation = flags & 0x30
        self.mirror = orientation in (0x10, 0x30)
        self.ystep = 1 if orientation in (0x20, 0x30) else -1
        f.read(id_len)
        self.palette = None
        if colormaptype:
            start, size, mapdepth = (struct.unpack_from("<H", s, 3)[0],
                                     struct.unpack_from("<H", s, 5)[0], s[7])
            if mapdepth not in MAP_DEPTHS:
                raise NotThisFormat("unknown TGA map depth")
            entry, bits = MAP_DEPTHS[mapdepth]
            self.palette = (entry * start + len(f.read(entry * size)), bits)
        self.mode, self.width, self.height = mode, width, height
        self.rle = bool(imagetype & 8)
        self.rawmode = MODES.get((imagetype & 7, depth))
        self.depth = depth
        self.offset = f.tell()
        check_size(width, height, path)

    def load(self) -> Tuple[str, np.ndarray]:
        """ImageFile.load, load_end's mirror and the palette's realisation
        -> (mode, np.asarray's array)."""
        path, mode, w, h = self.path, self.mode, self.width, self.height
        if self.rawmode is None:
            raise refused(path, f"a {mode} TGA of {self.depth} bits (cannot "
                          "load this image)")
        if self.rle:
            if (mode, self.rawmode) == ("L", "P"):
                raise refused(path, "a colour-mapped TGA without its map "
                              "(unknown raw mode)")
            row = (w * RAW_BITS[self.rawmode] + 7) // 8
            rows = native.decode_tga_rle(self.data, self.offset,
                                         self.depth // 8, row, h, path)
            arr = unpack(mode, self.rawmode, rows[::-1] if self.ystep < 0
                         else rows, w)
        else:
            arr = raw_image(self.data, self.offset, mode, self.rawmode, w, h,
                            0, self.ystep, path)
        if self.mirror:
            arr = arr[:, ::-1]
        if self.palette is not None:
            size, bits = self.palette
            if mode not in ("L", "LA", "P"):
                raise refused(path, f"a colour map beside a {mode} TGA "
                              "(unrecognized image mode)")
            if bits is None:
                raise refused(path, "a TGA colour map of 32-bit entries "
                              "(unrecognized raw mode)")
            if size * 8 // bits > 256:
                raise refused(path, "a TGA colour map past 256 entries "
                              "(invalid palette size)")
        return mode, np.ascontiguousarray(arr)

