"""GIF frames as PIL 12.1.0 reads them (the port of the `Image.open`
calls in rsn/data/blender.py for GifImagePlugin).

`GifImage(data, path).load()` gives what `np.asarray(Image.open(path))`
gives: frame 0, which PIL's default LOADING_STRATEGY (RGB_AFTER_FIRST)
keeps as palette indices, so rsn reads a GIF frame as its indices / 255,
a quirk the port keeps (PARITY.md):

- mode "P", or "L" when the frame's colour table (its local table, else
  the global one) is absent or is the gray ramp (0, 0, 0), (1, 1, 1), ...
  that PIL drops;
- the image the logical screen's size, grown to hold a frame that passes
  its edge; outside the frame, the Graphic Control Extension's
  transparent index when it sets one, else 0 (not the background);
- the frame's LZW data through GifDecode.c
  (rsn_torch/data/native/raster.cpp): any minimum code size up to 12,
  interlaced rows, the table full at 4096 codes;
- extensions and stray bytes between blocks skipped as PIL skips them.

A file PIL refuses (a code past the table, a truncated frame, a minimum
code size past 12) raises ValueError naming the file.  A header PIL
cannot parse (no image descriptor, a truncated block) is not a GIF to
PIL's Image.open, which then tries its other plugins.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from rsn_torch.data import native
from rsn_torch.data.imagefile import File, NotThisFormat, check_size


def accept(prefix: bytes) -> bool:
    """GifImagePlugin._accept."""
    return prefix.startswith((b"GIF87a", b"GIF89a"))


def _palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed: not the gray ramp (IndexError on
    a short last entry when all before it are the ramp)."""
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


def _sub_block(f: File) -> Optional[bytes]:
    """GifImageFile.data."""
    s = f.read(1)
    if s and s[0]:
        return f.read(s[0])
    return None


class GifImage:
    """GifImageFile after _open (its _seek(0)): size, mode and frame 0's
    tile."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        f = File(data)
        s = f.read(13)
        if not accept(s):
            raise NotThisFormat("not a GIF file")
        width, height = struct.unpack_from("<HH", s, 6)
        flags = s[10]
        global_palette = False
        if flags & 128:
            s[11]  # info["background"]: an IndexError on a short header
            global_palette = _palette_needed(f.read(3 << ((flags & 7) + 1)))
        s = f.read(1)
        if not s or s == b";":
            raise NotThisFormat("no more images in GIF file")
        transparency = None
        box = None
        while True:
            if not s:
                s = f.read(1)
            if not s or s == b";":
                break
            if s == b"!":
                s = f.read(1)
                block = _sub_block(f)
                if s[0] == 249 and block is not None:
                    if block[0] & 1:
                        transparency = block[3]
                    struct.unpack_from("<H", block, 1)  # the duration
                elif s[0] == 254:
                    while block:
                        block = _sub_block(f)
                    s = b""
                    continue
                elif s[0] == 255 and block is not None:
                    if block.startswith(b"NETSCAPE2.0"):
                        _sub_block(f)
                while _sub_block(f):
                    pass
            elif s == b",":
                s = f.read(9)
                x0, y0, w, h = struct.unpack_from("<HHHH", s)
                x1, y1 = x0 + w, y0 + h
                if x1 > width or y1 > height:
                    width, height = max(x1, width), max(y1, height)
                    check_size(width, height, path)
                box = (x0, y0, x1, y1)
                flags = s[8]
                self.interlace = (flags & 64) != 0
                palette = None
                if flags & 128:
                    palette = _palette_needed(f.read(3 << ((flags & 7) + 1)))
                self.bits = f.read(1)[0]
                self.offset = f.tell()
                break
            s = b""
        if box is None:
            raise NotThisFormat("image not found in GIF frame")
        self.box, self.transparency = box, transparency
        self.width, self.height = width, height
        self.mode = "P" if (palette if palette is not None
                            else global_palette) else "L"
        if width <= 0 or height <= 0:
            raise NotThisFormat("a size of zero")
        check_size(width, height, path)

    def load(self) -> Tuple[str, np.ndarray]:
        """GifImageFile.load of frame 0 -> (mode, np.asarray's array)."""
        x0, y0, x1, y1 = self.box
        if x1 <= x0 or y1 <= y0:
            raise ValueError(f"{self.path}: a GIF frame of no pixels (tile "
                             "cannot extend outside image); PIL raises on it "
                             "too")
        fill = self.transparency if self.transparency is not None else 0
        image = np.full((self.height, self.width), fill, np.uint8)
        native.decode_gif_lzw(self.data, self.offset, self.bits,
                              self.interlace, image, self.box, self.path)
        return self.mode, image

