"""Which of PIL 12.1.0's plugins opens a file: Image.open's order, each
plugin's _accept on the file's first 16 bytes, and, for the plugins that
have none (IM, IMT, IPTC, PCD, SPIDER, TGA), whether their _open would
take the file.

rsn opens every frame with `PIL.Image.open`.  A fresh PIL tries the
plugins `Image.preinit` registers (BMP, DIB, GIF, JPEG, PPM, PNG), then
the rest in `Image.init`'s order; it opens the file with the first whose
_accept takes the prefix (a plugin without one is always tried) and
whose _open does not decline it (SyntaxError, or IndexError, TypeError,
KeyError, EOFError or struct.error, which ImageFile turns into it); any
other error from _open refuses the file.  `identify` walks the same
order: the ported plugins are opened as PIL opens them; an unported one
that accepts the prefix, or an accept-less one whose _open may take the
file, stops the walk (the port cannot tell whether PIL would go on).
"""
from __future__ import annotations

import re
import struct
from typing import Callable, Dict, Optional

from rsn_torch.data import avif, bmp, gif, jpeg2000, png, ppm, tga, tiff, webp
from rsn_torch.data.imagefile import DECLINES, File

FIRST_PASS = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG")
SECOND_PASS = (
    "AVIF", "BLP", "BUFR", "CUR", "PCX", "DCX", "DDS", "EPS", "FITS", "FLI",
    "FTEX", "GBR", "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO", "IM", "IMT",
    "IPTC", "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD", "QOI",
    "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")
ORDER = FIRST_PASS + SECOND_PASS
JPEG_PREFIX = b"\xff\xd8\xff"  # JpegImagePlugin._accept


def _le32(p: bytes) -> int:
    return struct.unpack_from("<I", p)[0]


def _be32(p: bytes, at: int = 0) -> int:
    return struct.unpack_from(">I", p, at)[0]


# each plugin's _accept (an exception from one declines, as in Image.open)
ACCEPT: Dict[str, Callable[[bytes], bool]] = {
    "BMP": bmp.accept,
    "DIB": bmp.dib_accept,
    "GIF": gif.accept,
    "JPEG": lambda p: p.startswith(JPEG_PREFIX),
    "PPM": ppm.accept,
    "PNG": lambda p: p.startswith(png.SIGNATURE),
    "AVIF": lambda p: p[4:8] == b"ftyp" and p[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1"),
    "BLP": lambda p: p.startswith((b"BLP1", b"BLP2")),
    "BUFR": lambda p: p.startswith((b"BUFR", b"ZCZC")),
    "CUR": lambda p: p.startswith(b"\0\0\2\0"),
    "PCX": lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
    "DCX": lambda p: len(p) >= 4 and _le32(p) == 0x3ADE68B1,
    "DDS": lambda p: p.startswith(b"DDS "),
    "EPS": lambda p: p.startswith(b"%!PS") or (
        len(p) >= 4 and _le32(p) == 0xC6D3D0C5),
    "FITS": lambda p: p.startswith(b"SIMPLE"),
    "FLI": lambda p: (len(p) >= 16 and struct.unpack_from("<H", p, 4)[0] in (
        0xAF11, 0xAF12) and struct.unpack_from("<H", p, 14)[0] in (0, 3)),
    "FTEX": lambda p: p.startswith(b"FTEX"),
    "GBR": lambda p: len(p) >= 8 and _be32(p) >= 20 and _be32(p, 4) in (1, 2),
    "GRIB": lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
    "HDF5": lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"),
    "JPEG2000": jpeg2000.accept,
    "ICNS": lambda p: p.startswith(b"icns"),
    "ICO": lambda p: p.startswith(b"\0\0\1\0"),
    "MCIDAS": lambda p: p.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
    "MPEG": lambda p: p.startswith(b"\x00\x00\x01\xb3"),
    "TIFF": tiff.is_tiff,
    "MSP": lambda p: p.startswith((b"DanM", b"LinS")),
    "PIXAR": lambda p: p.startswith(b"\200\350\000\000"),
    "PSD": lambda p: p.startswith(b"8BPS"),
    "QOI": lambda p: p.startswith(b"qoif"),
    "SGI": lambda p: len(p) >= 2 and struct.unpack_from(">H", p)[0] == 474,
    "SUN": lambda p: len(p) >= 4 and _be32(p) == 0x59A66A95,
    "WEBP": webp.is_webp,
    "WMF": lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                   b"\x01\x00\x00\x00")),
    "XBM": lambda p: p.lstrip().startswith(b"#define"),
    "XPM": lambda p: p.startswith(b"/* XPM */"),
    "XVTHUMB": lambda p: p.startswith(b"P7 332"),
}


def _entries(data: bytes):
    """CurImageFile / IcoFile's directory: its 16-byte entries (an
    IndexError on a short one, a decline)."""
    f = File(data)
    head = f.read(6)
    entries = [f.read(16) for _ in range(struct.unpack_from("<H", head, 4)[0])]
    for s in entries:
        s[1]
    return entries


def _cur_declines(data: bytes) -> bool:
    """CurImageFile._open: no entries, or the largest entry's bitmap is
    not a DIB header BmpImagePlugin reads (a height of 0 or 1 after
    halving among them)."""
    try:
        m = b""
        for s in _entries(data):
            if not m or (s[0] > m[0] and s[1] > m[1]):
                m = s
        if not m:
            return True
        img = bmp.BmpImage(data, "", dib=True,
                           header=struct.unpack_from("<I", m, 12)[0])
        return img.height // 2 <= 0
    except DECLINES:
        return True
    except ValueError:  # the bitmap refused: not a decline
        return False


def _ico_declines(data: bytes) -> bool:
    """IcoFile: no entries (IndexError on entry 0), or a short one."""
    try:
        return not _entries(data)
    except DECLINES:
        return True


# the unported plugins whose _open surely declines some files their
# _accept takes (a true-colour TGA without an ID field begins as a CUR)
DECLINED = {"CUR": _cur_declines, "ICO": _ico_declines}

_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {b"Comment", b"Date", b"Digitalization equipment",
            b"File size (no of images)", b"Lut", b"Name", b"Scale (x,y)",
            b"Image size (x*y)", b"Image type"}
_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _readline(f: File) -> bytes:
    rest = f.data[f.pos:]
    end = rest.find(b"\n")
    line = rest if end < 0 else rest[:end + 1]
    f.pos += len(line)
    return line


def _im_may_open(data: bytes) -> bool:
    """ImImageFile._open as far as it can decline: its header lines up to
    a NUL, ^Z or the end, each "Key: value" of at most 100 bytes, one of
    its tags among them, then a ^Z."""
    f = File(data)
    if b"\n" not in f.read(100):
        return False
    f.seek(0)
    n = 0
    while True:
        s = f.read(1)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        s = s + _readline(f)
        if len(s) > 100:
            return False
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(
            b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            return False
        n += m.group(1) in _IM_TAGS
    if not n:
        return False
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    return bool(s)


def _imt_may_open(data: bytes) -> bool:
    """ImtImageFile._open: "width", "height" and "pixel n8" fields before
    its header ends (a field it cannot read as an integer refuses the
    file, which is not a decline either)."""
    f = File(data)
    buffer = f.read(100)
    if b"\n" not in buffer:
        return False
    size, mode = [0, 0], ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += f.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k in (b"width", b"height"):
            try:
                size[k == b"height"] = int(v)
            except ValueError:
                return True
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return bool(mode) and size[0] > 0 and size[1] > 0


def _iptc_may_open(data: bytes) -> bool:
    """IptcImageFile._open's first field: a 0x1C tag of record 1-9 or
    240 (an all-zero one ends the fields before the image's, a decline)."""
    s = data[:5]
    if not s.strip(b"\x00"):
        return False
    return len(s) >= 3 and s[0] == 0x1C and s[1] in (1, 2, 3, 4, 5, 6, 7, 8,
                                                      9, 240)


def _pcd_may_open(data: bytes) -> bool:
    return data[2048:2052] == b"PCD_" and len(data) >= 2048 + 1539


def _spider_header(t) -> int:
    """SpiderImagePlugin.isSpiderHeader."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider_may_open(data: bytes) -> bool:
    """SpiderImageFile._open: a valid header, big-endian tried first, of
    a 2D image (iform 1)."""
    if len(data) < 108:
        return False
    for order in (">", "<"):
        t = struct.unpack(order + "27f", data[:108])
        if _spider_header(t):
            return int(t[4]) == 1
    return False


MAY_OPEN = {"IM": _im_may_open, "IMT": _imt_may_open,
            "IPTC": _iptc_may_open, "PCD": _pcd_may_open,
            "SPIDER": _spider_may_open}
# the ported plugins PIL opens in two steps: _open (which may decline)
OPENERS = {"BMP": lambda d, p: bmp.BmpImage(d, p),
           "DIB": lambda d, p: bmp.BmpImage(d, p, dib=True),
           "GIF": gif.GifImage, "PPM": ppm.PpmImage, "TGA": tga.TgaImage,
           "JPEG2000": jpeg2000.Jpeg2000Image, "AVIF": avif.AvifImage}
# the ported plugins read whole once their _accept takes the prefix
READERS = ("JPEG", "PNG", "TIFF", "WEBP")


class Identified:
    """The walk's end: `format` (PIL's format name, or None when nothing
    takes the file), `image` (an opened BMP / DIB / GIF / PPM / TGA /
    JPEG 2000 / AVIF) and
    `ported` (False: an unported plugin may take it first)."""

    def __init__(self, fmt: Optional[str], image=None, ported: bool = True):
        self.format, self.image, self.ported = fmt, image, ported


def identify(data: bytes, path: str) -> Identified:
    """The plugin Image.open(path) picks for a file of these bytes."""
    prefix = data[:16]
    for name in ORDER:
        if name in ACCEPT:
            try:
                if not ACCEPT[name](prefix):
                    continue
            except DECLINES:
                continue
        elif name in MAY_OPEN:
            if MAY_OPEN[name](data):
                return Identified(name, ported=False)
            continue
        if name in OPENERS:
            try:
                return Identified(name, OPENERS[name](data, path))
            except DECLINES:
                continue
        if name in READERS:
            return Identified(name)
        if name in DECLINED and DECLINED[name](data):
            continue
        return Identified(name, ported=False)
    return Identified(None, ported=False)
