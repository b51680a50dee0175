"""JPEG 2000 frames as PIL 12.1.0 reads them with OpenJPEG 2.5.4 (the
port of the `Image.open` calls in rsn/data/blender.py for
Jpeg2KImagePlugin, PIL/Jpeg2KImagePlugin.py, and its decoder,
libImaging/Jpeg2KDecode.c).

`Jpeg2000Image(data, path).load()` gives what
`np.asarray(Image.open(path))` gives:

- `_open` as the plugin runs it: a raw codestream (FF4F FF51) takes its
  size and mode from SIZ ("L", "I;16" past 8 bits, "LA", "RGB", "RGBA";
  more than 4 components is not a JPEG 2000 to PIL), a JP2 file from its
  `jp2h` box (`BoxReader`): `ihdr`, then `colr` enumcs 12 makes 4
  components "CMYK", a `pclr` of columns 8 bits or less makes "L" / "LA"
  "P" / "PA" (more than 256 colours refused, as ImagePalette refuses
  them), `res ` / `resc` only gives the dpi; a header without `ihdr` is
  not a JPEG 2000 to PIL;
- OpenJPEG's reading of the JP2 boxes (signature, `ftyp`, `jp2h` and
  its `ihdr` / `colr` / `pclr` / `cmap` / `cdef` / `bpcc`, the
  codestream box; a malformed one refused, an unknown one passed over)
  and its colour space (enumcs 16 sRGB, 17 gray, 18 sYCC, 24 e-sYCC, 12
  CMYK); the `ihdr` size must be the codestream's;
- the codestream decoded tile by tile by rsn_torch/data/native/
  jpeg2000.cpp as OpenJPEG decodes it (opj_read_tile_header,
  opj_decode_tile_data), each tile's components packed as OpenJPEG packs
  them (1, 2 or 4 bytes a sample by precision, signed or not);
- Jpeg2KDecode.c's unpacking: an unpacker chosen by mode, colour space
  (unspecified or unknown: gray for 1 or 2 components, sYCC for 3 or 4
  whose second or third is subsampled, else sRGB) and
  component count, each component's precision shifted to 8 bits (16 for
  "I;16") with its rounding offset and the offset of signed components,
  in unsigned arithmetic; subsampled components (dx, dy > 1) placed as
  PIL places them (floor(w / dx) samples a row); sYCC turned into RGB by
  ImagingConvertYCbCr2RGB; a `pclr`'s indices left as they are (PIL
  decodes tile by tile, so OpenJPEG never applies the palette); a tile
  outside the image, or no unpacker, refused.

A file PIL refuses raises ValueError naming it; a kind the port does
not decode yet (HTJ2K, the Part 2 markers) NotImplementedError.
"""
from __future__ import annotations

import io
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from rsn_torch.data import native
from rsn_torch.data.imagefile import NotThisFormat, check_size, refused

CODESTREAM = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

# OpenJPEG's OPJ_COLOR_SPACE
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}


def accept(prefix: bytes) -> bool:
    """Jpeg2KImagePlugin._accept."""
    return prefix.startswith((CODESTREAM, JP2_SIGNATURE))


def _ycbcr_table(k: float) -> np.ndarray:
    """ConvertYCbCr.c's tables: int(k * (i - 128) * 2**6 + 0.5), C's
    truncation."""
    return np.trunc(k * (np.arange(256) - 128) * 64 + 0.5).astype(np.int32)


R_CR, G_CB = _ycbcr_table(1.402), _ycbcr_table(-0.34414)
G_CR, B_CB = _ycbcr_table(-0.71414), _ycbcr_table(1.772)


def ycbcr_to_rgb(p: np.ndarray) -> np.ndarray:
    """ImagingConvertYCbCr2RGB on (..., 3) uint8 samples."""
    y, cb, cr = (p[..., i].astype(np.int32) for i in range(3))
    out = np.stack([y + (R_CR[cr] >> 6), y + ((G_CB[cb] + G_CR[cr]) >> 6),
                    y + (B_CB[cb] >> 6)], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---- Jpeg2KImagePlugin._open -------------------------------------------------

class _Fp:
    """The plugin's fp (an io.BytesIO over the file's bytes)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n] if self.pos < len(
            self.data) else b""
        self.pos += len(out)
        return out

    def seek(self, n: int, whence: int = 0) -> None:
        self.pos = n if whence == 0 else self.pos + n

    def tell(self) -> int:
        return self.pos


class BoxReader:
    """Jpeg2KImagePlugin.BoxReader."""

    def __init__(self, fp, length: int = -1):
        self.fp = fp
        self.has_length = length >= 0
        self.length = length
        self.remaining_in_box = -1

    def _can_read(self, num_bytes: int) -> bool:
        if self.has_length and self.fp.tell() + num_bytes > self.length:
            return False
        if self.remaining_in_box >= 0:
            return num_bytes <= self.remaining_in_box
        return True

    def _read_bytes(self, num_bytes: int) -> bytes:
        if not self._can_read(num_bytes):
            raise NotThisFormat("Not enough data in header")
        data = self.fp.read(num_bytes)
        if len(data) < num_bytes:  # an OSError in PIL: not a decline
            raise OSError(f"Expected to read {num_bytes} bytes but only got "
                          f"{len(data)}.")
        if self.remaining_in_box > 0:
            self.remaining_in_box -= num_bytes
        return data

    def read_fields(self, field_format: str) -> tuple:
        return struct.unpack(field_format,
                             self._read_bytes(struct.calcsize(field_format)))

    def read_boxes(self) -> "BoxReader":
        size = self.remaining_in_box
        data = self._read_bytes(size)
        return BoxReader(_Fp(data), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.tell() + self.remaining_in_box < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining_in_box > 0:
            self.fp.seek(self.remaining_in_box, os.SEEK_CUR)
        self.remaining_in_box = -1
        lbox, tbox = self.read_fields(">I4s")
        if lbox == 1:
            lbox = self.read_fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise NotThisFormat("Invalid header length")
        self.remaining_in_box = lbox - hlen
        return tbox


def _parse_codestream(fp) -> Tuple[Tuple[int, int], str]:
    hdr = fp.read(2)
    lsiz = struct.unpack_from(">H", hdr)[0]
    siz = hdr + fp.read(lsiz - 2)
    (lsiz, rsiz, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        ssiz = struct.unpack_from(">B", siz, 38)
        mode = "I;16" if (ssiz[0] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise NotThisFormat("unable to determine J2K image mode")
    return size, mode


def _parse_jp2_header(fp):
    """-> (size, mode, palette colours or None)."""
    reader = BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        elif tbox == b"ftyp":
            reader.read_fields(">4s")  # b"jpx " only sets the mimetype
    if header is None:  # PIL's `assert header is not None`
        raise AssertionError("no jp2h box")
    size = mode = nc = None
    colours = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            depths = header.read_fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                seen = set()
                for _ in range(ne):
                    seen.add(header.read_fields(">" + "B" * npc))
                    if len(seen) > 256:
                        raise ValueError("cannot allocate more than 256 "
                                         "colors")
                colours = len(seen)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")  # the dpi: not the pixels
                    break
    if size is None or mode is None:
        raise NotThisFormat("Malformed JP2 header")
    return size, mode, colours


def _parse_comment(fp) -> None:
    """Jpeg2KImageFile._parse_comment as far as it can decline."""
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        length = struct.unpack_from(">H", fp.read(2))[0]
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, os.SEEK_CUR)


# ---- OpenJPEG's reading of the JP2 boxes (opj_jp2_read_header) ---------------

class _Jp2Boxes:
    """What opj_jp2_read_header takes from the boxes before the codestream:
    the codestream's offset, the `ihdr` and the colour space."""

    def __init__(self, data: bytes, path: str):
        self.path = path
        self.ihdr: Optional[Tuple[int, int, int]] = None
        self.enumcs = 0
        self.has_colr = self.pclr = self.cmap = self.cdef = False
        self.pclr_channels = 0
        state = 0  # 1 signature, 2 file type, 4 header
        pos = 0
        while True:
            if len(data) - pos < 8:
                self._refuse("Stream too short (no codestream box)")
            lbox, tbox = struct.unpack_from(">I4s", data, pos)
            hlen = 8
            if lbox == 1:
                if len(data) - pos < 16:
                    self._refuse("Stream too short")
                xl = struct.unpack_from(">Q", data, pos + 8)[0]
                if xl >> 32:
                    self._refuse("Cannot handle box sizes higher than 2^32")
                lbox, hlen = xl, 16
            elif lbox == 0:
                lbox = len(data) - pos  # the last box
            if tbox == b"jp2c":
                if not state & 4:
                    self._refuse("bad placed jpeg codestream")
                self.offset = pos + hlen
                return
            if lbox < hlen:
                self._refuse(f"invalid box size {lbox}")
            body = data[pos + hlen:pos + lbox]
            if pos + lbox > len(data):
                if tbox in (b"jP  ", b"ftyp", b"jp2h"):
                    self._refuse("Stream too short")
                self._refuse("Problem with skipping JPEG2000 box, stream "
                             "error")
            if tbox == b"jP  ":
                if state:
                    self._refuse("The signature box must be the first box "
                                 "in the file.")
                if len(body) != 4 or body != b"\r\n\x87\n":
                    self._refuse("Error with JP signature Box")
                state |= 1
            elif tbox == b"ftyp":
                if state != 1:
                    self._refuse("The ftyp box must be the second box in "
                                 "the file.")
                if len(body) < 8 or len(body) % 4:
                    self._refuse("Error with FTYP signature Box size")
                state |= 2
            elif tbox == b"jp2h":
                if not state & 2:
                    self._refuse("The  box must be the first box in the "
                                 "file.")
                self._jp2h(body)
                state |= 4
            elif tbox in (b"ihdr", b"colr", b"pclr", b"cmap", b"cdef",
                          b"bpcc"):
                if state & 4:  # a misplaced box read all the same
                    self._image_box(tbox, body)
            else:
                if not state & 1:
                    self._refuse("Malformed JP2 file format: first box must "
                                 "be JPEG 2000 signature box")
                if not state & 2:
                    self._refuse("Malformed JP2 file format: second box "
                                 "must be file type box")
            pos += lbox

    def _refuse(self, what: str):
        raise ValueError(f"{self.path}: a JP2 file OpenJPEG cannot read "
                         f"({what}); PIL raises on it too")

    def _jp2h(self, body: bytes) -> None:
        pos, has_ihdr = 0, False
        while pos < len(body):
            left = len(body) - pos
            if left < 8:
                self._refuse("Cannot handle box of less than 8 bytes")
            lbox, tbox = struct.unpack_from(">I4s", body, pos)
            hlen = 8
            if lbox == 1:
                if left < 16:
                    self._refuse("Cannot handle XL box of less than 16 "
                                 "bytes")
                lbox, hlen = struct.unpack_from(">Q", body, pos + 8)[0], 16
                if lbox >> 32:
                    self._refuse("Cannot handle box sizes higher than 2^32")
            elif lbox == 0:
                self._refuse("Cannot handle box of undefined sizes")
            if lbox < hlen:
                self._refuse("Box length is inconsistent.")
            if lbox > left:
                self._refuse("Stream error while reading JP2 Header box: "
                             "box length is inconsistent.")
            self._image_box(tbox, body[pos + hlen:pos + lbox])
            has_ihdr |= tbox == b"ihdr"
            pos += lbox
        if not has_ihdr:
            self._refuse("Stream error while reading JP2 Header box: no "
                         "'ihdr' box.")

    def _image_box(self, tbox: bytes, b: bytes) -> None:
        if tbox == b"ihdr":
            if self.ihdr is not None:
                return  # "Ignoring ihdr box. First ihdr box already read"
            if len(b) != 14:
                self._refuse("Bad image header box (bad size)")
            h, w, nc = struct.unpack_from(">IIH", b)
            if w == 0 or h == 0 or nc == 0:
                self._refuse(f"Wrong values for: w({w}) h({h}) "
                             f"numcomps({nc}) (ihdr)")
            if nc - 1 >= 16384:
                self._refuse("Invalid number of components (ihdr)")
            self.ihdr = (w, h, nc)
        elif tbox == b"colr":
            if len(b) < 3:
                self._refuse("Bad COLR header box (bad size)")
            if self.has_colr:
                return  # only the first is read
            if b[0] == 1:
                if len(b) < 7:
                    self._refuse("Bad COLR header box (bad size)")
                self.enumcs = struct.unpack_from(">I", b, 3)[0]
            self.has_colr = True
        elif tbox == b"pclr":
            if self.pclr or len(b) < 3:
                self._refuse("Invalid PCLR box")
            ne, npc = struct.unpack_from(">HB", b)
            if ne == 0 or ne > 1024:
                self._refuse(f"Invalid PCLR box. Reports {ne} entries")
            if npc == 0:
                self._refuse("Invalid PCLR box. Reports 0 palette columns")
            if len(b) < 3 + npc:
                self._refuse("Invalid PCLR box")
            need = 3 + npc + ne * sum(min((((d & 0x7F) + 1) + 7) >> 3, 4)
                                      for d in b[3:3 + npc])
            if len(b) < need:
                self._refuse("Invalid PCLR box")
            self.pclr, self.pclr_channels = True, npc
        elif tbox == b"cmap":
            if not self.pclr:
                self._refuse("Need to read a PCLR box before the CMAP box.")
            if self.cmap:
                self._refuse("Only one CMAP box is allowed.")
            if len(b) < self.pclr_channels * 4:
                self._refuse("Insufficient data for CMAP box.")
            self.cmap = True
        elif tbox == b"cdef":
            if self.cdef:
                self._refuse("Only one CDEF box is allowed.")
            if len(b) < 2:
                self._refuse("Insufficient data for CDEF box.")
            n = struct.unpack_from(">H", b)[0]
            if n == 0:
                self._refuse("Number of channel description is equal to "
                             "zero in CDEF box.")
            if len(b) < 2 + n * 6:
                self._refuse("Insufficient data for CDEF box.")
            self.cdef = True
        elif tbox == b"bpcc":
            if len(b) != (self.ihdr[2] if self.ihdr else 0):
                self._refuse("Bad BPCC header box (bad size)")

    @property
    def color_space(self) -> int:
        return ENUMCS.get(self.enumcs, UNKNOWN)


# ---- Jpeg2KDecode.c -------------------------------------------------------------

class _Comp:
    def __init__(self, ssiz: int, dx: int, dy: int):
        self.prec, self.sgnd = (ssiz & 0x7F) + 1, ssiz >> 7
        self.dx, self.dy = dx, dy
        csiz = (self.prec + 7) >> 3
        self.csiz = 4 if csiz == 3 else csiz

    def shift_offset(self, bits: int) -> Tuple[int, int]:
        shift = bits - self.prec
        offset = 1 << (self.prec - 1) if self.sgnd else 0
        if shift < 0:
            offset += 1 << (-shift - 1)
        return shift, offset

    def words(self, buf: bytes, at: int, n: int) -> np.ndarray:
        dt = {1: "<u1", 2: "<u2", 4: "<u4"}[self.csiz]
        return np.frombuffer(buf, dt, n, at)

    def pixels(self, words: np.ndarray, bits: int) -> np.ndarray:
        """j2ku_shift(offset + word, shift) in C's unsigned arithmetic,
        kept to `bits`."""
        shift, offset = self.shift_offset(bits)
        v = words.astype(np.uint64 if self.csiz == 4 else np.uint32) + offset
        if self.csiz == 4:
            v &= 0xFFFFFFFF
        v = (v >> -shift) if shift < 0 else v << shift
        return (v & ((1 << bits) - 1)).astype(np.uint16 if bits == 16
                                              else np.uint8)


def _gray(comps, buf, w, h, bits):
    c = comps[0]
    return c.pixels(c.words(buf, 0, w * h), bits).reshape(h, w)


def _gray_alpha(comps, buf, w, h):
    c, a = comps[0], comps[1]
    g = c.pixels(c.words(buf, 0, w * h), 8).reshape(h, w)
    al = a.pixels(a.words(buf, c.csiz * w * h, w * h), 8).reshape(h, w)
    return g, al


def _subsampled(comps, buf, w, h, n):
    """j2ku_srgb_rgb's reading of n components: component k's samples
    from the buffer at its start plus csiz * ((y / dy) * (w / dx) + x / dx)
    (C's division; past the component's floor(h / dy) rows it reads on
    into the next one's, as PIL does)."""
    raw = np.frombuffer(buf, np.uint8)
    out, at = [], 0
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    for c in comps[:n]:
        if c.dx == c.dy == 1:
            out.append(c.pixels(c.words(buf, at, w * h), 8).reshape(h, w))
            at += c.csiz * w * h
            continue
        rw = w // c.dx
        where = at + c.csiz * ((ys // c.dy) * rw + xs // c.dx)
        words = np.zeros((h, w), np.uint64)
        for b in range(c.csiz):
            words |= raw[where + b].astype(np.uint64) << np.uint64(8 * b)
        out.append(c.pixels(words, 8))
        at += c.csiz * rw * (h // c.dy)
    return np.stack(out, -1)


def _unpack(unpacker: str, comps, buf, w, h) -> np.ndarray:
    """A tile as PIL's Imaging rows give it: (h, w) for "L" / "P" /
    "I;16", else (h, w, 4) bytes."""
    if unpacker == "gray_l":
        return _gray(comps, buf, w, h, 8)
    if unpacker == "gray_i":
        return _gray(comps, buf, w, h, 16)
    px = np.zeros((h, w, 4), np.uint8)
    if unpacker == "gray_rgb":
        g = _gray(comps, buf, w, h, 8)
        px[..., 0] = px[..., 1] = px[..., 2] = g
        px[..., 3] = 0xFF
    elif unpacker == "graya_la":
        g, a = _gray_alpha(comps, buf, w, h)
        px[..., 0] = px[..., 1] = px[..., 2] = g
        px[..., 3] = a
    elif unpacker in ("srgb_rgb", "sycc_rgb"):
        px[..., :3] = _subsampled(comps, buf, w, h, 3)
        px[..., 3] = 0xFF
        if unpacker == "sycc_rgb":
            px[..., :3] = ycbcr_to_rgb(px[..., :3])
    else:  # srgba_rgba, sycca_rgba
        px[...] = _subsampled(comps, buf, w, h, 4)
        if unpacker == "sycca_rgba":
            px[..., :3] = ycbcr_to_rgb(px[..., :3])
    return px


# j2k_unpackers: (mode, colour space, components) -> (unpacker, whether it
# places subsampled components); its I;16B row is left out, as the plugin
# never opens that mode
UNPACKERS = {
    ("L", GRAY, 1): ("gray_l", False),
    ("P", SRGB, 1): ("gray_l", False),
    ("PA", SRGB, 2): ("graya_la", False),
    ("I;16", GRAY, 1): ("gray_i", False),
    ("LA", GRAY, 2): ("graya_la", False),
    ("RGB", GRAY, 1): ("gray_rgb", False),
    ("RGB", GRAY, 2): ("gray_rgb", False),
    ("RGB", SRGB, 3): ("srgb_rgb", True),
    ("RGB", SYCC, 3): ("sycc_rgb", True),
    ("RGB", SRGB, 4): ("srgb_rgb", True),
    ("RGB", SYCC, 4): ("sycc_rgb", True),
    ("RGBA", GRAY, 1): ("gray_rgb", False),
    ("RGBA", GRAY, 2): ("graya_la", False),
    ("RGBA", SRGB, 3): ("srgb_rgb", True),
    ("RGBA", SYCC, 3): ("sycc_rgb", True),
    ("RGBA", SRGB, 4): ("srgba_rgba", True),
    ("RGBA", SYCC, 4): ("sycca_rgba", True),
    ("CMYK", CMYK, 4): ("srgba_rgba", True),
}
# np.asarray's bands of PIL's 4-byte pixels by mode
BANDS = {"LA": [0, 3], "PA": [0, 3], "RGB": [0, 1, 2], "RGBA": [0, 1, 2, 3],
         "CMYK": [0, 1, 2, 3]}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def guess_space(comps) -> int:
    """Jpeg2KDecode.c's colour space of a codestream that names none:
    gray for 1 or 2 components; for 3 or 4, sYCC when the first is not
    subsampled and the second or third is, else sRGB."""
    if len(comps) <= 2:
        return GRAY
    first = comps[0].dx == 1 and comps[0].dy == 1
    if first and any(c.dx != 1 or c.dy != 1 for c in comps[1:3]):
        return SYCC
    return SRGB


class Jpeg2000Image:
    """Jpeg2KImageFile after _open: mode and size (a decline raises one of
    imagefile.DECLINES, a refusal ValueError)."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        fp = _Fp(data)
        sig = fp.read(4)
        self.colours = None
        try:
            if sig == CODESTREAM:
                self.codec = "j2k"
                self.size, self.mode = _parse_codestream(fp)
                _parse_comment(fp)
            else:
                sig = sig + fp.read(8)
                if sig != JP2_SIGNATURE:
                    raise NotThisFormat("not a JPEG 2000 file")
                self.codec = "jp2"
                self.size, self.mode, self.colours = _parse_jp2_header(fp)
                if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
                    length = struct.unpack_from(">H", fp.read(2))[0]
                    fp.seek(length - 2, os.SEEK_CUR)
                    _parse_comment(fp)
        except (OSError, AssertionError) as e:
            raise refused(path, f"a JPEG 2000 header PIL cannot read ({e})")
        except ValueError as e:
            raise refused(path, f"a JP2 palette PIL cannot hold ({e})")
        if self.size[0] <= 0 or self.size[1] <= 0:
            raise NotThisFormat("not identified by this driver")
        check_size(*self.size, path)  # Image.open's, after _open

    def _broken(self, what: str) -> ValueError:
        return refused(self.path, f"a JPEG 2000 image PIL cannot decode "
                       f"({what}: broken data stream)")

    def load(self) -> Tuple[str, np.ndarray]:
        width, height = self.size
        data = self.data
        if self.codec == "jp2":
            boxes = _Jp2Boxes(data, self.path)
            offset, space = boxes.offset, boxes.color_space
        else:
            offset, space = 0, UNSPECIFIED
        cs = data[offset:]
        if len(cs) < 46 or cs[:4] != CODESTREAM:
            raise ValueError(f"{self.path}: a JPEG 2000 codestream OpenJPEG "
                             "cannot read (no SOC / SIZ); PIL raises on it "
                             "too")
        (lsiz, _, x1, y1, x0, y0, tdx, tdy, tx0, ty0,
         nc) = struct.unpack_from(">HHIIIIIIIIH", cs, 4)
        if len(cs) < 42 + 3 * nc or lsiz != 38 + 3 * nc or nc == 0:
            raise ValueError(f"{self.path}: a JPEG 2000 codestream OpenJPEG "
                             "cannot read (Error with SIZ marker size); PIL "
                             "raises on it too")
        comps = [_Comp(*cs[42 + 3 * i:45 + 3 * i]) for i in range(nc)]
        if (x0 >= x1 or y0 >= y1 or tdx == 0 or tdy == 0 or tx0 > x0
                or ty0 > y0 or tx0 + tdx <= x0 or ty0 + tdy <= y0
                or any(not 1 <= c.dx <= 255 or not 1 <= c.dy <= 255
                       or c.prec > 31 for c in comps)):
            raise ValueError(f"{self.path}: a JPEG 2000 codestream OpenJPEG "
                             "cannot read (Error with SIZ marker); PIL raises "
                             "on it too")
        if self.codec == "jp2" and boxes.ihdr[:2] != (x1 - x0, y1 - y0):
            w, h = boxes.ihdr[:2]
            raise ValueError(f"{self.path}: a JP2 file OpenJPEG cannot read "
                             f"(Error with SIZ marker: IHDR w({w}) h({h}) vs. "
                             f"SIZ w({x1 - x0}) h({y1 - y0})); PIL raises on "
                             "it too")
        tw, th = _cdiv(x1 - tx0, tdx), _cdiv(y1 - ty0, tdy)
        if tw == 0 or th == 0 or tw > 65535 // th:
            raise ValueError(f"{self.path}: a JPEG 2000 codestream OpenJPEG "
                             f"cannot read (Invalid number of tiles : {tw} x "
                             f"{th}); PIL raises on it too")
        # Jpeg2KDecode.c: what it can handle, and its unpacker
        if space in (UNSPECIFIED, UNKNOWN):
            space = guess_space(comps)
        found = UNPACKERS.get((self.mode, space, nc))
        if not 1 <= nc <= 4 or found is None:
            raise self._broken(f"no unpacker of {nc} components to mode "
                               f"{self.mode}")
        unpacker, subsampling = found
        if not subsampling and any(c.dx != 1 or c.dy != 1 for c in comps):
            raise self._broken("subsampled components the unpacker cannot "
                               "place")
        tiles: List[Tuple[int, int, int, int, int]] = []
        total = 0
        for t in range(tw * th):
            p, q = t % tw, t // tw
            bx0, by0 = max(tx0 + p * tdx, x0), max(ty0 + q * tdy, y0)
            bx1, by1 = min(tx0 + (p + 1) * tdx, x1), min(ty0 + (q + 1) * tdy,
                                                         y1)
            tiles.append((bx0, by0, bx1, by1, total))
            total += sum((_cdiv(bx1, c.dx) - _cdiv(bx0, c.dx))
                         * (_cdiv(by1, c.dy) - _cdiv(by0, c.dy))
                         for c in comps)
        out = np.zeros(total, np.int32)
        dims = np.zeros((tw * th, nc, 2), np.int32)
        order = np.zeros(tw * th, np.int32)
        n = native.decode_jpeg2000(data, offset, out, dims, order, self.path)
        four = unpacker not in ("gray_l", "gray_i")
        image = np.zeros((height, width) + ((4,) if four else ()),
                         np.uint16 if unpacker == "gray_i" else np.uint8)
        for t in order[:n]:
            bx0, by0, bx1, by1, at = tiles[t]
            w, h = bx1 - bx0, by1 - by0
            if (bx1 - x0 > width or by1 - y0 > height or w <= 0 or h <= 0):
                raise self._broken(f"tile {t} outside the image")
            buf = io.BytesIO()
            for c, comp in enumerate(comps):
                cw, ch = (int(v) for v in dims[t, c])
                samples = out[at:at + cw * ch].astype(np.int64)
                at += ((_cdiv(bx1, comp.dx) - _cdiv(bx0, comp.dx))
                       * (_cdiv(by1, comp.dy) - _cdiv(by0, comp.dy)))
                bits = 8 * comp.csiz
                buf.write((samples & ((1 << bits) - 1)).astype(
                    f"<u{comp.csiz}").tobytes())
            raw = buf.getvalue()
            need = sum(c.csiz for c in comps) * w * h
            raw += bytes(max(0, need - len(raw)))
            image[by0 - y0:by1 - y0, bx0 - x0:bx1 - x0] = _unpack(
                unpacker, comps, raw, w, h)
        if four:
            image = image[..., BANDS[self.mode]]
        return self.mode, np.ascontiguousarray(image)

