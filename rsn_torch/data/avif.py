"""AVIF still images as PIL 12.1.0 reads them with libavif 1.3.0 and
dav1d 1.5.1 (the port of the `Image.open` calls in rsn/data/blender.py
for AvifImagePlugin, PIL/AvifImagePlugin.py, and its decoder module
_avif.c).

`AvifImage(data, path).load()` gives what `np.asarray(Image.open(path))`
gives:

- `_open` (AvifImagePlugin.py:73-110) runs libavif's parse
  (avifDecoderParse): the top-level boxes until the brands' needs are met
  (`ftyp` first with an `avif` or `avis` brand; `avif` needs a `meta`,
  `avis` a `moov`: a major brand `avis` is an image sequence, not
  ported), then `meta` with `hdlr` `pict` first, `pitm`, `iloc` (versions
  0-2, construction methods 0 and 1 with `idat`, several extents),
  `iinf` / `infe`, `iref` (`auxl`, `prem`, `thmb`, `dimg`, read on from
  each reference box's header as libavif reads them), `iprp` / `ipco` /
  `ipma` and every property libavif knows, checked as it parses it
  (`ispe`, `pixi`, `av1C`, `colr` nclx and ICC, `auxC`, `clap`, `irot`,
  `imir`, ...); then avifDecoderReset's checks: an `ispe` within
  libavif's limits on every image item, the primary item (nonempty, of
  no unknown essential property, `av01`), its alpha item (an `auxl`
  reference to it and the alpha `auxC`), an `av1C` and a `pixi` of its
  depth on both, one `colr` of each kind, `clap`, `irot` and `imir`
  marked essential (their values not checked, as PIL runs libavif; PIL
  only reports the orientation, the pixels stay).  What libavif reports
  as a malformed or truncated file PIL raises as SyntaxError, a decline
  (the walk goes on); anything else refuses the file.  The mode is
  "RGBA" when an alpha item exists, else "RGB";
- the decode (AvifDecoder.get_frame): the primary item's OBUs (and the
  alpha item's) through rsn_torch/data/native/av1.cpp (a frame whose size
  is not its `ispe`, which libavif scales, is not ported), then
  avifImageYUVToRGB as it runs for PIL's 8-bit RGB / RGBA
  (native.avif_to_rgb); an image with a `prem` reference is
  un-premultiplied.  `irot`, `imir` and `clap` leave the pixels as they
  are (PIL only reports an EXIF orientation).

The CICP and range come from the `colr` nclx box when there is one, else
from the AV1 sequence header.  A file PIL refuses raises ValueError
naming it; a kind the port does not decode yet (grids, image sequences,
10 / 12 bits, intra block copy, CDEF, film grain, superres, quantizer
matrices, frames other than key frames) NotImplementedError.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from rsn_torch.data import native
from rsn_torch.data.imagefile import NotThisFormat, check_size, refused

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
# the item properties libavif reads; another marked essential refuses
KNOWN_PROPERTIES = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap",
                    b"irot", b"imir", b"pixi", b"a1op", b"lsel", b"a1lx",
                    b"clli", b"cclv", b"amve", b"reve", b"ndwt", b"mdcv")
# ipma's rules: these must be marked essential (the transformative ones by
# MIAF), a1lx must not be
ESSENTIAL = (b"a1op", b"lsel", b"clap", b"irot", b"imir")
NOT_ESSENTIAL = (b"a1lx",)
# the payload sizes libavif reads of the other properties it knows
SIZES = {b"pasp": 8, b"clap": 32, b"a1op": 1, b"lsel": 2, b"clli": 4}
# libavif's default imageDimensionLimit and imageSizeLimit
DIMENSION_LIMIT, SIZE_LIMIT = 32768, 16384 * 16384
LAYOUT_OF = {(0, 0, 0): "4:4:4", (1, 0, 0): "4:2:2", (1, 1, 0): "4:2:0",
             (1, 1, 1): "4:0:0"}


def unported(path: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: {what}; ROADMAP Queue 1: the port does not decode this "
        "AVIF kind yet, rsn/data/blender.py reads it with PIL")


class _Malformed(NotThisFormat):
    """avifDecoderParse's BMFF_PARSE_FAILED / TRUNCATED_DATA /
    INVALID_FTYP / NO_CONTENT, which _avif.c raises as SyntaxError."""


def _box_header(data: bytes, pos: int, end: int, top: bool = False):
    """The box at data[pos:end] as libavif reads its header -> (type,
    payload start, box end).  Inside another box a box past `end` or of
    size 0 is malformed; at the top level size 0 runs to the end."""
    if end - pos < 8:
        raise _Malformed("a box header past its parent")
    size, typ = struct.unpack_from(">I4s", data, pos)
    head = 8
    if size == 1:
        if end - pos < 16:
            raise _Malformed("a box header past its parent")
        size = struct.unpack_from(">Q", data, pos + 8)[0]
        head = 16
    if typ == b"uuid":
        if end - pos < head + 16:
            raise _Malformed("a box header past its parent")
        head += 16
    if size == 0:
        if not top:
            raise _Malformed("a box of size 0 inside another")
        size = end - pos
    elif size < head:
        raise _Malformed(f"box {typ!r} smaller than its header")
    if pos + size > end and not top:
        raise _Malformed(f"box {typ!r} runs past its parent")
    return typ, pos + head, pos + size


def _boxes(data: bytes, start: int, end: int):
    """-> [(type, payload start, end)] of the boxes in data[start:end]."""
    out = []
    pos = start
    while pos < end:
        out.append(_box_header(data, pos, end))
        pos = out[-1][2]
    return out


class _Reader:
    def __init__(self, data: bytes, start: int, end: int):
        self.d, self.pos, self.end = data, start, end

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise _Malformed("a box's fields run past it")
        b = self.d[self.pos:self.pos + n]
        self.pos += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def full(self) -> Tuple[int, int]:
        v = self.u(1)
        return v, self.u(3)

    def cstring(self) -> bytes:
        i = self.d.find(b"\0", self.pos, self.end)
        if i < 0:
            raise _Malformed("a string without its terminator")
        s = self.d[self.pos:i]
        self.pos = i + 1
        return s


class _Item:
    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b""
        self.extents: List[Tuple[int, int]] = []
        self.method = 0
        self.props: List[Tuple[bytes, int, int, bool]] = []
        self.ipma_seen = False
        self.unsupported_essential = False
        self.aux_for = self.prem_by = self.thumbnail_for = 0

    @property
    def size(self) -> int:
        return sum(length for _, length in self.extents)


def _item_id(value: int) -> int:
    if value == 0:
        raise _Malformed("an item ID of 0")
    return value


class AvifImage:
    """AvifImageFile after _open: mode and size (a decline raises one of
    imagefile.DECLINES, a refusal ValueError or NotImplementedError)."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        self.counts: Optional[np.ndarray] = None
        # a kind PIL opens that the port does not decode: load() raises it
        self.pending: Optional[NotImplementedError] = None
        self.size, self.mode = (0, 0), "RGB"
        self._parse()
        check_size(*self.size, path)  # Image.open's, after _open

    # ---- the parse (avifDecoderParse) ------------------------------------
    def _parse(self) -> None:
        """avifParse: top-level boxes until the brands' needs are met (an
        `avif` brand needs a meta box, `avis` a moov box); ftyp, meta and
        moov are read whole, the others skipped unread."""
        data = self.data
        seen = set()
        needs = set()
        major = b""
        pos = 0
        while pos < len(data):
            typ, s, e = _box_header(data, pos, len(data), top=True)
            if typ in (b"ftyp", b"meta", b"moov"):
                if e > len(data):
                    raise _Malformed(f"box {typ!r} truncated")
                if typ in seen:
                    raise _Malformed(f"two {typ.decode()} boxes")
                seen.add(typ)
            elif not seen:
                raise _Malformed("no ftyp box first")
            pos = e
            if typ == b"ftyp":
                if e - s < 8 or (e - s) % 4:
                    raise _Malformed("an ftyp box of a bad size")
                major = data[s:s + 4]
                brands = [data[i:i + 4] for i in range(s, e, 4)
                          if i != s + 4]
                if b"avif" not in brands and b"avis" not in brands:
                    raise _Malformed("an ftyp without the avif or avis brand")
                needs = ({b"meta"} if b"avif" in brands else set()) | (
                    {b"moov"} if b"avis" in brands else set())
            elif typ == b"meta":
                self._parse_meta(s, e)
            if b"ftyp" in seen and needs <= seen:
                break
        if pos > len(data):
            raise _Malformed("a box runs past the end of the file")
        if not needs <= seen:
            raise _Malformed("a box the brands need is missing (truncated)")
        if major == b"avis":
            self.pending = unported(self.path,
                                    "an AVIF image sequence (moov track)")
            return
        if b"meta" not in seen:
            raise _Malformed("no meta box")
        self._resolve()

    def _parse_meta(self, start: int, end: int) -> None:
        data = self.data
        r = _Reader(data, start, end)
        if r.full()[0] != 0:
            raise _Malformed("a meta box of version other than 0")
        children = _boxes(data, r.pos, end)
        if not children or children[0][0] != b"hdlr":
            raise _Malformed("a meta box without hdlr first")
        seen = set()
        self.items: Dict[int, _Item] = {}
        self.primary: Optional[int] = None
        self.idat: Optional[Tuple[int, int]] = None
        self.props: List[Tuple[bytes, int, int]] = []
        for typ, s, e in children:
            if typ in seen and typ in (b"hdlr", b"iloc", b"pitm", b"idat",
                                       b"iprp", b"iinf", b"iref"):
                raise _Malformed(f"two {typ.decode()} boxes")
            seen.add(typ)
            if typ == b"hdlr":
                b = _Reader(data, s, e)
                if b.full()[0] != 0 or b.u(4) != 0:
                    raise _Malformed("an hdlr of version or pre_defined "
                                     "other than 0")
                if b.take(4) != b"pict":
                    raise _Malformed("a handler other than pict")
                b.take(12)
                b.cstring()
            elif typ == b"iloc":
                self._parse_iloc(s, e)
            elif typ == b"pitm":
                b = _Reader(data, s, e)
                v, _ = b.full()
                self.primary = b.u(2 if v == 0 else 4)
            elif typ == b"idat":
                self.idat = (s, e)
            elif typ == b"iprp":
                self._parse_iprp(s, e)
            elif typ == b"iinf":
                self._parse_iinf(s, e)
            elif typ == b"iref":
                self._parse_iref(s, e)

    def _item(self, item_id: int) -> _Item:
        if item_id not in self.items:
            self.items[item_id] = _Item(item_id)
        return self.items[item_id]

    def _parse_iloc(self, s: int, e: int) -> None:
        r = _Reader(self.data, s, e)
        version, _ = r.full()
        if version > 2:
            raise _Malformed("an iloc box of version above 2")
        a, b = r.u(1), r.u(1)
        osz, lsz, bsz = a >> 4, a & 15, b >> 4
        isz = b & 15 if version in (1, 2) else 0
        for n in (osz, lsz, bsz, isz):
            if n not in (0, 4, 8):
                raise _Malformed("an iloc field size other than 0, 4, 8")
        for _ in range(r.u(2 if version < 2 else 4)):
            item = self._item(_item_id(r.u(2 if version < 2 else 4)))
            if item.extents:
                raise _Malformed("an item located twice")
            if version in (1, 2):
                word = r.u(2)  # 12 reserved bits, construction_method
                if word >> 4 or word > 1:
                    raise _Malformed("an iloc construction method above 1 "
                                     "or reserved bits set")
                item.method = word
            r.u(2)  # data_reference_index: libavif does not check it
            base = r.u(bsz)
            for _ in range(r.u(2)):
                r.u(isz)  # extent_index
                off, length = r.u(osz), r.u(lsz)
                item.extents.append((base + off, length))

    def _parse_iinf(self, s: int, e: int) -> None:
        r = _Reader(self.data, s, e)
        version, _ = r.full()
        if version > 1:
            raise _Malformed("an iinf box of version above 1")
        for _ in range(r.u(2 if version == 0 else 4)):
            typ, bs, be = _box_header(self.data, r.pos, e)
            r.pos = be
            if typ != b"infe":
                raise _Malformed("an iinf entry that is not infe")
            b = _Reader(self.data, bs, be)
            v, _ = b.full()
            if v not in (2, 3):
                raise _Malformed("an infe of version other than 2 or 3")
            item_id = _item_id(b.u(2 if v == 2 else 4))
            b.u(2)
            item_type = b.take(4)
            b.cstring()
            if item_type == b"mime":
                b.cstring()
            self._item(item_id).type = item_type

    def _parse_iref(self, s: int, e: int) -> None:
        r = _Reader(self.data, s, e)
        version, _ = r.full()
        while r.pos < e:
            # libavif reads each reference on from its box header in the
            # iref box's stream: the reference box's own size is not used
            typ, r.pos, _ = _box_header(self.data, r.pos, e)
            if version > 1:
                break  # libavif skips the rest
            n = 2 if version == 0 else 4
            src = _item_id(r.u(n))
            for _ in range(r.u(2)):
                to = _item_id(r.u(n))
                if typ == b"dimg":
                    self._item(to)
                    continue
                item = self._item(src)
                if typ == b"thmb":
                    item.thumbnail_for = to
                elif typ == b"auxl":
                    item.aux_for = to
                elif typ == b"prem":
                    item.prem_by = to

    def _parse_iprp(self, s: int, e: int) -> None:
        kids = _boxes(self.data, s, e)
        if not kids or kids[0][0] != b"ipco":
            raise _Malformed("an iprp box without ipco first")
        self.props = _boxes(self.data, kids[0][1], kids[0][2])
        for typ, ps, pe in self.props:
            self._check_property(typ, ps, pe)
        seen = set()
        for typ, bs, be in kids[1:]:
            if typ != b"ipma":
                raise _Malformed("an iprp child that is not ipma")
            r = _Reader(self.data, bs, be)
            version, flags = r.full()
            if (version, flags) in seen:
                raise _Malformed("two ipma boxes of one version and flags")
            seen.add((version, flags))
            previous = 0
            for _ in range(r.u(4)):
                item_id = _item_id(r.u(2 if version < 1 else 4))
                if item_id <= previous:
                    raise _Malformed("ipma item IDs out of order")
                if item_id not in self.items:
                    raise _Malformed("an ipma entry for an item no box "
                                     "before it names")
                previous = item_id
                item = self._item(item_id)
                if item.ipma_seen:
                    raise _Malformed("an item in two ipma boxes")
                item.ipma_seen = True
                for _ in range(r.u(1)):
                    v = r.u(2 if flags & 1 else 1)
                    essential = bool(v >> (15 if flags & 1 else 7))
                    index = v & (0x7FFF if flags & 1 else 0x7F)
                    if index == 0:
                        continue
                    if index > len(self.props):
                        raise _Malformed("an ipma index past ipco")
                    typ, ps, pe = self.props[index - 1]
                    if typ not in KNOWN_PROPERTIES:
                        item.unsupported_essential |= essential
                        continue
                    if essential and typ in NOT_ESSENTIAL:
                        raise _Malformed(f"a {typ.decode()} property marked "
                                         "essential")
                    if not essential and typ in ESSENTIAL:
                        raise _Malformed(f"a {typ.decode()} property not "
                                         "marked essential")
                    item.props.append((typ, ps, pe, essential))

    def _check_property(self, typ: bytes, s: int, e: int) -> None:
        """The checks of libavif's parse of each property it knows, made on
        every property of ipco, associated or not."""
        r = _Reader(self.data, s, e)
        if typ in (b"ispe", b"auxC", b"pixi"):
            if r.full()[0] != 0:
                raise _Malformed(f"a {typ.decode()} of version other than 0")
        if typ == b"ispe":
            r.take(8)
        elif typ == b"auxC":
            r.cstring()
        elif typ == b"pixi":
            count = r.u(1)
            if not 1 <= count <= 4:
                raise refused(self.path, f"an AVIF pixi of {count} channels "
                              "(not implemented in libavif)")
            depths = r.take(count)
            if len(set(depths)) != 1:
                raise refused(self.path, "an AVIF pixi of unequal depths (not "
                              "implemented in libavif)")
        elif typ == b"av1C":
            if r.u(1) != 0x81:
                raise _Malformed("an av1C of marker or version other than 1")
            r.take(2)
        elif typ == b"colr":
            if r.take(4) == b"nclx":
                r.take(6)
                if r.u(1) & 0x7F:
                    raise _Malformed("a colr nclx with reserved bits set")
        elif typ in (b"irot", b"imir"):
            if r.u(1) & (0xFC if typ == b"irot" else 0xFE):
                raise _Malformed(f"an {typ.decode()} with reserved bits set")
        elif typ in SIZES:
            r.take(SIZES[typ])

    def _prop(self, item: _Item, typ: bytes):
        for t, s, e, _ in item.props:
            if t == typ:
                return s, e
        return None

    def _usable(self, item: _Item) -> bool:
        return item.size > 0 and not item.unsupported_essential

    def _resolve(self) -> None:
        """avifDecoderReset: an ispe within libavif's limits on every
        image item, the primary item (nonempty, of no unsupported essential
        property, av01 or grid, no thumbnail), its alpha item (an av01 item
        whose auxl points at it, of the alpha auxC) and the checks of both
        items' other properties."""
        for item in self.items.values():
            if self._usable(item) and item.type in (b"av01", b"grid"):
                ispe = self._prop(item, b"ispe")
                if ispe is None:
                    raise _Malformed("an image item without ispe")
                w, h = struct.unpack_from(">II", self.data, ispe[0] + 4)
                if not (0 < w <= DIMENSION_LIMIT and 0 < h <= DIMENSION_LIMIT
                        and w * h <= SIZE_LIMIT):
                    raise _Malformed(f"an image of {w}x{h}, past libavif's "
                                     "limits")
        color = next((i for i in self.items.values() if self._usable(i)
                      and i.type in (b"av01", b"grid") and not i.thumbnail_for
                      and i.id == self.primary), None)
        if color is None:
            raise refused(self.path, "an AVIF file without its primary image "
                          "item (libavif: missing or empty image item)")
        if color.type == b"grid":
            self.pending = unported(self.path, "a grid image (dimg items)")
            return
        for kind in (b"nclx", b"ICC"):
            if sum(1 for t, ps, _, _ in color.props if t == b"colr" and (
                    self.data[ps:ps + 4] == b"nclx") == (kind == b"nclx")
                    and self.data[ps:ps + 4] in (b"nclx", b"rICC", b"prof")
                    ) > 1:
                raise _Malformed(f"two colr {kind.decode()} properties")
        if color.method == 0 and not any(
                t == b"colr" and self.data[ps:ps + 4] == b"nclx"
                for t, ps, _, _ in color.props):
            # without nclx libavif reads the CICP from the item's sequence
            # header while it parses: an extent past the file fails there
            if any(off > len(self.data) for off, _ in color.extents):
                raise _Malformed("an item that starts past the file")
        self.color = color
        self.alpha: Optional[_Item] = None
        for cand in self.items.values():
            aux = self._prop(cand, b"auxC")
            if (self._usable(cand) and cand.type == b"av01" and aux
                    and cand.aux_for == color.id
                    and _Reader(self.data, aux[0] + 4, aux[1]).cstring()
                    in ALPHA_URNS):
                self.alpha = cand
                break
        self.premultiplied = (self.alpha is not None
                              and color.prem_by == self.alpha.id)
        for item in (color,) + ((self.alpha,) if self.alpha else ()):
            av1c = self._prop(item, b"av1C")
            if av1c is None:
                raise _Malformed("an av01 item without av1C")
            flags = self.data[av1c[0] + 2]
            depth = 12 if flags & 0x20 else 10 if flags & 0x40 else 8
            pixi = self._prop(item, b"pixi")
            if pixi is not None and self.data[pixi[0] + 5] != depth:
                raise _Malformed("a pixi depth other than av1C's")
            if item.size > len(self.data):
                raise _Malformed("an item larger than the file")
        s, _ = self._prop(color, b"ispe")
        self.size = struct.unpack_from(">II", self.data, s + 4)
        self.mode = "RGBA" if self.alpha is not None else "RGB"

    # ---- the decode (AvifDecoder.get_frame) ------------------------------
    def _item_data(self, item: _Item) -> bytes:
        out = bytearray()
        if item.method == 1:
            if self.idat is None:
                raise refused(self.path, "an AVIF item in an idat box that "
                              "is not there")
            base, end = self.idat
        else:
            base, end = 0, len(self.data)
        for off, length in item.extents:
            if base + off + length > end:
                raise refused(self.path, "an AVIF item past the end of the "
                              "file (truncated data)")
            out += self.data[base + off:base + off + length]
        return bytes(out)

    def _decode(self, item: _Item, counts: np.ndarray):
        obus = self._item_data(item)
        info = native.probe_av1(obus, self.path)
        w, h = info["width"], info["height"]
        sx, sy = info["subsampling_x"], info["subsampling_y"]
        planes = [np.empty((h, w), np.uint8)]
        if not info["mono"]:
            cs = ((h + sy) >> sy, (w + sx) >> sx)
            planes += [np.empty(cs, np.uint8), np.empty(cs, np.uint8)]
        s, _ = self._prop(item, b"ispe")
        if struct.unpack_from(">II", self.data, s + 4) != (w, h):
            raise unported(self.path, "an item whose ispe is not its frame's "
                           f"size ({w}x{h}), which libavif scales")
        return planes, native.decode_av1(obus, planes, counts, self.path)

    def _cicp(self, info: dict) -> Tuple[int, bool]:
        colr = None
        for typ, s, e, _ in self.color.props:
            if typ == b"colr" and self.data[s:s + 4] == b"nclx":
                colr = (s, e)
                break
        if colr is not None:
            s, _ = colr
            matrix = struct.unpack_from(">H", self.data, s + 8)[0]
            full = bool(self.data[s + 10] >> 7)
            return matrix, full
        return info["matrix"], bool(info["full_range"])

    def load(self) -> Tuple[str, np.ndarray]:
        if self.pending is not None:
            raise self.pending
        counts = np.zeros(len(native.av1_count_names()), np.uint64)
        planes, info = self._decode(self.color, counts)
        alpha = None
        if self.alpha is not None:
            aplanes, ainfo = self._decode(self.alpha, counts)
            if (ainfo["width"], ainfo["height"]) != (info["width"],
                                                     info["height"]):
                raise refused(self.path, "an AVIF alpha plane of another size"
                              " than the image")
            alpha = aplanes[0]
        self.counts = counts
        layout = LAYOUT_OF[(info["subsampling_x"], info["subsampling_y"],
                            info["mono"])]
        matrix, full = self._cicp(info)
        w, h = info["width"], info["height"]
        out = np.empty((h, w, 3 if alpha is None else 4), np.uint8)
        native.avif_to_rgb(planes, alpha, layout, matrix, full,
                           self.premultiplied, out, self.path)
        return self.mode, out


def read_avif(path: str) -> Tuple[str, np.ndarray]:
    """-> (PIL's mode, np.asarray(Image.open(path))) for an AVIF file."""
    with open(path, "rb") as f:
        data = f.read()
    return AvifImage(data, path).load()
