"""Write the AVIF fixtures of rsn_torch.data.avif and their digests (PIL
12.1.0 with libavif 1.3.0, dav1d 1.5.1 and libaom 3.12.1).

    python tests/golden/avif/write_fixtures.py

Three writers make the files:

- PIL's own `save` (`pil_save`): every named option of AvifImagePlugin
  (quality, speed, subsampling 4:0:0 / 4:2:0 / 4:2:2 / 4:4:4, range,
  tile_rows / tile_cols / autotiling, alpha and alpha_premultiplied,
  from every mode PIL saves: L, LA, P, PA, I;16, CMYK, RGB, RGBA) and the
  `advanced` options of libaom that stay in the decoder's scope (aq /
  delta q / delta lf modes, cdf updates, the reduced transform set,
  64-point transforms, palette, filter intra, CfL, sharpness, loop
  restoration, superblock size);
- `struct` rewraps (`Heif`): PIL's file read into items, properties and
  references and written again with a change: the item data in an `idat`
  or in several extents, `iloc` versions 0-2, `colr` ICC or none, `clap`,
  `irot`, `imir`, properties removed, an `ispe` that differs from the
  frame, an essential property libavif does not know, a grid of two
  items, OBUs removed from an item, truncated and corrupt data;
- AV1 streams written by hand (`av1_symbols`) in PIL's container: a
  sequence header of any layout and a key frame header with the tools
  libaom does not write for PIL (segmentation, explicit tile sizes, a
  delta loop-filter level per edge and plane, a full sequence header, a
  decoder model, a frame header OBU and a tile group OBU, a sequence
  header after the frame, and the refused superres, quantizer matrices,
  10 and 12 bits, intra-only frames, scalable streams, a second frame, a
  new sequence header before the frame's tiles, a frame header that
  shows an existing frame), then tiles of seeded random bytes, which
  decode as random symbols.

CASES are committed with PIL's mode, shape, dtype and sha256 of
np.asarray in digests.json; UNPORTED_CASES too (PIL opens them, the port
raises NotImplementedError: a coding tool or container kind it does not
decode yet); REFUSED_CASES with PIL's error; FRAMES are the five 800x800
frames of tests/golden/jpeg/ as AVIF, which chip_smoke.py times.  The
writer makes its files in this folder only and leaves nothing else
behind.
"""
from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_FRAMES = os.path.join(os.path.dirname(HERE), "jpeg")

# ---- pixels ------------------------------------------------------------------


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(int(hashlib.sha256(name.encode())
                                     .hexdigest()[:8], 16))


def natural(h: int, w: int, seed: str = "n") -> np.ndarray:
    """Smooth shading, a coloured rectangle and a ramp: the intra modes
    of an ordinary photograph at a small size."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = _rng(seed).uniform(0.8, 1.2)
    a = np.stack([128 + 100 * np.sin(x / (17 * r)) * np.cos(y / 23),
                  128 + 90 * np.sin((x + y) / (31 * r)),
                  (x * 3 + y * 5) % 256], -1)
    a = a.astype(np.uint8)
    a[h // 3:h // 2, w // 4:w // 2] = (250, 20, 30)
    return a


def few_colours(h: int, w: int, seed: str = "f") -> np.ndarray:
    """A handful of flat colours in stripes: screen content (palette)."""
    rng = _rng(seed)
    pal = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    idx = (np.add.outer(np.arange(h) // 7, np.arange(w) // 5) +
           (np.arange(w) // 23)[None, :]) % 5
    return pal[idx]


def edges(h: int, w: int) -> np.ndarray:
    """Hard edges at several angles: the directional modes, edge filter
    and upsampling, filter intra."""
    y, x = np.mgrid[0:h, 0:w]
    out = np.zeros((h, w, 3), np.uint8)
    for k, ang in enumerate([0.3, 1.1, 2.0, 2.7, 0.8]):
        m = (np.cos(ang) * x + np.sin(ang) * y) % 40 < 20
        out[..., k % 3] |= (m * (60 + 40 * k)).astype(np.uint8)
    return out


def stripes(h: int, w: int) -> np.ndarray:
    """Saturated stripes at four angles: screen content that libaom codes
    with intra block copy at 4:4:4."""
    y, x = np.mgrid[0:h, 0:w]
    out = np.zeros((h, w, 3), np.uint8)
    for k, ang in enumerate([0.3, 1.1, 2.0, 2.7]):
        m = (np.cos(ang) * x + np.sin(ang) * y) % 40 < 20
        out[..., k % 3] |= (m * 200).astype(np.uint8)
    return out


def gradient(h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(w + h - 2, 1)], -1).astype(np.uint8)


def noise(h: int, w: int, seed: str = "z") -> np.ndarray:
    return _rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def disc_alpha(h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    d = np.hypot(x - w / 2, y - h / 2) / (0.45 * min(h, w))
    return np.clip(255 * (1.3 - d), 0, 255).astype(np.uint8)


def image(arr: np.ndarray, mode: str = "RGB", alpha=None):
    from PIL import Image

    if alpha is not None:
        arr = np.dstack([arr, alpha])
        return Image.fromarray(arr, "RGBA").convert(mode)
    return Image.fromarray(arr, "RGB").convert(mode)


def pil_save(img, **opts) -> bytes:
    out = io.BytesIO()
    img.save(out, "AVIF", **opts)
    return out.getvalue()


# ---- the container -------------------------------------------------------------


def box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), typ) + payload


def fullbox(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(typ, bytes([version]) + flags.to_bytes(3, "big") + payload)


def boxes(data: bytes, start: int = 0, end=None):
    end = len(data) if end is None else end
    out = []
    while start < end:
        size, typ = struct.unpack_from(">I4s", data, start)
        out.append((typ, data[start + 8:start + size]))
        start += size
    return out


class Heif:
    """PIL's AVIF file as items: `items[id] = {"type", "name", "data",
    "props": [[type, payload, essential], ...]}`, `primary`, `refs`
    ([(type, from, [to])]), `brands` (major first); `write()` makes a file
    of them again, as PIL lays it out unless told otherwise."""

    def __init__(self, data: bytes):
        top = dict((t, p) for t, p in boxes(data))
        self.brands = [top[b"ftyp"][0:4]] + [
            top[b"ftyp"][i:i + 4] for i in range(8, len(top[b"ftyp"]), 4)]
        meta = boxes(top[b"meta"], 4)
        self.items, self.refs = {}, []
        props, assoc = [], []
        for typ, p in meta:
            if typ == b"pitm":
                self.primary = struct.unpack_from(">H", p, 4)[0]
            elif typ == b"iinf":
                for _, e in boxes(p, 6):
                    iid, _, ityp = struct.unpack_from(">HH4s", e, 4)
                    self.items[iid] = {"type": ityp, "name": e[12:-1],
                                       "props": []}
            elif typ == b"iloc":
                v = p[0]
                osz, lsz, bsz = p[4] >> 4, p[4] & 15, p[5] >> 4
                pos, n = 8, struct.unpack_from(">H", p, 6)[0]
                locs = {}
                for _ in range(n):
                    iid = struct.unpack_from(">H", p, pos)[0]
                    pos += 2 + (2 if v else 0) + 2
                    base = int.from_bytes(p[pos:pos + bsz], "big")
                    pos += bsz
                    ext = []
                    count = struct.unpack_from(">H", p, pos)[0]
                    pos += 2
                    for _ in range(count):
                        o = int.from_bytes(p[pos:pos + osz], "big")
                        ln = int.from_bytes(p[pos + osz:pos + osz + lsz],
                                            "big")
                        pos += osz + lsz
                        ext.append((base + o, ln))
                    locs[iid] = ext
            elif typ == b"iref":
                for rt, r in boxes(p, 4):
                    src, cnt = struct.unpack_from(">HH", r)
                    self.refs.append((rt, src, list(struct.unpack_from(
                        f">{cnt}H", r, 4))))
            elif typ == b"iprp":
                for ct, c in boxes(p):
                    if ct == b"ipco":
                        props = boxes(c)
                    elif ct == b"ipma":
                        flags = int.from_bytes(c[1:4], "big")
                        pos, n = 8, struct.unpack_from(">I", c, 4)[0]
                        for _ in range(n):
                            iid, k = struct.unpack_from(">HB", c, pos)
                            pos += 3
                            for _ in range(k):
                                if flags & 1:
                                    v = struct.unpack_from(">H", c, pos)[0]
                                    pos += 2
                                    assoc.append((iid, v >> 15, v & 0x7FFF))
                                else:
                                    assoc.append((iid, c[pos] >> 7,
                                                  c[pos] & 0x7F))
                                    pos += 1
        for iid, ess, idx in assoc:
            t, pl = props[idx - 1]
            self.items[iid]["props"].append([t, pl, bool(ess)])
        for iid, ext in locs.items():
            self.items[iid]["data"] = b"".join(data[o:o + n] for o, n in ext)

    def prop(self, iid: int, typ: bytes):
        return next(p for p in self.items[iid]["props"] if p[0] == typ)

    def drop(self, iid: int, typ: bytes) -> "Heif":
        self.items[iid]["props"] = [p for p in self.items[iid]["props"]
                                    if p[0] != typ]
        return self

    def add(self, iid: int, typ: bytes, payload: bytes,
            essential: bool = False) -> "Heif":
        self.items[iid]["props"].append([typ, payload, essential])
        return self

    def alpha_id(self):
        return next((s for t, s, to in self.refs if t == b"auxl"), None)

    def write(self, iloc_version: int = 0, idat: bool = False,
              extents: int = 1, base_offset: bool = False,
              mdat_first: bool = False, large_ipma: bool = False) -> bytes:
        ids = sorted(self.items)
        ftyp = box(b"ftyp", self.brands[0] + b"\0\0\0\0" +
                   b"".join(self.brands[1:]))
        hdlr = fullbox(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 12 +
                       b"\0")
        pitm = fullbox(b"pitm", 0, 0, struct.pack(">H", self.primary))
        infe = b"".join(fullbox(b"infe", 2, 0, struct.pack(
            ">HH4s", i, 0, self.items[i]["type"]) + self.items[i]["name"] +
            b"\0") for i in ids)
        iinf = fullbox(b"iinf", 0, 0, struct.pack(">H", len(ids)) + infe)
        iref = fullbox(b"iref", 0, 0, b"".join(
            box(t, struct.pack(">HH", s, len(to)) + struct.pack(
                f">{len(to)}H", *to)) for t, s, to in self.refs)) \
            if self.refs else b""
        uniq = []
        for i in ids:
            for t, p, _ in self.items[i]["props"]:
                if (t, p) not in uniq:
                    uniq.append((t, p))
        ipco = box(b"ipco", b"".join(box(t, p) for t, p in uniq))
        ent = b""
        for i in ids:
            ps = self.items[i]["props"]
            ent += struct.pack(">HB", i, len(ps))
            for t, p, e in ps:
                k = uniq.index((t, p)) + 1
                ent += (struct.pack(">H", (e << 15) | k) if large_ipma
                        else bytes([(e << 7) | k]))
        ipma = fullbox(b"ipma", 0, 1 if large_ipma else 0,
                       struct.pack(">I", len(ids)) + ent)
        iprp = box(b"iprp", ipco + ipma)
        chunks = []  # (item, piece) in file order
        for i in ids:
            d = self.items[i]["data"]
            cut = [len(d) * k // extents for k in range(extents + 1)]
            chunks += [(i, d[cut[k]:cut[k + 1]]) for k in range(extents)]
        if extents > 1:
            chunks = chunks[::-1]  # each item's extents out of file order

        def make_iloc(offsets) -> bytes:
            osz = lsz = 4
            bsz = 4 if base_offset else 0
            p = bytes([osz << 4 | lsz, bsz << 4])
            p += struct.pack(">H" if iloc_version < 2 else ">I", len(ids))
            for i in ids:
                p += struct.pack(">H" if iloc_version < 2 else ">I", i)
                if iloc_version:
                    p += struct.pack(">H", 1 if idat else 0)
                p += struct.pack(">H", 0)
                if bsz:
                    p += struct.pack(">I", 0)
                mine = [(o, len(c)) for (j, c), o in zip(chunks, offsets)
                        if j == i]
                if extents > 1:
                    mine = mine[::-1]
                p += struct.pack(">H", len(mine))
                for o, n in mine:
                    p += struct.pack(">II", o, n)
            return fullbox(b"iloc", iloc_version, 0, p)

        payload = b"".join(c for _, c in chunks)
        rel = []
        pos = 0
        for _, c in chunks:
            rel.append(pos)
            pos += len(c)
        if idat:
            meta = fullbox(b"meta", 0, 0, hdlr + pitm + make_iloc(rel) + iinf
                           + iref + iprp + box(b"idat", payload))
            return ftyp + meta
        if mdat_first:
            start = len(ftyp) + 8
            mdat = box(b"mdat", payload)
            meta = fullbox(b"meta", 0, 0, hdlr + pitm + make_iloc(
                [start + r for r in rel]) + iinf + iref + iprp)
            return ftyp + mdat + meta
        meta0 = fullbox(b"meta", 0, 0, hdlr + pitm + make_iloc(rel) + iinf +
                        iref + iprp)
        start = len(ftyp) + len(meta0) + 8
        meta = fullbox(b"meta", 0, 0, hdlr + pitm + make_iloc(
            [start + r for r in rel]) + iinf + iref + iprp)
        return ftyp + meta + box(b"mdat", payload)


def obus(data: bytes):
    """An item's OBUs -> [(type, header bytes, payload)]."""
    out, pos = [], 0
    while pos < len(data):
        h = data[pos]
        ext = (h >> 2) & 1
        hl = 1 + ext
        size, k = 0, 0
        while True:
            b = data[pos + hl]
            hl += 1
            size |= (b & 0x7F) << (7 * k)
            k += 1
            if not b & 0x80:
                break
        out.append(((h >> 3) & 15, data[pos:pos + 1 + ext],
                    data[pos + hl:pos + hl + size]))
        pos += hl + size
    return out


def leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def join_obus(parts) -> bytes:
    return b"".join(bytes([h[0] | 2]) + h[1:] + leb128(len(p)) + p
                    for _, h, p in parts)


class Bits:
    """An AV1 header's bits, most significant first."""

    def __init__(self):
        self.bits = []

    def f(self, n: int, v: int) -> None:
        self.bits += [(v >> i) & 1 for i in reversed(range(n))]

    def su(self, n: int, v: int) -> None:
        self.f(n, v & ((1 << n) - 1))

    def ns(self, n: int, v: int) -> None:
        w = n.bit_length()
        m = (1 << w) - n
        if v < m:
            self.f(w - 1, v)
        else:
            self.f(w - 1, (v + m) >> 1)
            self.f(1, (v + m) & 1)

    def align(self) -> None:
        self.bits += [0] * (-len(self.bits) % 8)

    def trailing(self) -> None:
        self.bits.append(1)
        self.align()

    def bytes(self) -> bytes:
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


PROFILES = {"4:2:0": 0, "4:0:0": 0, "4:4:4": 1, "4:2:2": 2}


def _sequence_header(w, h, layout, bits, sb128, full, superres,
                     restoration, op_idc=0, decoder_model=False) -> bytes:
    mono = layout == "4:0:0"
    profile = 2 if bits == 12 else PROFILES[layout]
    seq = Bits()
    seq.f(3, profile)
    seq.f(1, 0 if full else 1)  # still_picture
    seq.f(1, 0 if full else 1)  # reduced_still_picture_header
    if full:
        seq.f(1, 1)  # timing info: equal intervals unless a decoder model
        seq.f(32, 1)
        seq.f(32, 30)
        seq.f(1, not decoder_model)
        if not decoder_model:
            seq.f(1, 1)
        seq.f(1, decoder_model)
        if decoder_model:  # delays and times of 10 bits
            seq.f(5, 9)
            seq.f(32, 1)
            seq.f(5, 9)
            seq.f(5, 9)
        seq.f(1, 1)  # initial display delay
        seq.f(5, 0)  # one operating point: level 9, tier 0
        seq.f(12, op_idc)
        seq.f(5, 9)
        seq.f(1, 0)
        if decoder_model:  # its decoder model's parameters
            seq.f(1, 1)
            seq.f(10, 100)
            seq.f(10, 200)
            seq.f(1, 0)
        seq.f(1, 1)
        seq.f(4, 3)
    else:
        seq.f(5, 0)
    seq.f(4, 15)
    seq.f(4, 15)
    seq.f(16, w - 1)
    seq.f(16, h - 1)
    if full:
        seq.f(1, 1)  # frame ids of 10 bits
        seq.f(4, 5)
        seq.f(3, 2)
    seq.f(1, sb128)
    seq.f(1, 1)  # filter intra
    seq.f(1, 1)  # intra edge filter
    if full:
        seq.f(4, 0)
        seq.f(1, 1)  # order hints of 7 bits
        seq.f(2, 0)
        seq.f(1, 1)  # screen content tools chosen per frame
        seq.f(1, 1)  # and integer motion vectors
        seq.f(3, 6)
    seq.f(1, superres)
    seq.f(1, 0)  # cdef
    seq.f(1, restoration is not None)
    seq.f(1, bits > 8)
    if bits == 12:
        seq.f(1, 1)
    if profile != 1:
        seq.f(1, mono)
    seq.f(1, 1)  # colour description: BT.709 primaries, sRGB, BT.601
    seq.f(8, 1)
    seq.f(8, 13)
    seq.f(8, 6)
    seq.f(1, 1)  # full range
    if not mono:
        if bits == 12:
            seq.f(2, 3)  # 4:2:0
        if layout == "4:2:0":
            seq.f(2, 0)  # chroma_sample_position
        seq.f(1, 0)  # separate_uv_delta_q
    seq.f(1, 0)  # film grain
    seq.trailing()
    return seq.bytes()


def av1_symbols(w: int, h: int, seed: str, q: int = 20, layout="4:2:0",
                bits: int = 8, sb128: bool = False, full: bool = False,
                frame_type: int = 0, sct: bool = True, superres: bool = False,
                qmatrix: bool = False, tiles=None, seg=None,
                delta_lf_multi: bool = False, lf=(12, 10, 8, 6),
                restoration=None, tile_bytes: int = 3000, op_idc: int = 0,
                decoder_model: bool = False, show_existing: bool = False,
                split: bool = False) -> bytes:
    """An AV1 item written by hand: a sequence header and a key frame
    header with the given tools, then tiles of seeded random bytes, which
    the symbol decoder reads as random partitions, skips, modes, palettes,
    segments, deltas and coefficients.  `full`: a full sequence header
    (timing info, frame ids, order hints) and frame header of
    `frame_type`, with `op_idc` the operating point's layers and
    `decoder_model` its decoder model (then a frame header that shows an
    existing frame, if `show_existing`); `tiles`: explicit tile sizes in
    superblocks ([columns], [rows]); `seg`: {(segment, feature): value};
    `restoration`: (types per plane, unit shift, chroma shift); `split`:
    a frame header OBU and a tile group OBU in place of a frame OBU."""
    mono = layout == "4:0:0"
    fr = Bits()
    seq = _sequence_header(w, h, layout, bits, sb128, full, superres,
                           restoration, op_idc, decoder_model)
    if full:
        fr.f(1, show_existing)  # show_existing_frame
        if show_existing:
            fr.f(3, 0)  # frame_to_show_map_idx
            if decoder_model:
                fr.f(10, 1)  # frame_presentation_time
            fr.f(10, 5)  # display_frame_id
            fr.trailing()
            return join_obus([(2, b"\x10", b""), (1, b"\x08", seq),
                              (3, b"\x18", fr.bytes())])
        fr.f(2, frame_type)
        fr.f(1, 1)  # show_frame
        if decoder_model:
            fr.f(10, 1)  # frame_presentation_time
        if frame_type:
            fr.f(1, 0)  # error_resilient_mode
    fr.f(1, 0)  # disable_cdf_update
    fr.f(1, sct)
    if sct:
        fr.f(1, 0)  # force_integer_mv
    if full:
        fr.f(10, 5)  # current_frame_id
        fr.f(1, 0)  # frame_size_override_flag
        fr.f(7, 0)  # order_hint
        if decoder_model:
            fr.f(1, 1)  # buffer_removal_time_present_flag
            if op_idc == 0 or op_idc & 0x101 == 0x101:
                fr.f(10, 50)  # for the operating point
        if frame_type:
            fr.f(8, 1)  # refresh_frame_flags
    if superres:
        fr.f(1, 1)  # a denominator of 9
        fr.f(3, 0)
    fr.f(1, 0)  # render size
    if sct and not superres:
        fr.f(1, 0)  # allow_intrabc
    if full:
        fr.f(1, 1)  # disable_frame_end_update_cdf
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3)
    sh = 5 if sb128 else 4
    sbc = (mi_cols + (1 << sh) - 1) >> sh
    sbr = (mi_rows + (1 << sh) - 1) >> sh
    if tiles is None:
        fr.f(1, 1)  # uniform, one tile
        if _tile_log2(1, sbc):
            fr.f(1, 0)
        if _tile_log2(1, sbr):
            fr.f(1, 0)
        ntiles = 1
    else:
        cols, rows = tiles
        assert sum(cols) == sbc and sum(rows) == sbr
        fr.f(1, 0)
        start = 0
        for c in cols:
            fr.ns(min(sbc - start, 4096 >> (sh + 2)), c - 1)
            start += c
        start = 0
        for r in rows:
            fr.ns(min(sbr - start, max(sbr * sbc // max(cols), 1)), r - 1)
            start += r
        ntiles = len(cols) * len(rows)
        log2 = _tile_log2(1, len(cols)) + _tile_log2(1, len(rows))
        if log2:
            fr.f(log2, 0)  # context_update_tile_id
            fr.f(2, 3)  # tile sizes of 4 bytes
    fr.f(8, q)
    fr.f(1, 0)
    if not mono:
        fr.f(1, 0)
        fr.f(1, 0)
    fr.f(1, qmatrix)
    if qmatrix:
        fr.f(4, 5)
        fr.f(4, 6)
    fr.f(1, seg is not None)
    if seg is not None:
        for i in range(8):
            for j, (nb, signed) in enumerate([(8, 1), (6, 1), (6, 1), (6, 1),
                                              (6, 1), (3, 0), (0, 0), (0, 0)]):
                v = seg.get((i, j))
                fr.f(1, v is not None)
                if v is not None and signed:
                    fr.su(1 + nb, v)
                elif v is not None:
                    fr.f(nb, v)
    fr.f(1, 1)  # delta q of resolution 2
    fr.f(2, 1)
    fr.f(1, 1)  # delta lf of resolution 1
    fr.f(2, 0)
    fr.f(1, delta_lf_multi)
    fr.f(6, lf[0])
    fr.f(6, lf[1])
    if not mono and (lf[0] or lf[1]):
        fr.f(6, lf[2])
        fr.f(6, lf[3])
    fr.f(3, 2)  # sharpness
    fr.f(1, 1)  # the default mode and reference deltas
    fr.f(1, 0)
    if restoration is not None:
        types, shift, uv_shift = restoration
        for t in types:
            fr.f(2, t)
        if any(types):
            if sb128:
                fr.f(1, shift - 1)
            else:
                fr.f(1, shift > 0)
                if shift:
                    fr.f(1, shift - 1)
            if layout == "4:2:0" and any(types[1:]):
                fr.f(1, uv_shift)
    fr.f(1, 1)  # tx_mode_select
    fr.f(1, 0)  # reduced_tx_set
    header = Bits()
    header.bits = list(fr.bits)
    header.trailing()
    fr.align()
    rng = _rng(seed)
    # a frame of several tiles: tile_start_and_end_present_flag 0
    tiles = b"\0" if ntiles > 1 else b""
    for i in range(ntiles):
        t = rng.integers(0, 256, tile_bytes, dtype=np.uint8).tobytes()
        if i < ntiles - 1:
            tiles += (len(t) - 1).to_bytes(4, "little")
        tiles += t
    frame = ([(3, b"\x18", header.bytes()), (4, b"\x20", tiles)] if split
             else [(6, b"\x30", fr.bytes() + tiles)])
    return join_obus([(2, b"\x10", b""), (1, b"\x08", seq)] + frame)


def with_item(data: bytes, item: bytes, bits: int = 8) -> bytes:
    """PIL's file with the primary item's data replaced (and its av1C and
    pixi set to `bits`)."""
    h = Heif(data)
    h.items[h.primary]["data"] = item
    if bits != 8:
        for p in h.items[h.primary]["props"]:
            if p[0] == b"av1C":
                b = bytearray(p[1])
                b[1] = (b[1] & 0x1F) | (2 << 5 if bits == 12 else 0)
                b[2] = (b[2] & 0x9F) | 0x40 | (0x20 if bits == 12 else 0)
                p[1] = bytes(b)
            elif p[0] == b"pixi":
                p[1] = p[1][:5] + bytes([bits] * p[1][4])
    return h.write()


def without_obu(data: bytes, item: int, kind: int) -> bytes:
    h = Heif(data)
    parts = [p for p in obus(h.items[item]["data"]) if p[0] != kind]
    h.items[item]["data"] = join_obus(parts)
    return h.write()


def grid(data_a: bytes, data_b: bytes) -> bytes:
    """A grid item of two tiles side by side (ImageGrid, 16-bit sizes)."""
    a, b = Heif(data_a), Heif(data_b)
    w, h = struct.unpack_from(">II", a.prop(a.primary, b"ispe")[1], 4)
    t1, t2 = a.items[a.primary], b.items[b.primary]
    g = Heif(data_a)
    g.items = {1: dict(t1, props=[list(p) for p in t1["props"]]),
               2: dict(t2, props=[list(p) for p in t2["props"]]),
               3: {"type": b"grid", "name": b"",
                   "data": bytes([0, 0, 0, 1]) + struct.pack(">HH", 2 * w, h),
                   "props": [[b"ispe", b"\0" * 4 + struct.pack(
                       ">II", 2 * w, h), False]] + [
                       list(p) for p in t1["props"] if p[0] in (b"pixi",
                                                               b"colr")]}}
    g.primary, g.refs = 3, [(b"dimg", 3, [1, 2])]
    return g.write()


def heif_edit(data: bytes, fn, **write) -> bytes:
    h = Heif(data)
    fn(h)
    return h.write(**write)


def ispe(w: int, h: int) -> bytes:
    return b"\0" * 4 + struct.pack(">II", w, h)


def clap(wn, wd, hn, hd, hon, hod, von, vod) -> bytes:
    return struct.pack(">IIIIiIiI", wn, wd, hn, hd, hon, hod, von, vod)


def colr_nclx(cp: int, tc: int, mc: int, full: int) -> bytes:
    return b"nclx" + struct.pack(">HHHB", cp, tc, mc, full << 7)


def set_colr(h: Heif, payload: bytes) -> None:
    h.drop(h.primary, b"colr")
    if payload:
        h.add(h.primary, b"colr", payload)


# ---- the cases ---------------------------------------------------------------

def _nat(h=48, w=64, seed="n"):
    return image(natural(h, w, seed))


def _rgba(h=40, w=56):
    return image(natural(h, w, "a"), "RGBA", disc_alpha(h, w))


def _adv(*pairs, img=None, **opts):
    return lambda: pil_save(img() if img else _nat(), advanced=list(pairs),
                            **opts)


_BASE = lambda: pil_save(_nat())  # noqa: E731
_BASE444 = lambda: pil_save(_nat(), subsampling="4:4:4")  # noqa: E731
_BASE_A = lambda: pil_save(_rgba())  # noqa: E731

CASES = {
    # modes PIL saves
    "rgb_420.avif": _BASE,
    "rgb_444.avif": _BASE444,
    "rgb_422.avif": lambda: pil_save(_nat(), subsampling="4:2:2"),
    "rgb_400.avif": lambda: pil_save(_nat(), subsampling="4:0:0"),
    "rgb_420_limited.avif": lambda: pil_save(_nat(), range="limited"),
    "rgb_444_limited.avif": lambda: pil_save(_nat(), subsampling="4:4:4",
                                             range="limited"),
    "rgb_422_limited.avif": lambda: pil_save(_nat(), subsampling="4:2:2",
                                             range="limited"),
    "rgb_400_limited.avif": lambda: pil_save(_nat(), subsampling="4:0:0",
                                             range="limited"),
    "l.avif": lambda: pil_save(_nat().convert("L")),
    "la.avif": lambda: pil_save(_rgba().convert("LA")),
    "p.avif": lambda: pil_save(_nat().convert("P")),
    "pa.avif": lambda: pil_save(_nat().convert("P").convert("PA")),
    "i16.avif": lambda: pil_save(_nat().convert("L").convert("I;16")),
    "cmyk.avif": lambda: pil_save(_nat().convert("CMYK")),
    "rgba.avif": _BASE_A,
    "rgba_444.avif": lambda: pil_save(_rgba(), subsampling="4:4:4"),
    "rgba_400.avif": lambda: pil_save(_rgba(), subsampling="4:0:0"),
    "rgba_limited.avif": lambda: pil_save(_rgba(), range="limited"),
    "rgba_premultiplied.avif": lambda: pil_save(_rgba(),
                                                alpha_premultiplied=True),
    "rgba_premultiplied_444.avif": lambda: pil_save(
        _rgba(), subsampling="4:4:4", alpha_premultiplied=True),
    "la_premultiplied.avif": lambda: pil_save(_rgba().convert("LA"),
                                              alpha_premultiplied=True),
    "rgba_opaque.avif": lambda: pil_save(image(natural(24, 40), "RGBA",
                                               np.full((24, 40), 255,
                                                       np.uint8))),
    # quality and speed
    "q0.avif": lambda: pil_save(_nat(), quality=0),
    "q30.avif": lambda: pil_save(_nat(), quality=30),
    "q90.avif": lambda: pil_save(_nat(), quality=90),
    "q100.avif": lambda: pil_save(_nat(), quality=100),
    "q100_444.avif": lambda: pil_save(_nat(), quality=100,
                                      subsampling="4:4:4"),
    "speed0.avif": lambda: pil_save(_nat(96, 80), speed=0),
    "speed0_444.avif": lambda: pil_save(_nat(72, 88), speed=0,
                                        subsampling="4:4:4"),
    "speed2.avif": lambda: pil_save(_nat(), speed=2),
    "speed4.avif": lambda: pil_save(_nat(), speed=4),
    "speed8.avif": lambda: pil_save(_nat(), speed=8),
    "speed10.avif": lambda: pil_save(_nat(), speed=10),
    # content
    "few_colours.avif": lambda: pil_save(image(few_colours(64, 72))),
    "few_colours_444.avif": lambda: pil_save(image(few_colours(48, 40, "g")),
                                             subsampling="4:4:4"),
    "edges.avif": lambda: pil_save(image(edges(80, 96))),
    "edges_q80.avif": lambda: pil_save(image(edges(64, 64)), quality=80),
    "gradient.avif": lambda: pil_save(image(gradient(70, 90))),
    "noise.avif": lambda: pil_save(image(noise(40, 48))),
    "noise_q95_444.avif": lambda: pil_save(image(noise(24, 32, "y")),
                                           quality=95, subsampling="4:4:4"),
    # sizes
    "size_1x1.avif": lambda: pil_save(_nat(1, 1)),
    "size_1x37.avif": lambda: pil_save(_nat(1, 37)),
    "size_29x1.avif": lambda: pil_save(_nat(29, 1)),
    "size_13x31.avif": lambda: pil_save(_nat(13, 31)),
    "size_127x65.avif": lambda: pil_save(_nat(127, 65)),
    "size_129x66.avif": lambda: pil_save(_nat(129, 66), speed=8),
    "size_17x257.avif": lambda: pil_save(_nat(17, 257)),
    "size_5x3_444.avif": lambda: pil_save(_nat(5, 3), subsampling="4:4:4"),
    # tiles
    "tiles_2x2.avif": lambda: pil_save(_nat(160, 192), tile_rows=1,
                                       tile_cols=1, speed=8),
    "tiles_1x4.avif": lambda: pil_save(_nat(72, 300), tile_cols=2,
                                       speed=9),
    "autotiling.avif": lambda: pil_save(_nat(64, 96), autotiling=True),
    # libaom's options in the decoder's scope
    "aq_mode1.avif": _adv(("aq-mode", "1")),
    "deltaq_mode1.avif": _adv(("deltaq-mode", "1")),
    "deltaq_mode3_delta_lf.avif": _adv(("deltaq-mode", "3"),
                                       ("delta-lf-mode", "1"),
                                       img=lambda: _nat(256, 256)),
    "cdf_update0.avif": _adv(("cdf-update-mode", "0")),
    "cdf_update2.avif": _adv(("cdf-update-mode", "2")),
    "reduced_tx_set.avif": _adv(("reduced-tx-type-set", "1")),
    "no_tx64.avif": _adv(("enable-tx64", "0"),
                         img=lambda: image(gradient(128, 128))),
    "tx64.avif": _adv(("enable-tx64", "1"),
                      img=lambda: image(gradient(128, 128))),
    "palette.avif": _adv(("enable-palette", "1"),
                         img=lambda: image(few_colours(40, 56, "p"))),
    "no_filter_intra.avif": _adv(("enable-filter-intra", "0")),
    "no_cfl.avif": _adv(("enable-cfl-intra", "0")),
    "sharpness7.avif": _adv(("sharpness", "7")),
    "restoration.avif": _adv(("enable-restoration", "1"),
                             img=lambda: _nat(80, 72), speed=0),
    "sb128.avif": _adv(("sb-size", "128"), img=lambda: _nat(136, 144)),
    "sb64.avif": _adv(("sb-size", "64")),
    "no_smooth.avif": _adv(("enable-smooth-intra", "0")),
    "no_paeth.avif": _adv(("enable-paeth-intra", "0")),
    # rewraps PIL opens
    "iloc_v1.avif": lambda: Heif(_BASE()).write(iloc_version=1),
    "iloc_v2.avif": lambda: Heif(_BASE_A()).write(iloc_version=2),
    "idat.avif": lambda: Heif(_BASE()).write(iloc_version=1, idat=True),
    "extents.avif": lambda: Heif(_BASE_A()).write(extents=3),
    "base_offset.avif": lambda: Heif(_BASE()).write(base_offset=True),
    "mdat_first.avif": lambda: Heif(_BASE()).write(mdat_first=True),
    "ipma_large.avif": lambda: Heif(_BASE()).write(large_ipma=True),
    "brand_mif1.avif": lambda: heif_edit(_BASE(), lambda h: setattr(
        h, "brands", [b"mif1", b"avif", b"mif1", b"miaf"])),
    "colr_icc.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, b"prof" + _icc())),
    "colr_none.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(h, b"")),
    "colr_none_limited.avif": lambda: heif_edit(
        pil_save(_nat(), range="limited"), lambda h: set_colr(h, b"")),
    "colr_bt709.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, colr_nclx(1, 1, 1, 1))),
    "colr_bt709_limited.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, colr_nclx(1, 1, 1, 0))),
    "colr_bt2020.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, colr_nclx(9, 16, 9, 1))),
    "colr_bt2020_limited_422.avif": lambda: heif_edit(pil_save(
        _nat(), subsampling="4:2:2"), lambda h: set_colr(
        h, colr_nclx(9, 16, 9, 0))),
    "colr_unspecified.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, colr_nclx(2, 2, 2, 1))),
    "colr_bt470bg_limited.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, colr_nclx(5, 6, 5, 0))),
    "colr_identity_444.avif": lambda: heif_edit(_BASE444(), lambda h: set_colr(
        h, colr_nclx(1, 13, 0, 1))),
    "colr_identity_444_limited.avif": lambda: heif_edit(
        _BASE444(), lambda h: set_colr(h, colr_nclx(1, 13, 0, 0))),
    "colr_range_flipped.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, colr_nclx(1, 13, 6, 0))),
    "clap_irot_imir.avif": lambda: heif_edit(_BASE(), lambda h: (
        h.add(h.primary, b"clap", clap(32, 1, 24, 1, 0, 1, 0, 1), True),
        h.add(h.primary, b"irot", b"\x01", True),
        h.add(h.primary, b"imir", b"\x01", True))),
    "irot3.avif": lambda: heif_edit(_BASE_A(), lambda h: h.add(
        h.primary, b"irot", b"\x03", True)),
    "unknown_property.avif": lambda: heif_edit(_BASE(), lambda h: h.add(
        h.primary, b"xyzw", b"\0\0\0\0", False)),
    "clap_past_the_image.avif": lambda: heif_edit(_BASE(), lambda h: h.add(
        h.primary, b"clap", clap(70, 1, 24, 1, 0, 1, 0, 1), True)),
    "clap_odd_offset.avif": lambda: heif_edit(_BASE(), lambda h: h.add(
        h.primary, b"clap", clap(31, 1, 24, 1, 1, 2, 0, 1), True)),
    "no_pixi.avif": lambda: heif_edit(_BASE_A(), lambda h: (
        h.drop(h.primary, b"pixi"), h.drop(h.alpha_id(), b"pixi"))),
    # AV1 streams written by hand (av1_symbols): the tools libaom does not
    # write for PIL, on random symbols
    "symbols_segments_preskip.avif": lambda: _symbols(seg=_SEG_PRESKIP),
    "symbols_segments.avif": lambda: _symbols(seg=_SEG),
    "symbols_explicit_tiles.avif": lambda: with_item(
        pil_save(_nat(128, 192)), av1_symbols(
            192, 128, "symbols_explicit_tiles", tiles=([1, 2], [1, 1]),
            delta_lf_multi=True, tile_bytes=1500)),
    "symbols_full_header.avif": lambda: _symbols(full=True),
    "symbols_decoder_model.avif": lambda: _symbols(full=True,
                                                   decoder_model=True),
    # a 4:2:2 sequence header after a 4:2:0 frame: dav1d parses it and
    # decodes the frame under the first
    "symbols_sequence_header_after_frame.avif": lambda: _reordered(
        lambda a, b, s: a + [b[1]]),
    # a frame header OBU twice (dav1d parses it anew), the same sequence
    # header again, then the tile group OBU
    "symbols_frame_header_obus.avif": lambda: _reordered(
        lambda a, b, s: s[:3] + [s[2], a[1]] + s[3:]),
}

# segment features (SEG_LVL_ALT_Q, ALT_LF_Y_V .. ALT_LF_V, REF_FRAME, SKIP):
# with a skip or reference feature the segment is read before the skip flag
_SEG_PRESKIP = {(0, 0): -12, (1, 1): 9, (1, 2): -9, (2, 3): 7, (2, 4): -7,
                (3, 0): 25, (4, 6): 0}
_SEG = {(0, 0): -12, (1, 1): 9, (2, 2): -9, (3, 3): 20, (3, 4): -20,
        (4, 0): 25}


def _symbols(name=None, bits=8, **tools) -> bytes:
    seed = name or repr(sorted(tools.items()))
    return with_item(pil_save(_nat(96, 128)), av1_symbols(
        128, 96, seed, bits=bits, tile_bytes=1500, **tools), bits)


def _reordered(make) -> bytes:
    """PIL's file with an item of OBUs rearranged by `make(a, b, s)` from
    three hand-written items of the same symbols, each [temporal delimiter,
    sequence header, frame ...]: `a` 4:2:0, `b` 4:2:2 (another profile),
    `s` 4:2:0 with a frame header OBU and a tile group OBU for the frame."""
    def item(**tools):
        return obus(av1_symbols(128, 96, "reordered", tile_bytes=1500,
                                **tools))
    parts = make(item(), item(layout="4:2:2"), item(split=True))
    return with_item(pil_save(_nat(96, 128)), join_obus(parts))


def _level_1(part):
    """A reduced sequence header OBU of seq_level_idx 0 with 1 instead."""
    kind, head, seq = part
    return kind, head, seq[:1] + bytes([seq[1] | 0x40]) + seq[2:]


def _icc() -> bytes:
    """littleCMS's sRGB profile with its creation date zeroed, so the file
    is the same on every run (libavif hands the profile over unread)."""
    from PIL import ImageCms

    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    return icc[:24] + bytes(12) + icc[36:]


def _truncated() -> bytes:
    d = _BASE()
    return d[:len(d) - 40]


def _corrupt_tile() -> bytes:
    h = Heif(_BASE())
    d = bytearray(h.items[h.primary]["data"])
    for k in range(len(d) - 30, len(d), 3):
        d[k] ^= 0x5A
    h.items[h.primary]["data"] = bytes(d)
    return h.write()


UNPORTED_CASES = {
    "unported_intrabc.avif": lambda: pil_save(image(stripes(140, 100)),
                                              subsampling="4:4:4"),
    "unported_cdef.avif": _adv(("enable-cdef", "1")),
    "unported_film_grain.avif": _adv(("film-grain-test", "1")),
    "unported_sequence.avif": lambda: _sequence(),
    "unported_grid.avif": lambda: grid(pil_save(_nat(64, 64)),
                                       pil_save(_nat(64, 64, "m"))),
    "unported_ispe_mismatch.avif": lambda: heif_edit(_BASE(), lambda h: (
        h.drop(h.primary, b"ispe"), h.add(h.primary, b"ispe", ispe(60, 48)))),
    "unported_intra_only_frame.avif": lambda: _symbols(full=True,
                                                       frame_type=2),
    "unported_superres.avif": lambda: _symbols(superres=True),
    "unported_qmatrix.avif": lambda: _symbols(qmatrix=True),
    "unported_10bit.avif": lambda: _symbols(bits=10),
    "unported_12bit.avif": lambda: _symbols(bits=12),
    "unported_segmentation_without_features.avif": lambda: _symbols(seg={}),
    "unported_scalable.avif": lambda: _symbols(full=True, op_idc=0x101),
    "unported_two_frames.avif": lambda: _reordered(lambda a, b, s: a + a[2:]),
    "unported_colr_bt2020_cl.avif": lambda: heif_edit(
        _BASE(), lambda h: set_colr(h, colr_nclx(9, 16, 12, 1))),
    "unported_identity_premultiplied_limited.avif": lambda: heif_edit(
        pil_save(_rgba(), subsampling="4:4:4", alpha_premultiplied=True),
        lambda h: set_colr(h, colr_nclx(1, 13, 0, 0))),
}


def _sequence() -> bytes:
    out = io.BytesIO()
    a, b = _nat(32, 40), _nat(32, 40, "s")
    a.save(out, "AVIF", save_all=True, append_images=[b])
    data = bytearray(out.getvalue())
    # the creation and modification times, so the file is the same on
    # every run
    for typ in (b"mvhd", b"tkhd", b"mdhd"):
        i = data.find(typ)
        while i >= 0:
            n = 16 if data[i + 4] == 1 else 8
            data[i + 8:i + 8 + n] = bytes(n)
            i = data.find(typ, i + 1)
    return bytes(data)


REFUSED_CASES = {
    "refused_no_ispe.avif": lambda: heif_edit(_BASE(), lambda h: h.drop(
        h.primary, b"ispe")),
    "refused_no_av1c.avif": lambda: heif_edit(_BASE(), lambda h: h.drop(
        h.primary, b"av1C")),
    "refused_alpha_no_ispe.avif": lambda: heif_edit(_BASE_A(), lambda h: h.drop(
        h.alpha_id(), b"ispe")),
    "refused_clap_not_essential.avif": lambda: heif_edit(_BASE(), lambda h: h.add(
        h.primary, b"clap", clap(32, 1, 24, 1, 0, 1, 0, 1))),
    "refused_colr_identity_420.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, colr_nclx(1, 13, 0, 1))),
    "refused_unknown_essential.avif": lambda: heif_edit(_BASE(), lambda h: h.add(
        h.primary, b"xyzw", b"\0\0\0\0", True)),
    "refused_truncated.avif": _truncated,
    "refused_corrupt_tile.avif": _corrupt_tile,
    "refused_no_sequence_header.avif": lambda: without_obu(
        _BASE(), 1, 1),
    "refused_no_avif_brand.avif": lambda: heif_edit(_BASE(), lambda h: setattr(
        h, "brands", [b"mif1", b"mif1", b"miaf"])),
    "refused_handler.avif": lambda: _handler(b"vide"),
    "refused_colr_ycgco.avif": lambda: heif_edit(_BASE(), lambda h: set_colr(
        h, colr_nclx(1, 13, 8, 0))),
    # another sequence header between the frame header and its tiles (the
    # same but for its level, under which the tiles would decode): dav1d
    # drops the frame header
    "refused_sequence_header_mid_frame.avif": lambda: _reordered(
        lambda a, b, s: s[:3] + [_level_1(s[1])] + s[3:]),
    # no frame decoded before it to show
    "refused_show_existing_frame.avif": lambda: _symbols(full=True,
                                                         show_existing=True),
}


def _handler(kind: bytes) -> bytes:
    d = _BASE()
    i = d.find(b"pict")
    return d[:i] + kind + d[i + 4:]


def _frame(i: int):
    from PIL import Image

    with Image.open(os.path.join(JPEG_FRAMES, f"frame_{i:05d}.jpg")) as im:
        return im.convert("RGB")


# the five 800x800 frames chip_smoke.py times: name -> (frame, writer)
FRAMES = {
    "frame_default.avif": (0, lambda im: pil_save(im)),
    "frame_speed0.avif": (1, lambda im: pil_save(im, speed=0)),
    "frame_q100_444.avif": (2, lambda im: pil_save(im, quality=100,
                                                   subsampling="4:4:4")),
    "frame_rgba_disc.avif": (3, lambda im: pil_save(image(
        np.asarray(im), "RGBA", disc_alpha(800, 800)))),
    "frame_400.avif": (4, lambda im: pil_save(im, subsampling="4:0:0")),
}
DIGESTS = os.path.join(HERE, "digests.json")
# files AvifImagePlugin._accept takes whose _open declines them (Image.open
# goes on to the next plugin); the tests write them, they are not committed
NEAR_MISSES = {
    "ftyp_only": lambda: box(b"ftyp", b"avif\0\0\0\0avifmif1"),
    "mif1_without_avif": lambda: box(b"ftyp", b"mif1\0\0\0\0mif1miaf") +
    _after_ftyp(_BASE()),
    "meta_cut": lambda: _BASE()[:200],
    "hdlr_not_first": lambda: _swap_hdlr(_BASE()),
}


def _after_ftyp(data: bytes) -> bytes:
    return data[struct.unpack_from(">I", data)[0]:]


def _swap_hdlr(data: bytes) -> bytes:
    top = boxes(data)
    meta = dict(top)[b"meta"]
    kids = boxes(meta, 4)
    kids = kids[1:2] + kids[:1] + kids[2:]
    body = meta[:4] + b"".join(box(t, p) for t, p in kids)
    return b"".join(box(t, body if t == b"meta" else p) for t, p in top)


def fixture_name(name: str) -> str:
    return name


def case_bytes(name: str) -> bytes:
    return {**CASES, **UNPORTED_CASES, **REFUSED_CASES}[name]()


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def pil_result(path: str):
    """-> ("ok", digest) or ("error", "Type: message") as PIL gives it."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            return "ok", digest(img.mode, np.asarray(img))
    except Exception as e:  # noqa: BLE001 - PIL's refusal, recorded
        return "error", f"{type(e).__name__}: " + str(e).replace(
            path, os.path.basename(path))


def main() -> None:
    from PIL import Image

    for old in glob.glob(os.path.join(HERE, "*.avif")):
        os.unlink(old)
    files, refused = {}, {}
    for name in {**CASES, **UNPORTED_CASES, **REFUSED_CASES}:
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(case_bytes(name))
        kind, what = pil_result(path)
        if kind == "ok":
            if name in REFUSED_CASES:
                raise RuntimeError(f"{name}: PIL opens it")
            files[name] = what
        else:
            if name not in REFUSED_CASES:
                raise RuntimeError(f"{name}: {what}")
            refused[name] = what
    for name, (i, write) in FRAMES.items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(write(_frame(i)))
        files[name] = pil_result(path)[1]
    with open(DIGESTS, "w") as f:
        json.dump({"pil": Image.__version__, "files": files,
                   "refused": refused}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    main()
