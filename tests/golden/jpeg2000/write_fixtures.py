"""Write the JPEG 2000 fixtures of rsn_torch.data.jpeg2000 and their
digests (PIL 12.1.0 with its OpenJPEG 2.5.4).

    python tests/golden/jpeg2000/write_fixtures.py

Three writers make the files:

- PIL's own `save` (`pil_save`): every option Jpeg2KImagePlugin takes
  (modes L, LA, RGB, RGBA, I;16, CMYK; `.jp2` or raw `.j2k`;
  irreversible, quality layers by rate or dB, resolutions, code-block
  and precinct sizes, the five progressions, tiles and offsets, mct,
  signed, plt, comment);
- OpenJPEG's encoder through ctypes (`opj_encode`), over the library
  PIL loads, for what `save` cannot ask for: code-block styles (bypass,
  reset, termall, vertically causal, predictable termination,
  segmentation symbols), ROI shifts, SOP / EPH, subsampled components,
  precisions other than 8 and 16, signed components, tile-parts, POC,
  TLM; its `opj_cparameters_t` is written by int32 index (the layout of
  openjpeg.h 2.5: numresolution, cblockw_init and cblockh_init at
  1400-1402, roi_compno at 1405);
- `struct` rewraps of those codestreams (`jp2`, `box`): JP2 headers
  with `pclr` / `cmap` (P, PA), `colr` sYCC, gray, CMYK, ICC and unknown
  ones, the `jpx ` brand, `res `, boxes PIL and OpenJPEG pass over,
  packet headers moved to PPM / PPT, COC / QCC / CRG / PLM markers, and
  tile-parts of several tiles interleaved.

CASES are committed with PIL's mode, shape, dtype and sha256 of
np.asarray in digests.json; REFUSED_CASES with PIL's error; FRAMES are
the five 800x800 frames of tests/golden/jpeg/ as JPEG 2000, which
chip_smoke.py times.  NEAR_MISSES are written by the tests and not
committed.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_FRAMES = os.path.join(os.path.dirname(HERE), "jpeg")

# ---- OpenJPEG's encoder through ctypes -------------------------------------

# opj_cparameters_t fields by int32 index (openjpeg.h 2.5, x86-64)
P_TILE_ON, P_TX0, P_TY0, P_TDX, P_TDY, P_DISTO_ALLOC = 0, 1, 2, 3, 4, 5
P_CSTY, P_PROG, P_POC, POC_INTS = 12, 13, 14, 37
P_NUMPOCS, P_NUMLAYERS, P_RATES = 1198, 1199, 1200
P_NUMRES, P_CBW, P_CBH, P_MODE, P_IRREV, P_ROI_COMP, P_ROI_SHIFT = (
    1400, 1401, 1402, 1403, 1404, 1405, 1406)
P_RES_SPEC, P_PRCW, P_PRCH = 1407, 1408, 1441
P_OFFSET_X, P_OFFSET_Y = 4547, 4548
B_TP_ON, B_TP_FLAG, B_MCT = 18696, 18697, 18698  # byte offsets
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
SPACES = {"srgb": 1, "gray": 2, "sycc": 3, "cmyk": 5, "unspecified": 0}


def _openjpeg():
    from PIL import __file__ as pil_init
    libs = os.path.join(os.path.dirname(os.path.dirname(pil_init)),
                        "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libopenjp2-*.so*"))[0])
    vp = ctypes.c_void_p
    for name, res, args in [
            ("opj_create_compress", vp, [ctypes.c_int]),
            ("opj_set_default_encoder_parameters", None, [vp]),
            ("opj_image_create", vp, [ctypes.c_uint32, vp, ctypes.c_int]),
            ("opj_setup_encoder", ctypes.c_int, [vp, vp, vp]),
            ("opj_encoder_set_extra_options", ctypes.c_int,
             [vp, ctypes.POINTER(ctypes.c_char_p)]),
            ("opj_stream_create_default_file_stream", vp,
             [ctypes.c_char_p, ctypes.c_int]),
            ("opj_start_compress", ctypes.c_int, [vp, vp, vp]),
            ("opj_encode", ctypes.c_int, [vp, vp]),
            ("opj_end_compress", ctypes.c_int, [vp, vp]),
            ("opj_stream_destroy", None, [vp]),
            ("opj_destroy_codec", None, [vp]),
            ("opj_image_destroy", None, [vp])]:
        f = getattr(lib, name)
        f.restype, f.argtypes = res, args
    return lib


def opj_encode(planes, dx=None, dy=None, prec=8, sgnd=False, space="srgb",
               jp2=False, offset=(0, 0), tile=None, tile_offset=(0, 0),
               numres=6, cblk=(64, 64), precincts=None, mode=0,
               irreversible=False, rates=(0,), prog="LRCP", sop=False,
               eph=False, roi=None, mct=None, tile_parts=None, pocs=(),
               options=()) -> bytes:
    """One codestream (or JP2 file) from OpenJPEG's encoder: `planes` a
    list of int arrays (one per component, each its own size), `dx` /
    `dy` their subsampling, `prec` / `sgnd` per component or for all,
    `mode` the code-block style bits, `roi` (component, shift), `pocs`
    a list of (resno0, compno0, layno1, resno1, compno1, progression),
    `tile_parts` 'R', 'L' or 'C', `options` opj_encoder_set_extra_options'
    strings (b"TLM=YES", b"PLT=YES")."""
    lib = _openjpeg()
    n = len(planes)
    dx = dx or [1] * n
    dy = dy or [1] * n
    prec = prec if isinstance(prec, (list, tuple)) else [prec] * n
    sgnd = sgnd if isinstance(sgnd, (list, tuple)) else [sgnd] * n
    h0, w0 = planes[0].shape
    x0, y0 = offset
    x1, y1 = x0 + (w0 - 1) * dx[0] + 1, y0 + (h0 - 1) * dy[0] + 1
    parms = (ctypes.c_uint32 * (9 * n))()
    for i, p in enumerate(planes):
        h, w = p.shape
        assert (w, h) == (-(-x1 // dx[i]) - -(-x0 // dx[i]),
                          -(-y1 // dy[i]) - -(-y0 // dy[i])), (i, w, h)
        parms[9 * i:9 * i + 9] = [dx[i], dy[i], w, h, x0, y0, prec[i], 0,
                                  int(sgnd[i])]
    image = lib.opj_image_create(n, ctypes.addressof(parms), SPACES[space])
    hdr = (ctypes.c_uint32 * 4).from_address(image)
    hdr[:] = [x0, y0, x1, y1]
    comps = ctypes.c_void_p.from_address(image + 24).value
    for i, p in enumerate(planes):
        data = ctypes.c_void_p.from_address(comps + 64 * i + 48).value
        flat = np.ascontiguousarray(p, np.int32).ravel()
        ctypes.memmove(data, flat.ctypes.data, flat.nbytes)
    buf = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_encoder_parameters(buf)
    i32 = (ctypes.c_int32 * (1 << 14)).from_buffer(buf)
    f32 = (ctypes.c_float * (1 << 14)).from_buffer(buf)
    if tile:
        i32[P_TILE_ON], i32[P_TDX], i32[P_TDY] = 1, tile[0], tile[1]
        i32[P_TX0], i32[P_TY0] = tile_offset
    i32[P_OFFSET_X], i32[P_OFFSET_Y] = offset
    i32[P_DISTO_ALLOC] = 1
    i32[P_NUMLAYERS] = len(rates)
    for k, r in enumerate(rates):
        f32[P_RATES + k] = r
    # as PIL's encoder does: no more resolutions than the tile can hold
    tw, th = tile or (x1 - x0, y1 - y0)
    while numres > 1 and (tw < 1 << (numres - 1) or th < 1 << (numres - 1)):
        numres -= 1
    i32[P_NUMRES] = numres
    i32[P_CBW], i32[P_CBH] = cblk
    i32[P_MODE] = mode
    i32[P_IRREV] = int(irreversible)
    i32[P_PROG] = PROGRESSIONS[prog]
    csty = (2 if sop else 0) | (4 if eph else 0)
    if precincts:
        csty |= 1
        i32[P_RES_SPEC] = len(precincts)
        for k, (pw, ph) in enumerate(precincts):
            i32[P_PRCW + k], i32[P_PRCH + k] = pw, ph
    i32[P_CSTY] = csty
    if roi:
        i32[P_ROI_COMP], i32[P_ROI_SHIFT] = roi
    buf[B_MCT] = bytes([int(mct if mct is not None else n >= 3)])
    if tile_parts:
        buf[B_TP_ON], buf[B_TP_FLAG] = b"\x01", tile_parts.encode()
    for k, (r0, c0, l1, r1, c1, pg) in enumerate(pocs):
        base = P_POC + POC_INTS * k
        i32[base:base + 5] = [r0, c0, l1, r1, c1]
        i32[base + 8] = PROGRESSIONS[pg]
        i32[base + 12] = 1  # the tile (1-based)
    i32[P_NUMPOCS] = len(pocs)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    # OpenJPEG's file stream writes outside the fixture folder
    out = os.path.join(tempfile.gettempdir(), f"rsn-opj-encode-{os.getpid()}")
    stream = None
    try:
        if not lib.opj_setup_encoder(codec, buf, image):
            raise RuntimeError("opj_setup_encoder failed")
        if options:
            arr = (ctypes.c_char_p * (len(options) + 1))(*options, None)
            if not lib.opj_encoder_set_extra_options(codec, arr):
                raise RuntimeError("opj_encoder_set_extra_options failed")
        stream = lib.opj_stream_create_default_file_stream(out.encode(), 0)
        if not (lib.opj_start_compress(codec, image, stream)
                and lib.opj_encode(codec, stream)
                and lib.opj_end_compress(codec, stream)):
            raise RuntimeError("OpenJPEG's encoder failed")
        lib.opj_stream_destroy(stream)
        stream = None
        with open(out, "rb") as f:
            return f.read()
    finally:
        if stream:
            lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        if os.path.exists(out):
            os.unlink(out)


# ---- PIL's writer and the pixels ---------------------------------------------

def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(int.from_bytes(
        hashlib.sha256(name.encode()).digest()[:8], "little"))


def values(h: int, w: int, ch: int, name: str, bits: int = 8) -> np.ndarray:
    """A smooth field with noise: what a codec meets in a frame."""
    g = _rng(name)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for c in range(ch):
        a, b = g.uniform(0.05, 0.4, 2)
        v = 0.5 + 0.35 * np.sin(a * xx + b * yy + c) + g.normal(0, 0.05, (h, w))
        out.append(np.clip(v, 0, 1) * ((1 << bits) - 1))
    return np.rint(np.stack(out, -1)).astype(np.int64)


def source(mode: str, w: int, h: int, name: str):
    from PIL import Image

    if mode == "I;16":
        v = values(h, w, 1, name, 16)[..., 0].astype("<u2")
        return Image.frombytes("I;16", (w, h), v.tobytes())
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    return Image.frombytes(mode, (w, h),
                           values(h, w, ch, name).astype(np.uint8).tobytes())


def pil_save(mode: str, w: int, h: int, ext: str, name: str, **opts) -> bytes:
    out = io.BytesIO()
    source(mode, w, h, name).save(out, "JPEG2000", no_jp2=ext == "j2k",
                                  **opts)
    return out.getvalue()


def planes(h: int, w: int, n: int, name: str, prec: int = 8,
           sgnd: bool = False, dx=None, dy=None, offset=(0, 0)):
    """n components of a (w, h) reference grid (subsampled by dx / dy)
    in [0, 2**prec) or, signed, [-2**(prec-1), 2**(prec-1))."""
    dx, dy = dx or [1] * n, dy or [1] * n
    x0, y0 = offset
    x1, y1 = x0 + (w - 1) * dx[0] + 1, y0 + (h - 1) * dy[0] + 1
    out = []
    for k in range(n):
        cw = -(-x1 // dx[k]) - -(-x0 // dx[k])
        ch = -(-y1 // dy[k]) - -(-y0 // dy[k])
        v = values(ch, cw, 1, f"{name}/{k}", prec)[..., 0]
        out.append(v - (1 << (prec - 1)) if sgnd else v)
    return out


# ---- struct rewraps ----------------------------------------------------------

def box(tbox: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), tbox) + payload


def ihdr(h: int, w: int, nc: int, bpc: int = 7) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs: int = 16, meth: int = 1) -> bytes:
    if meth == 1:
        return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return box(b"colr", struct.pack(">BBB", meth, 0, 0) + bytes(24))


def pclr(entries, depths=(7, 7, 7)) -> bytes:
    body = struct.pack(">HB", len(entries), len(depths)) + bytes(depths)
    for e in entries:
        for v, d in zip(e, depths):
            body += v.to_bytes(((d & 0x7F) + 8) // 8, "big")
    return box(b"pclr", body)


def cmap(n: int = 3) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                 for i in range(n)))


SIGNATURE = box(b"jP  ", b"\r\n\x87\n")


def ftyp(brand: bytes = b"jp2 ") -> bytes:
    return box(b"ftyp", brand + bytes(4) + b"jp2 ")


def jp2(cs: bytes, h: int, w: int, nc: int, header=(), brand=b"jp2 ",
        before=b"", after=b"", xl=False, bpc: int = 7) -> bytes:
    """A JP2 file around a codestream: `header` the jp2h boxes after
    ihdr, `before` / `after` top-level boxes around the codestream's."""
    c = (struct.pack(">I4sQ", 1, b"jp2c", 16 + len(cs)) + cs if xl
         else box(b"jp2c", cs))
    return (SIGNATURE + ftyp(brand) + before
            + box(b"jp2h", ihdr(h, w, nc, bpc) + b"".join(header)) + c + after)


def codestream(data: bytes) -> bytes:
    if data[:2] == b"\xff\x4f":
        return data
    i = data.index(b"jp2c")
    xl = struct.unpack_from(">I", data, i - 4)[0] == 1
    return data[i + 12 if xl else i + 4:]


def main_header(cs: bytes):
    """-> ([(marker, segment)] from SIZ to the first SOT, the rest)."""
    pos, segs = 2, []
    while True:
        m, = struct.unpack_from(">H", cs, pos)
        if m == 0xFF90:
            return segs, cs[pos:]
        n, = struct.unpack_from(">H", cs, pos + 2)
        segs.append((m, cs[pos + 4:pos + 2 + n]))
        pos += 2 + n


def tile_parts(rest: bytes):
    """The tile-parts after the main header -> [[isot, tpsot, tnsot,
    header segments, body]] and what follows them (EOC)."""
    parts, pos = [], 0
    while rest[pos:pos + 2] == b"\xff\x90" and len(rest) >= pos + 12:
        isot, psot, tp, tn = struct.unpack_from(">HIBB", rest, pos + 4)
        psot = psot or len(rest) - 2 - pos  # 0: the last, up to EOC
        q, segs = pos + 12, []
        while True:
            m, = struct.unpack_from(">H", rest, q)
            if m == 0xFF93:
                break
            n, = struct.unpack_from(">H", rest, q + 2)
            segs.append((m, rest[q + 4:q + 2 + n]))
            q += 2 + n
        parts.append([isot, tp, tn, segs, rest[q + 2:pos + psot]])
        pos += psot
    return parts, rest[pos:]


def segment(m: int, body: bytes) -> bytes:
    return struct.pack(">HH", m, len(body) + 2) + body


def build(main, parts, tail=b"\xff\xd9", psot_zero_last=False) -> bytes:
    out = b"\xff\x4f" + b"".join(segment(m, b) for m, b in main)
    for k, (isot, tp, tn, segs, body) in enumerate(parts):
        head = b"".join(segment(m, b) for m, b in segs)
        psot = 12 + len(head) + 2 + len(body)
        if psot_zero_last and k == len(parts) - 1:
            psot = 0
        out += (struct.pack(">HHHIBB", 0xFF90, 10, isot, psot, tp, tn) + head
                + b"\xff\x93" + body)
    return out + tail


def rewrite(cs: bytes, main_fn=None, parts_fn=None, **kw) -> bytes:
    main, rest = main_header(cs)
    parts, tail = tile_parts(rest)
    main = main_fn(main) if main_fn else main
    parts = parts_fn(parts) if parts_fn else parts
    return build(main, parts, tail, **kw)


def split_packets(body: bytes):
    """A tile-part body of SOP / EPH packets -> [(SOP, header with its
    EPH, data)]."""
    out, pos = [], 0
    while pos < len(body):
        assert body[pos:pos + 2] == b"\xff\x91", pos
        eph = body.index(b"\xff\x92", pos + 6) + 2
        nxt = body.find(b"\xff\x91", eph)
        nxt = len(body) if nxt < 0 else nxt
        out.append((body[pos:pos + 6], body[pos + 6:eph], body[eph:nxt]))
        pos = nxt
    return out


def to_ppt(parts):
    out = []
    for isot, tp, tn, segs, body in parts:
        pk = split_packets(body)
        heads = b"".join(h for _, h, _ in pk)
        out.append([isot, tp, tn, segs + [(0xFF61, bytes([tp]) + heads)],
                    b"".join(s + d for s, _, d in pk)])
    return out


def to_ppm(cs: bytes) -> bytes:
    main, rest = main_header(cs)
    parts, tail = tile_parts(rest)
    ppm, out, cut = b"", [], 0
    for isot, tp, tn, segs, body in parts:
        pk = split_packets(body)
        heads = b"".join(h for _, h, _ in pk)
        cut = cut or len(ppm) + 4 + len(heads) // 2
        ppm += struct.pack(">I", len(heads)) + heads
        out.append([isot, tp, tn, segs, b"".join(s + d for s, _, d in pk)])
    # two PPM segments, the split inside the first tile-part's headers
    main = main + [(0xFF60, b"\0" + ppm[:cut]), (0xFF60, b"\1" + ppm[cut:])]
    return build(main, out, tail)


def interleave(parts):
    """Tile-parts of several tiles taken in turns (each tile's in order)."""
    by_tile = {}
    for p in parts:
        by_tile.setdefault(p[0], []).append(p)
    out = []
    while any(by_tile.values()):
        for t in sorted(by_tile):
            if by_tile[t]:
                out.append(by_tile[t].pop(0))
    return out


def after(main, marker: int, extra):
    """The main header with `extra` segments after `marker`'s."""
    k = [m for m, _ in main].index(marker) + 1
    return main[:k] + extra + main[k:]


def cod_of(main):
    return dict(main)[0xFF52]


def coc_like_cod(main, comp: int, cblksty=None):
    cod = cod_of(main)
    sp = bytearray(cod[5:])
    if cblksty is not None:
        sp[3] = cblksty
    return (0xFF53, bytes([comp, cod[0] & 1]) + bytes(sp))


def qcc_like_qcd(main, comp: int):
    return (0xFF5D, bytes([comp]) + dict(main)[0xFF5C])


# ---- the cases ---------------------------------------------------------------

CASES = {}
REFUSED_CASES = {}


def _case(table, name, fn):
    table[name] = lambda: fn(name)


def _pil_case(name, mode, w, h, **opts):
    ext = name.rsplit(".", 1)[1]
    _case(CASES, name, lambda n: pil_save(mode, w, h, ext, n, **opts))


def _opj_case(name, table=None, n=3, w=37, h=29, prec=8, sgnd=False,
              **kw):
    ext = name.rsplit(".", 1)[1]
    dx, dy, off = kw.get("dx"), kw.get("dy"), kw.get("offset", (0, 0))
    _case(CASES if table is None else table, name, lambda nm: opj_encode(
        planes(h, w, n, nm, prec, sgnd, dx, dy, off), prec=prec, sgnd=sgnd,
        jp2=ext == "jp2", **kw))


# PIL's writer: modes, containers, sizes
for _m in ("L", "LA", "RGB", "RGBA", "I;16", "CMYK"):
    for _e in ("j2k", "jp2"):
        _pil_case(f"pil_{_m.replace(';', '')}_13x7.{_e}", _m, 13, 7)
for _name, _m, _w, _h, _o in [
        ("pil_L_1x1.j2k", "L", 1, 1, {}),
        ("pil_L_1x1.jp2", "L", 1, 1, {}),
        ("pil_L_1x9.j2k", "L", 1, 9, {}),
        ("pil_L_9x1.jp2", "L", 9, 1, {}),
        ("pil_RGB_3x2.j2k", "RGB", 3, 2, {}),
        ("pil_RGB_1x1_97.jp2", "RGB", 1, 1, {"irreversible": True}),
        ("pil_RGB_2x3_97.j2k", "RGB", 2, 3, {"irreversible": True}),
        ("pil_RGB_17x1_97.j2k", "RGB", 17, 1, {"irreversible": True}),
        ("pil_L_1x17_97.jp2", "L", 1, 17, {"irreversible": True}),
        ("pil_RGBA_5x3_97.jp2", "RGBA", 5, 3, {"irreversible": True}),
        ("pil_L_97.j2k", "L", 31, 23, {"irreversible": True}),
        ("pil_RGB_97.jp2", "RGB", 31, 23, {"irreversible": True}),
        ("pil_RGB_97_1layer.j2k", "RGB", 31, 23,
         {"irreversible": True, "quality_layers": [10]}),
        ("pil_RGB_97_2layers.jp2", "RGB", 31, 23,
         {"irreversible": True, "quality_layers": [40, 10]}),
        ("pil_RGB_97_3layers.j2k", "RGB", 31, 23,
         {"irreversible": True, "quality_layers": [80, 20, 5]}),
        ("pil_L_97_dB.jp2", "L", 31, 23,
         {"irreversible": True, "quality_mode": "dB",
          "quality_layers": [25, 35]}),
        ("pil_RGB_53_1layer.jp2", "RGB", 31, 23, {"quality_layers": [20]}),
        ("pil_RGB_53_2layers.j2k", "RGB", 31, 23,
         {"quality_layers": [40, 10]}),
        ("pil_L_53_3layers_dB.jp2", "L", 31, 23,
         {"quality_mode": "dB", "quality_layers": [20, 30, 40]}),
        ("pil_RGB_mct.j2k", "RGB", 31, 23, {"mct": 1}),
        ("pil_RGB_mct_97.jp2", "RGB", 31, 23,
         {"mct": 1, "irreversible": True, "quality_layers": [30, 8]}),
        ("pil_L_signed.j2k", "L", 19, 11, {"signed": True}),
        ("pil_RGB_signed_97.jp2", "RGB", 19, 11,
         {"signed": True, "irreversible": True}),
        ("pil_RGB_plt.j2k", "RGB", 19, 11, {"plt": True}),
        ("pil_L_comment.jp2", "L", 19, 11, {"comment": "rsn frame"}),
        ("pil_L_comment.j2k", "L", 19, 11, {"comment": b"\x00\xffbytes"}),
        ("pil_RGB_tiles.j2k", "RGB", 37, 29, {"tile_size": (16, 16)}),
        ("pil_L_tiles_offsets.jp2", "L", 37, 29,
         {"tile_size": (13, 11), "tile_offset": (1, 1), "offset": (3, 2)}),
        ("pil_RGB_tiles_offsets_97.j2k", "RGB", 37, 29,
         {"tile_size": (13, 11), "tile_offset": (2, 3), "offset": (4, 5),
          "irreversible": True, "quality_layers": [30, 10]}),
        ("pil_RGBA_tiles_7x9.jp2", "RGBA", 23, 19,
         {"tile_size": (7, 9), "offset": (5, 6)}),
        ("pil_L_offset_odd.j2k", "L", 21, 17,
         {"offset": (7, 3), "tile_size": (32, 32)}),
        ("pil_RGB_offset_odd_97.jp2", "RGB", 21, 17,
         {"offset": (1, 1), "tile_size": (32, 32), "irreversible": True}),
]:
    _pil_case(_name, _m, _w, _h, **_o)
for _r in range(1, 8):
    _pil_case(f"pil_L_res{_r}.{'j2k' if _r % 2 else 'jp2'}", "L", 71, 67,
              num_resolutions=_r, irreversible=_r > 4)
for _cb in [(4, 4), (64, 4), (4, 64), (8, 32), (32, 8), (16, 16)]:
    _pil_case(f"pil_RGB_cblk{_cb[0]}x{_cb[1]}.j2k", "RGB", 37, 29,
              codeblock_size=_cb, irreversible=_cb[0] == 8)
for _p in [(32, 32), (64, 32), (128, 128)]:
    _pil_case(f"pil_RGB_prec{_p[0]}x{_p[1]}.jp2", "RGB", 71, 53,
              precinct_size=_p, num_resolutions=3, quality_layers=[40, 10])
for _k, _prog in enumerate(("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")):
    _pil_case(f"pil_RGB_{_prog}.{'j2k' if _k % 2 else 'jp2'}", "RGB", 71, 53,
              progression=_prog, quality_layers=[40, 20, 10],
              precinct_size=(32, 32), num_resolutions=4,
              codeblock_size=(16, 16), irreversible=_k >= 3)
    _pil_case(f"pil_RGBA_{_prog}_tiles.j2k", "RGBA", 41, 37,
              progression=_prog, tile_size=(16, 16), tile_offset=(1, 2),
              offset=(3, 4), quality_layers=[30, 10])

# OpenJPEG's encoder: code-block styles (1 bypass, 2 reset, 4 termall,
# 8 vertically causal, 16 predictable termination, 32 segmentation
# symbols), markers, precisions, subsampling, tile-parts, POC
for _mode in (1, 2, 4, 8, 16, 32, 5, 63):
    _opj_case(f"opj_style{_mode}.j2k", mode=_mode)
    _opj_case(f"opj_style{_mode}_97.jp2", mode=_mode, irreversible=True,
              rates=(40, 10, 1))
_opj_case("opj_sop_eph.j2k", sop=True, eph=True, rates=(20, 5, 1))
_opj_case("opj_sop_eph_tiles.jp2", sop=True, eph=True, rates=(20, 5),
          tile=(16, 16), w=41, h=37)
_opj_case("opj_roi.j2k", roi=(0, 5))
_opj_case("opj_roi_97.jp2", roi=(1, 7), irreversible=True, rates=(20, 4))
for _prec in (1, 4, 12, 20):
    _opj_case(f"opj_gray_prec{_prec}.j2k", n=1, w=17, h=13, prec=_prec,
              space="gray")
_opj_case("opj_gray_prec12_signed.jp2", n=1, w=17, h=13, prec=12,
          sgnd=True, space="gray")
_opj_case("opj_gray_prec9_97.jp2", n=1, w=17, h=13, prec=9, space="gray",
          irreversible=True)
_opj_case("opj_rgb_prec5.j2k", w=17, h=13, prec=5)
_opj_case("opj_rgb_prec10_97.jp2", w=17, h=13, prec=10, irreversible=True)
_opj_case("opj_rgb_signed.j2k", w=17, h=13, sgnd=True)
_opj_case("opj_la_prec12.j2k", n=2, w=17, h=13, prec=12, space="gray")
_opj_case("opj_tileparts_R.j2k", tile=(16, 16), tile_parts="R", numres=3,
          w=40, h=33)
_opj_case("opj_tileparts_L.jp2", tile_parts="L", rates=(20, 5, 1), w=40,
          h=33)
_opj_case("opj_tileparts_C.j2k", tile_parts="C", tile=(20, 20), w=40, h=33)
_opj_case("opj_tlm.j2k", tile=(16, 16), tile_parts="R", w=40, h=33,
          options=(b"TLM=YES",))
_opj_case("opj_poc.j2k", numres=3, rates=(20, 5, 1), w=40, h=33,
          pocs=[(0, 0, 2, 3, 3, "RLCP"), (0, 0, 3, 3, 3, "CPRL")])
_opj_case("opj_poc_97.jp2", numres=4, rates=(30, 10, 3), w=40, h=33,
          irreversible=True, precincts=[(32, 32)] * 4,
          pocs=[(0, 1, 3, 4, 3, "PCRL"), (0, 0, 1, 2, 1, "RPCL"),
                (0, 0, 3, 4, 3, "LRCP")])
for _name, _dx, _dy, _sp, _o in [
        ("opj_sub420.j2k", [1, 2, 2], [1, 2, 2], "unspecified", (0, 0)),
        ("opj_sub420_sycc.jp2", [1, 2, 2], [1, 2, 2], "sycc", (0, 0)),
        ("opj_sub422_srgb.jp2", [1, 2, 2], [1, 1, 1], "srgb", (0, 0)),
        ("opj_sub_all2.j2k", [2, 2, 2], [2, 2, 2], "unspecified", (0, 0)),
        ("opj_sub_first.j2k", [2, 1, 1], [1, 1, 1], "unspecified", (0, 0)),
        ("opj_sub_odd_offset.jp2", [1, 2, 3], [1, 3, 2], "sycc", (3, 5)),
        ("opj_sub_rows.j2k", [1, 1, 1], [1, 2, 2], "unspecified", (0, 1))]:
    _opj_case(_name, w=23, h=17, dx=_dx, dy=_dy, space=_sp, mct=0,
              offset=_o)
_opj_case("opj_sub_rgba.j2k", n=4, w=23, h=17, dx=[1, 2, 2, 1],
          dy=[1, 2, 2, 1], mct=0, space="unspecified")
_opj_case("opj_sub_cmyk.jp2", n=4, w=23, h=17, dx=[1, 2, 1, 2],
          dy=[1, 1, 2, 2], mct=0, space="cmyk")
_opj_case("opj_sub_rgba_alpha.j2k", n=4, w=23, h=17, dx=[1, 1, 1, 2],
          dy=[1, 1, 1, 2], mct=0, space="unspecified")


def _l_cs(name, w=13, h=7, **opts):
    return codestream(pil_save("L", w, h, "j2k", name, **opts))


def _rgb_cs(name, w=13, h=7, **opts):
    return codestream(pil_save("RGB", w, h, "j2k", name, **opts))


def _sop_cs(name, n=3, **kw):
    kw = {"sop": True, "eph": True, "rates": (20, 5, 1), **kw}
    return opj_encode(planes(kw.pop("h", 29), kw.pop("w", 37), n, name),
                      **kw)


_PALETTE = [(i, 255 - i, (i * 7) % 256) for i in range(256)]
_PA_CMAP = box(b"cmap", struct.pack(">HBBHBBHBBHBB", 0, 1, 0, 0, 1, 1, 0, 1,
                                    2, 1, 0, 0))
_REWRAPS = {
    # pclr: P / PA with the indices as they are
    "wrap_pclr_cmap.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1, [
        colr(16), pclr(_PALETTE), cmap()]),
    "wrap_pclr_no_cmap.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1, [
        colr(16), pclr(_PALETTE[:40])]),
    "wrap_pclr_rgba_columns.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1, [
        colr(16), pclr([c + (200,) for c in _PALETTE[:64]], (7, 7, 7, 7))]),
    "wrap_pclr_pa.jp2": lambda n: jp2(codestream(pil_save(
        "LA", 13, 7, "j2k", n)), 7, 13, 2, [colr(16), pclr(_PALETTE),
                                              _PA_CMAP]),
    "wrap_pclr_16bit_is_L.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1, [
        pclr([(i * 257, i, i) for i in range(20)], (15, 7, 7))]),
    # colr: sYCC, gray, CMYK, ICC, unknown enumcs, none, a second one
    "wrap_sycc.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [colr(18)]),
    "wrap_sycc_97.jp2": lambda n: jp2(_rgb_cs(n, irreversible=True), 7, 13,
                                      3, [colr(18)]),
    "wrap_sycc_rgba.jp2": lambda n: jp2(codestream(pil_save(
        "RGBA", 13, 7, "j2k", n)), 7, 13, 4, [colr(18)]),
    "wrap_gray_colr.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1, [colr(17)]),
    "wrap_cmyk_colr.jp2": lambda n: jp2(codestream(pil_save(
        "RGBA", 13, 7, "j2k", n)), 7, 13, 4, [colr(12)]),
    "wrap_icc.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [colr(meth=2)]),
    "wrap_enumcs_unknown.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3,
                                             [colr(99)]),
    "wrap_no_colr.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3),
    "wrap_two_colr.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3,
                                       [colr(16), colr(18)]),
    "wrap_colr_outside_jp2h.jp2": lambda n: SIGNATURE + ftyp() + box(
        b"jp2h", ihdr(7, 13, 3)) + colr(18) + box(b"jp2c", _rgb_cs(n)),
    "wrap_sub420_gray_colr_l.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1,
                                                 [colr(17), colr(16)]),
    # boxes passed over, the brand, sizes
    "wrap_jpx_brand.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [colr(16)],
                                        brand=b"jpx "),
    "wrap_res.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [colr(16), box(
        b"res ", box(b"resc", struct.pack(">HHHHBB", 72, 1, 96, 1, 0, 0))
        + box(b"resd", struct.pack(">HHHHBB", 1, 1, 1, 1, 0, 0)))]),
    "wrap_res_zero_denominator.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [
        colr(16), box(b"res ", box(b"resc", bytes(10)))]),
    "wrap_cdef_bpcc.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [
        colr(16), box(b"bpcc", bytes([7, 7, 7])),
        box(b"cdef", struct.pack(">HHHHHHHHHH", 3, 0, 0, 1, 1, 0, 2, 2, 0,
                                 3))], bpc=255),
    "wrap_boxes_passed_over.jp2": lambda n: jp2(
        _rgb_cs(n), 7, 13, 3, [colr(16), box(b"uinf", bytes(12))],
        before=box(b"xml ", b"<x/>") + box(b"uuid", bytes(20)),
        after=box(b"uuid", bytes(16))),
    "wrap_xl_jp2c.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [colr(16)],
                                      xl=True),
    "wrap_jp2c_to_the_end.jp2": lambda n: SIGNATURE + ftyp() + box(
        b"jp2h", ihdr(7, 13, 3) + colr(16)) + struct.pack(
        ">I4s", 0, b"jp2c") + _rgb_cs(n),
    # markers: COC / QCC / CRG / PLM / COM / an unknown one, tile-part
    # headers, PPM / PPT, tile-parts in turns, Psot 0, TNsot 0
    "cs_coc_qcc.j2k": lambda n: rewrite(_rgb_cs(n), lambda m: after(
        after(m, 0xFF52, [coc_like_cod(m, 1), coc_like_cod(m, 2)]), 0xFF5C,
        [qcc_like_qcd(m, 0), qcc_like_qcd(m, 2)])),
    "cs_coc_other_style.j2k": lambda n: rewrite(_rgb_cs(n), lambda m: after(
        m, 0xFF52, [coc_like_cod(m, 1, cblksty=8)])),
    "cs_crg_plm_unknown.j2k": lambda n: rewrite(_rgb_cs(n), lambda m: m + [
        (0xFF63, bytes(12)), (0xFF57, b"\0\0"), (0xFF6A, bytes(6))]),
    "cs_cap_cpf.j2k": lambda n: rewrite(_rgb_cs(n), lambda m: m + [
        (0xFF50, bytes(6)), (0xFF59, bytes(4))]),
    "cs_tile_headers.j2k": lambda n: rewrite(_rgb_cs(n, 37, 29, tile_size=(
        16, 16)), parts_fn=lambda ps: [
        [i, tp, tn, s + [(0xFF52, cod_of(main_header(_rgb_cs(n, 37, 29))[0])),
                         (0xFF64, b"\0\1tile")], b] for i, tp, tn, s, b in ps]),
    "cs_ppt.j2k": lambda n: rewrite(_sop_cs(n), parts_fn=to_ppt),
    "cs_ppt_tiles.jp2": lambda n: jp2(rewrite(_sop_cs(n, tile=(16, 16),
                                                      tile_parts="R"),
                                              parts_fn=to_ppt), 29, 37, 3,
                                      [colr(16)]),
    "cs_ppm.j2k": lambda n: to_ppm(_sop_cs(n, tile=(16, 16),
                                           tile_parts="R")),
    "cs_tileparts_in_turns.j2k": lambda n: rewrite(_sop_cs(
        n, tile=(16, 16), tile_parts="R"), parts_fn=interleave),
    "cs_psot_zero.j2k": lambda n: rewrite(_sop_cs(n, tile=(16, 16)),
                                          psot_zero_last=True),
    "cs_tnsot_zero.j2k": lambda n: rewrite(_sop_cs(
        n, tile=(16, 16), tile_parts="R"), parts_fn=lambda ps: [
        [i, tp, 0, s, b] for i, tp, tn, s, b in ps]),
    # where OpenJPEG ends without an error: a stream cut right after a
    # marker (no tile holds data: zeros), a SOP missing (a warning), a POC
    # of an order it does not know (no packets)
    "cs_ends_after_sot_marker.j2k": lambda n: (lambda cs: cs[:cs.index(
        b"\xff\x90") + 2])(_rgb_cs(n)),
    "cs_sop_missing.j2k": lambda n: rewrite(_sop_cs(n), parts_fn=lambda ps: [
        [i, tp, tn, s, _drop_packet_marker(b, 1, 0)] for i, tp, tn, s, b in ps]),
    "cs_poc_unknown_order.j2k": lambda n: _poc_order(opj_encode(
        planes(33, 40, 3, n), numres=3, rates=(20, 5, 1), pocs=[
            (0, 0, 2, 3, 3, "RLCP"), (0, 0, 3, 2, 3, "CPRL"),
            (0, 0, 3, 3, 3, "LRCP")]), 1, 9),
}
for _name, _fn in _REWRAPS.items():
    _case(CASES, _name, _fn)


def _truncated(keep):
    return lambda n: (lambda cs: cs[:keep(len(cs))])(_rgb_cs(n, 37, 29))


def _psot(cs: bytes, psot: int) -> bytes:
    """The first tile-part's Psot set to `psot`."""
    i = cs.index(b"\xff\x90")
    return cs[:i + 6] + struct.pack(">I", psot) + cs[i + 10:]


_REFUSED = {
    "pil_precincts_16.j2k": lambda n: pil_save("RGB", 40, 33, "j2k", n,
                                               precinct_size=(16, 16)),
    "truncated_half.j2k": _truncated(lambda k: k // 2),
    "truncated_no_eoc.j2k": _truncated(lambda k: k - 2),
    "no_eoc_two_bytes.j2k": lambda n: _rgb_cs(n)[:-2] + b"\0\0",
    "truncated_in_tile_header.jp2": lambda n: jp2(_rgb_cs(n)[:150], 7, 13,
                                                  3, [colr(16)]),
    "jp2_without_jp2h.jp2": lambda n: SIGNATURE + ftyp() + box(
        b"jp2c", _rgb_cs(n)),
    "ihdr_size_mismatch.jp2": lambda n: jp2(_rgb_cs(n), 8, 13, 3,
                                            [colr(16)]),
    "cmap_without_pclr.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1,
                                           [colr(16), cmap()]),
    "pclr_300_colours.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1, [
        colr(16), pclr([(i % 256, i // 256, 0) for i in range(300)])]),
    "pclr_on_gray_colr.jp2": lambda n: jp2(_l_cs(n), 7, 13, 1, [
        colr(17), pclr(_PALETTE)]),
    "gray_colr_on_rgb.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [colr(17)]),
    "esycc_colr.jp2": lambda n: jp2(_rgb_cs(n), 7, 13, 3, [colr(24)]),
    "la_subsampled.j2k": lambda n: opj_encode(planes(
        9, 11, 2, n, dx=[1, 2], dy=[1, 2]), dx=[1, 2], dy=[1, 2],
        space="unspecified"),
    "decompression_bomb.j2k": lambda n: rewrite(_l_cs(n), lambda m: [
        (0xFF51, m[0][1][:2] + struct.pack(">II", 20000, 20000)
         + m[0][1][10:])] + m[1:]),
    "tile_parts_out_of_order.j2k": lambda n: rewrite(_sop_cs(
        n, tile=(16, 16), tile_parts="R"), parts_fn=lambda ps: [
        ps[1], ps[0]] + ps[2:]),
    "cod_without_layers.j2k": lambda n: rewrite(_l_cs(n), lambda m: [
        (k, v[:2] + b"\0\0" + v[4:] if k == 0xFF52 else v) for k, v in m]),
    "psot_too_small.j2k": lambda n: _psot(_l_cs(n), 13),
    "segment_too_long.j2k": lambda n: _corrupt_lengths(_sop_cs(n)),
    "eph_missing.j2k": lambda n: rewrite(_sop_cs(n), parts_fn=lambda ps: [
        [i, tp, tn, s, _drop_packet_marker(b, 2, 1)] for i, tp, tn, s, b in ps]),
    "cod_unknown_progression.j2k": lambda n: rewrite(_l_cs(n), lambda m: [
        (k, v[:1] + b"\x07" + v[2:] if k == 0xFF52 else v) for k, v in m]),
    "unknown_marker_in_tile_header.j2k": lambda n: rewrite(
        _l_cs(n), parts_fn=lambda ps: [[i, tp, tn, s + [(0xFF6A, bytes(4))], b]
                                       for i, tp, tn, s, b in ps]),
    "empty_tile_part.j2k": lambda n: (lambda cs: (lambda i: cs[:i] + struct.pack(
        ">HHHIBB", 0xFF90, 10, 0, 12, 0, 0) + cs[i:])(cs.index(b"\xff\x90")))(
        rewrite(_l_cs(n), parts_fn=lambda ps: [[i, tp + 1, 0, s, b]
                                               for i, tp, tn, s, b in ps])),
}
for _name, _fn in _REFUSED.items():
    _case(REFUSED_CASES, _name, _fn)


def _drop_packet_marker(body: bytes, k: int, which: int) -> bytes:
    """A tile-part body with packet k's SOP (which 0) or EPH (1) left
    out."""
    pk = split_packets(body)
    return b"".join(
        (b"" if j == k and which == 0 else sop)
        + (head[:-2] if j == k and which == 1 else head) + data
        for j, (sop, head, data) in enumerate(pk))


def _poc_order(cs: bytes, k: int, order: int) -> bytes:
    """POC entry k's progression order set to `order`."""
    i = cs.index(b"\xff\x5f") + 4 + 7 * k + 6
    return cs[:i] + bytes([order]) + cs[i + 1:]


def _corrupt_lengths(cs: bytes) -> bytes:
    """The first packet header's bytes set to ones: lengths past the
    data."""
    i = cs.index(b"\xff\x91") + 6
    return cs[:i] + b"\xff\x7f\xff\x7f" + cs[i + 4:]


NEAR_MISSES = {
    "jp2h_without_ihdr": lambda: SIGNATURE + ftyp() + box(
        b"jp2h", colr(16)) + box(b"jp2c", b"\xff\x4f\xff\x51"),
    "five_components": lambda: b"\xff\x4f\xff\x51" + struct.pack(
        ">HHIIIIIIIIH", 38 + 15, 0, 8, 8, 0, 0, 8, 8, 0, 0, 5)
        + bytes([7, 1, 1]) * 5,
    "five_components_ihdr": lambda: SIGNATURE + ftyp() + box(
        b"jp2h", ihdr(8, 8, 5)) + box(b"jp2c", b"\xff\x4f\xff\x51"),
    "zero_width": lambda: b"\xff\x4f\xff\x51" + struct.pack(
        ">HHIIIIIIIIH", 41, 0, 4, 8, 4, 0, 8, 8, 0, 0, 1) + bytes([7, 1, 1]),
    "short_siz": lambda: b"\xff\x4f\xff\x51\x00\x29\x00",
    "box_of_length_4": lambda: SIGNATURE + struct.pack(">I4s", 4, b"ftyp"),
    "codestream_cut_in_a_comment": lambda: b"\xff\x4f\xff\x51" + struct.pack(
        ">HHIIIIIIIIH", 41, 0, 4, 4, 0, 0, 4, 4, 0, 0, 1) + bytes([7, 1, 1])
        + b"\xff",
}


def _frame(i: int):
    from PIL import Image

    with Image.open(os.path.join(JPEG_FRAMES, f"frame_{i:05d}.jpg")) as im:
        return im.convert("RGB")


def _frame_bytes(img, **opts) -> bytes:
    out = io.BytesIO()
    img.save(out, "JPEG2000", **opts)
    return out.getvalue()


def _frame_i16(img):
    from PIL import Image

    a = np.asarray(img).astype(np.uint16)
    v = (a[..., 0] << 8 | a[..., 1]).astype("<u2")
    return Image.frombytes("I;16", img.size, v.tobytes())


# the five 800x800 frames chip_smoke.py times: kind -> (frame, writer)
FRAMES = {
    "frame_rgb_53.jp2": (0, lambda im: _frame_bytes(im)),
    "frame_rgb_97_rate20.jp2": (1, lambda im: _frame_bytes(
        im, irreversible=True, quality_layers=[20])),
    "frame_rgb_97_layers_rpcl_tiles.jp2": (2, lambda im: _frame_bytes(
        im, irreversible=True, quality_layers=[40, 20, 10],
        progression="RPCL", tile_size=(50, 50))),
    "frame_l_53.jp2": (3, lambda im: _frame_bytes(im.convert("L"))),
    "frame_i16_53.jp2": (4, lambda im: _frame_bytes(_frame_i16(im))),
}
DIGESTS = os.path.join(HERE, "digests.json")


def case_bytes(name: str) -> bytes:
    return {**CASES, **REFUSED_CASES}[name]()


def fixture_name(name: str) -> str:
    return name


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def main() -> None:
    from PIL import Image

    for old in glob.glob(os.path.join(HERE, "*.j2k")) + glob.glob(
            os.path.join(HERE, "*.jp2")):
        os.unlink(old)
    files, refused = {}, {}
    for name in {**CASES, **REFUSED_CASES}:
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(case_bytes(name))
        try:
            with Image.open(path) as img:
                files[name] = digest(img.mode, np.asarray(img))
        except Exception as e:  # noqa: BLE001 - PIL's refusal, recorded
            if name in CASES:
                raise
            refused[name] = f"{type(e).__name__}: " + str(e).replace(
                path, name)
            continue
        if name in REFUSED_CASES:
            raise RuntimeError(f"{name}: PIL opens it")
    for name, (i, write) in FRAMES.items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(write(_frame(i)))
        with Image.open(path) as img:
            files[name] = digest(img.mode, np.asarray(img))
    with open(DIGESTS, "w") as f:
        json.dump({"pil": Image.__version__, "files": files,
                   "refused": refused}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    main()
