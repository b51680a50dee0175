"""A WebP writer for the cases of tests/test_torch_webp.py, and the
committed fixtures beside this file.

Everything here uses numpy and the standard library only
(chip_smoke.py runs it on the card's host, which has no PIL):

  - `write_vp8l(rgba, **spec)`: a lossless VP8L bitstream of an (H, W, 4)
    uint8 image, with any of the four transforms in any order (subtract
    green; the predictor with a mode per tile, 0-15; cross-colour with
    multipliers per tile; colour indexing with 2, 4, 16 or 256 colours,
    bundled), the colour cache, LZ77 copies (short, 2D-map and long
    distances, lengths up to 4096), an entropy image of several groups,
    simple (one or two symbols) and normal prefix codes, max_symbol;
  - `write_vp8(width, height, macroblocks, **spec)`: a VP8 key frame from
    chosen modes and chosen quantised coefficients (no forward DCT): a
    boolean encoder writes the segment and filter headers (simple or
    normal filter, level, sharpness, mode / reference deltas), 1-8 token
    partitions, the quantiser indices and deltas, coefficient probability
    updates, the skip probability or none, the intra modes and the tokens
    with their contexts;
  - `alph_chunk(alpha, method, filter)`: an ALPH chunk, raw or as a
    headerless VP8L stream, with each prediction filter;
  - `riff(chunks)`, `vp8x(...)`, `anmf(...)`: the container.

The constant tables are read from the decoder's source,
rsn_torch/data/native/webp.cpp, so the two share one copy; the digests
are PIL's (libwebp's) decodes, which hold both to the format.

CASES names each committed case; PIL_CASES the files PIL's own encoder
writes (only `main` needs PIL for those); REFUSED_CASES files PIL refuses.
`python tests/golden/webp/write_fixtures.py` writes one file per case
here and digests.json: the mode, shape, dtype and sha256 of
`np.asarray(Image.open(f))`, with the PIL and libwebp versions.
"""
from __future__ import annotations

import hashlib
import heapq
import json
import os
import re
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
DIGESTS = os.path.join(HERE, "digests.json")
CODEC_SOURCE = os.path.join(REPO, "rsn_torch", "data", "native", "webp.cpp")


def _cpp_table(name: str, shape) -> np.ndarray:
    """The integers of the C array `name` in webp.cpp."""
    with open(CODEC_SOURCE) as f:
        src = f.read()
    m = re.search(r"\b" + re.escape(name) + r"(\[[0-9]*\])+\s*=\s*\{", src)
    body = src[m.end():src.index("};", m.end())]
    vals = [int(v, 0) for v in re.findall(r"-?(?:0x[0-9a-fA-F]+|\d+)", body)]
    return np.array(vals, np.int64).reshape(shape)


_TABLES = {}


def table(name: str) -> np.ndarray:
    shapes = {"kCoeffsProba0": (4, 8, 3, 11),
              "kCoeffsUpdateProba": (4, 8, 3, 11),
              "kBModesProba": (10, 10, 9), "kCodeToPlane": (120,),
              "kCodeLengthOrder": (19,), "kBands": (17,), "kZigzag": (16,),
              "kYModesIntra4": (18,)}
    if name not in _TABLES:
        _TABLES[name] = _cpp_table(name, shapes[name])
    return _TABLES[name]


# ---- the container ------------------------------------------------------------------

def chunk(tag: bytes, payload: bytes, pad: bool = True) -> bytes:
    out = tag + struct.pack("<I", len(payload)) + payload
    return out + (b"\x00" if pad and len(payload) & 1 else b"")


def riff(chunks, riff_size=None) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    size = len(body) if riff_size is None else riff_size
    return b"RIFF" + struct.pack("<I", size) + body


def vp8x(flags: int, width: int, height: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0])
                 + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def anim(background: int = 0xFF102030, loops: int = 0) -> bytes:
    return chunk(b"ANIM", struct.pack("<IH", background, loops))


def anmf(x: int, y: int, width: int, height: int, frame_chunks: bytes,
         duration: int = 100, bits: int = 0) -> bytes:
    head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
            + (width - 1).to_bytes(3, "little")
            + (height - 1).to_bytes(3, "little")
            + duration.to_bytes(3, "little") + bytes([bits]))
    return chunk(b"ANMF", head + frame_chunks)


# ---- VP8L ---------------------------------------------------------------------------

class LBitWriter:
    """LSB-first bits, packed with numpy at the end."""

    def __init__(self):
        self.vals, self.lens = [], []

    def put(self, value: int, nbits: int) -> None:
        if nbits:
            self.vals.append(value)
            self.lens.append(nbits)

    def tobytes(self) -> bytes:
        if not self.lens:
            return b""
        vals = np.array(self.vals, np.uint64)
        lens = np.array(self.lens, np.int64)
        pos = np.cumsum(lens) - lens
        total = int(pos[-1] + lens[-1])
        nbytes = (total + 7) // 8
        v = vals << (pos & 7).astype(np.uint64)
        idx = pos >> 3
        out = np.zeros(nbytes + 8, np.float64)
        for k in range(5):  # the bits are disjoint: sums are ors
            out += np.bincount(idx + k, weights=((v >> np.uint64(8 * k))
                                                  & np.uint64(255))
                               .astype(np.float64), minlength=len(out))[
                                   :len(out)]
        return out[:nbytes].astype(np.uint8).tobytes()


def code_lengths(freq, limit: int) -> np.ndarray:
    """Huffman code lengths of at most `limit` bits (frequencies halved
    until they fit); a single used symbol gets length 1."""
    freq = np.asarray(freq, np.int64)
    lengths = np.zeros(len(freq), np.int64)
    used = np.nonzero(freq)[0]
    if len(used) == 1:
        lengths[used[0]] = 1
    if len(used) <= 1:
        return lengths
    f = freq[used].copy()
    while True:
        heap = [(int(w), i, (i,)) for i, w in enumerate(f)]
        heapq.heapify(heap)
        depth = np.zeros(len(f), np.int64)
        tick = len(f)
        while len(heap) > 1:
            w1, _, a = heapq.heappop(heap)
            w2, _, b = heapq.heappop(heap)
            for s in a + b:
                depth[s] += 1
            heapq.heappush(heap, (w1 + w2, tick, a + b))
            tick += 1
        if depth.max() <= limit:
            break
        f = np.maximum(f // 2, 1)
    lengths[used] = depth
    return lengths


def canonical_codes(lengths) -> tuple:
    """-> (codes bit-reversed for LSB-first writing, lengths to write): a
    code of one symbol is read with no bits."""
    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros(len(lengths), np.int64)
    emit = lengths.copy()
    if np.count_nonzero(lengths) == 1:
        emit[:] = 0
        return codes, emit
    count = np.bincount(lengths, minlength=16)
    count[0] = 0
    next_code = np.zeros(17, np.int64)
    code = 0
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        next_code[n] = code
    for s in range(len(lengths)):
        n = int(lengths[s])
        if n:
            c = int(next_code[n])
            next_code[n] += 1
            codes[s] = int(f"{c:0{n}b}"[::-1], 2)
    return codes, emit


def _rle(lengths) -> list:
    """Code lengths -> (symbol, extra bits, extra value) tokens: 16 repeats
    the last non-zero length 3-6 times, 17 / 18 write 3-10 / 11-138 zeros."""
    tokens, prev, i, n = [], 8, 0, len(lengths)
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and lengths[i + run] == v:
            run += 1
        i += run
        if v == 0:
            while run >= 3:
                if run >= 11:
                    r = min(run, 138)
                    tokens.append((18, 7, r - 11))
                else:
                    r = min(run, 10)
                    tokens.append((17, 3, r - 3))
                run -= r
            tokens += [(0, 0, 0)] * run
        else:
            if v != prev:
                tokens.append((v, 0, 0))
                prev = v
                run -= 1
            while run >= 3:
                r = min(run, 6)
                tokens.append((16, 2, r - 3))
                run -= r
            tokens += [(v, 0, 0)] * run
    return tokens


def write_code(bw: LBitWriter, freq, *, simple: bool = True,
               max_symbol: bool = False) -> tuple:
    """One prefix code of the histogram `freq` -> (codes, lengths to
    write) of its symbols."""
    alphabet = len(freq)
    used = [int(s) for s in np.nonzero(freq)[0]]
    if simple and len(used) <= 2 and all(s < 256 for s in used):
        used = used or [0]
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        if used[0] < 2:
            bw.put(0, 1)
            bw.put(used[0], 1)
        else:
            bw.put(1, 1)
            bw.put(used[0], 8)
        if len(used) == 2:
            bw.put(used[1], 8)
        lengths = np.zeros(alphabet, np.int64)
        lengths[used] = 1
        return canonical_codes(lengths)
    if not used:
        freq = np.zeros(alphabet, np.int64)
        freq[0] = 1
    lengths = code_lengths(freq, 15)
    bw.put(0, 1)
    order = table("kCodeLengthOrder")
    if max_symbol:
        last = int(np.nonzero(lengths)[0][-1]) + 1
        tokens = _rle(lengths[:last])
        if len(tokens) < 2:
            tokens = _rle(lengths[:last + 1])
    else:
        tokens = _rle(lengths)
    cl_freq = np.bincount([t[0] for t in tokens], minlength=19)
    cl_lengths = code_lengths(cl_freq, 7)
    num = max(4, max(i for i in range(19) if cl_lengths[order[i]] or i < 4)
              + 1)
    bw.put(num - 4, 4)
    for i in range(num):
        bw.put(int(cl_lengths[order[i]]), 3)
    if max_symbol:
        m = len(tokens) - 2
        k = 0
        while m >= 1 << (2 + 2 * k):
            k += 1
        bw.put(1, 1)
        bw.put(k, 3)
        bw.put(m, 2 + 2 * k)
    else:
        bw.put(0, 1)
    cl_codes, cl_emit = canonical_codes(cl_lengths)
    for sym, nbits, extra in tokens:
        bw.put(int(cl_codes[sym]), int(cl_emit[sym]))
        bw.put(extra, nbits)
    return canonical_codes(lengths)


def prefix_encode(value: int) -> tuple:
    """A length or distance (1...) -> (prefix symbol, extra bits, extra
    value), VP8LPrefixEncode."""
    if value <= 4:
        return value - 1, 0, 0
    d = value - 1
    high = d.bit_length() - 1
    second = (d >> (high - 1)) & 1
    extra_bits = high - 1
    return 2 * high + second, extra_bits, d & ((1 << extra_bits) - 1)


def _plane_distances(width: int) -> dict:
    """distance -> the smallest 2D-map code (1-120) decoding to it."""
    out = {}
    for c, p in enumerate(table("kCodeToPlane")):
        d = max(1, (int(p) >> 4) * width + 8 - (int(p) & 0xF))
        out.setdefault(d, c + 1)
    return out


def _runs(eq: np.ndarray) -> np.ndarray:
    """run[i]: how many of eq[i], eq[i + 1], ... are True in a row."""
    n = len(eq)
    idx = np.where(~eq, np.arange(n), n)
    nxt = np.minimum.accumulate(idx[::-1])[::-1]
    return nxt - np.arange(n)


def _events(px: np.ndarray, width: int, cache_bits: int, lz77) -> list:
    """The pixels as literals, colour-cache hits and copies.  `lz77`: None
    or {"distances": [...], "min_len": n, "max_len": n, "linear": bool}
    (linear: every distance written past the 2D map)."""
    n = len(px)
    runs = []
    if lz77:
        for d in lz77["distances"]:
            if 0 < d < n:
                eq = np.zeros(n, bool)
                eq[d:] = px[d:] == px[:-d]
                runs.append((d, _runs(eq)))
    min_len = lz77.get("min_len", 3) if lz77 else 0
    max_len = lz77.get("max_len", 4096) if lz77 else 0
    plane = {} if not lz77 or lz77.get("linear") else _plane_distances(width)
    cache = {}
    shift = 32 - cache_bits
    events = []
    i = 0
    pxl = px.tolist()

    def insert(a, b):
        if cache_bits:
            for j in range(a, b):
                cache[((pxl[j] * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = pxl[j]

    while i < n:
        best = None
        for d, run in runs:
            if d <= i:
                length = min(int(run[i]), max_len, n - i)
                if length >= min_len and (best is None or length > best[0]):
                    best = (length, d)
        if best:
            length, d = best
            events.append(("copy", i, length, plane.get(d, d + 120)))
            insert(i, i + length)
            i += length
            continue
        p = pxl[i]
        if cache_bits:
            key = ((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift
            if cache.get(key) == p:
                events.append(("cache", i, key))
                cache[key] = p
                i += 1
                continue
            cache[key] = p
        events.append(("lit", i, p))
        i += 1
    return events


def _argb(rgba: np.ndarray) -> np.ndarray:
    a = rgba.astype(np.uint32)
    return (a[..., 3] << 24) | (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]


def write_stream(bw: LBitWriter, px: np.ndarray, width: int, *,
                 level0: bool = False, cache_bits: int = 0, meta=None,
                 lz77=None, simple: bool = True,
                 max_symbol: bool = False) -> None:
    """One image stream of ARGB pixels (flat uint32, `width` per row): the
    colour cache, at level 0 the entropy image (meta: (bits, groups) with
    `groups` an array of group per tile), the codes and the pixels."""
    height = len(px) // width
    bw.put(1 if cache_bits else 0, 1)
    if cache_bits:
        bw.put(cache_bits, 4)
    group_of = None
    num_groups = 1
    if level0:
        bw.put(1 if meta is not None else 0, 1)
        if meta is not None:
            bits, groups = meta
            bw.put(bits - 2, 3)
            groups = np.asarray(groups, np.uint32)
            write_stream(bw, (groups & 0xFF) << 8 | (groups >> 8) << 16,
                         -(-width // (1 << bits)))
            gw = -(-width // (1 << bits))
            num_groups = int(groups.max()) + 1
            ys, xs = np.divmod(np.arange(len(px)), width)
            group_of = groups[(ys >> bits) * gw + (xs >> bits)]
    events = _events(px, width, cache_bits, lz77)
    alph = [256 + 24 + ((1 << cache_bits) if cache_bits else 0), 256, 256,
            256, 40]
    hist = np.zeros((num_groups, 5, max(alph)), np.int64)
    for ev in events:
        g = int(group_of[ev[1]]) if group_of is not None else 0
        if ev[0] == "lit":
            p = ev[2]
            hist[g, 0, (p >> 8) & 255] += 1
            hist[g, 1, (p >> 16) & 255] += 1
            hist[g, 2, p & 255] += 1
            hist[g, 3, p >> 24] += 1
        elif ev[0] == "cache":
            hist[g, 0, 280 + ev[2]] += 1
        else:
            hist[g, 0, 256 + prefix_encode(ev[2])[0]] += 1
            hist[g, 4, prefix_encode(ev[3])[0]] += 1
    codes = []
    for g in range(num_groups):
        codes.append([write_code(bw, hist[g, j, :alph[j]], simple=simple,
                                 max_symbol=max_symbol) for j in range(5)])
    for ev in events:
        c = codes[int(group_of[ev[1]]) if group_of is not None else 0]
        if ev[0] == "lit":
            p = ev[2]
            for j, s in ((0, (p >> 8) & 255), (1, (p >> 16) & 255),
                         (2, p & 255), (3, p >> 24)):
                bw.put(int(c[j][0][s]), int(c[j][1][s]))
        elif ev[0] == "cache":
            s = 280 + ev[2]
            bw.put(int(c[0][0][s]), int(c[0][1][s]))
        else:
            sym, nbits, extra = prefix_encode(ev[2])
            bw.put(int(c[0][0][256 + sym]), int(c[0][1][256 + sym]))
            bw.put(extra, nbits)
            sym, nbits, extra = prefix_encode(ev[3])
            bw.put(int(c[4][0][sym]), int(c[4][1][sym]))
            bw.put(extra, nbits)


def _channels(argb):
    return [((argb >> s) & 255).astype(np.int64) for s in (24, 16, 8, 0)]


def _join(a, r, g, b):
    return ((a & 255).astype(np.uint32) << 24 | (r & 255).astype(np.uint32)
            << 16 | (g & 255).astype(np.uint32) << 8
            | (b & 255).astype(np.uint32))


def _avg2(x, y):
    return (((x ^ y) & np.uint32(0xFEFEFEFE)) >> np.uint32(1)) + (x & y)


def _predictions(img: np.ndarray) -> np.ndarray:
    """(16, H, W) predictions of each mode from the pixels themselves (the
    rightmost column's top-right is the row's first pixel)."""
    h, w = img.shape
    L = np.zeros_like(img)
    L[:, 1:] = img[:, :-1]
    T = np.zeros_like(img)
    T[1:] = img[:-1]
    TL = np.zeros_like(img)
    TL[1:, 1:] = img[:-1, :-1]
    TR = np.zeros_like(img)
    TR[1:, :-1] = img[:-1, 1:]
    TR[1:, -1] = img[1:, 0]
    out = np.empty((16,) + img.shape, np.uint32)
    out[0] = out[14] = out[15] = 0xFF000000
    out[1], out[2], out[3], out[4] = L, T, TR, TL
    out[5] = _avg2(_avg2(L, TR), T)
    out[6] = _avg2(L, TL)
    out[7] = _avg2(L, T)
    out[8] = _avg2(TL, T)
    out[9] = _avg2(T, TR)
    out[10] = _avg2(_avg2(L, TL), _avg2(T, TR))
    cl, ct, ctl = _channels(L), _channels(T), _channels(TL)
    d = sum(np.abs(b - c) - np.abs(a - c) for a, b, c in zip(ct, cl, ctl))
    out[11] = np.where(d <= 0, T, L)
    out[12] = _join(*[np.clip(a + b - c, 0, 255)
                      for a, b, c in zip(cl, ct, ctl)])
    ave = _channels(_avg2(L, T))
    out[13] = _join(*[np.clip(a + np.trunc((a - c) / 2).astype(np.int64), 0,
                              255) for a, c in zip(ave, ctl)])
    return out


def _sub(a, b):
    return _join(*[x - y for x, y in zip(_channels(a), _channels(b))])


def predictor_forward(img: np.ndarray, bits: int, modes: np.ndarray):
    """Residuals of the predictor transform with `modes` (per tile) ->
    (residuals, the transform's image)."""
    h, w = img.shape
    assert modes.size == _tiles(h, w, bits), "one mode per tile"
    pred = _predictions(img)
    ys, xs = np.mgrid[0:h, 0:w]
    tw = -(-w // (1 << bits))
    mode = modes.reshape(-1)[(ys >> bits) * tw + (xs >> bits)]
    mode[0, :] = 1
    mode[1:, 0] = 2
    p = np.take_along_axis(pred, mode[None], 0)[0]
    p[0, 0] = 0xFF000000
    return _sub(img, p), (modes.reshape(-1).astype(np.uint32) << 8
                          | np.uint32(0xFF000000))


def cross_color_forward(img: np.ndarray, bits: int, mults: np.ndarray):
    """mults: (tiles, 3) int8 (green to red, green to blue, red to blue)."""
    h, w = img.shape
    assert len(mults) == _tiles(h, w, bits), "one multiplier set per tile"
    ys, xs = np.mgrid[0:h, 0:w]
    tw = -(-w // (1 << bits))
    m = mults.astype(np.int64)[(ys >> bits) * tw + (xs >> bits)]
    a, r, g, b = _channels(img)
    sg = g.astype(np.int8).astype(np.int64)
    sr = r.astype(np.int8).astype(np.int64)
    r2 = r - ((m[..., 0] * sg) >> 5)
    b2 = b - ((m[..., 1] * sg) >> 5) - ((m[..., 2] * sr) >> 5)
    code = ((mults[:, 2].astype(np.uint8).astype(np.uint32) << 16)
            | (mults[:, 1].astype(np.uint8).astype(np.uint32) << 8)
            | mults[:, 0].astype(np.uint8).astype(np.uint32))
    return _join(a, r2, g, b2), code | np.uint32(0xFF000000)


def write_vp8l(rgba: np.ndarray, *, transforms=(), cache_bits: int = 0,
               meta=None, lz77=None, simple: bool = True,
               max_symbol: bool = False, alpha_bit=None,
               sub_cache_bits: int = 0) -> bytes:
    """A VP8L chunk's payload of an (H, W, 4) uint8 RGBA image.

    transforms, applied in order: "subtract_green", ("predictor", bits,
    modes per tile), ("cross_color", bits, (tiles, 3) multipliers),
    ("palette", colours as (n, 4) RGBA); meta: (bits, group per tile) of
    the entropy image."""
    h, w = rgba.shape[:2]
    img = _argb(rgba)
    bw = LBitWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    if alpha_bit is None:
        alpha_bit = int((rgba[..., 3] != 255).any())
    bw.put(alpha_bit, 1)
    bw.put(0, 3)
    write_level0(bw, img, transforms=transforms, cache_bits=cache_bits,
                 meta=meta, lz77=lz77, simple=simple, max_symbol=max_symbol,
                 sub_cache_bits=sub_cache_bits)
    return bw.tobytes()


def write_level0(bw: LBitWriter, img: np.ndarray, *, transforms=(),
                 cache_bits=0, meta=None, lz77=None, simple=True,
                 max_symbol=False, sub_cache_bits=0) -> None:
    """The transforms and the main image stream of an (H, W) ARGB image."""
    w = img.shape[1]
    for t in transforms:
        kind = t if isinstance(t, str) else t[0]
        bw.put(1, 1)
        if kind == "subtract_green":
            bw.put(2, 2)
            a, r, g, b = _channels(img)
            img = _join(a, r - g, g, b - g)
        elif kind == "predictor":
            _, bits, modes = t
            bw.put(0, 2)
            bw.put(bits - 2, 3)
            img, data = predictor_forward(img, bits, np.asarray(modes))
            write_stream(bw, data, -(-w // (1 << bits)),
                         cache_bits=sub_cache_bits)
        elif kind == "cross_color":
            _, bits, mults = t
            bw.put(1, 2)
            bw.put(bits - 2, 3)
            img, data = cross_color_forward(img, bits, np.asarray(mults))
            write_stream(bw, data, -(-w // (1 << bits)))
        else:  # palette
            pal = _argb(np.asarray(t[1], np.uint8).reshape(-1, 4))
            n = len(pal)
            bw.put(3, 2)
            bw.put(n - 1, 8)
            deltas = np.concatenate([pal[:1], _sub(pal[1:], pal[:-1])])
            write_stream(bw, deltas, n)
            lookup = {int(p): i for i, p in enumerate(pal.tolist())}
            idx = np.vectorize(lambda p: lookup[int(p)], otypes=[np.int64])(
                img)
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            per, bpp = 1 << bits, 8 >> bits
            pw = -(-w // per)
            pad = np.zeros((img.shape[0], pw * per), np.int64)
            pad[:, :w] = idx
            packed = sum(pad[:, k::per] << (k * bpp) for k in range(per))
            img = (packed.astype(np.uint32) << 8) | np.uint32(0xFF000000)
            w = pw
    bw.put(0, 1)
    write_stream(bw, img.reshape(-1), w, level0=True, cache_bits=cache_bits,
                 meta=meta, lz77=lz77, simple=simple, max_symbol=max_symbol)


# ---- ALPH -----------------------------------------------------------------------------

def alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """The encoder's side of filters.c: 1 horizontal, 2 vertical, 3
    gradient (the first row horizontal, the first column from above)."""
    a = alpha.astype(np.int64)
    out = a.copy()
    if method == 0:
        return alpha.copy()
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    out[1:, 0] = a[1:, 0] - a[:-1, 0]
    if method == 1:
        out[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif method == 2:
        out[1:, 1:] = a[1:, 1:] - a[:-1, 1:]
    else:
        g = a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1]
        out[1:, 1:] = a[1:, 1:] - np.clip(g, 0, 255)
    return (out & 255).astype(np.uint8)


def alpha_unfilter(filtered: np.ndarray, method: int) -> np.ndarray:
    """filters.c's unfilters, row by row (the plain version the decoder is
    held to)."""
    h, w = filtered.shape
    out = np.zeros((h, w), np.uint8)
    for y in range(h):
        row = filtered[y].astype(np.int64)
        prev = out[y - 1].astype(np.int64) if y else None
        if method == 0:
            out[y] = filtered[y]
        elif method == 1 or prev is None:
            acc = prev[0] if prev is not None else 0
            for x in range(w):
                acc = (acc + row[x]) & 255
                out[y, x] = acc
        elif method == 2:
            out[y] = (prev + row) & 255
        else:
            left = prev[0]
            for x in range(w):
                top, tl = prev[x], prev[x - 1] if x else prev[0]
                left = (row[x] + np.clip(left + top - tl, 0, 255)) & 255
                out[y, x] = left
    return out


def alph_chunk(alpha: np.ndarray, method: int, filt: int, pre: int = 0,
               **vp8l) -> bytes:
    """An ALPH chunk's payload: raw rows (method 0) or a headerless VP8L
    stream whose green is the filtered alpha (method 1)."""
    f = alpha_filter(alpha, filt)
    head = bytes([method | filt << 2 | pre << 4])
    if method == 0:
        return head + f.tobytes()
    bw = LBitWriter()
    write_level0(bw, f.astype(np.uint32) << 8, **vp8l)
    return head + bw.tobytes()


# ---- VP8 ------------------------------------------------------------------------------

class BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 255)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, nbits: int) -> None:
        for k in range(nbits - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def signed(self, v: int, nbits: int) -> None:
        self.value(abs(v), nbits)
        self.put(1 if v < 0 else 0, 128)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 255)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out) + b"\x00\x00"


B_DC, B_TM, B_VE, B_HE = 0, 1, 2, 3  # libwebp's mode numbers
_CAT_PROBS = [(173, 148, 140), (176, 155, 140, 135),
              (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129)]


def _bmode_paths() -> dict:
    tree = table("kYModesIntra4")
    paths = {}

    def walk(node, path):
        for bit in (0, 1):
            nxt = int(tree[2 * node + bit])
            step = path + [(node, bit)]
            if nxt > 0:
                walk(nxt, step)
            else:
                paths[-nxt] = step
    walk(0, [])
    return paths


def _put_large(enc: BoolEncoder, v: int, p) -> None:
    if v <= 4:
        enc.put(0, p[3])
        if v == 2:
            enc.put(0, p[4])
        else:
            enc.put(1, p[4])
            enc.put(v - 3, p[5])
        return
    enc.put(1, p[3])
    if v <= 10:
        enc.put(0, p[6])
        if v <= 6:
            enc.put(0, p[7])
            enc.put(v - 5, 159)
        else:
            enc.put(1, p[7])
            enc.put((v - 7) >> 1, 165)
            enc.put((v - 7) & 1, 145)
        return
    enc.put(1, p[6])
    cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
    enc.put(cat >> 1, p[8])
    enc.put(cat & 1, p[9 + (cat >> 1)])
    extra = v - (3 + (8 << cat))
    probs = _CAT_PROBS[cat]
    for k, prob in enumerate(probs):
        enc.put((extra >> (len(probs) - 1 - k)) & 1, prob)


def _put_coeffs(enc: BoolEncoder, proba, typ: int, ctx: int, levels,
                first: int) -> bool:
    """One block's tokens (levels in zigzag order) -> whether it had a
    non-zero coefficient (the next blocks' context)."""
    bands = table("kBands")
    nz = [i for i in range(first, 16) if levels[i]]
    p = proba[typ][bands[first]][ctx]
    if not nz:
        enc.put(0, p[0])
        return False
    last = nz[-1]
    n = first
    while True:
        enc.put(1, p[0])
        while levels[n] == 0:
            enc.put(0, p[1])
            n += 1
            p = proba[typ][bands[n]][0]
        enc.put(1, p[1])
        v = abs(int(levels[n]))
        if v == 1:
            enc.put(0, p[2])
            ctx = 1
        else:
            enc.put(1, p[2])
            _put_large(enc, v, p)
            ctx = 2
        enc.put(1 if levels[n] < 0 else 0, 128)
        n += 1
        if n == 16:
            return True
        p = proba[typ][bands[n]][ctx]
        if n > last:
            enc.put(0, p[0])
            return True


def write_vp8(width: int, height: int, mbs, *, q: int = 40, dq=(0,) * 5,
              segment=None, filt=(False, 20, 0), lf_delta=None,
              partitions: int = 1, skip_prob=None, proba_updates=None,
              scale=(0, 0)) -> bytes:
    """A VP8 key frame's payload.

    mbs: one dict per macroblock in raster order: "ymode" (0-3, libwebp's
    DC / TM / V / H) or "bmodes" (16 modes 0-9), "uvmode", "segment",
    "skip" (no tokens; with skip_prob only), "coeffs": {block: 16 levels in
    zigzag order} with blocks 0-15 Y, 16-19 U, 20-23 V and 24 the Y2.
    segment: None or {"update_map": probs or None, "absolute": bool,
    "quant": 4 values, "filter": 4 values}.  filt: (simple, level,
    sharpness); lf_delta: (ref deltas, mode deltas) or None.
    proba_updates: {(t, b, c, p): value}."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    assert len(mbs) == mb_w * mb_h
    hdr = BoolEncoder()
    hdr.value(0, 1)  # colour space
    hdr.value(0, 1)  # clamping type
    hdr.value(1 if segment else 0, 1)
    seg_probs = (255, 255, 255)
    if segment:
        update_map = segment.get("update_map")
        hdr.value(1 if update_map else 0, 1)
        hdr.value(1, 1)  # update data
        hdr.value(1 if segment.get("absolute") else 0, 1)
        for v in segment["quant"]:
            hdr.value(1 if v else 0, 1)
            if v:
                hdr.signed(v, 7)
        for v in segment["filter"]:
            hdr.value(1 if v else 0, 1)
            if v:
                hdr.signed(v, 6)
        if update_map:
            seg_probs = update_map
            for v in update_map:
                hdr.value(1 if v != 255 else 0, 1)
                if v != 255:
                    hdr.value(v, 8)
    simple, level, sharpness = filt
    hdr.value(1 if simple else 0, 1)
    hdr.value(level, 6)
    hdr.value(sharpness, 3)
    hdr.value(1 if lf_delta else 0, 1)
    if lf_delta:
        hdr.value(1, 1)
        for v in list(lf_delta[0]) + list(lf_delta[1]):
            hdr.value(1 if v else 0, 1)
            if v:
                hdr.signed(v, 6)
    hdr.value({1: 0, 2: 1, 4: 2, 8: 3}[partitions], 2)
    hdr.value(q, 7)
    for v in dq:
        hdr.value(1 if v else 0, 1)
        if v:
            hdr.signed(v, 4)
    hdr.value(0, 1)  # refresh entropy probs
    proba = table("kCoeffsProba0").tolist()
    upd = table("kCoeffsUpdateProba")
    updates = proba_updates or {}
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    v = updates.get((t, b, c, p))
                    hdr.put(1 if v is not None else 0, int(upd[t, b, c, p]))
                    if v is not None:
                        hdr.value(v, 8)
                        proba[t][b][c][p] = v
    hdr.value(1 if skip_prob is not None else 0, 1)
    if skip_prob is not None:
        hdr.value(skip_prob, 8)
    # the modes, row by row
    bmp = table("kBModesProba")
    paths = _bmode_paths()
    intra_t = [B_DC] * (4 * mb_w)
    for my in range(mb_h):
        intra_l = [B_DC] * 4
        for mx in range(mb_w):
            mb = mbs[my * mb_w + mx]
            if segment and segment.get("update_map"):
                s = mb.get("segment", 0)
                hdr.put(1 if s >= 2 else 0, seg_probs[0])
                hdr.put(s & 1, seg_probs[1] if s < 2 else seg_probs[2])
            if skip_prob is not None:
                hdr.put(1 if mb.get("skip") else 0, skip_prob)
            top = intra_t[4 * mx:4 * mx + 4]
            if "bmodes" not in mb:
                ym = mb["ymode"]
                hdr.put(1, 145)
                hdr.put(1 if ym in (B_TM, B_HE) else 0, 156)
                if ym in (B_TM, B_HE):
                    hdr.put(1 if ym == B_TM else 0, 128)
                else:
                    hdr.put(1 if ym == B_VE else 0, 163)
                top = [ym] * 4
                intra_l = [ym] * 4
            else:
                hdr.put(0, 145)
                modes = mb["bmodes"]
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        m = modes[4 * y + x]
                        prob = bmp[top[x], left]
                        for node, bit in paths[m]:
                            hdr.put(bit, int(prob[node]))
                        top[x] = left = m
                    intra_l[y] = left
            intra_t[4 * mx:4 * mx + 4] = top
            uv = mb["uvmode"]
            hdr.put(0 if uv == B_DC else 1, 142)
            if uv != B_DC:
                hdr.put(0 if uv == B_VE else 1, 114)
                if uv != B_VE:
                    hdr.put(1 if uv == B_TM else 0, 183)
    first = hdr.flush()
    # the tokens, row r into partition r % partitions
    parts = [BoolEncoder() for _ in range(partitions)]
    top_nz = [[0] * 9 for _ in range(mb_w)]  # 4 Y, 2 U, 2 V, Y2
    for my in range(mb_h):
        left_nz = [0] * 9
        enc = parts[my % partitions]
        for mx in range(mb_w):
            mb = mbs[my * mb_w + mx]
            tn = top_nz[mx]
            if skip_prob is not None and mb.get("skip"):
                for k in range(8):
                    tn[k] = left_nz[k] = 0
                if "bmodes" not in mb:
                    tn[8] = left_nz[8] = 0
                continue
            coeffs = mb.get("coeffs", {})
            zero = [0] * 16
            if "bmodes" not in mb:
                nz = _put_coeffs(enc, proba, 1, tn[8] + left_nz[8],
                                 coeffs.get(24, zero), 0)
                tn[8] = left_nz[8] = int(nz)
                typ, first_c = 0, 1
            else:
                typ, first_c = 3, 0
            for y in range(4):
                for x in range(4):
                    nz = _put_coeffs(enc, proba, typ, tn[x] + left_nz[y],
                                     coeffs.get(4 * y + x, zero), first_c)
                    tn[x] = left_nz[y] = int(nz)
            for ch, base in ((0, 16), (1, 20)):
                for y in range(2):
                    for x in range(2):
                        t, l = 4 + 2 * ch + x, 4 + 2 * ch + y
                        nz = _put_coeffs(enc, proba, 2, tn[t] + left_nz[l],
                                         coeffs.get(base + 2 * y + x, zero),
                                         0)
                        tn[t] = left_nz[l] = int(nz)
    tokens = [e.flush() for e in parts]
    bits = 0 | 0 << 1 | 1 << 4 | len(first) << 5  # key frame, shown
    out = bytearray(bits.to_bytes(3, "little"))
    out += b"\x9d\x01\x2a"
    out += (width | scale[0] << 14).to_bytes(2, "little")
    out += (height | scale[1] << 14).to_bytes(2, "little")
    out += first
    for t in tokens[:-1]:
        out += len(t).to_bytes(3, "little")
    for t in tokens:
        out += t
    return bytes(out)


# ---- the cases ------------------------------------------------------------------------

def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(int(hashlib.sha256(name.encode())
                                     .hexdigest()[:8], 16))


def photo(height: int, width: int, seed: int = 0, bands: int = 3,
          noise: float = 0.008) -> np.ndarray:
    """A photo-like frame: smooth gradients, soft discs, mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64) / max(height, width)
    img = np.empty((height, width, bands))
    for c in range(bands):
        a, b, p = rng.uniform(0.5, 3.0, 3)
        img[..., c] = 0.5 + 0.23 * np.sin(a * 6 * x + p) * np.cos(b * 5 * y)
        for _ in range(6):
            cx, cy, r, v = rng.uniform(0, 1, 4)
            disc = ((x - cx) ** 2 + (y - cy) ** 2) < (0.05 + 0.2 * r) ** 2
            img[..., c] += np.where(disc, 0.3 * (v - 0.5), 0)
    img += rng.normal(0.0, noise, img.shape)
    return np.clip(np.rint(img * 255), 0, 255).astype(np.uint8)


def _opaque(rgb: np.ndarray) -> np.ndarray:
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)],
                          -1)


def _tiles(h: int, w: int, bits: int) -> int:
    return (-(-h // (1 << bits))) * (-(-w // (1 << bits)))


def _noise(name: str, h: int, w: int, alpha: bool = False) -> np.ndarray:
    img = _rng(name).integers(0, 256, (h, w, 4), dtype=np.uint8)
    if not alpha:
        img[..., 3] = 255
    return img


def _palette_image(name: str, h: int, w: int, n: int) -> tuple:
    rng = _rng(name)
    pal = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    pal = np.unique(pal.view("<u4").reshape(-1)).view(np.uint8).reshape(
        -1, 4)
    idx = rng.integers(0, len(pal), (h, w))
    return pal[idx], pal


def _repeats(name: str, h: int, w: int) -> np.ndarray:
    """Noise with stretches copied from the row above, above-left and
    above-right, a flat run and a long copy: LZ77's matter."""
    flat = _noise(name, h, w, alpha=True).reshape(-1, 4)
    n = len(flat)
    for at, length, dist in ((0.1, 0.1, w), (0.25, 0.08, w + 1),
                             (0.35, 0.05, 1), (0.45, 0.08, max(w - 1, 1)),
                             (0.6, 0.35, n // 2)):
        a, d = int(at * n), max(dist, 1)
        if a >= d:
            for i in range(a, min(a + int(length * n), n)):
                flat[i] = flat[i - d]
    return flat.reshape(h, w, 4)


def _vp8l_case(rgba, **spec) -> bytes:
    return riff([chunk(b"VP8L", write_vp8l(rgba, **spec))])


def _lossy_mbs(name: str, mb_w: int, mb_h: int, *, density=0.35, big=0,
               i4_share=0.5, skip_share=0.0, segments=1) -> list:
    """Seeded macroblocks: modes, sparse small levels (big > 0: some up to
    that size), the i16 macroblocks' Y2 levels."""
    rng = _rng(name)
    mbs = []
    for _ in range(mb_w * mb_h):
        mb = {"uvmode": int(rng.integers(0, 4)),
              "segment": int(rng.integers(0, segments))}
        if rng.random() < i4_share:
            mb["bmodes"] = [int(v) for v in rng.integers(0, 10, 16)]
        else:
            mb["ymode"] = int(rng.integers(0, 4))
        coeffs = {}
        for k in range(25):
            lv = rng.integers(-4, 5, 16) * (rng.random(16) < density)
            lv = lv * (rng.random(16) < np.linspace(1.0, 0.2, 16))
            if big and rng.random() < 0.3:
                lv[rng.integers(0, 16)] = int(rng.integers(-big, big + 1))
            coeffs[k] = [int(v) for v in lv]
        mb["coeffs"] = coeffs
        if skip_share and rng.random() < skip_share:
            mb["skip"] = True
            mb["coeffs"] = {}
        mbs.append(mb)
    return mbs


def _vp8_case(name: str, width: int, height: int, mb_spec=None,
              **spec) -> bytes:
    mbs = _lossy_mbs(name, (width + 15) // 16, (height + 15) // 16,
                     **(mb_spec or {}))
    return riff([chunk(b"VP8 ", write_vp8(width, height, mbs, **spec))])


def _edge_modes() -> list:
    """4 x 3 macroblocks: each 16x16 mode, each 4x4 mode and each chroma
    mode on the top row, the left column and the corner."""
    mbs = []
    for i in range(12):
        mb = {"uvmode": i % 4, "coeffs": {}}
        if i % 3 == 1:
            mb["bmodes"] = [(i + k) % 10 for k in range(16)]
        else:
            mb["ymode"] = (i // 3 + i) % 4
        mbs.append(mb)
    return mbs


def _saturating() -> list:
    """Levels of category 6 at the largest quantiser: the dequantised
    coefficients wrap int16, and Transform_SSE2's 16-bit lanes wrap with
    them (blocks of more than three coefficients); blocks of two or three
    large coefficients (106 x 284 = 30104) take libwebp's 32-bit C code,
    DC-only blocks too."""
    mbs = _lossy_mbs("saturate", 3, 2, big=2114, density=0.5)
    for mb in mbs[:2]:
        mb.pop("bmodes", None)
        mb["ymode"] = B_TM
        mb["coeffs"] = {k: [0, 106, -106] + [0] * 13 for k in range(16)}
        mb["coeffs"][24] = [2114, -2114, 2114] + [0] * 13
    mbs[2]["bmodes"] = [0] * 16
    mbs[2]["coeffs"] = {k: [2114 if k % 2 else -2114] + [0] * 15
                        for k in range(24)}
    return mbs


def _dc_near_int16_max() -> list:
    """At quantiser 34 (DC step 31) a DC level of 1057 dequantises to
    32767, where a 16-bit DC + 4 would wrap: libwebp's DC-only transforms
    (luma and chroma) are 32-bit C code."""
    mbs = []
    for i in range(4):
        sign = 1 if i % 2 == 0 else -1
        mbs.append({"bmodes": [(i + k) % 10 for k in range(16)],
                    "uvmode": i % 4,
                    "coeffs": {k: [sign * 1057] + [0] * 15
                               for k in range(24)}})
    return mbs


def _alpha_plane(h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    a = (128 + 100 * np.sin(x / 3.0) * np.cos(y / 4.0)).astype(np.int64)
    a[: h // 3, : w // 3] = 255
    a[h // 2:, w // 2:] = (x[h // 2:, w // 2:] * 37 + y[h // 2:, w // 2:]
                           * 11) % 256
    return a.astype(np.uint8)


def _alph_case(method: int, filt: int, pre: int = 0, flag: bool = True,
               **vp8l) -> bytes:
    w, h = 37, 21
    frame = write_vp8(w, h, _lossy_mbs("alph_frame", 3, 2))
    alph = alph_chunk(_alpha_plane(h, w), method, filt, pre, **vp8l)
    return riff([vp8x(ALPHA if flag else 0, w, h), chunk(b"ALPH", alph),
                 chunk(b"VP8 ", frame)])


ALPHA, ANIMATION, XMP, EXIF, ICCP = 0x10, 0x02, 0x04, 0x08, 0x20


def _anim_case(alpha_flag: bool, first: str) -> bytes:
    cw, ch = 41, 30
    if first == "lossy":
        f0 = (chunk(b"ALPH", alph_chunk(_alpha_plane(12, 17), 1, 3,
                                        cache_bits=2))
              + chunk(b"VP8 ", write_vp8(17, 12, _lossy_mbs("anim0", 2, 1))))
        w0, h0 = 17, 12
    else:
        img = _noise("anim0l", 13, 19, alpha=True)
        f0 = chunk(b"VP8L", write_vp8l(img, transforms=["subtract_green"]))
        w0, h0 = 19, 13
    f1 = chunk(b"VP8L", write_vp8l(_noise("anim1", ch, cw)))
    return riff([vp8x((ALPHA if alpha_flag else 0) | ANIMATION, cw, ch),
                 anim(), anmf(6, 8, w0, h0, f0, bits=2),
                 anmf(0, 0, cw, ch, f1)])


def _metadata_case() -> bytes:
    img = _noise("meta", 11, 9)
    exif = (b"Exif\x00\x00II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00"
            b"\x01\x00\x00\x00\x06\x00\x00\x00\x00\x00\x00\x00")
    return riff([vp8x(ICCP | EXIF | XMP, 9, 11), chunk(b"ICCP", b"\x00" * 7),
                 chunk(b"VP8L", write_vp8l(img)), chunk(b"EXIF", exif),
                 chunk(b"XMP ", b"<x:xmpmeta/>"), chunk(b"ABCD", b"xyz")])


def _odd_payload_case() -> bytes:
    img = _noise("odd", 5, 7)
    payload = write_vp8l(img)
    if not len(payload) & 1:
        payload += b"\x00"
    return riff([chunk(b"VP8L", payload), chunk(b"JUNK", b"q")]) + b"trail"


_P = "predictor"
CASES = {
    # VP8L
    "vp8l_plain": lambda: _vp8l_case(_opaque(photo(19, 23, 1))),
    "vp8l_subtract_green": lambda: _vp8l_case(
        _opaque(photo(17, 21, 2)), transforms=["subtract_green"]),
    "vp8l_predictor_modes": lambda: _vp8l_case(
        _noise("pm", 24, 40, alpha=True),
        transforms=[(_P, 2, np.arange(_tiles(24, 40, 2)) % 16)]),
    "vp8l_predictor_photo": lambda: _vp8l_case(
        _opaque(photo(33, 35, 3)),
        transforms=[(_P, 3, (np.arange(_tiles(33, 35, 3)) * 5) % 14)]),
    "vp8l_cross_color": lambda: _vp8l_case(
        _noise("cc", 20, 30), transforms=[("cross_color", 2, _rng(
            "ccm").integers(-128, 128, (_tiles(20, 30, 2), 3)))]),
    **{f"vp8l_palette{n}": (lambda n=n: _vp8l_case(
        _palette_image(f"pal{n}", 13, 29, n)[0],
        transforms=[("palette", _palette_image(f"pal{n}", 13, 29, n)[1])]))
       for n in (2, 3, 11, 200)},
    "vp8l_palette_then_predictor": lambda: _vp8l_case(
        _palette_image("pp", 16, 27, 14)[0],
        transforms=[("palette", _palette_image("pp", 16, 27, 14)[1]),
                    (_P, 2, np.arange(_tiles(16, 14, 2)) % 14)]),
    **{f"vp8l_cache{b}": (lambda b=b: _vp8l_case(
        _palette_image(f"c{b}", 21, 25, 40)[0], cache_bits=b))
       for b in (1, 4, 11)},
    "vp8l_lz77_short": lambda: _vp8l_case(
        _repeats("lzs", 24, 31), lz77={"distances": [1, 2, 3, 4]}),
    "vp8l_lz77_plane": lambda: _vp8l_case(
        _repeats("lzp", 24, 31), lz77={"distances": [1, 31, 32, 30, 62]}),
    "vp8l_lz77_long": lambda: _vp8l_case(
        _repeats("lzl", 96, 91), lz77={"distances": [1, 91, 91 * 45],
                                       "linear": True}),
    "vp8l_meta": lambda: _vp8l_case(
        _noise("meta", 22, 26, alpha=True),
        meta=(2, np.arange(_tiles(22, 26, 2)) % 5), cache_bits=3),
    "vp8l_simple_codes": lambda: _vp8l_case(
        np.stack([_rng("sc").integers(0, 2, (14, 18)) * 200,
                  _rng("sc2").integers(0, 2, (14, 18)),
                  np.full((14, 18), 77), np.full((14, 18), 255)],
                 -1).astype(np.uint8)),
    "vp8l_max_symbol": lambda: _vp8l_case(
        _opaque(photo(15, 19, 4) // 16), simple=False, max_symbol=True),
    "vp8l_everything": lambda: _vp8l_case(
        _repeats("all", 40, 44),
        transforms=["subtract_green",
                    (_P, 3, np.arange(_tiles(40, 44, 3)) % 14),
                    ("cross_color", 4, _rng("allc").integers(
                        -128, 128, (_tiles(40, 44, 4), 3)))],
        cache_bits=6, meta=(3, np.arange(_tiles(40, 44, 3)) % 4),
        lz77={"distances": [1, 44, 45, 43, 88]}, max_symbol=True,
        sub_cache_bits=2),
    "vp8l_1x1": lambda: _vp8l_case(_noise("one", 1, 1, alpha=True)),
    "vp8l_width1": lambda: _vp8l_case(
        _repeats("w1", 40, 1), lz77={"distances": [1, 2, 3]},
        transforms=[(_P, 2, np.arange(10) % 14)]),
    "vp8l_height1": lambda: _vp8l_case(
        _repeats("h1", 1, 50), lz77={"distances": [1, 2]}),
    "vp8l_alpha_bit_off_translucent": lambda: _vp8l_case(
        _noise("abo", 9, 10, alpha=True), alpha_bit=0),
    "vp8l_in_vp8x_without_flag": lambda: riff([
        vp8x(0, 10, 9),
        chunk(b"VP8L", write_vp8l(_noise("ivx", 9, 10, alpha=True)))]),
    # ALPH
    **{f"alph_raw_filter{f}": (lambda f=f: _alph_case(0, f))
       for f in range(4)},
    **{f"alph_vp8l_filter{f}": (lambda f=f: _alph_case(
        1, f, cache_bits=f, transforms=[(_P, 2, np.arange(60) % 14)]
        if f == 3 else ()))
       for f in range(4)},
    "alph_preprocessed": lambda: _alph_case(1, 1, pre=1),
    "alph_without_flag": lambda: _alph_case(0, 2, flag=False),
    "vp8x_alpha_flag_without_alph": lambda: riff([
        vp8x(ALPHA, 37, 21),
        chunk(b"VP8 ", write_vp8(37, 21, _lossy_mbs("alph_frame", 3, 2)))]),
    # VP8
    "vp8_normal_filter": lambda: _vp8_case("nf", 40, 33, skip_prob=180,
                                           filt=(False, 20, 0)),
    "vp8_simple_filter": lambda: _vp8_case("sf", 40, 33, filt=(True, 32, 0)),
    "vp8_simple_filter_sharp": lambda: _vp8_case("sfs", 40, 33,
                                                 filt=(True, 50, 6)),
    "vp8_filter_level0": lambda: _vp8_case("f0", 40, 33,
                                           filt=(False, 0, 3)),
    **{f"vp8_sharpness{s}": (lambda s=s: _vp8_case(
        f"sh{s}", 35, 18, filt=(False, 9 * s, s))) for s in range(1, 8)},
    **{f"vp8_partitions{p}": (lambda p=p: _vp8_case(
        f"p{p}", 24, 150, partitions=p, mb_spec={"i4_share": 0.3}))
       for p in (2, 4, 8)},
    "vp8_lf_deltas": lambda: _vp8_case(
        "lfd", 40, 33, filt=(False, 24, 2),
        lf_delta=((9, -3, 2, 1), (-12, 4, 0, 7))),
    "vp8_segments_map": lambda: _vp8_case(
        "segm", 48, 40, mb_spec={"segments": 4},
        segment={"update_map": (120, 90, 200), "absolute": False,
                 "quant": (0, -20, 15, 40), "filter": (0, -10, 12, 30)},
        filt=(False, 16, 0)),
    "vp8_segments_absolute": lambda: _vp8_case(
        "sega", 48, 40, mb_spec={"segments": 4},
        segment={"update_map": (255, 60, 255), "absolute": True,
                 "quant": (10, 127, 60, 3), "filter": (0, 63, 14, 40)},
        filt=(False, 30, 0)),
    "vp8_segments_without_map": lambda: _vp8_case(
        "segn", 40, 33,
        segment={"update_map": None, "absolute": False,
                 "quant": (-30, 5, 5, 5), "filter": (20, 0, 0, 0)}),
    "vp8_no_skip_probability": lambda: _vp8_case("nsp", 40, 33),
    "vp8_skipped_macroblocks": lambda: _vp8_case(
        "skm", 48, 40, skip_prob=90, mb_spec={"skip_share": 0.4}),
    "vp8_probability_updates": lambda: _vp8_case(
        "pu", 40, 33, proba_updates={
            (t, b, c, p): int(v) for (t, b, c, p), v in zip(
                [(t, b, c, p) for t in range(4) for b in range(8)
                 for c in range(3) for p in range(11)][::7],
                _rng("puv").integers(1, 256, 200))}),
    "vp8_modes_on_edges": lambda: riff([chunk(b"VP8 ", write_vp8(
        64, 48, _edge_modes()))]),
    "vp8_modes_on_edges_coded": lambda: riff([chunk(b"VP8 ", write_vp8(
        64, 48, [{**m, "coeffs": c["coeffs"]} for m, c in zip(
            _edge_modes(), _lossy_mbs("emc", 4, 3))], filt=(False, 10, 0)))]),
    "vp8_saturating": lambda: riff([chunk(b"VP8 ", write_vp8(
        48, 32, _saturating(), q=127, filt=(False, 40, 0)))]),
    "vp8_dc_near_int16_max": lambda: riff([chunk(b"VP8 ", write_vp8(
        32, 32, _dc_near_int16_max(), q=34))]),
    "vp8_quantiser_deltas": lambda: _vp8_case(
        "qd", 40, 33, q=3, dq=(-7, 5, -8, 15, -6)),
    "vp8_quantiser_high": lambda: _vp8_case(
        "qh", 40, 33, q=120, dq=(7, 7, 7, 7, 7), mb_spec={"big": 300}),
    "vp8_odd_size_scaled": lambda: _vp8_case("odd", 33, 17, scale=(1, 3)),
    "vp8_hev_thresholds": lambda: _vp8_case(
        "hev", 64, 32, mb_spec={"segments": 4},
        segment={"update_map": (128, 128, 128), "absolute": True,
                 "quant": (30, 30, 30, 30), "filter": (14, 15, 39, 40)}),
    "vp8_1x1": lambda: _vp8_case("v11", 1, 1),
    "vp8_1x17": lambda: _vp8_case("v117", 1, 17),
    # the container
    "container_metadata_chunks": _metadata_case,
    "container_odd_payload_trailing": _odd_payload_case,
    "anim_first_frame_offset_lossy": lambda: _anim_case(True, "lossy"),
    "anim_first_frame_offset_lossless": lambda: _anim_case(True, "vp8l"),
    "anim_without_alpha_flag": lambda: _anim_case(False, "lossy"),
}


def case_bytes(name: str) -> bytes:
    return {**CASES, **REFUSED_CASES}[name]()


def _cut(data: bytes, at: int) -> bytes:
    return data[:at]


def _patched(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


def _shrunk_chunk(tag: bytes, payload: bytes, keep: int) -> bytes:
    """A file whose chunk holds only the first `keep` bytes of payload."""
    return riff([chunk(tag, payload[:keep])])


# files PIL refuses: name -> bytes
REFUSED_CASES = {
    "truncated_file": lambda: _cut(CASES["vp8l_plain"](), 300),
    "riff_size_past_end": lambda: riff([chunk(b"VP8L", write_vp8l(
        _noise("r", 5, 5)))], riff_size=len(write_vp8l(_noise("r", 5, 5)))
        + 40),
    "riff_size_odd_short": lambda: (lambda d: _patched(
        d, 4, struct.pack("<I", len(d) - 9)))(CASES["vp8l_1x1"]()),
    "stray_bytes_in_riff": lambda: (lambda c: riff(
        [c], riff_size=4 + len(c) + 3) + b"abc")(
        chunk(b"VP8L", write_vp8l(_noise("s", 5, 5)))),
    "vp8_not_key_frame": lambda: (lambda d: _patched(
        d, 20, bytes([d[20] | 1])))(CASES["vp8_1x1"]()),
    "vp8_bad_start_code": lambda: (lambda d: _patched(
        d, 23, b"\x9d\x02"))(CASES["vp8_1x1"]()),
    "vp8_truncated_tokens": lambda: _shrunk_chunk(
        b"VP8 ", write_vp8(40, 33, _lossy_mbs("tt", 3, 3, density=0.9)),
        120),
    "vp8_partition_past_chunk": lambda: (lambda p: riff([chunk(
        b"VP8 ", ((p[0] | p[1] << 8 | p[2] << 16) & 0x1F
                  | (len(p) + 5) << 5).to_bytes(3, "little") + p[3:])]))(
        write_vp8(16, 16, _lossy_mbs("pp", 1, 1))),
    "vp8l_bad_signature": lambda: (lambda d: _patched(d, 20, b"\x2e"))(
        CASES["vp8l_1x1"]()),
    "vp8l_truncated_stream": lambda: _shrunk_chunk(
        b"VP8L", write_vp8l(_noise("ts", 20, 20)), 400),
    "vp8l_after_alph": lambda: riff([
        vp8x(ALPHA, 5, 5), chunk(b"ALPH", b"\x00" + b"\x80" * 25),
        chunk(b"VP8L", write_vp8l(_noise("aa", 5, 5)))]),
    "vp8x_canvas_mismatch": lambda: riff([
        vp8x(0, 6, 5), chunk(b"VP8L", write_vp8l(_noise("cm", 5, 5)))]),
    "vp8x_reserved_flag": lambda: riff([
        vp8x(0x01, 5, 5), chunk(b"VP8L", write_vp8l(_noise("rf", 5, 5)))]),
    "vp8x_without_image": lambda: riff([vp8x(0, 5, 5),
                                        chunk(b"EXIF", b"none")]),
    "alph_reserved_bits": lambda: riff([
        vp8x(ALPHA, 16, 16), chunk(b"ALPH", b"\xc0" + b"\x80" * 256),
        chunk(b"VP8 ", write_vp8(16, 16, _lossy_mbs("ar", 1, 1)))]),
    "alph_raw_truncated": lambda: riff([
        vp8x(ALPHA, 16, 16), chunk(b"ALPH", b"\x00" + b"\x80" * 200),
        chunk(b"VP8 ", write_vp8(16, 16, _lossy_mbs("at", 1, 1)))]),
    "alph_vp8l_truncated": lambda: riff([
        vp8x(ALPHA, 37, 21), chunk(b"ALPH", alph_chunk(
            _alpha_plane(21, 37), 1, 0)[:30]),
        chunk(b"VP8 ", write_vp8(37, 21, _lossy_mbs("alph_frame", 3, 2)))]),
    "anim_frame_past_canvas": lambda: riff([
        vp8x(ANIMATION, 20, 20), anim(),
        anmf(10, 10, 12, 12, chunk(b"VP8L", write_vp8l(_noise(
            "fp", 12, 12))))]),
    "anim_frame_without_animation_flag": lambda: riff([
        vp8x(0, 12, 12), anim(),
        anmf(0, 0, 12, 12, chunk(b"VP8L", write_vp8l(_noise(
            "fa", 12, 12))))]),
}

# the files PIL's own encoder writes: name -> (source mode, size, save
# options); main() writes them with PIL, the committed bytes are the case
PIL_CASES = {
    **{f"pil_lossy_q{q}": ("RGB", (48, 40), {"quality": q})
       for q in (1, 50, 90, 100)},
    **{f"pil_lossy_method{m}": ("RGB", (48, 40), {"method": m})
       for m in (0, 6)},
    **{f"pil_lossless_method{m}": ("RGB", (48, 40), {"lossless": True,
                                                     "method": m})
       for m in (0, 6)},
    "pil_lossless_exact": ("RGBA", (40, 33), {"lossless": True,
                                              "exact": True}),
    "pil_lossy_alpha_quality30": ("RGBA", (40, 33), {"quality": 80,
                                                     "alpha_quality": 30}),
    "pil_lossy_rgba": ("RGBA", (40, 33), {"quality": 80}),
    "pil_lossy_from_l": ("L", (40, 33), {"quality": 70}),
    "pil_lossy_from_la": ("LA", (40, 33), {"quality": 70}),
    **{f"pil_lossy_{w}x{h}": ("RGB", (w, h), {"quality": 85})
       for w, h in ((1, 1), (1, 17), (17, 1), (17, 33), (33, 17))},
    **{f"pil_lossless_{w}x{h}": ("RGBA", (w, h), {"lossless": True})
       for w, h in ((1, 1), (17, 33), (33, 17))},
    "pil_save_all_animation": ("RGBA", (36, 28), {"save_all": True,
                                                  "duration": 40}),
}
FRAMES = [f"frame_{i:05d}" for i in range(5)]  # tests/golden/jpeg's pixels


def pil_source(name: str):
    """The PIL image PIL_CASES[name] saves (and, for the animation, the
    frames it appends)."""
    from PIL import Image

    mode, (w, h), opts = PIL_CASES[name]
    rgb = photo(h, w, 7 + len(name), noise=0.03)
    alpha = _alpha_plane(h, w)
    img = Image.fromarray(np.concatenate([rgb, alpha[..., None]], -1),
                          "RGBA")
    if opts.get("exact"):
        arr = np.asarray(img).copy()
        arr[::3, ::2, 3] = 0  # hidden colours under zero alpha
        img = Image.fromarray(arr, "RGBA")
    if opts.get("save_all"):
        more = [Image.fromarray(np.roll(np.asarray(img), 5 * k, 1), "RGBA")
                for k in (1, 2)]
        return img, more
    return img.convert(mode), []


def frame_pixels(i: int) -> np.ndarray:
    """tests/golden/jpeg/frame_0000i.jpg's pixels, as PIL decodes them."""
    from PIL import Image

    with Image.open(os.path.join(os.path.dirname(HERE), "jpeg",
                                 f"frame_{i:05d}.jpg")) as img:
        return np.asarray(img.convert("RGB"))


# the 800x800 kinds chip_smoke.py times: lossless from the writer (the
# photo's samples), and the committed lossy frame with the writer's ALPH
def timed_lossless(size: int = 800) -> tuple:
    """-> (file bytes, the (size, size, 3) samples it holds)."""
    rgb = photo(size, size, 11)
    data = write_vp8l(_opaque(rgb), transforms=[
        "subtract_green", (_P, 4, np.full(_tiles(size, size, 4), 11)),
        ("cross_color", 5, _rng("t").integers(-20, 20, (_tiles(
            size, size, 5), 3)))], cache_bits=10,
        lz77={"distances": [1, size]})
    return riff([chunk(b"VP8L", data)]), rgb


def timed_lossy_alpha(frame_file: bytes) -> tuple:
    """A committed 800x800 lossy frame with an ALPH chunk (VP8L-compressed,
    gradient filter) -> (file bytes, the alpha plane)."""
    vp8 = frame_file[12:]
    assert vp8[:4] == b"VP8 "
    size = struct.unpack_from("<I", vp8, 4)[0]
    payload = vp8[8:8 + size]
    w = (payload[6] | payload[7] << 8) & 0x3FFF
    h = (payload[8] | payload[9] << 8) & 0x3FFF
    alpha = _alpha_plane(h, w)
    return riff([vp8x(ALPHA, w, h),
                 chunk(b"ALPH", alph_chunk(alpha, 1, 3, cache_bits=4)),
                 chunk(b"VP8 ", payload)]), alpha


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def fixture_name(name: str) -> str:
    return f"{name}.webp"


def main() -> None:
    from PIL import Image, features

    files = {}

    def record(name):
        path = os.path.join(HERE, fixture_name(name))
        with Image.open(path) as img:
            files[fixture_name(name)] = digest(img.mode, np.asarray(img))

    for name in CASES:
        with open(os.path.join(HERE, fixture_name(name)), "wb") as f:
            f.write(case_bytes(name))
        record(name)
    for name, (_, _, opts) in PIL_CASES.items():
        img, more = pil_source(name)
        kw = {k: v for k, v in opts.items() if k != "save_all"}
        if more:
            kw.update(save_all=True, append_images=more)
        img.save(os.path.join(HERE, fixture_name(name)), "WEBP", **kw)
        record(name)
    for i, name in enumerate(FRAMES):
        Image.fromarray(frame_pixels(i)).save(
            os.path.join(HERE, fixture_name(name)), "WEBP", quality=90)
        record(name)
    with open(DIGESTS, "w") as f:
        json.dump({"pil": Image.__version__,
                   "libwebp": features.version("webp"), "files": files},
                  f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
