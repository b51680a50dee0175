"""Write rsn_torch/data/native/av1_tables.h from the libavif PIL ships.

PIL 12.1.0 reads AVIF through pillow.libs/libavif-01e67780.so.16.3.0,
which links dav1d 1.5.1 (the decoder) and libaom 3.12.1 (the encoder)
statically.  Both carry the AV1 specification's default tables: dav1d in
its own padded layout (each CDF stored as 32768 - x, then a counter slot,
padded to a power of two), libaom in the AOM_CDFn layout (32768 - x, then
0 for the last symbol and a counter).  This script finds each table in the
library by its first entries and its shape, reads it from both copies
where both hold it and requires them to agree, checks every CDF (strictly
increasing, below 32768), and writes plain C arrays in the
specification's layout (x, ..., 32768, 0).

The quantizer lookups, the smooth weights, the filter-intra taps, the
directional derivatives, the DCT / ADST constants and the self-guided
parameters are read the same way; the scan orders are generated from
their definition and required to occur in both copies (which store them
transposed, column by column).

Run it with numpy and the standard library only:

    python tests/golden/avif/extract_av1_tables.py [--check]

--check compares the committed header with what the library gives and
exits 1 when they differ.
"""
from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
HEADER = os.path.join(REPO, "rsn_torch", "data", "native", "av1_tables.h")
LIB_NAME = "libavif-01e67780.so.16.3.0"


def library_path():
    try:
        import PIL
    except ImportError:
        return None
    site = os.path.dirname(os.path.dirname(PIL.__file__))
    path = os.path.join(site, "pillow.libs", LIB_NAME)
    return path if os.path.isfile(path) else None


class Lib:
    def __init__(self, path):
        self.b = open(path, "rb").read()
        self.u16 = np.frombuffer(self.b[:len(self.b) // 2 * 2], dtype="<u2")

    def find(self, vals, fmt, lo=0, hi=None):
        pat = struct.pack("<%d%s" % (len(vals), fmt), *vals)
        hi = len(self.b) if hi is None else hi
        out, i = [], self.b.find(pat, lo, hi)
        while i >= 0:
            out.append(i)
            i = self.b.find(pat, i + 1, hi)
        return out

    def read(self, off, fmt, n):
        return list(struct.unpack_from("<%d%s" % (n, fmt), self.b, off))


# Byte ranges of the two copies of the CDF tables in the library: libaom's
# entropy tables sit below dav1d's.
AOM = (4_400_000, 4_530_000)
DAV1D = (4_655_000, 4_700_000)


def walk(lib, off, nsyms):
    """Read CDFs from byte offset `off` in the 32768 - x layout: each is
    len-1 nonzero values followed by zeros (the last symbol, a counter,
    padding).  -> (list of CDFs in the specification's form, end offset)."""
    a = lib.u16
    i = off // 2
    out = []
    for n in nsyms:
        while a[i] == 0:
            i += 1
        vals = [int(v) for v in a[i:i + n - 1]]
        if a[i + n - 1] != 0 or any(v == 0 for v in vals):
            raise ValueError(f"no {n}-symbol CDF at byte {2 * i}")
        cdf = [32768 - v for v in vals]
        if any(not 0 < x < 32768 for x in cdf) or any(
                x >= y for x, y in zip(cdf, cdf[1:])):
            raise ValueError(f"not a CDF at byte {2 * i}: {cdf}")
        out.append(cdf)
        i += n
    return out, 2 * i


def locate(lib, rng, first, skip=0, lowest=False):
    """Byte offset of the unique run of CDFs `first` (specification form,
    each followed by a zero) in `rng`; `skip` CDFs of the run are context
    and the table starts after them."""
    a = lib.u16
    cands = lib.find([32768 - x for x in first[0]] + [0], "H", *rng)
    hits = []
    for c in cands:
        try:
            got, _ = walk(lib, c, [len(f) + 1 for f in first])
        except (ValueError, IndexError):
            continue
        if got == first:
            hits.append(c)
    if lowest and hits:
        hits = hits[:1]
    if len(hits) != 1:
        return None if not hits else ValueError(f"{len(hits)} hits")
    off = hits[0]
    if skip:
        _, off = walk(lib, off, [len(f) + 1 for f in first[:skip]])
        while a[off // 2] == 0:
            off += 2
    return off


def prod(dims):
    n = 1
    for d in dims:
        n *= d
    return n


# name, dims (without the CDF axis), symbols per CDF (int, or a list for
# one CDF each), the first CDFs that find it in dav1d's copy (and how many
# of those are context), the same for libaom's copy (None: libaom keeps no
# array of its own for it; a compiler copies it with immediate stores).
CDFS = []


def cdf(name, dims, nsym, dav1d, aom=None, dav1d_skip=0, aom_skip=0,
        aom_take=None, dav1d_order=None, aom_lowest=False):
    CDFS.append(dict(name=name, dims=dims, nsym=nsym, dav1d=dav1d, aom=aom,
                     dav1d_skip=dav1d_skip, aom_skip=aom_skip,
                     aom_take=aom_take, dav1d_order=dav1d_order,
                     aom_lowest=aom_lowest))


Q = [[15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165,
      29093, 30466]]
cdf("kf_y_mode", [5, 5], 13, Q, Q)
U0 = [[22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244, 30059,
       30941, 31961]]
cdf("uv_mode_cfl_not_allowed", [13], 13, U0, U0)
U1 = [[10407, 11208, 12900, 13181, 13823, 14175, 14899, 15656, 15986, 20086,
       20995, 22455, 24212]]
cdf("uv_mode_cfl_allowed", [13], 14, U1, U1)
P8 = [[19132, 25510, 30392]]
cdf("partition_w8", [4], 4, P8, P8)
P16 = [[15597, 20929, 24571, 26706, 27664, 28821, 29601, 30571, 31902]]
cdf("partition_w16", [4], 10, P16, P16)
P32 = [[18462, 20920, 23124, 27647, 28227, 29049, 29519, 30178, 31544]]
cdf("partition_w32", [4], 10, P32, P32)
P64 = [[20137, 21547, 23078, 29566, 29837, 30261, 30524, 30892, 31724]]
cdf("partition_w64", [4], 10, P64, P64)
P128 = [[27899, 28219, 28529, 32484, 32539, 32619, 32639]]
cdf("partition_w128", [4], 8, P128, P128)
cdf("skip", [3], 2, [[31671], [16515], [4576]])
cdf("segment_id", [3], 8, [[5622, 7893, 16093, 18233, 27809, 28373, 32533]])
DQ = [[16803, 22759], [28160, 32120, 32677]]
cdf("delta_q", [], 4, DQ, dav1d_skip=1)
cdf("delta_lf", [], 4, DQ + [[28160, 32120, 32677]], dav1d_skip=2)
TX8 = [[19968], [19968], [24320]]
cdf("tx_8x8", [3], 2, TX8, TX8)
TX16 = [[12272, 30172], [12272, 30172], [18677, 30848]]
cdf("tx_16x16", [3], 3, TX16, TX16)
TX32 = [[12986, 15180], [12986, 15180], [24302, 25602]]
cdf("tx_32x32", [3], 3, TX32, TX32)
TX64 = [[5782, 11475], [5782, 11475], [16803, 22759]]
cdf("tx_64x64", [3], 3, TX64, TX64)
# dav1d orders block sizes from 128x128 down to 4x4
BS_DAV1D = [15, 14, 13, 12, 11, 21, 10, 9, 8, 19, 20, 7, 6, 5, 17, 18, 4, 3,
            2, 16, 1, 0]
cdf("filter_intra", [22], 2, [[16384]] * 7 + [[22343], [12756]],
    [[4621], [6743], [5893], [7866], [12551]], dav1d_order=BS_DAV1D)
cdf("filter_intra_mode", [], 5, [[8949, 12776, 17211, 29558]])
cdf("cfl_sign", [], 8, [[1418, 2123, 13340, 18405, 26972, 28343, 32294]])
CA = [[7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704,
       32708, 32712, 32716, 32720, 32724]]
cdf("cfl_alpha", [6], 16, CA, CA)
AD = [[2180, 5032, 7567, 22776, 26989, 30217]]
cdf("angle_delta", [8], 7, AD, AD)
PY = [[31676], [3419], [1261]]
cdf("palette_y_mode", [7, 3], 2, PY, PY)
cdf("palette_uv_mode", [2], 2, [[32461], [21488]])
PS = [[7952, 13000, 18149, 21478, 25527, 29241]]
cdf("palette_y_size", [7], 7, PS, PS)
PU = [[8713, 19979, 27128, 29609, 31331, 32272]]
cdf("palette_uv_size", [7], 7, PU, PU)
CY = [[28710], [16384], [10553], [27036], [31603]]
cdf("palette_y_color", [], sum(([n] * 5 for n in range(2, 9)), []), CY, CY)
CU = [[29089], [16384], [8713], [29257], [31610]]
cdf("palette_uv_color", [], sum(([n] * 5 for n in range(2, 9)), []), CU, CU)
S1 = [[1535, 8035, 9461, 12751, 23467, 27825]]
cdf("intra_tx_set1", [2, 13], 7, S1, S1)
S2 = [[3409, 5436, 10599, 15599, 19687, 24040],
      [6554, 13107, 19661, 26214]]
cdf("intra_tx_set2", [3, 13], 5, [[3511, 6332, 11165, 15335, 19323, 23594],
                                  [6554, 13107, 19661, 26214]],
    dav1d_skip=1)
cdf("restoration_switchable", [], 3, [[9413, 22581]])
cdf("restoration_wiener", [], 2, [[11570]])
cdf("restoration_sgrproj", [], 2, [[16855]])
# coefficient CDFs, one set per quantizer context
cdf("txb_skip", [4, 5, 13], 2, None, [[31849], [5892], [12112]])
cdf("eob_pt_16", [4, 2, 2], 5, None, [[840, 1039, 1980, 4895], [370, 671, 1883, 4471]])
cdf("eob_pt_32", [4, 2, 2], 6, None, [[400, 520, 977, 2102, 6542], [210, 405, 1315, 3326, 7537]])
cdf("eob_pt_64", [4, 2, 2], 7, None, [[329, 498, 1101, 1784, 3265, 7758],
     [335, 730, 1459, 5494, 8755, 12997]])
cdf("eob_pt_128", [4, 2, 2], 8, None,
    [[219, 482, 1140, 2091, 3680, 6028, 12586]])
cdf("eob_pt_256", [4, 2, 2], 9, None,
    [[310, 584, 1887, 3589, 6168, 8611, 11352, 15652]])
# libaom keeps a context axis of 2 on the 512 and 1024 tables, of which
# only context 0 is read (their transforms are all of the 2D class)
cdf("eob_pt_512", [4, 2], 10, None,
    [[641, 983, 3707, 5430, 10234, 14958, 18788, 23412, 26061]],
    aom_take=(2, 0))
cdf("eob_pt_1024", [4, 2], 11, None,
    [[393, 421, 751, 1623, 3160, 6352, 13345, 18047, 22571, 25830]],
    aom_take=(2, 0))
cdf("eob_extra", [4, 5, 2, 9], 2, None, [[16961], [17223], [7621]])
# the four quantizer contexts hold the same dc_sign CDFs: the table is
# the first of the four runs
cdf("dc_sign", [4, 2, 3], 2, None, [[16000], [13056], [18816]],
    aom_lowest=True)
cdf("coeff_base_eob", [4, 5, 2, 4], 3, None, [[17837, 29055], [29600, 31446]])
cdf("coeff_base", [4, 5, 2, 42], 4, None, [[4034, 8930, 12727], [18082, 29741, 31877]])
cdf("coeff_br", [4, 5, 2, 21], 4, None, [[14298, 20718, 24174], [12536, 19601, 23789]])


def nsym_list(t, count):
    n = t["nsym"]
    return list(n) if isinstance(n, list) else [n] * count


def extract_cdfs(lib):
    tables, notes = {}, []
    for t in CDFS:
        count = prod(t["dims"]) if not isinstance(t["nsym"], list) else 1
        syms = nsym_list(t, count)
        count = len(syms)
        got = {}
        if t["dav1d"] is not None:
            off = locate(lib, DAVID_RANGE(), t["dav1d"], t["dav1d_skip"])
            if not isinstance(off, int):
                raise SystemExit(f"{t['name']}: not found in dav1d's copy")
            vals, _ = walk(lib, off, syms)
            if t["dav1d_order"]:
                order = t["dav1d_order"]
                spec = [None] * count
                for k, bs in enumerate(order):
                    spec[bs] = vals[k]
                vals = spec
            got["dav1d"] = vals
        if t["aom"] is not None:
            off = locate(lib, AOM, t["aom"], t["aom_skip"], t["aom_lowest"])
            if not isinstance(off, int):
                raise SystemExit(f"{t['name']}: not found in libaom's copy")
            if t["aom_take"]:
                k, pick = t["aom_take"]
                vals, _ = walk(lib, off, [syms[0]] * (count * k))
                vals = vals[pick::k]
            else:
                vals, _ = walk(lib, off, syms)
            got["aom"] = vals
        if "dav1d" in got and "aom" in got and got["dav1d"] != got["aom"]:
            raise SystemExit(f"{t['name']}: dav1d's and libaom's copies "
                             "differ")
        src = " and ".join(sorted(got))
        vals = got.get("dav1d", got.get("aom"))
        if t["name"].startswith(("txb_skip", "eob_", "dc_sign", "coeff_")):
            check_coef_in_dav1d(lib, t, vals)
            src = "aom and dav1d"
        tables[t["name"]] = vals
        notes.append((t["name"], src))
    return tables, notes


def DAVID_RANGE():
    return DAVID


DAVID = DAV1D


def check_coef_in_dav1d(lib, t, vals):
    """dav1d keeps the coefficient CDFs per quantizer context in a struct
    of its own (no context axis on eob 512 / 1024, 41 base contexts, 4 br
    sizes, 11 eob-extra slots); every CDF libaom gives for a context and
    size must occur in dav1d's copy in the same order."""
    dims = t["dims"]
    inner = prod(dims[1:])
    # the unit compared: the innermost row of CDFs
    row = dims[-1]
    for q in range(4):
        block = vals[q * inner:(q + 1) * inner]
        for r0 in range(0, len(block), row):
            seq = block[r0:r0 + row]
            if t["name"] == "coeff_base":
                seq = seq[:41]
            tx = (r0 // row) // (prod(dims[2:-1]) if len(dims) > 3 else 1)
            if t["name"] == "coeff_br" and len(dims) == 4 and tx >= 4:
                continue
            # chroma has no 64-point transforms: dav1d leaves those unused
            # CDFs at their defaults
            if len(dims) == 4 and tx >= 4 and (r0 // row) % 2 == 1:
                continue
            off = locate(lib, DAV1D, seq[:1])
            if off is None or isinstance(off, ValueError):
                # the first CDF of the row may repeat: find it with the row
                off = locate(lib, DAV1D, seq, lowest=True)
            if not isinstance(off, int):
                raise SystemExit(f"{t['name']}[{q}] row {r0}: not in dav1d")
            got, _ = walk(lib, off, [len(c) + 1 for c in seq])
            if got != seq:
                raise SystemExit(f"{t['name']}[{q}] row {r0}: dav1d differs")


# ---- tables that are not CDFs -------------------------------------------

def extract_misc(lib):
    out = {}
    # quantizer lookups: libaom's int16 dc_qlookup / ac_qlookup and
    # dav1d's interleaved (dc, ac) pairs
    dc_off = lib.find([4, 8, 8, 9, 10, 11, 12, 12, 13], "h", *AOM)
    ac_off = lib.find([4, 8, 9, 10, 11, 12, 13, 14, 15, 16], "h", *AOM)
    assert len(dc_off) == 1 and len(ac_off) == 1, (dc_off, ac_off)
    dc = lib.read(dc_off[0], "h", 256)
    ac = lib.read(ac_off[0], "h", 256)
    pairs = lib.find([4, 4, 8, 8, 8, 9, 9, 10], "H", *DAV1D)
    assert len(pairs) == 1
    pv = lib.read(pairs[0], "H", 512)
    assert pv[0::2] == dc and pv[1::2] == ac, "quantizer copies differ"
    assert dc[-1] == 1336 and ac[-1] == 1828
    out["dc_qlookup"] = dc
    out["ac_qlookup"] = ac
    # smooth weights for 4..64 (libaom: 4, 8, ... 64 in a row; dav1d: the
    # same after entries for 1 and 2)
    sm_aom = [i for i in lib.find([255, 149, 85, 64, 255, 197], "B", *AOM)]
    sm_d = lib.find([0, 0, 255, 128, 255, 149, 85, 64], "B", *DAV1D)
    assert sm_aom and len(sm_d) == 1
    sm = lib.read(sm_aom[0], "B", 124)
    assert lib.read(sm_d[0] + 4, "B", 124) == sm, "smooth weights differ"
    assert sm[4:12] == [255, 197, 146, 105, 73, 50, 37, 32]
    out["sm_weights"] = sm
    # filter-intra taps: libaom's int8 [5][8][8] (7 taps and a pad)
    fi = lib.find([-6, 10, 0, 0, 0, 12, 0, 0], "b", *AOM)
    assert len(fi) == 1
    taps = lib.read(fi[0], "b", 5 * 8 * 8)
    assert all(taps[k * 8 + 7] == 0 for k in range(40))
    out["filter_intra_taps"] = [taps[k * 8:k * 8 + 7] for k in range(40)]
    # dav1d's copy: per mode, pairs of taps ([pair][output][2], the eighth
    # tap 0) in int8
    for m in range(5):
        rows = [r + [0] for r in out["filter_intra_taps"][m * 8:m * 8 + 8]]
        want = [rows[o][2 * k + j] for k in range(4) for o in range(8)
                for j in range(2)]
        assert lib.find(want, "b", *DAV1D), f"filter-intra mode {m}"
    # directional derivatives: libaom's int16 dr_intra_derivative[90]
    dr = lib.find([0, 0, 0, 1023, 0, 0, 547], "h", *AOM)
    assert len(dr) == 1
    drv = lib.read(dr[0], "h", 90)
    out["dr_intra_derivative"] = drv
    nz = [v for v in drv if v]
    # dav1d's uint16 copy keeps zeros between the angles it skips
    a = lib.u16
    starts = np.nonzero(a == nz[0])[0]
    assert any([int(v) for v in a[i:i + 64] if v][:len(nz)] == nz
               for i in starts if DAV1D[0] <= 2 * i < DAV1D_SCAN[1]), \
        "dav1d's derivatives"
    # DCT constants (cos_bit 12) and the ADST4 sines
    cs = lib.find([4096, 4095, 4091, 4085], "i", *AOM)
    assert len(cs) == 1
    cos = lib.read(cs[0], "i", 64)
    import math
    assert cos == [round(4096 * math.cos(i * math.pi / 128))
                   for i in range(64)]
    out["cospi"] = cos
    sp = lib.find([0, 1321, 2482, 3344, 3803], "i", *AOM)
    assert sp
    out["sinpi"] = lib.read(sp[0], "i", 5)
    # self-guided parameters: libaom's {r0, r1, s0, s1}; dav1d keeps the s
    sg = lib.find([2, 1, 140, 3236], "i")
    assert len(sg) == 1
    raw = lib.read(sg[0], "i", 64)
    params = [[raw[4 * k], raw[4 * k + 2], raw[4 * k + 1], raw[4 * k + 3]]
              for k in range(16)]
    s_only = []
    for r0, s0, r1, s1 in params:
        s_only += [s0 if r0 else 0, s1 if r1 else 0]
    assert lib.find(s_only[:8], "H"), "dav1d's self-guided parameters"
    out["sgr_params"] = params
    return out


# ---- scans ---------------------------------------------------------------

def spec_scan(w, h, kind):
    """The specification's scan, row-major positions (row * w + col)."""
    if kind == "mrow":
        return list(range(w * h))
    if kind == "mcol":
        return [r * w + c for c in range(w) for r in range(h)]
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]  # down-left
        if w == h:
            if d % 2 == 0:
                cells = cells[::-1]  # even diagonals run up and right
        elif w > h:
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return out


SCANS = [("default", 4, 4), ("default", 8, 8), ("default", 16, 16),
         ("default", 32, 32), ("default", 4, 8), ("default", 8, 4),
         ("default", 8, 16), ("default", 16, 8), ("default", 16, 32),
         ("default", 32, 16), ("default", 4, 16), ("default", 16, 4),
         ("default", 8, 32), ("default", 32, 8)]
for _kind in ("mrow", "mcol"):
    SCANS += [(_kind, w, h) for w, h in [(4, 4), (8, 8), (16, 16), (4, 8),
                                          (8, 4), (8, 16), (16, 8), (4, 16),
                                          (16, 4)]]


def check_scans(lib):
    out = {}
    for kind, w, h in SCANS:
        s = spec_scan(w, h, kind)
        # both libraries store coefficients column by column
        t = [(p % w) * h + p // w for p in s]
        # dav1d walks the one-dimensional classes' scans in raster order
        # without a table
        copies = ((AOM_SCAN, "h"), (DAV1D_SCAN, "H"))
        for rng, fmt in copies if kind == "default" else copies[:1]:
            if not lib.find(t, fmt, *rng):
                raise SystemExit(f"{kind} scan {w}x{h} not in the library")
        out[f"{kind}_scan_{w}x{h}"] = s
    return out


AOM_SCAN = (4_000_000, 4_100_000)
DAV1D_SCAN = (4_690_000, 4_710_000)


# ---- output --------------------------------------------------------------

def c_array(name, ctype, dims, flat, per_line=12):
    body = ", ".join(str(v) for v in flat)
    lines, cur = [], ""
    for tok in body.split(", "):
        if len(cur) + len(tok) + 2 > 76:
            lines.append(cur.rstrip())
            cur = ""
        cur += tok + ", "
    lines.append(cur.rstrip().rstrip(","))
    dim = "".join(f"[{d}]" for d in dims)
    return (f"static const {ctype} {name}{dim} = {{\n  " +
            "\n  ".join(lines) + "\n};\n")


def render(tables, notes, misc, scans):
    out = ["/* AV1 tables for av1.cpp, generated by",
           " * tests/golden/avif/extract_av1_tables.py from the",
           f" * {LIB_NAME} that PIL 12.1.0 ships: dav1d 1.5.1",
           " * (BSD-2-Clause, Copyright (c) 2018-2024, VideoLAN and dav1d",
           " * authors) and libaom 3.12.1 (BSD-2-Clause, Copyright (c) 2016,",
           " * Alliance for Open Media) hold these tables of the AV1",
           " * specification; where both copies hold one they agree.",
           " * CDFs are in the specification's layout: x_0 .. x_{N-2}, 32768,",
           " * then a zero counter.  Do not edit: rerun the script. */",
           "#pragma once", "#include <stdint.h>", ""]
    for (name, src) in notes:
        t = next(x for x in CDFS if x["name"] == name)
        vals = tables[name]
        if isinstance(t["nsym"], list):
            # palette colours: one array per palette size, [5][n + 1]
            k = 0
            for n in range(2, 9):
                rows = vals[k:k + 5]
                k += 5
                flat = sum((r + [32768, 0] for r in rows), [])
                out.append(f"/* from {src} */")
                out.append(c_array(f"av1_{name}_{n}_cdf", "uint16_t",
                                   [5, n + 1], flat))
            continue
        n = t["nsym"]
        flat = sum((r + [32768, 0] for r in vals), [])
        out.append(f"/* from {src} */")
        out.append(c_array(f"av1_{name}_cdf", "uint16_t",
                           t["dims"] + [n + 1], flat))
    out.append(c_array("av1_dc_qlookup", "int16_t", [256],
                       misc["dc_qlookup"]))
    out.append(c_array("av1_ac_qlookup", "int16_t", [256],
                       misc["ac_qlookup"]))
    out.append("/* weights for 4, 8, 16, 32, 64 in a row */")
    out.append(c_array("av1_sm_weights", "uint8_t", [124],
                       misc["sm_weights"]))
    out.append(c_array("av1_filter_intra_taps", "int8_t", [5, 8, 7],
                       sum(misc["filter_intra_taps"], [])))
    out.append(c_array("av1_dr_intra_derivative", "int16_t", [90],
                       misc["dr_intra_derivative"]))
    out.append(c_array("av1_cospi", "int32_t", [64], misc["cospi"]))
    out.append(c_array("av1_sinpi", "int32_t", [5], misc["sinpi"]))
    out.append("/* {r0, s0, r1, s1} */")
    out.append(c_array("av1_sgr_params", "int32_t", [16, 4],
                       sum(misc["sgr_params"], [])))
    for name, s in scans.items():
        out.append(c_array(f"av1_{name}", "uint16_t", [len(s)], s))
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    path = library_path()
    if path is None:
        raise SystemExit(f"{LIB_NAME} not found (PIL 12.1.0's wheel)")
    lib = Lib(path)
    tables, notes = extract_cdfs(lib)
    text = render(tables, notes, extract_misc(lib), check_scans(lib))
    if args.check:
        with open(HEADER) as f:
            same = f.read() == text
        print("av1_tables.h matches" if same else "av1_tables.h differs")
        return 0 if same else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
