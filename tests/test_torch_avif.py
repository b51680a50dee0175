"""The port's AVIF reader (rsn_torch/data/avif.py, the AV1 decoder and
libavif's YUV to RGB of rsn_torch/data/native/av1.cpp) against PIL
12.1.0 with libavif 1.3.0 and dav1d 1.5.1: every committed fixture of
tests/golden/avif/ against its recorded digest and PIL; the kinds not
ported (NotImplementedError); the files PIL refuses (ValueError naming
them, or no plugin for what libavif declines); the plugin read_image
picks against Image.open's, on the fixtures and on near misses; the
coding tools the fixtures reach; a seeded sweep of PIL's writer; the
decoded planes against dav1d's own and the conversion against libavif's
own (both called through ctypes in the library PIL loads); the tables
against the library; a failed build and the bindings' checks; the
loaders on AVIF scenes against rsn's."""
import ctypes
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from rsn_torch.data import avif as tavif
from rsn_torch.data import native as tnative
from rsn_torch.data.jpeg import read_image
from torch_raster import (Golden, check_fixture, check_loaders,
                          check_near_miss, check_refused, pil_choice,
                          port_choice, pil_read, write_scene)

G = Golden("avif")
W = G.writer
FILES = sorted(set(W.CASES) | set(W.FRAMES))
ALL = sorted(G.recorded["files"]) + sorted(G.recorded["refused"])
DECLINED = sorted(f for f, e in G.recorded["refused"].items()
                  if e.startswith("UnidentifiedImageError"))
REFUSED = sorted(set(G.recorded["refused"]) - set(DECLINED))
LIBAVIF = os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                       "pillow.libs", "libavif-01e67780.so.16.3.0")


@pytest.mark.parametrize("fname", FILES)
def test_committed_fixture_digests(fname):
    check_fixture(G, fname)


@pytest.mark.parametrize("fname", sorted(W.UNPORTED_CASES))
def test_kind_not_ported_raises_not_implemented(fname):
    """PIL opens the file (its digest recorded); read_image raises
    NotImplementedError naming the file, ROADMAP Queue 1 and
    rsn/data/blender.py."""
    path = G.path(fname)
    assert W.digest(*pil_read(path)) == G.recorded["files"][fname]
    with pytest.raises(NotImplementedError) as info:
        read_image(path)
    msg = str(info.value)
    assert path in msg and "ROADMAP Queue 1" in msg
    assert "rsn/data/blender.py" in msg


@pytest.mark.parametrize("fname", REFUSED)
def test_file_pil_refuses_raises_value_error(fname):
    check_refused(G, fname)


@pytest.mark.parametrize("fname", DECLINED)
def test_file_libavif_declines_is_no_plugins(fname):
    """libavif's parse fails (SyntaxError from _open): Image.open finds no
    plugin, nor does identify; read_image raises NotImplementedError."""
    path = G.path(fname)
    assert pil_choice(path) is None and port_choice(path) is None
    with pytest.raises(NotImplementedError, match="not a file any"):
        read_image(path)
    with open(path, "rb") as f:
        assert f.read() == W.case_bytes(fname)


@pytest.mark.parametrize("fname", ALL)
def test_read_image_picks_pils_plugin(fname):
    path = G.path(fname)
    assert port_choice(path) == pil_choice(path)


@pytest.mark.parametrize("name", sorted(W.NEAR_MISSES))
def test_near_miss_is_not_an_avif(tmp_path, name):
    check_near_miss(G, name, tmp_path, ("AVIF",))


def test_fixture_set_is_whole_and_small():
    """One file per case and frame, the folder (writers and digests
    included) under 900 KB, both modes PIL reads an AVIF as, and nothing
    else in the folder."""
    names = set(W.CASES) | set(W.FRAMES) | set(W.UNPORTED_CASES)
    assert set(G.recorded["files"]) == names
    assert set(G.recorded["refused"]) == set(W.REFUSED_CASES)
    listed = os.listdir(G.dir)
    assert set(listed) == names | set(W.REFUSED_CASES) | {
        "digests.json", "write_fixtures.py", "extract_av1_tables.py"}
    total = sum(os.path.getsize(G.path(f)) for f in listed)
    assert total < 900 * 1024, total
    assert {d["mode"] for d in G.recorded["files"].values()} == {"RGB",
                                                                "RGBA"}


def test_fixtures_reach_every_tool():
    """Between them the committed fixtures reach every coding tool the
    decoder takes (av1.cpp's counts: palette, CfL, filter intra, each
    intra mode, transform size and type, both restoration filters, tiles,
    delta q and delta lf, ...); a tool none reaches is refused instead."""
    total = None
    for fname in FILES:
        with open(G.path(fname), "rb") as f:
            img = tavif.AvifImage(f.read(), fname)
        img.load()
        total = img.counts if total is None else total + img.counts
    names = tnative.av1_count_names()
    assert len(names) == total.size
    unreached = [n for n, c in zip(names, total) if c == 0]
    assert not unreached, unreached


_MODES = ("RGB", "RGBA", "L", "LA", "P", "PA", "I;16", "CMYK")
_ADVANCED = ([], [("aq-mode", "1")], [("cdf-update-mode", "0")],
             [("reduced-tx-type-set", "1")], [("enable-tx64", "0")],
             [("enable-filter-intra", "0")], [("enable-cfl-intra", "0")],
             [("sharpness", "5")], [("deltaq-mode", "3")],
             [("enable-restoration", "1")], [("sb-size", "128")])


def _random_save(rng, path):
    h, w = (int(v) for v in rng.integers(1, 72, 2))
    kind = rng.integers(4)
    if kind == 0:
        px = W.natural(h, w, str(rng.integers(1 << 30)))
    elif kind == 1:
        px = W.gradient(h, w)
    elif kind == 2:
        px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    else:
        px = W.edges(h, w)
    mode = _MODES[rng.integers(len(_MODES))]
    alpha = W.disc_alpha(h, w) if mode in ("RGBA", "LA", "PA") else None
    img = W.image(px, "RGBA" if alpha is not None else "RGB", alpha)
    if mode == "PA":
        img = img.convert("RGB").convert("P").convert("PA")
    elif mode == "I;16":
        img = img.convert("L").convert("I;16")
    elif mode not in ("RGB", "RGBA"):
        img = img.convert(mode)
    opts = {"quality": int(rng.integers(0, 101)),
            "speed": int(rng.integers(0, 11)),
            "subsampling": ("4:2:0", "4:2:2", "4:4:4", "4:0:0")[
                rng.integers(4)],
            "range": ("full", "limited")[rng.integers(2)],
            "advanced": _ADVANCED[rng.integers(len(_ADVANCED))]}
    if alpha is not None and rng.integers(2):
        opts["alpha_premultiplied"] = True
    img.save(path, "AVIF", **opts)
    return path


@pytest.mark.parametrize("chunk", range(10))
def test_seeded_sweep_of_pils_writer(tmp_path, chunk):
    """15 images a chunk, 150 in all, of every mode PIL saves with random
    sizes, contents and options: read_image == PIL bit for bit."""
    rng = np.random.default_rng(3000 + chunk)
    for i in range(15):
        path = _random_save(rng, str(tmp_path / f"s{chunk}_{i}.avif"))
        want = pil_read(path)
        got = read_image(path)
        assert got[0] == want[0] and got[1].dtype == want[1].dtype, path
        assert np.array_equal(got[1], want[1]), path


def _random_stream(rng, path, seed):
    """A hand-written AV1 stream of random tools and random symbols in
    PIL's container (write_fixtures.av1_symbols)."""
    w, h = (int(v) for v in rng.integers(8, 200, 2))
    layout = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")[rng.integers(4)]
    sb128 = bool(rng.integers(2))
    tools = dict(q=int(rng.integers(1, 256)), layout=layout, sb128=sb128,
                 sct=bool(rng.integers(2)),
                 delta_lf_multi=bool(rng.integers(2)),
                 lf=tuple(int(v) for v in rng.integers(0, 64, 4)),
                 full=bool(rng.integers(4) == 0),
                 tile_bytes=int(rng.integers(200, 3000)))
    seg = {(i, j): int(rng.integers(-30, 31)) if j < 5 else
           int(rng.integers(8)) if j == 5 else 0
           for i in range(int(rng.integers(1, 8))) for j in range(8)
           if rng.integers(3) == 0}
    if seg and rng.integers(2):
        tools["seg"] = seg
    if rng.integers(3) == 0:
        tools["restoration"] = (
            tuple(int(v) for v in rng.integers(
                0, 4, 1 if layout == "4:0:0" else 3)),
            int(rng.integers(1, 3)), int(rng.integers(2)))
    sh = 5 if sb128 else 4
    sbc = (2 * ((w + 7) >> 3) + (1 << sh) - 1) >> sh
    sbr = (2 * ((h + 7) >> 3) + (1 << sh) - 1) >> sh
    if rng.integers(2):
        def split(n):
            out = []
            while n:
                out.append(int(rng.integers(1, n + 1)))
                n -= out[-1]
            return out
        tools["tiles"] = (split(sbc), split(sbr))
    base = W.pil_save(W._nat(h, w), subsampling=layout)
    with open(path, "wb") as f:
        f.write(W.with_item(base, W.av1_symbols(w, h, seed, **tools)))
    return path


@pytest.mark.parametrize("chunk", range(4))
def test_seeded_sweep_of_hand_written_streams(tmp_path, chunk):
    """12 streams a chunk, 48 in all, of random sizes and tools
    (segmentation, explicit tiles, delta lf per edge and plane, full
    headers, restoration, every layout, 128 superblocks) whose tiles are random
    bytes: read_image == PIL bit for bit, and a stream dav1d refuses (its
    symbols run past the tile) raises ValueError."""
    rng = np.random.default_rng(3100 + chunk)
    for i in range(12):
        path = _random_stream(rng, str(tmp_path / f"r{chunk}_{i}.avif"),
                              f"{chunk}-{i}")
        try:
            want = pil_read(path)
        except RuntimeError:
            with pytest.raises(ValueError, match="dav1d cannot decode"):
                read_image(path)
            continue
        got = read_image(path)
        assert got[0] == want[0] and np.array_equal(got[1], want[1]), path


# ---- libavif's parse on single edits of committed files ------------------------


def _fixture(name: str) -> bytes:
    with open(G.path(name), "rb") as f:
        return f.read()


def _patch(name: str, box: bytes, at: int, value: bytes, nth: int = 0):
    """`name`'s bytes with `value` written `at` bytes into the payload of
    its `nth` box of type `box` (negative `at`: from the payload's end)."""
    d = bytearray(_fixture(name))
    i = -1
    for _ in range(nth + 1):
        i = d.index(box, i + 1)
    size = struct.unpack_from(">I", d, i - 4)[0]
    start = i + 4 + (at if at >= 0 else size - 8 + at)
    d[start:start + len(value)] = value
    return bytes(d)


def _heif(name: str, edit) -> bytes:
    h = W.Heif(_fixture(name))
    edit(h)
    return h.write()


def _extra_item(item_type: bytes, props):
    def edit(h):
        h.items[9] = {"type": item_type, "name": b"", "data": b"\0\0\0\0abcd",
                      "props": [list(h.prop(h.primary, p)) for p in props]}
    return edit


def _iloc_extent(name: str, offset_delta: int = 0, length_delta: int = 0):
    d = bytearray(_fixture(name))
    i = d.index(b"iloc") + 4 + 4 + 2 + 2 + 2 + 2 + 2  # v0, 4-byte fields
    off, length = struct.unpack_from(">II", d, i)
    struct.pack_into(">II", d, i, off + offset_delta, length + length_delta)
    return bytes(d)


def _obu_forbidden_bit(h):
    data = bytearray(h.items[h.primary]["data"])
    data[2] |= 0x80  # the sequence header's, after the temporal delimiter
    h.items[h.primary]["data"] = bytes(data)


# each: (the bytes, what PIL does: "ok", "decline" (no plugin takes the
# file: libavif's parse failed) or "refuse")
PARSE_RULES = {
    "hdlr_version_1": (lambda: _patch("rgb_420.avif", b"hdlr", 0, b"\1"),
                       "decline"),
    "hdlr_pre_defined": (lambda: _patch("rgb_420.avif", b"hdlr", 4, b"\1"),
                         "decline"),
    "hdlr_name_unterminated": (
        lambda: _patch("rgb_420.avif", b"hdlr", -1, b"x"), "decline"),
    "infe_name_unterminated": (
        lambda: _patch("rgb_420.avif", b"infe", -1, b"x"), "decline"),
    "infe_version_4": (lambda: _patch("rgb_420.avif", b"infe", 0, b"\4"),
                       "decline"),
    "ispe_version_1": (lambda: _patch("rgb_420.avif", b"ispe", 0, b"\1"),
                       "decline"),
    "ispe_zero_width": (lambda: _patch("rgb_420.avif", b"ispe", 4, b"\0" * 4),
                        "decline"),
    "ispe_past_the_dimension_limit": (
        lambda: _patch("rgb_420.avif", b"ispe", 4, struct.pack(">I", 32769)),
        "decline"),
    "ispe_past_the_size_limit": (
        lambda: _patch("rgb_420.avif", b"ispe", 4,
                       struct.pack(">II", 32768, 8193)), "decline"),
    "pixi_version_1": (lambda: _patch("rgb_420.avif", b"pixi", 0, b"\1"),
                       "decline"),
    "pixi_five_channels": (lambda: _patch("rgb_420.avif", b"pixi", 4, b"\5"),
                           "refuse"),
    "pixi_unequal_depths": (
        lambda: _patch("rgb_420.avif", b"pixi", 5, b"\x08\x08\x09"), "refuse"),
    "pixi_depth_other_than_av1c": (
        lambda: _patch("rgb_420.avif", b"pixi", 5, b"\x0a\x0a\x0a"),
        "decline"),
    "alpha_pixi_depth_other_than_av1c": (
        lambda: _patch("rgba.avif", b"pixi", 5, b"\x09", nth=1), "decline"),
    "av1c_version_2": (lambda: _patch("rgb_420.avif", b"av1C", 0, b"\x82"),
                       "decline"),
    "av1c_twelve_bit": (lambda: _patch("rgb_420.avif", b"av1C", 2, b"\x2c"),
                        "decline"),
    "av1c_subsampling_ignored": (
        lambda: _patch("rgb_420.avif", b"av1C", 2, b"\x00"), "ok"),
    "colr_reserved_bits": (lambda: _patch("rgb_420.avif", b"colr", 10,
                                          b"\x81"), "decline"),
    "two_colr_nclx": (lambda: _heif("rgb_420.avif", lambda h: h.add(
        h.primary, b"colr", W.colr_nclx(1, 1, 1, 1))), "decline"),
    "iloc_reserved_bits": (
        lambda: _patch("iloc_v1.avif", b"iloc", 10, b"\x10\x00"), "decline"),
    "iloc_construction_method_2": (
        lambda: _patch("iloc_v1.avif", b"iloc", 10, b"\x00\x02"), "decline"),
    "iloc_data_reference_index": (
        lambda: _patch("rgb_420.avif", b"iloc", 10, b"\x00\x01"), "ok"),
    "iloc_index_size_4": (lambda: _patch("iloc_v2.avif", b"iloc", 5, b"\x04"),
                          "decline"),
    "item_larger_than_the_file": (
        lambda: _iloc_extent("rgb_420.avif", length_delta=1000), "decline"),
    "item_a_few_bytes_past_the_file": (
        lambda: _iloc_extent("rgb_420.avif", length_delta=40), "refuse"),
    "item_past_the_file_without_nclx": (
        lambda: _iloc_extent("colr_none.avif", offset_delta=1000), "decline"),
    "item_past_the_file_with_nclx": (
        lambda: _iloc_extent("rgb_420.avif", offset_delta=1000), "refuse"),
    "empty_item": (lambda: _iloc_extent("rgb_420.avif", length_delta=-396),
                   "refuse"),
    "pitm_unknown_item": (lambda: _patch("rgb_420.avif", b"pitm", 4, b"\0\7"),
                          "refuse"),
    "primary_item_not_av01": (
        lambda: _patch("rgb_420.avif", b"infe", 8, b"av02"), "refuse"),
    "ipma_unknown_item": (lambda: _patch("rgb_420.avif", b"ipma", 8, b"\0\7"),
                          "decline"),
    "extra_av01_item_without_ispe": (
        lambda: _heif("rgb_420.avif", _extra_item(b"av01", [b"av1C"])),
        "decline"),
    "extra_av01_item_with_ispe": (
        lambda: _heif("rgb_420.avif", _extra_item(b"av01", [b"ispe"])), "ok"),
    "extra_exif_item": (lambda: _heif("rgb_420.avif", _extra_item(b"Exif", [])),
                        "ok"),
    "iref_child_box_short": (
        lambda: _patch("rgba.avif", b"auxl", -14, struct.pack(">I", 12)),
        "ok"),
    "iref_reference_count_0": (
        lambda: _patch("rgba.avif", b"auxl", 2, b"\0\0"), "decline"),
    "alpha_without_properties": (lambda: _heif("rgba.avif", lambda h: h.items[
        h.alpha_id()].update(props=[])), "decline"),
    "bytes_after_what_libavif_reads": (
        lambda: _fixture("rgb_420.avif") + b"\1\2\3", "ok"),
    "obu_forbidden_bit": (lambda: _heif("rgb_420.avif", _obu_forbidden_bit),
                          "ok"),
}


def _outcome(read):
    try:
        got = read()
    except (UnidentifiedImageError, NotImplementedError) as e:
        if isinstance(e, NotImplementedError) and "not a file any" not in str(
                e):
            raise
        return "decline", None
    except Exception:  # noqa: BLE001 - PIL's refusals, the port's ValueError
        return "refuse", None
    return "ok", got


@pytest.mark.parametrize("name", sorted(PARSE_RULES))
def test_libavifs_parse_rules(tmp_path, name):
    """One edit of a committed file, written by the test: PIL does what the
    case says (a decline: libavif's parse failed, no plugin takes the
    file; a refusal: PIL raises), and so does read_image, bit for bit
    where both decode."""
    make, want = PARSE_RULES[name]
    path = str(tmp_path / f"{name}.avif")
    with open(path, "wb") as f:
        f.write(make())
    pil, pil_px = _outcome(lambda: pil_read(path))
    port, port_px = _outcome(lambda: read_image(path))
    assert pil == want
    assert port == want
    if want == "ok":
        assert port_px[0] == pil_px[0] and np.array_equal(port_px[1],
                                                          pil_px[1])


# ---- dav1d and libavif in the library PIL loads ---------------------------------

def _libavif():
    if not os.path.isfile(LIBAVIF):
        pytest.skip(f"{LIBAVIF} is not here")
    return ctypes.CDLL(LIBAVIF)


def _dav1d_planes(lib, obus: bytes):
    """dav1d 1.5.1's picture of one item's OBUs, one thread: its planes
    cropped to the frame (Dav1dSettings: n_threads at byte 0,
    max_frame_delay at 4; Dav1dPicture: data at 16, stride at 40, w, h,
    layout at 56)."""
    settings = ctypes.create_string_buffer(256)
    lib.dav1d_default_settings(settings)
    struct.pack_into("<ii", settings, 0, 1, 1)
    ctx = ctypes.c_void_p()
    assert lib.dav1d_open(ctypes.byref(ctx), settings) == 0
    data = ctypes.create_string_buffer(128)
    lib.dav1d_data_create.restype = ctypes.c_void_p
    ptr = lib.dav1d_data_create(data, ctypes.c_size_t(len(obus)))
    ctypes.memmove(ptr, obus, len(obus))
    assert lib.dav1d_send_data(ctx, data) == 0
    pic = ctypes.create_string_buffer(512)
    rc = lib.dav1d_get_picture(ctx, pic)
    if rc < 0:
        rc = lib.dav1d_get_picture(ctx, pic)
    assert rc == 0
    ptrs = struct.unpack_from("<3Q", pic.raw, 16)
    strides = struct.unpack_from("<2q", pic.raw, 40)
    w, h, layout = struct.unpack_from("<3i", pic.raw, 56)
    sx, sy = {0: (1, 1), 1: (1, 1), 2: (1, 0), 3: (0, 0)}[layout]
    planes = []
    for i in range(1 if layout == 0 else 3):
        pw, ph = (w, h) if i == 0 else ((w + sx) >> sx, (h + sy) >> sy)
        stride = strides[0 if i == 0 else 1]
        raw = ctypes.string_at(ptrs[i], stride * ph)
        planes.append(np.frombuffer(raw, np.uint8).reshape(ph, stride)[:, :pw])
    lib.dav1d_picture_unref(pic)
    lib.dav1d_close(ctypes.byref(ctx))
    return planes


@pytest.mark.parametrize("fname", ["rgb_420.avif", "rgb_422.avif",
                                   "rgb_444.avif", "rgba_400.avif",
                                   "tiles_2x2.avif", "speed0.avif",
                                   "few_colours.avif", "q100_444.avif",
                                   "sb128.avif", "frame_speed0.avif"])
def test_decoded_planes_are_dav1ds(fname):
    """Each item's planes from av1.cpp == dav1d's, before any colour
    conversion."""
    lib = _libavif()
    with open(G.path(fname), "rb") as f:
        img = tavif.AvifImage(f.read(), fname)
    for item in [img.color] + ([img.alpha] if img.alpha else []):
        obus = img._item_data(item)
        info = tnative.probe_av1(obus, fname)
        w, h = info["width"], info["height"]
        sx, sy = info["subsampling_x"], info["subsampling_y"]
        got = [np.empty((h, w), np.uint8)]
        if not info["mono"]:
            cs = ((h + sy) >> sy, (w + sx) >> sx)
            got += [np.empty(cs, np.uint8), np.empty(cs, np.uint8)]
        tnative.decode_av1(obus, got, np.zeros(len(tnative.av1_count_names()),
                                               np.uint64), fname)
        want = _dav1d_planes(lib, obus)
        assert len(got) == len(want)
        for g, wnt in zip(got, want):
            assert np.array_equal(g, wnt), fname


def _libavif_rgb(lib, planes, alpha, layout, matrix, full, prem):
    """avifImageYUVToRGB as PIL calls it (avifRGBImageSetDefaults, 8-bit
    RGB or RGBA) on the given planes (avifImage: yuvRange at byte 16,
    alphaPremultiplied at 80, matrixCoefficients at 108; avifRGBImage:
    format at 12, pixels at 48, rowBytes at 56)."""
    fmt = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}[layout]
    h, w = planes[0].shape
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImagePlane.restype = ctypes.c_void_p
    lib.avifImagePlaneRowBytes.restype = ctypes.c_uint32
    img = ctypes.c_void_p(lib.avifImageCreate(w, h, 8, fmt))
    assert lib.avifImageAllocatePlanes(img, 1) == 0
    chans = list(enumerate(planes))
    if alpha is not None:
        assert lib.avifImageAllocatePlanes(img, 2) == 0
        chans.append((3, alpha))
    for ch, a in chans:
        p = lib.avifImagePlane(img, ch)
        rb = lib.avifImagePlaneRowBytes(img, ch)
        for y in range(a.shape[0]):
            ctypes.memmove(p + y * rb, a[y].tobytes(), a.shape[1])
    head = (ctypes.c_char * 112).from_address(img.value)
    struct.pack_into("<I", head, 16, int(full))
    struct.pack_into("<I", head, 80, int(prem))
    struct.pack_into("<H", head, 108, matrix)
    rgb = ctypes.create_string_buffer(64)
    lib.avifRGBImageSetDefaults(rgb, img)
    struct.pack_into("<I", rgb, 12, 0 if alpha is None else 1)
    lib.avifRGBImageAllocatePixels(rgb)
    rc = lib.avifImageYUVToRGB(img, rgb)
    pix, rb = struct.unpack_from("<QI", rgb.raw, 48)
    c = 3 if alpha is None else 4
    out = np.frombuffer(ctypes.string_at(pix, rb * h), np.uint8).reshape(
        h, rb)[:, :w * c].reshape(h, w, c).copy()
    lib.avifRGBImageFreePixels(rgb)
    lib.avifImageDestroy(img)
    return rc, out


def test_conversion_is_libavifs():
    """native.avif_to_rgb == libavif's avifImageYUVToRGB on random planes:
    every layout, both ranges, the matrices it converts through libyuv
    (BT.601, BT.709, BT.2020, unspecified) and identity, RGB and RGBA,
    premultiplied or not, odd and even sizes; and the matrices libavif
    refuses are refused."""
    lib = _libavif()
    rng = np.random.default_rng(30)
    for h, w in [(1, 1), (2, 3), (5, 8), (9, 4), (17, 33)]:
        for layout, (sx, sy) in (("4:4:4", (0, 0)), ("4:2:2", (1, 0)),
                                 ("4:2:0", (1, 1)), ("4:0:0", (1, 1))):
            cs = ((h + sy) >> sy, (w + sx) >> sx)
            planes = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
            if layout != "4:0:0":
                planes += [rng.integers(0, 256, cs, dtype=np.uint8)
                           for _ in range(2)]
            matrices = (0, 1, 2, 5, 6, 9) if layout == "4:4:4" else (1, 6, 9)
            for matrix in matrices:
                for full in (False, True):
                    for alpha, prem in ((None, False), ("a", False),
                                        ("a", True)):
                        if matrix == 0 and prem and not full:
                            continue  # libavif's float path: not ported
                        a = (None if alpha is None else
                             rng.integers(0, 256, (h, w), dtype=np.uint8))
                        rc, want = _libavif_rgb(lib, planes, a, layout,
                                                matrix, full, prem)
                        assert rc == 0
                        got = np.empty_like(want)
                        tnative.avif_to_rgb(planes, a, layout, matrix, full,
                                            prem, got, "x")
                        assert np.array_equal(got, want), (
                            h, w, layout, matrix, full, alpha, prem)
    planes = [np.zeros((4, 4), np.uint8), np.zeros((2, 2), np.uint8),
              np.zeros((2, 2), np.uint8)]
    for matrix in (3, 10, 11, 13, 14, 16):
        assert _libavif_rgb(lib, planes, None, "4:2:0", matrix, True,
                            False)[0] != 0
        with pytest.raises(ValueError, match="cannot convert"):
            tnative.avif_to_rgb(planes, None, "4:2:0", matrix, True, False,
                                np.empty((4, 4, 3), np.uint8), "x")
    for matrix in (4, 7, 12, 15):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            tnative.avif_to_rgb(planes, None, "4:2:0", matrix, True, False,
                                np.empty((4, 4, 3), np.uint8), "x")


def test_tables_are_the_librarys():
    """av1_tables.h is what extract_av1_tables.py reads from the library
    PIL ships (every table held in both dav1d's and libaom's layouts
    agreeing)."""
    _libavif()
    script = os.path.join(G.dir, "extract_av1_tables.py")
    res = subprocess.run([sys.executable, script, "--check"],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


# ---- the library and its bindings ---------------------------------------------------

def test_library_hash_covers_the_tables():
    """The AV1 library's name changes with av1_tables.h as with av1.cpp."""
    with_tables = tnative.library_path(tnative.AV1_SOURCE, (), tnative.FLAGS,
                                       tnative.AV1_HEADERS)
    without = tnative.library_path(tnative.AV1_SOURCE, (), tnative.FLAGS)
    assert with_tables != without
    lib = tnative.get_av1_lib()
    assert os.path.basename(lib._name) == os.path.basename(with_tables)


def test_failed_av1_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "av1.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "AV1_SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_av1_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        tnative.get_av1_lib()
    assert "av1.cpp" in str(info.value)
    assert os.listdir(tmp_path / "build") == []


def test_bindings_check_arrays_before_c():
    """decode_av1 refuses planes of the wrong dtype, rank or stride and
    counts of the wrong kind before C, and planes of another count or
    shape than the frame's in C, before it writes any; avif_to_rgb an
    unknown layout and an output of the wrong shape."""
    with open(G.path("rgb_420.avif"), "rb") as f:
        img = tavif.AvifImage(f.read(), "x")
    obus = img._item_data(img.color)
    counts = np.zeros(len(tnative.av1_count_names()), np.uint64)
    y = np.empty((48, 64), np.uint8)
    u, v = np.empty((24, 32), np.uint8), np.empty((24, 32), np.uint8)
    with pytest.raises(ValueError, match="3 planes"):
        tnative.decode_av1(obus, [y], counts, "x")
    with pytest.raises(ValueError, match="uint8"):
        tnative.decode_av1(obus, [y.astype(np.int16), u, v], counts, "x")
    with pytest.raises(ValueError, match="is \\(24, 31\\)"):
        tnative.decode_av1(obus, [y, u[:, :31], v], counts, "x")
    # planes of a 4:2:2 frame for this 4:2:0 one: refused, none written
    tall = [np.full((48, 64), 7, np.uint8), np.full((48, 32), 7, np.uint8),
            np.full((48, 32), 7, np.uint8)]
    with pytest.raises(ValueError, match="plane 1 is \\(48, 32\\), not "
                       "\\(24, 32\\)"):
        tnative.decode_av1(obus, tall, counts, "x")
    assert all((a == 7).all() for a in tall) and not counts.any()
    with pytest.raises(ValueError, match="contiguous rows"):
        tnative.decode_av1(obus, [y, np.empty((24, 64), np.uint8)[:, ::2], v],
                           counts, "x")
    with pytest.raises(ValueError, match="counts"):
        tnative.decode_av1(obus, [y, u, v], counts[:-1].copy(), "x")
    tnative.decode_av1(obus, [y, u, v], counts, "x")
    assert counts[tnative.av1_count_names().index("frames")] == 1
    with pytest.raises(ValueError, match="layout"):
        tnative.avif_to_rgb([y, u, v], None, "4:1:1", 6, True, False,
                            np.empty((48, 64, 3), np.uint8), "x")
    with pytest.raises(ValueError, match="out must be"):
        tnative.avif_to_rgb([y, u, v], None, "4:2:0", 6, True, False,
                            np.empty((48, 64, 4), np.uint8), "x")
    with pytest.raises(ValueError, match="AV1 frame dav1d cannot decode"):
        tnative.probe_av1(obus[:3], "x")


# ---- the loaders on AVIF scenes -----------------------------------------------------

def _frame_file(i, img):
    """Scene frames of five kinds: the default 4:2:0, 4:4:4 limited range,
    4:0:0, RGBA with a disc of alpha, premultiplied 4:2:2 RGBA."""
    out = io.BytesIO()
    h, w = img.shape[:2]
    kinds = [({}, None), ({"subsampling": "4:4:4", "range": "limited"}, None),
             ({"subsampling": "4:0:0"}, None), ({}, W.disc_alpha(h, w)),
             ({"subsampling": "4:2:2", "alpha_premultiplied": True},
              W.disc_alpha(h, w))]
    opts, alpha = kinds[i % 5]
    W.image(img, "RGB" if alpha is None else "RGBA", alpha).save(
        out, "AVIF", **opts)
    return out.getvalue()


@pytest.mark.parametrize("fmt", ["blender", "nerfstudio"])
@pytest.mark.parametrize("downscale", [1, 2])
def test_loaders_on_an_avif_scene_match_rsn(tmp_path, fmt, downscale):
    """load_dataset over AVIF frames of five kinds equals rsn's with 0 max
    abs difference (RGBA blended to white as rsn blends it)."""
    root = write_scene(str(tmp_path), fmt, _frame_file, "avif")
    check_loaders(root, fmt, downscale)
