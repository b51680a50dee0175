"""The port's JPEG 2000 reader (rsn_torch/data/jpeg2000.py, the
codestream decoder of rsn_torch/data/native/jpeg2000.cpp) against PIL
12.1.0 with OpenJPEG 2.5.4: every committed fixture of
tests/golden/jpeg2000/ against its recorded digest and PIL; the files
PIL refuses (ValueError naming them); the plugin read_image picks
against Image.open's, on the fixtures and on near misses; the kinds
every fixture set must reach; a seeded sweep of PIL's writer over modes,
sizes and options; the kinds not ported (NotImplementedError); sYCC's
conversion against PIL's; the library's flags, a failed build and the
bindings' checks; the loaders on JPEG 2000 scenes against rsn's."""
import os
import struct

import numpy as np
import pytest
from PIL import Image

from rsn_torch.data import jpeg2000 as tj2k
from rsn_torch.data import native as tnative
from rsn_torch.data.jpeg import read_image
from torch_raster import (PORTED, Golden, check_fixture, check_loaders,
                          check_near_miss, check_refused, pil_choice,
                          port_choice, same_as_pil, write_scene)

G = Golden("jpeg2000")
W = G.writer
ALL = sorted(G.recorded["files"]) + sorted(G.recorded["refused"])


@pytest.mark.parametrize("fname", sorted(G.recorded["files"]))
def test_committed_fixture_digests(fname):
    check_fixture(G, fname)


@pytest.mark.parametrize("fname", sorted(G.recorded["refused"]))
def test_file_pil_refuses_raises_value_error(fname):
    check_refused(G, fname)


@pytest.mark.parametrize("fname", ALL)
def test_read_image_picks_pils_plugin(fname):
    path = G.path(fname)
    assert port_choice(path) == pil_choice(path)


@pytest.mark.parametrize("name", sorted(W.NEAR_MISSES))
def test_near_miss_is_not_a_jpeg2000(tmp_path, name):
    check_near_miss(G, name, tmp_path, ("JPEG2000",))


def _markers(fname):
    """(the codestream's main-header segments by marker, its SIZ
    fields) of a fixture."""
    with open(G.path(fname), "rb") as f:
        cs = W.codestream(f.read())
    main, _ = W.main_header(cs)
    segs = {}
    for m, body in main:
        segs.setdefault(m, []).append(body)
    parts, _ = W.tile_parts(_)
    tile_markers = {m for part in parts for m, _ in part[3]}
    return segs, struct.unpack_from(">HIIIIIIIIH", segs[0xFF51][0]), \
        tile_markers


def test_fixture_set_is_whole_and_small():
    """One file per case and frame, the folder (writer and digests
    included) under 900 KB, and every mode PIL reads a JPEG 2000 as."""
    names = set(W.CASES) | set(W.FRAMES)
    assert set(G.recorded["files"]) == names
    assert set(G.recorded["refused"]) == set(W.REFUSED_CASES)
    total = sum(os.path.getsize(G.path(f)) for f in os.listdir(G.dir)
                if not f.startswith("."))
    assert total < 900 * 1024, total
    assert {d["mode"] for d in G.recorded["files"].values()} == {
        "L", "LA", "RGB", "RGBA", "I;16", "CMYK", "P", "PA"}


def test_fixtures_reach_every_kind():
    """Between them the committed fixtures hold: 5/3 and 9/7 each with
    one layer and with several, all five progressions, tiles with tile
    and image offsets, precincts, several code-block sizes and styles,
    SOP / EPH, POC, PPM, PPT, ROI, subsampled, signed and sYCC
    components, both containers."""
    seen = set()
    for fname in G.recorded["files"]:
        segs, siz, tile_markers = _markers(fname)
        cod = segs[0xFF52][0]
        scod, prog, layers = cod[0], cod[1], struct.unpack_from(">H", cod,
                                                                2)[0]
        wavelet = "97" if cod[9] == 0 else "53"
        seen |= {f"{wavelet}-{'1' if layers == 1 else 'n'}", f"prog{prog}",
                 f"cblk{cod[6]}x{cod[7]}", f"style{cod[8]}",
                 os.path.splitext(fname)[1]}
        seen |= {"precincts"} if scod & 1 else set()
        seen |= {"sop"} if scod & 2 else set()
        seen |= {"eph"} if scod & 4 else set()
        _, x1, y1, x0, y0, tdx, tdy, tx0, ty0, nc = siz
        if (tdx < x1 or tdy < y1) and (tx0 or ty0) and (x0 or y0):
            seen.add("tiles-offsets")
        comps = segs[0xFF51][0][36:]
        if any(comps[3 * i + 1] > 1 or comps[3 * i + 2] > 1
               for i in range(nc)):
            seen.add("subsampled")
        if any(comps[3 * i] & 0x80 for i in range(nc)):
            seen.add("signed")
        seen |= {{0xFF5F: "poc", 0xFF60: "ppm", 0xFF5E: "roi",
                  0xFF53: "coc", 0xFF5D: "qcc"}.get(m)
                 for m in set(segs) | tile_markers}
        seen |= {"ppt"} if 0xFF61 in tile_markers else set()
        with open(G.path(fname), "rb") as f:
            sycc = b"colr\x01\x00\x00\x00\x00\x00\x12" in f.read(200)
        seen |= {"sycc"} if sycc else set()
    want = {"53-1", "53-n", "97-1", "97-n", "prog0", "prog1", "prog2",
            "prog3", "prog4", "tiles-offsets", "precincts", "sop", "eph",
            "poc", "ppm", "ppt", "roi", "coc", "qcc", "subsampled", "signed",
            "sycc", ".jp2", ".j2k"}
    want |= {f"style{s}" for s in (1, 2, 4, 8, 16, 32)}
    assert want <= seen, want - seen
    assert len({k for k in seen if k and k.startswith("cblk")}) >= 5


_MODES = ("L", "LA", "RGB", "RGBA", "I;16", "CMYK")
_SIZES = (1, 2, 3, 5, 8, 13, 17, 31, 40)


def _random_save(rng, path):
    """One image PIL writes with random options (a kind its encoder
    refuses is written again without the options)."""
    mode = _MODES[int(rng.integers(0, len(_MODES)))]
    w, h = (int(_SIZES[int(rng.integers(0, len(_SIZES)))]) for _ in "wh")
    img = W.source(mode, w, h, f"sweep{path}")
    opts = {}
    if rng.random() < 0.5:
        opts["irreversible"] = True
    if rng.random() < 0.4:
        rates = sorted(rng.choice([2, 5, 10, 20, 40, 80],
                                  int(rng.integers(1, 4)), replace=False))
        opts["quality_layers"] = [float(r) for r in rates[::-1]]
        if rng.random() < 0.3:
            opts["quality_mode"] = "dB"
            opts["quality_layers"] = [20.0 + 10 * k for k in range(
                len(rates))]
    if rng.random() < 0.4:
        opts["num_resolutions"] = int(rng.integers(1, 6))
    if rng.random() < 0.4:
        cw = 1 << int(rng.integers(2, 7))
        ch = 1 << int(rng.integers(2, 7))
        while cw * ch > 4096:
            ch //= 2
        opts["codeblock_size"] = (cw, ch)
    if rng.random() < 0.3:
        opts["precinct_size"] = (1 << int(rng.integers(5, 8)),) * 2
    if rng.random() < 0.5:
        opts["progression"] = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")[
            int(rng.integers(0, 5))]
    if rng.random() < 0.3:
        opts["tile_size"] = (int(rng.integers(8, 24)),
                             int(rng.integers(8, 24)))
        if rng.random() < 0.5:
            opts["tile_offset"] = (int(rng.integers(0, 4)),
                                   int(rng.integers(0, 4)))
            opts["offset"] = tuple(t + int(rng.integers(0, 4))
                                   for t in opts["tile_offset"])
    for key, p in (("mct", 0.2), ("signed", 0.2), ("plt", 0.1)):
        if rng.random() < p:
            opts[key] = True if key != "mct" else int(rng.integers(0, 2))
    ext = ".j2k" if rng.random() < 0.5 else ".jp2"
    path = path + ext
    # 9/7 on a line of one sample (an image's, or an edge tile's)
    # aborts in an assertion of OpenJPEG's encoder
    if opts.get("irreversible") and (w == 1 or h == 1 or "tile_size" in opts):
        opts.pop("irreversible")
    try:
        img.save(path, "JPEG2000", **opts)
    except OSError:
        img.save(path, "JPEG2000")
    return path


@pytest.mark.parametrize("chunk", range(8))
def test_seeded_sweep_of_pils_writer(tmp_path, chunk):
    """25 images a chunk, 200 in all: read_image == PIL bit for bit."""
    rng = np.random.default_rng(2900 + chunk)
    for i in range(25):
        path = _random_save(rng, str(tmp_path / f"s{chunk}_{i}"))
        assert same_as_pil(path), path


def _fixture_cs(fname="pil_RGB_13x7.j2k"):
    with open(G.path(fname), "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["ht_style", "mct_marker", "mcc_marker",
                                  "cbd_marker"])
def test_kinds_not_ported_raise_not_implemented(tmp_path, kind):
    """HTJ2K code blocks (style 0x40) and the Part 2 markers raise
    NotImplementedError naming ROADMAP Queue 1 and rsn/data/blender.py."""
    cs = _fixture_cs()
    if kind == "ht_style":
        data = W.rewrite(cs, lambda m: [
            (k, v[:8] + bytes([v[8] | 0x40]) + v[9:] if k == 0xFF52 else v)
            for k, v in m])
    else:
        marker = {"mct_marker": 0xFF74, "mcc_marker": 0xFF75,
                  "cbd_marker": 0xFF78}[kind]
        data = W.rewrite(cs, lambda m: m + [(marker, bytes(6))])
    path = str(tmp_path / "kind.j2k")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(NotImplementedError) as info:
        read_image(path)
    msg = str(info.value)
    assert path in msg and "ROADMAP Queue 1" in msg
    assert "rsn/data/blender.py" in msg


def test_ycbcr_to_rgb_is_pils():
    """sYCC's conversion (ConvertYCbCr.c's tables) == PIL's YCbCr to RGB
    over every (Cb, Cr) at five Y."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 1, 64, 200, 255):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
        assert np.array_equal(tj2k.ycbcr_to_rgb(ycc), want)


def test_colour_space_guess_is_pils(tmp_path):
    """A codestream that names no colour space: sYCC when the first
    component is whole and the second or third subsampled, else sRGB
    (checked against PIL over subsampling patterns)."""
    for dx, dy in [((1, 2, 2), (1, 2, 2)), ((1, 1, 2), (1, 1, 1)),
                   ((2, 2, 2), (1, 1, 1)), ((2, 4, 4), (2, 4, 4)),
                   ((1, 1, 1), (1, 2, 1)), ((3, 1, 2), (1, 1, 1))]:
        data = W.opj_encode(W.planes(7, 9, 3, f"g{dx}{dy}", dx=list(dx),
                                     dy=list(dy)), dx=list(dx), dy=list(dy),
                            mct=0, space="unspecified")
        path = str(tmp_path / "guess.j2k")
        with open(path, "wb") as f:
            f.write(data)
        assert same_as_pil(path), (dx, dy)


def test_library_is_built_without_contraction():
    """jpeg2000.cpp's flags are the others' with -ffp-contract=off (the
    float wavelet and ICT round as OpenJPEG's SSE code), and the flags
    enter the library's hash; the other libraries keep theirs."""
    assert tnative.JPEG2000_FLAGS == tnative.FLAGS + ("-ffp-contract=off",)
    assert "-ffp-contract=off" not in tnative.FLAGS
    with_off = tnative.library_path(tnative.JPEG2000_SOURCE, (),
                                    tnative.JPEG2000_FLAGS)
    without = tnative.library_path(tnative.JPEG2000_SOURCE, ())
    assert with_off != without
    lib = tnative.get_jpeg2000_lib()
    assert os.path.basename(lib._name) == os.path.basename(with_off)


def test_failed_jpeg2000_build_raises_with_compiler_output(tmp_path,
                                                           monkeypatch):
    bad = tmp_path / "jpeg2000.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "JPEG2000_SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_jpeg2000_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        tnative.get_jpeg2000_lib()
    assert "jpeg2000.cpp" in str(info.value)
    assert "-ffp-contract=off" in str(info.value)
    assert os.listdir(tmp_path / "build") == []


def test_bindings_check_arrays_before_c():
    """decode_jpeg2000 refuses a negative offset, an array that is not a
    writeable C-contiguous int32 one of its rank, and dims that do not
    match the tiles; an output of the wrong size is refused by the
    library as a ValueError; no pointer reaches C before the checks."""
    cs = _fixture_cs()
    out = np.zeros(13 * 7 * 3, np.int32)
    dims = np.zeros((1, 3, 2), np.int32)
    order = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="before the data"):
        tnative.decode_jpeg2000(cs, -1, out, dims, order, "x")
    with pytest.raises(ValueError, match="int32"):
        tnative.decode_jpeg2000(cs, 0, out.astype(np.int64), dims, order,
                                "x")
    with pytest.raises(ValueError, match="C-contiguous"):
        tnative.decode_jpeg2000(cs, 0, np.zeros(2 * out.size, np.int32)[::2],
                                dims, order, "x")
    with pytest.raises(ValueError, match="tiles"):
        tnative.decode_jpeg2000(cs, 0, out, np.zeros((2, 3, 2), np.int32),
                                order, "x")
    with pytest.raises(ValueError, match="not 273"):
        tnative.decode_jpeg2000(cs, 0, out[:-1].copy(), dims, order, "x")
    assert tnative.decode_jpeg2000(cs, 0, out, dims, order, "x") == 1
    assert dims.tolist() == [[[13, 7]] * 3]


def test_unported_format_names_the_queue(tmp_path):
    """A QOI, the next format of ROADMAP Queue 1, raises
    NotImplementedError naming what the port decodes."""
    path = str(tmp_path / "frame.qoi")
    Image.new("RGB", (8, 8), (10, 20, 30)).save(path, "QOI")
    with pytest.raises(NotImplementedError) as info:
        read_image(path)
    msg = str(info.value)
    assert "QOI" in msg and PORTED in msg and "JPEG 2000" in PORTED


def _frame_file(i, img):
    """Scene frames of five kinds: 5/3 RGB, 9/7 with layers, a raw
    codestream, tiles with offsets, sYCC."""
    import io

    out = io.BytesIO()
    im = Image.fromarray(img)
    opts = [{}, {"irreversible": True, "quality_layers": [30, 10]},
            {"no_jp2": True}, {"tile_size": (16, 16), "offset": (1, 2)},
            {"irreversible": True, "mct": 1}][i % 5]
    im.save(out, "JPEG2000", **opts)
    return out.getvalue()


@pytest.mark.parametrize("fmt", ["blender", "nerfstudio"])
@pytest.mark.parametrize("downscale", [1, 2])
def test_loaders_on_a_jpeg2000_scene_match_rsn(tmp_path, fmt, downscale):
    """load_dataset over JPEG 2000 frames of five kinds equals rsn's with
    0 max abs difference."""
    root = write_scene(str(tmp_path), fmt, _frame_file, "jp2")
    check_loaders(root, fmt, downscale)
