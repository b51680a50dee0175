"""The port's TGA reader (rsn_torch/data/tga.py, the RLE decoder of
rsn_torch/data/native/raster.cpp) and its place in Image.open's order
(rsn_torch/data/formats.py) against PIL: every committed fixture of
tests/golden/tga/ against its recorded digest and PIL; the files PIL
refuses (ValueError); the plugin read_image picks against Image.open's,
on the fixtures, on near misses and on files of the unported plugins
tried before TGA; a fresh PIL's plugin order; a seeded sweep of image
types, depths, colour maps, origins and RLE packets; the loaders on TGA
scenes against rsn's."""
import os
import struct

import numpy as np
import pytest
from PIL import Image

from rsn_torch.data import formats
from rsn_torch.data.jpeg import read_image
from torch_raster import (PORTED, Golden, check_fixture, check_loaders,
                          check_near_miss, check_refused, fresh_pil_order,
                          pil_choice, port_choice, same_as_pil, write_scene)

G = Golden("tga")
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
def test_near_miss_is_not_a_tga(tmp_path, name):
    check_near_miss(G, name, tmp_path, ("TGA",))


def test_fixture_set_is_whole_and_small():
    """One file per case (PIL's encoder's files among them), a few KB
    each; every image type PIL reads and every mode it reads them as."""
    names = {W.fixture_name(n) for n in {**W.CASES, **W.PIL_CASES}}
    assert set(G.recorded["files"]) == names
    assert set(G.recorded["refused"]) == {
        W.fixture_name(n) for n in W.REFUSED_CASES}
    sizes = [os.path.getsize(G.path(f)) for f in ALL]
    assert max(sizes) < 4 * 1024 and sum(sizes) < 64 * 1024, sizes
    assert {d["mode"] for d in G.recorded["files"].values()} == {
        "1", "L", "LA", "P", "RGB", "RGBA"}
    assert {W.case_bytes(n)[2] for n in W.CASES} == {1, 2, 3, 9, 10, 11}


def test_plugin_order_is_a_fresh_pils():
    """formats.ORDER is Image.ID after the preinit and init that a first
    Image.open runs (the tests open files with this order)."""
    assert fresh_pil_order() == list(formats.ORDER)


def _im(path):
    Image.new("L", (4, 3), 7).save(path, "IM")


def _spider(path):
    Image.new("F", (4, 3), 1.5).save(path, "SPIDER")


def _pcd(path):
    with open(path, "wb") as f:
        f.write(bytes(2048) + b"PCD_" + bytes(1600))


def _imt(path):
    with open(path, "wb") as f:
        f.write(b"width 4\nheight 2\npixel n8\n\x0c" + bytes(8))


def _qoi(path):
    Image.new("RGB", (8, 8), (10, 20, 30)).save(path, "QOI")


def _pcx(path):
    Image.new("RGB", (8, 8), (10, 20, 30)).save(path, "PCX")


def _cur_directory_of_a_bmp(path):
    """A CUR of one entry whose bitmap is a 24-bit DIB of height 4."""
    dib = struct.pack("<IiiHHIIiiII", 40, 2, 4, 1, 24, 0, 0, 0, 0, 0, 0)
    entry = struct.pack("<BBBBHHII", 2, 2, 0, 0, 1, 24, 64, 22)
    with open(path, "wb") as f:
        f.write(b"\0\0\2\0\1\0" + entry + dib + bytes(24))


@pytest.mark.parametrize("write", [_im, _spider, _pcd, _imt, _qoi,
                                   _pcx, _cur_directory_of_a_bmp])
def test_unported_plugins_are_named(tmp_path, write):
    """A file an unported plugin takes (the accept-less IM, IMT, SPIDER
    and PCD tried before TGA among them): read_image names the plugin
    Image.open picks and raises NotImplementedError naming ROADMAP Queue
    1 and rsn/data/blender.py."""
    path = str(tmp_path / f"other_{write.__name__}")
    write(path)
    want = pil_choice(path)
    assert want not in (None, "refused") and port_choice(path) == want
    with pytest.raises(NotImplementedError) as info:
        read_image(path)
    msg = str(info.value)
    assert want in msg and PORTED in msg and "ROADMAP Queue 1" in msg


def _random_tga(rng) -> bytes:
    w, h = int(rng.integers(1, 9)), int(rng.integers(1, 7))
    itype, depth = [(9, 8), (10, 16), (10, 24), (10, 32), (11, 8), (11, 16),
                    (11, 1), (1, 8), (2, 16), (2, 24), (2, 32), (3, 8),
                    (3, 16), (3, 1), (2, 8), (3, 24), (1, 16)][
        int(rng.integers(0, 17))]
    n = max(1, depth // 8)
    if itype & 8:
        data, done = b"", 0
        while done < w * h + int(rng.integers(0, 3)):
            c = int(rng.integers(1, min(128, 2 * w) + 1))
            if rng.integers(0, 2):
                data += bytes([0x80 | c - 1]) + rng.integers(
                    0, 256, n, np.uint8).tobytes()
            else:
                data += bytes([c - 1]) + rng.integers(0, 256, n * c,
                                                      np.uint8).tobytes()
            done += c
    else:
        data = rng.integers(0, 256, max(0, (w * h * depth + 7) // 8 + int(
            rng.integers(-2, 3))), np.uint8).tobytes()
    if rng.integers(0, 4) == 0:
        data = data[:int(rng.integers(0, len(data) + 1))]
    kw, cmap = {}, b""
    if itype in (1, 9) or rng.integers(0, 5) == 0:
        mdepth = int(rng.choice([16, 24, 32, 15]))
        mlen = int(rng.integers(0, 300))
        kw = dict(map_type=1, map_start=int(rng.integers(0, 10)),
                  map_len=mlen, map_depth=mdepth)
        cmap = rng.integers(0, 256, mlen * ((mdepth + 7) // 8),
                            np.uint8).tobytes()
    flags = int(rng.choice([0, 0x10, 0x20, 0x30, 0x28, 0x08]))
    ident = rng.integers(0, 256, int(rng.integers(0, 5)), np.uint8).tobytes()
    head = W.header(itype, w, h, depth, flags, len(ident), **kw)
    return W.tga(head, data, ident, cmap, bool(rng.integers(0, 3) == 0))


@pytest.mark.parametrize("seed", range(3))
def test_seeded_sweep_matches_pil(tmp_path, seed):
    """Seeded files of every image type and depth PIL reads or refuses,
    colour maps of each entry depth, origins, ID fields, footers, RLE
    packets that cross rows (runs and literals), some cut short: the
    port gives PIL's array bit for bit or refuses where PIL refuses."""
    rng = np.random.default_rng(seed)
    for k in range(120):
        path = str(tmp_path / f"s{k}.tga")
        with open(path, "wb") as f:
            f.write(_random_tga(rng))
        assert same_as_pil(path), k


def test_timed_kind_decodes_to_its_pixels(tmp_path):
    """The writer's RLE true-colour frame (chip_smoke.py times it at
    800x800 on the card's host) reads back as its pixels."""
    rgb = W.values(30, 41, 24, "timed")
    path = str(tmp_path / "t.tga")
    with open(path, "wb") as f:
        f.write(W.write_rle24(rgb))
    mode, arr = read_image(path)
    assert mode == "RGB" and np.array_equal(arr, rgb)
    assert same_as_pil(path)


def _frame_file(i: int, img: np.ndarray) -> bytes:
    """Frame i as another TGA kind: RLE 24-bit, raw 32-bit, 16-bit (RGBA,
    1-bit alpha), colour-mapped, gray RLE."""
    h, w = img.shape[:2]
    bgr = img[..., ::-1]
    if i == 0:
        return W.write_rle24(img)
    if i == 1:
        bgra = np.concatenate([bgr, img[..., :1]], -1)
        return W.tga(W.header(2, w, h, 32, W.TOP), W.pixels(bgra, 32, W.TOP))
    if i == 2:
        v = ((img[..., 0].astype(np.uint16) >> 3) << 10
             | (img[..., 1].astype(np.uint16) >> 3) << 5
             | img[..., 2] >> 3 | (img[..., 0] > 100).astype(np.uint16) << 15)
        return W.tga(W.header(2, w, h, 16, W.RIGHT),
                     W.pixels(v.astype("<u2").view(np.uint8).reshape(
                         h, w, 2), 16, W.RIGHT))
    if i == 3:
        idx = (img[..., 1] // 4).astype(np.uint8)
        return W.tga(W.header(1, w, h, 8, 0, map_type=1, map_len=64,
                              map_depth=24), W.pixels(idx, 8),
                     cmap=W.colour_map(64, 24, "scene"))
    return W.tga(W.header(11, w, h, 8), W.rle(img[..., 2:], 8))


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("fmt", ["blender", "nerfstudio"])
def test_loaders_on_a_tga_scene_match_rsn(tmp_path, fmt, downscale):
    """load_dataset over TGA frames of five kinds (RGB, RGBA, 16-bit
    RGBA, P, L) equals rsn's with 0 max abs difference."""
    root = write_scene(str(tmp_path), fmt, _frame_file, "tga")
    check_loaders(root, fmt, downscale)
