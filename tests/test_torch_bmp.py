"""The port's BMP / DIB reader (rsn_torch/data/bmp.py, the RLE decoder of
rsn_torch/data/native/raster.cpp) against PIL: every committed fixture
of tests/golden/bmp/ against its recorded digest and PIL; the files PIL
refuses (ValueError); the plugin read_image picks against Image.open's,
on the fixtures and on near misses; a seeded sweep of headers, depths,
compressions, palettes and RLE streams; the loaders on BMP scenes against
rsn's."""
import os
import struct

import numpy as np
import pytest

from torch_raster import (Golden, check_fixture, check_loaders,
                          check_near_miss, check_refused, pil_choice,
                          port_choice, same_as_pil, write_scene)

G = Golden("bmp")
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
def test_near_miss_is_not_a_bmp(tmp_path, name):
    check_near_miss(G, name, tmp_path, ("BMP", "DIB"))


def test_fixture_set_is_whole_and_small():
    """One file per case (PIL's encoder's files among them), a few KB
    each; the opened ones cover every header size, depth, compression
    and mode PIL reads BMPs as."""
    names = {W.fixture_name(n) for n in {**W.CASES, **W.PIL_CASES}}
    assert set(G.recorded["files"]) == names
    assert set(G.recorded["refused"]) == {
        W.fixture_name(n) for n in W.REFUSED_CASES}
    sizes = [os.path.getsize(G.path(f)) for f in ALL]
    assert max(sizes) < 4 * 1024 and sum(sizes) < 96 * 1024, sizes
    assert {d["mode"] for d in G.recorded["files"].values()} == {
        "1", "L", "P", "RGB", "RGBA"}
    heads, bits, comps = set(), set(), set()
    for n in W.CASES:
        data = W.case_bytes(n)
        at = 0 if n.startswith("dib_") else 14
        size = struct.unpack_from("<I", data, at)[0]
        heads.add(size)
        if size == 12:
            bits.add(struct.unpack_from("<H", data, at + 10)[0])
        else:
            bits.add(struct.unpack_from("<H", data, at + 14)[0])
            comps.add(struct.unpack_from("<I", data, at + 16)[0])
    assert heads == {12, 40, 52, 56, 64, 108, 124}
    assert bits == {1, 4, 8, 16, 24, 32} and comps == {0, 1, 2, 3}


_MASKS = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
          (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0, 0, 0, 0),
          (0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0),
          (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
          (0x3FF, 0xFFC00, 0x3FF00000, 0)]


def _rle_stream(rng, w: int, h: int, rle4: bool) -> bytes:
    """Rows of runs (some past the row), absolute runs (aligned or not),
    deltas, early ends of line and of the bitmap."""
    out = b""
    for _ in range(h):
        x = 0
        while x < w + int(rng.integers(0, 2)):
            k = int(rng.integers(0, 10))
            if k < 4:
                c = int(rng.integers(1, 256 if rng.integers(0, 4) == 0
                                     else w + 2))
                out += bytes([c, int(rng.integers(0, 256))])
                x += c
            elif k < 7:
                c = int(rng.integers(3, 40))
                n = (c + 1) // 2 if rle4 else c
                out += bytes([0, c]) + rng.integers(0, 256, n, np.uint8
                                                    ).tobytes()
                if len(out) % 2 and rng.integers(0, 4):
                    out += b"\0"
                x += c
            elif k == 7:
                out += bytes([0, 2, *rng.integers(0, 4, 4).tolist()])
                x += 2
            else:
                break
        out += b"\0\0" if rng.integers(0, 5) else b""
    return out + (b"\0\1" if rng.integers(0, 4) else b"")


def _random_bmp(rng) -> tuple:
    size = int(rng.choice([12, 40, 52, 56, 64, 108, 124]))
    w, h = int(rng.integers(1, 20)), int(rng.integers(1, 8))
    bits = int(rng.choice([1, 4, 8, 16, 24, 32, 2]))
    comp = int(rng.choice([0, 0, 0, 1, 2, 3, 3, 4, 6])) if size != 12 else 0
    if comp in (1, 2) and rng.integers(0, 4):
        bits = 8 if comp == 1 else 4
    colors = int(rng.choice([0, 0, 2, 3, 16, 256, 300])) if bits <= 8 else 0
    n = colors or (1 << bits if bits <= 8 else 0)
    pad = 3 if size == 12 else 4
    kind = int(rng.integers(0, 3))
    if kind == 0:
        pal = W.gray_ramp(n, pad)
    elif kind == 1 and n == 2:
        pal = W.palette([[0, 0, 0], [255, 255, 255]], pad)
    else:
        pal = rng.integers(0, 256, n * pad, np.uint8).tobytes()
    masks = _MASKS[int(rng.integers(0, len(_MASKS)))]
    top_down = size != 12 and rng.integers(0, 3) == 0
    head = W.info_header(size, w, -h if top_down else h, bits, comp, colors,
                         masks)
    after = (struct.pack("<III", *_MASKS[int(rng.integers(0, 8))][:3])
             if size == 40 and comp == 3 else b"")
    if comp in (1, 2):
        px = _rle_stream(rng, w, h, comp == 2)
    else:
        px = rng.integers(0, 256, (((w * bits + 31) >> 3) & ~3) * h,
                          np.uint8).tobytes()
    if rng.integers(0, 6) == 0:
        px = px[:int(rng.integers(0, len(px) + 1))]
    r = int(rng.integers(0, 8))
    offset = {0: 14 + size, 1: 0}.get(r)
    gap = b"\x99" if r == 2 else b""
    dib = bool(rng.integers(0, 6) == 0)
    return W.bmp(head, px, pal, after, offset, dib, gap), dib


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sweep_matches_pil(tmp_path, seed):
    """Seeded BMPs and DIBs of every header, depth, compression, palette
    kind, pixel offset and RLE escape, some cut short: the port gives
    PIL's array bit for bit or refuses where PIL refuses."""
    rng = np.random.default_rng(seed)
    for k in range(60):
        data, dib = _random_bmp(rng)
        path = str(tmp_path / f"s{k}.{'dib' if dib else 'bmp'}")
        with open(path, "wb") as f:
            f.write(data)
        assert same_as_pil(path), k


def test_timed_kinds_decode_to_their_pixels(tmp_path):
    """The writer's 24-bit and RLE8 frames (chip_smoke.py times them at
    800x800 on the card's host) read back as their pixels."""
    from rsn_torch.data.jpeg import read_image

    rgb = W.photo(30, 41, "timed")
    path = str(tmp_path / "t24.bmp")
    with open(path, "wb") as f:
        f.write(W.write_24bit(rgb))
    mode, arr = read_image(path)
    assert mode == "RGB" and np.array_equal(arr, rgb)
    gray = rgb[..., 1]
    with open(path, "wb") as f:
        f.write(W.write_rle8_gray(gray))
    mode, arr = read_image(path)
    assert mode == "L" and np.array_equal(arr, gray)
    assert same_as_pil(path)


def _frame_file(i: int, img: np.ndarray) -> bytes:
    """Frame i as a BMP of another kind: 24-bit, 8-bit palette, RLE8 of
    its gray levels, 32-bit bitfields with alpha, 1-bit black and
    white."""
    h, w = img.shape[:2]
    if i == 0:
        return W.write_24bit(img)
    if i == 1:
        idx = (img[..., 0] // 32 * 8 + img[..., 1] // 32).astype(np.uint8)
        return W.bmp(W.info_header(40, w, h, 8), W.pack_rows(idx, 8),
                     W.palette(W._colors(256, "scene")))
    if i == 2:
        return W.write_rle8_gray(img[..., 1])
    if i == 3:
        bgra = np.concatenate([img[..., ::-1], 255 - img[..., :1]], -1)
        return W.bmp(W.info_header(56, w, h, 32, W.BITFIELDS, masks=(
            0xFF0000, 0xFF00, 0xFF, 0xFF000000)), W.pack_rows(bgra, 32))
    return W.bmp(W.info_header(40, w, h, 1, colors=2), W.pack_rows(
        img[..., 2] > 127, 1), W.palette([[0, 0, 0], [255, 255, 255]]))


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("fmt", ["blender", "nerfstudio"])
def test_loaders_on_a_bmp_scene_match_rsn(tmp_path, fmt, downscale):
    """load_dataset over BMP frames of five kinds (RGB, P, L from RLE8,
    RGBA, mode 1) equals rsn's with 0 max abs difference."""
    root = write_scene(str(tmp_path), fmt, _frame_file, "bmp")
    check_loaders(root, fmt, downscale)
