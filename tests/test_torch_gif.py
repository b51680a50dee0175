"""The port's GIF reader (rsn_torch/data/gif.py, the LZW decoder of
rsn_torch/data/native/raster.cpp) against PIL: every committed fixture
of tests/golden/gif/ against its recorded digest and PIL; the files PIL
refuses (ValueError); the plugin read_image picks against Image.open's,
on the fixtures and on near misses; a seeded sweep of random LZW streams,
screens, tables and extensions, and of PIL's own encoder; the loaders on
GIF scenes against rsn's (frame 0 as palette indices / 255, rsn's
quirk); a failed build of raster.cpp raises."""
import os
import struct

import numpy as np
import pytest
from PIL import Image

from rsn_torch.data import native as tnative
from torch_raster import (Golden, check_fixture, check_loaders,
                          check_near_miss, check_refused, pil_choice,
                          port_choice, same_as_pil, write_scene)

G = Golden("gif")
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
def test_near_miss_is_not_a_gif(tmp_path, name):
    check_near_miss(G, name, tmp_path, ("GIF",))


def test_fixture_set_is_whole_and_small():
    """One file per case (PIL's encoder's files among them), a few KB
    each; modes P and L, every minimum code size from 1 to 8."""
    names = {W.fixture_name(n) for n in {**W.CASES, **W.PIL_CASES}}
    assert set(G.recorded["files"]) == names
    assert set(G.recorded["refused"]) == {
        W.fixture_name(n) for n in W.REFUSED_CASES}
    sizes = [os.path.getsize(G.path(f)) for f in ALL]
    assert max(sizes) < 8 * 1024 and sum(sizes) < 96 * 1024, sizes
    assert {d["mode"] for d in G.recorded["files"].values()} == {"P", "L"}
    assert {f"min_code_{b}" for b in range(2, 9)} <= set(W.CASES)


def _random_gif(rng) -> bytes:
    """A frame of random LZW bytes (any minimum code size up to 13) on a
    random screen, tables, transparency and trailing bytes."""
    w, h = int(rng.integers(1, 12)), int(rng.integers(1, 12))
    bits = int(rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13]))
    data = rng.integers(0, 256, int(rng.integers(0, 60)), np.uint8).tobytes()
    gct = (rng.integers(0, 256, 3 * int(rng.choice([2, 4, 16, 256])),
                        np.uint8).tobytes() if rng.integers(0, 2) else b"")
    blocks = []
    if rng.integers(0, 2):
        blocks.append(W.gce(int(rng.integers(0, 256)),
                            flag=bool(rng.integers(0, 2))))
    sw, sh, x0, y0 = w, h, 0, 0
    if rng.integers(0, 3) == 0:
        sw, sh = int(rng.integers(0, 14)), int(rng.integers(0, 14))
        x0, y0 = int(rng.integers(0, 4)), int(rng.integers(0, 4))
    flags = 0x40 if rng.integers(0, 2) else 0
    blocks.append(b"," + struct.pack("<HHHHB", x0, y0, w, h, flags)
                  + bytes([bits]) + W.sub_blocks(data))
    trailer = [b";", b"", b"\x00", rng.integers(0, 256, int(rng.integers(
        0, 300)), np.uint8).tobytes()][int(rng.integers(0, 4))]
    return W.gif(sw, sh, blocks, gct, trailer=trailer)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_sweep_matches_pil(tmp_path, seed):
    """Random LZW streams (most break, some decode) and PIL's own encoder
    on random frames (interlaced or not, optimised or not, tables of 2 to
    256 colours, up to a full code table): the port gives PIL's array
    bit for bit or refuses where PIL refuses."""
    rng = np.random.default_rng(seed)
    for k in range(100):
        path = str(tmp_path / f"r{k}.gif")
        with open(path, "wb") as f:
            f.write(_random_gif(rng))
        assert same_as_pil(path), k
    for k in range(20):
        w, h = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        n = int(rng.choice([2, 4, 16, 200, 256]))
        img = Image.fromarray(rng.integers(0, n, (h, w), np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 768, np.uint8).tobytes())
        path = str(tmp_path / f"v{k}.gif")
        img.save(path, interlace=bool(rng.integers(0, 2)),
                 optimize=bool(rng.integers(0, 2)))
        assert same_as_pil(path), k


def test_timed_kind_decodes_to_its_pixels(tmp_path):
    """The writer's gray GIF (chip_smoke.py times it at 800x800 on the
    card's host) reads back as its gray levels, mode L."""
    from rsn_torch.data.jpeg import read_image

    gray = W.indices(30, 41, 256, "timed")
    path = str(tmp_path / "t.gif")
    with open(path, "wb") as f:
        f.write(W.write_gray(gray))
    mode, arr = read_image(path)
    assert mode == "L" and np.array_equal(arr, gray)
    assert same_as_pil(path)


def _frame_file(i: int, img: np.ndarray) -> bytes:
    """Frame i as another GIF kind: gray (L), a colour table (P),
    interlaced, a frame inside the screen over a transparent index, a
    local 16-colour table."""
    h, w = img.shape[:2]
    gray = img[..., 1]
    if i == 0:
        return W.write_gray(gray)
    idx = (img[..., 0] // 64 * 16 + img[..., 1] // 64 * 4
           + img[..., 2] // 64).astype(np.uint8)
    table = W.colour_table(64, "scene")
    if i == 1:
        return W.gif(w, h, [W.image(0, 0, idx)], table)
    if i == 2:
        return W.gif(w, h, [W.image(0, 0, idx, interlace=True)], table)
    if i == 3:
        return W.gif(w, h, [W.gce(transparency=63), W.image(
            2, 3, idx[3:-2, 2:-4])], table)
    return W.gif(w, h, [W.image(0, 0, idx % 16, 4, lct=W.colour_table(
        16, "local"))])


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("fmt", ["blender", "nerfstudio"])
def test_loaders_on_a_gif_scene_match_rsn(tmp_path, fmt, downscale):
    """load_dataset over GIF frames of five kinds equals rsn's (its
    palette indices / 255 for a P frame) with 0 max abs difference."""
    root = write_scene(str(tmp_path), fmt, _frame_file, "gif")
    check_loaders(root, fmt, downscale)


def test_failed_raster_build_raises_with_compiler_output(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "raster.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "RASTER_SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_raster_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        tnative.get_raster_lib()
    assert "raster.cpp" in str(info.value)
    assert os.listdir(tmp_path / "build") == []


def test_bindings_check_sizes_before_c():
    """decode_gif_lzw refuses an image that is not a writeable (H, W)
    uint8 array and a box outside it; decode_ppm_plain a total that is
    not whole int32 samples; no pointer reaches C."""
    img = np.zeros((4, 5), np.uint8)
    with pytest.raises(ValueError, match="outside"):
        tnative.decode_gif_lzw(b"\x00", 0, 2, False, img, (0, 0, 6, 4), "x")
    with pytest.raises(ValueError, match="C-contiguous"):
        tnative.decode_gif_lzw(b"\x00", 0, 2, False, img[:, ::2],
                               (0, 0, 1, 1), "x")
    with pytest.raises(ValueError, match="whole"):
        tnative.decode_ppm_plain(b"1", 0, False, 255, True, 6, "x")
    with pytest.raises(ValueError, match="before"):
        tnative.decode_tga_rle(b"\x00", -1, 1, 4, 1, "x")
