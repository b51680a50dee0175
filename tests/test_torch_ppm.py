"""The port's PBM / PGM / PPM / PFM reader (rsn_torch/data/ppm.py, the
plain decoder of rsn_torch/data/native/raster.cpp) against PIL: every
committed fixture of tests/golden/ppm/ against its recorded digest and
PIL; the files PIL refuses (ValueError); the plugin read_image picks
against Image.open's, on the fixtures and on near misses; a seeded sweep
of magic numbers, header tokens and comments, maxvals and plain tokens;
plain tokens split across the decoder's 1 MiB blocks; the loaders on PPM
scenes against rsn's."""
import os

import numpy as np
import pytest

from torch_raster import (Golden, check_fixture, check_loaders,
                          check_near_miss, check_refused, pil_choice,
                          port_choice, same_as_pil, write_scene)

G = Golden("ppm")
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
def test_near_miss_is_not_a_ppm(tmp_path, name):
    check_near_miss(G, name, tmp_path, ("PPM",))


def test_fixture_set_is_whole_and_small():
    """One file per case (PIL's encoder's files among them), a few KB
    each, covering every magic number and every mode PIL reads them as."""
    names = {W.fixture_name(n) for n in {**W.CASES, **W.PIL_CASES}}
    assert set(G.recorded["files"]) == names
    assert set(G.recorded["refused"]) == {
        W.fixture_name(n) for n in W.REFUSED_CASES}
    sizes = [os.path.getsize(G.path(f)) for f in ALL]
    assert max(sizes) < 4 * 1024 and sum(sizes) < 64 * 1024, sizes
    assert {d["mode"] for d in G.recorded["files"].values()} == {
        "1", "L", "I", "F", "RGB", "RGBA", "P", "CMYK"}
    magics = {W.case_bytes(n).split()[0][:6] for n in W.CASES}
    assert {b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf", b"P0CMYK",
            b"PyP", b"PyRGBA", b"PyCMYK"} <= magics


_WS = [b" ", b"\t", b"\n", b"\r", b"\x0b", b"\x0c", b"\r\n", b"  "]


def _random_ppm(rng) -> bytes:
    def sep():
        s = _WS[int(rng.integers(0, len(_WS)))]
        if rng.integers(0, 8) == 0:
            s += b"# a comment" + [b"\n", b"\r", b""][int(rng.integers(0, 3))]
        return s

    def tok(v):
        s = str(v).encode()
        r = int(rng.integers(0, 20))
        if r == 0:
            return b"+" + s
        if r == 1:
            return b"0" + s
        if r == 2 and len(s) > 1:
            return s[:1] + b"_" + s[1:]
        if r == 3:
            return s + b"#c\n"
        return b"x" + s if r == 4 else s

    magic = [b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf", b"P0CMYK",
             b"PyP", b"PyRGBA", b"PyCMYK", b"P7", b"PF"][int(rng.integers(
                 0, 13))]
    w, h = int(rng.integers(0, 9)), int(rng.integers(1, 7))
    bands = {b"P3": 3, b"P6": 3, b"P0CMYK": 4, b"PyRGBA": 4,
             b"PyCMYK": 4}.get(magic, 1)
    maxval = int(rng.choice([1, 7, 100, 255, 256, 1000, 65535, 65536, 0]))
    head = magic + sep() + tok(w) + sep() + tok(h)
    if magic == b"Pf":
        head += sep() + [b"-1.0", b"1.0", b"0", b"inf", b"2.5e0", b"-0.5"][
            int(rng.integers(0, 6))]
    elif magic not in (b"P1", b"P4"):
        head += sep() + tok(maxval)
    head += _WS[int(rng.integers(0, 6))][:1]
    n = max(0, w * h * bands + int(rng.integers(-1, 3)))
    if magic == b"P1":
        body = b"".join(bytes([48 + int(rng.integers(0, 2))])
                        + (sep() if rng.integers(0, 2) else b"")
                        for _ in range(n))
        body += b"2" if rng.integers(0, 10) == 0 else b""
    elif magic in (b"P2", b"P3"):
        top = max(maxval, 1) + (2 if rng.integers(0, 10) == 0 else 1)
        body = b"".join(tok(int(v)) + sep() for v in rng.integers(0, top, n))
        body = body.rstrip() if rng.integers(0, 10) == 0 else body
    elif magic == b"Pf":
        body = rng.standard_normal(n).astype(np.float32).tobytes()
    elif magic == b"P4":
        body = rng.integers(0, 256, (w + 7) // 8 * h, np.uint8).tobytes()
    else:
        body = rng.integers(0, 256, n * (1 if maxval < 256 else 2),
                            np.uint8).tobytes()
    if rng.integers(0, 6) == 0:
        body = body[:int(rng.integers(0, len(body) + 1))]
    return head + body


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sweep_matches_pil(tmp_path, seed):
    """Seeded files of every magic number, header separator and comment,
    maxval and token form (signs, leading zeros, underscores, comments
    inside tokens), some cut short or past maxval: the port gives PIL's
    array bit for bit or refuses where PIL refuses."""
    rng = np.random.default_rng(seed)
    for k in range(100):
        path = str(tmp_path / f"s{k}.ppm")
        with open(path, "wb") as f:
            f.write(_random_ppm(rng))
        assert same_as_pil(path), k


@pytest.mark.parametrize("split", ["token", "comment", "comment_end"])
def test_plain_tokens_across_1mib_blocks(tmp_path, split):
    """PpmPlainDecoder reads 1 MiB blocks: a token, a comment or a
    comment's line end split between two blocks reads as PIL reads it
    (a comment whose end starts a block drops up to a later CR, as PIL's
    _find_comment_end does)."""
    block = 1 << 20
    special, before = {"token": (b" 123 ", 3), "comment": (b" #abc\n9 ", 3),
                       "comment_end": (b" #ab\n1\r7 ", 4)}[split]
    filler = b" " * ((block - before) % 2) + b"7 " * ((block - before) // 2)
    body = filler + special + b"5 " * 2000
    data = W.header(b"P2", 1000, 525, 255) + body
    path = str(tmp_path / "blocks.pgm")
    with open(path, "wb") as f:
        f.write(data)
    assert same_as_pil(path)


def test_timed_kinds_decode_to_their_pixels(tmp_path):
    """The writer's P6 and 16-bit P5 frames (chip_smoke.py times them at
    800x800 on the card's host) read back as their pixels."""
    from rsn_torch.data.jpeg import read_image

    rgb = W.samples(30, 41, 3, 255, "timed").astype(np.uint8)
    path = str(tmp_path / "t.ppm")
    with open(path, "wb") as f:
        f.write(W.write_p6(rgb))
    mode, arr = read_image(path)
    assert mode == "RGB" and np.array_equal(arr, rgb)
    gray = W.samples(30, 41, 1, 65535, "timed16").astype(np.uint16)
    with open(path, "wb") as f:
        f.write(W.write_p5_16bit(gray))
    mode, arr = read_image(path)
    assert mode == "I" and arr.dtype == np.dtype("<i4")
    assert np.array_equal(arr, gray)
    assert same_as_pil(path)


def _frame_file(i: int, img: np.ndarray) -> bytes:
    """Frame i as another PPM kind: P6, plain P3 of maxval 15, P5 of
    maxval 65535 (mode I, past 1 after / 255), P4 (mode 1), Pf (F)."""
    h, w = img.shape[:2]
    if i == 0:
        return W.write_p6(img)
    if i == 1:
        return W.header(b"P3", w, h, 15) + W.plain(img // 17)
    if i == 2:
        return W.write_p5_16bit(img[..., 0].astype(np.uint16) * 3)
    if i == 3:
        return W.header(b"P4", w, h) + W.raw_bits(img[..., 1] > 127)
    return W.pfm(img[..., 2].astype(np.float32) / 200, i % 2 == 0)


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("fmt", ["blender", "nerfstudio"])
def test_loaders_on_a_ppm_scene_match_rsn(tmp_path, fmt, downscale):
    """load_dataset over PPM frames of five kinds (RGB, plain RGB
    rescaled, I, 1, F) equals rsn's with 0 max abs difference."""
    root = write_scene(str(tmp_path), fmt, _frame_file, "ppm")
    check_loaders(root, fmt, downscale)
