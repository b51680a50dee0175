"""The port's WebP decoder (rsn_torch/data/webp.py and native/webp.cpp)
against PIL: every committed fixture of tests/golden/webp/ against its
recorded digest and PIL; what they reach (both loop filters, every
partition count, ALPH raw and compressed with each filter, VP8L's
transforms); the writer's VP8L frames against their own samples; the
ALPH unfilters against a plain numpy version; PIL's encoder over a seeded
sweep; the files PIL refuses (ValueError); the constant tables against
the libwebp PIL loads; the loaders on WebP scenes against rsn's."""
import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from rsn.data import blender as jblender
from rsn_torch.data import blender as tblender
from rsn_torch.data import jpeg as tjpeg
from rsn_torch.data import native as tnative
from rsn_torch.data import synthetic as tsynthetic
from rsn_torch.data import webp as twebp

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "webp")
_spec = importlib.util.spec_from_file_location(
    "webp_fixtures", os.path.join(GOLDEN, "write_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)
with open(fixtures.DIGESTS) as _f:
    RECORDED = json.load(_f)


def _pil(path):
    with Image.open(path) as img:
        return img.mode, np.asarray(img)


def _same(got, want):
    (mode, arr), (want_mode, want_arr) = got, want
    assert (mode, arr.dtype, arr.shape) == (want_mode, want_arr.dtype,
                                             want_arr.shape)
    assert arr.tobytes() == want_arr.tobytes()


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("fname", sorted(RECORDED["files"]))
def test_committed_fixture_digests(fname):
    """PIL still decodes each committed fixture to its recorded digest,
    the port decodes it to the digest through read_image (chip_smoke.py
    checks the port's on the card's host, which has no PIL), and the
    writer still writes its own cases byte for byte."""
    path = os.path.join(GOLDEN, fname)
    want = RECORDED["files"][fname]
    assert fixtures.digest(*_pil(path)) == want
    assert fixtures.digest(*tjpeg.read_image(path)) == want
    name = fname[:-len(".webp")]
    if name in fixtures.CASES:
        with open(path, "rb") as f:
            assert f.read() == fixtures.case_bytes(name)


class _BoolDecoder:
    """RFC 6386's boolean decoder, plain, to read a frame's headers."""

    def __init__(self, data):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.bits = 255, 0

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            b, self.range, self.value = 1, self.range - split, self.value - big
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bits += 1
            if self.bits == 8:
                self.bits = 0
                nxt = self.data[self.pos] if self.pos < len(self.data) else 0
                self.value |= nxt
                self.pos += 1
        return b

    def value_bits(self, n):
        return sum(self.bit(128) << k for k in range(n - 1, -1, -1))


def _vp8_headers(payload):
    """-> (filter type: 0 none, 1 simple, 2 normal; partitions)."""
    d = _BoolDecoder(payload[10:])
    d.value_bits(2)
    if d.bit(128):  # segments
        update_map, update_data = d.bit(128), d.bit(128)
        if update_data:
            d.bit(128)
            for bits in (7,) * 4 + (6,) * 4:
                if d.bit(128):
                    d.value_bits(bits + 1)
        if update_map:
            for _ in range(3):
                if d.bit(128):
                    d.value_bits(8)
    simple, level = d.bit(128), d.value_bits(6)
    d.value_bits(3)
    if d.bit(128) and d.bit(128):
        for _ in range(8):
            if d.bit(128):
                d.value_bits(7)
    return (0 if level == 0 else 1 if simple else 2), 1 << d.value_bits(2)


def _chunks(data):
    out, at = [], 12
    while at + 8 <= len(data):
        tag = data[at:at + 4]
        size = int.from_bytes(data[at + 4:at + 8], "little")
        out.append((tag, data[at + 8:at + 8 + size]))
        at += 8 + size + (size & 1)
        if tag == b"ANMF":
            out += [(b"ANMF/" + t, p) for t, p in _chunks(
                b"\x00" * 12 + data[at - size - (size & 1) + 16:at])]
    return out


def test_fixture_set_is_whole_and_covers_the_kinds():
    """One fixture per case, the folder under 400 KB; together they reach
    the simple and normal loop filters and none, 1 / 2 / 4 / 8 token
    partitions, VP8L's four transforms (colour indexing at 2, 3-4, 5-16
    and 17-256 colours), the colour cache, ALPH raw and compressed with
    each of its filters, an animation whose frame 0 is smaller than its
    canvas and offset in it, and PIL's own encoder's files."""
    names = set(fixtures.CASES) | set(fixtures.PIL_CASES) | set(
        fixtures.FRAMES)
    assert set(RECORDED["files"]) == {fixtures.fixture_name(n) for n in names}
    total = sum(os.path.getsize(p) for p in glob.glob(os.path.join(GOLDEN,
                                                                   "*")))
    assert total < 400 * 1024, total
    filters, parts, alph, first_transforms, palettes = set(), set(), set(), \
        set(), set()
    cache = False
    for name in fixtures.CASES:
        with open(os.path.join(GOLDEN, fixtures.fixture_name(name)),
                  "rb") as f:
            chunks = _chunks(f.read())
        for tag, payload in chunks:
            if tag.endswith(b"VP8 "):
                ft, np_ = _vp8_headers(payload)
                filters.add(ft)
                parts.add(np_)
            elif tag.endswith(b"ALPH"):
                alph.add((payload[0] & 3, (payload[0] >> 2) & 3))
            elif tag.endswith(b"VP8L"):
                bits = int.from_bytes(payload[5:8], "little")
                if bits & 1:
                    first_transforms.add((bits >> 1) & 3)
                    if (bits >> 1) & 3 == 3:
                        palettes.add(((bits >> 3) & 255) + 1)
                elif (bits >> 1) & 1:
                    cache = True
    assert filters == {0, 1, 2} and parts == {1, 2, 4, 8}
    assert alph == {(m, f) for m in (0, 1) for f in range(4)}
    assert first_transforms == {0, 1, 2, 3}
    assert {2, 3, 11, 200} <= palettes and cache
    with open(os.path.join(GOLDEN, "anim_first_frame_offset_lossy.webp"),
              "rb") as f:
        anmf = [p for t, p in _chunks(f.read()) if t == b"ANMF"][0]
    x = 2 * int.from_bytes(anmf[0:3], "little")
    w = 1 + int.from_bytes(anmf[6:9], "little")
    assert x > 0 and w < RECORDED["files"][
        "anim_first_frame_offset_lossy.webp"]["shape"][1]


@pytest.mark.parametrize("kind", [
    "plain", "transforms", "palette16", "palette256", "cache_lz77_meta",
    "alpha_translucent", "width1"])
def test_writer_vp8l_frames_decode_to_their_samples(tmp_path, kind):
    """The writer's VP8L frames give back their samples through the port,
    and through PIL."""
    rng = np.random.default_rng(len(kind))
    h, w = 29, 37
    img = fixtures.photo(h, w, len(kind), bands=4)
    img[..., 3] = 255
    spec = {}
    if kind == "transforms":
        spec["transforms"] = [
            "subtract_green", ("predictor", 2, rng.integers(0, 16, 80)),
            ("cross_color", 3, rng.integers(-128, 128, (20, 3)))]
    elif kind.startswith("palette"):
        n = int(kind[7:])
        img, pal = fixtures._palette_image(kind, h, w, n)
        spec["transforms"] = [("palette", pal)]
    elif kind == "cache_lz77_meta":
        img = fixtures._repeats(kind, h, w)
        spec.update(cache_bits=5, lz77={"distances": [1, w, w + 1, 3 * w]},
                    meta=(2, np.arange(80) % 3))
    elif kind == "alpha_translucent":
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    elif kind == "width1":
        img = fixtures._repeats(kind, 45, 1)
        spec["lz77"] = {"distances": [1, 2]}
    path = _write(tmp_path, "w.webp",
                  fixtures.riff([fixtures.chunk(b"VP8L",
                                                fixtures.write_vp8l(img,
                                                                    **spec))]))
    mode, arr = twebp.read_webp(path)
    want = img if mode == "RGBA" else img[..., :3]
    assert mode == ("RGBA" if (img[..., 3] != 255).any() else "RGB")
    np.testing.assert_array_equal(arr, want)
    _same((mode, arr), _pil(path))


@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_alph_unfilters_match_plain_numpy(tmp_path, method, filt):
    """An ALPH chunk's alpha (raw or VP8L, each filter) comes out as the
    plain numpy unfilter of what it holds, which is the plane written;
    PIL gives the same."""
    rng = np.random.default_rng(10 * method + filt)
    h, w = 19, 23
    alpha = fixtures._alpha_plane(h, w)
    alpha[rng.random((h, w)) < 0.1] = 0
    filtered = fixtures.alpha_filter(alpha, filt)
    plain = fixtures.alpha_unfilter(filtered, filt)
    np.testing.assert_array_equal(plain, alpha)
    frame = fixtures.write_vp8(w, h, fixtures._lossy_mbs("u", 2, 2))
    data = fixtures.riff([fixtures.vp8x(fixtures.ALPHA, w, h),
                          fixtures.chunk(b"ALPH", fixtures.alph_chunk(
                              alpha, method, filt)),
                          fixtures.chunk(b"VP8 ", frame)])
    path = _write(tmp_path, "a.webp", data)
    mode, arr = twebp.read_webp(path)
    assert mode == "RGBA"
    np.testing.assert_array_equal(arr[..., 3], plain)
    _same((mode, arr), _pil(path))


def test_pils_encoder_sweep_matches_pil(tmp_path):
    """PIL's encoder over seeded sizes, qualities, methods and alpha
    options: the port gives PIL's array bit for bit every time."""
    rng = np.random.default_rng(27)
    checked = 0
    for k in range(24):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        img = fixtures.photo(h, w, k, bands=4, noise=0.05)
        img[..., 3] = fixtures._alpha_plane(h, w)
        if k % 4 == 0:
            img = img // 64 * 64  # few colours: a palette
        opts = {"method": int(rng.integers(0, 7))}
        if k % 3 == 0:
            opts.update(lossless=True, exact=bool(k % 2))
        else:
            opts.update(quality=int(rng.integers(0, 101)),
                        alpha_quality=int(rng.integers(0, 101)),
                        alpha_filter=["none", "fast", "best"][k % 3])
        mode = ["RGB", "RGBA", "L", "LA"][k % 4]
        path = str(tmp_path / f"s{k}.webp")
        Image.fromarray(img, "RGBA").convert(mode).save(path, "WEBP", **opts)
        _same(twebp.read_webp(path), _pil(path))
        checked += 1
    assert checked == 24


@pytest.mark.parametrize("name", sorted(fixtures.REFUSED_CASES))
def test_file_pil_refuses_raises_value_error(tmp_path, name):
    """A WebP PIL refuses (truncated, a bad RIFF size, stray bytes, a
    frame past its canvas, a corrupt VP8 / VP8L / ALPH stream, ...): the
    port raises ValueError naming the file, through read_image."""
    path = _write(tmp_path, f"{name}.webp", fixtures.case_bytes(name))
    with pytest.raises((OSError, ValueError, SyntaxError, EOFError)):
        _pil(path)
    with pytest.raises(ValueError) as info:
        tjpeg.read_image(path)
    assert path in str(info.value)


def test_read_image_dispatch_and_other_formats(tmp_path):
    """read_image sends a WebP to read_webp whatever its name; a RIFF /
    WEBP file whose first chunk is not VP8, VP8L or VP8X is not a WebP
    for PIL, and it and a QOI raise NotImplementedError naming the
    queue."""
    src = os.path.join(GOLDEN, "pil_lossy_rgba.webp")
    with open(src, "rb") as f:
        data = f.read()
    path = _write(tmp_path, "frame.png", data)
    _same(tjpeg.read_image(path), _pil(src))
    other = _write(tmp_path, "alph_first.webp",
                   data[:12] + b"ALPH" + data[16:])
    qoi = str(tmp_path / "frame.qoi")
    Image.new("RGB", (8, 8), (10, 20, 30)).save(qoi, "QOI")
    for p in (other, qoi):
        with pytest.raises(NotImplementedError) as info:
            tjpeg.read_image(p)
        msg = str(info.value)
        assert ("PNG, JPEG, TIFF, WebP, BMP, GIF, PPM, TGA, JPEG 2000 and "
                "AVIF" in msg), msg
        assert "ROADMAP Queue 1" in msg and "rsn/data/blender.py" in msg


def test_tables_are_libwebps():
    """Every constant table of webp.cpp stands, byte for byte, in the
    read-only data of the libwebp that PIL loads."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libwebp-*.so*"))
    assert libs, "PIL's bundled libwebp"
    with open(libs[0], "rb") as f:
        blob = f.read()
    for name, dtype in (("kCoeffsProba0", np.uint8),
                        ("kCoeffsUpdateProba", np.uint8),
                        ("kBModesProba", np.uint8), ("kDcTable", np.uint8),
                        ("kAcTable", "<u2"), ("kZigzag", np.uint8),
                        ("kBands", np.uint8), ("kCodeToPlane", np.uint8),
                        ("kCodeLengthOrder", np.uint8), ("kCat6", np.uint8),
                        ("kCat5", np.uint8), ("kCat4", np.uint8),
                        ("kCat3", np.uint8)):
        vals = fixtures._cpp_table(name, (-1,))
        assert vals.tobytes() != b""
        assert np.asarray(vals, dtype).tobytes() in blob, name


def test_failed_webp_build_raises_with_compiler_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "webp.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "WEBP_SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_webp_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        tnative.get_webp_lib()
    assert "webp.cpp" in str(info.value)
    assert os.listdir(tmp_path / "build") == []


# ---- the loaders on WebP scenes ----------------------------------------------------

def _frame_file(img: np.ndarray, i: int) -> bytes:
    """Frame i as a WebP of another kind: lossy, lossless, lossy with
    ALPH (raw, gradient), lossless with alpha, an animation's first
    frame, lossy from PIL's encoder."""
    f = fixtures
    h, w = img.shape[:2]
    rgba = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    if i == 0:
        return f.riff([f.chunk(b"VP8L", f.write_vp8l(rgba, transforms=[
            "subtract_green"]))])
    if i == 1:
        rgba[..., 3] = f._alpha_plane(h, w)
        return f.riff([f.chunk(b"VP8L", f.write_vp8l(rgba, cache_bits=3))])
    mbs = f._lossy_mbs(f"scene{i}", (w + 15) // 16, (h + 15) // 16)
    vp8 = f.write_vp8(w, h, mbs, filt=(i == 3, 20, 0))
    if i == 2:
        return f.riff([f.chunk(b"VP8 ", vp8)])
    if i == 3:
        return f.riff([f.vp8x(f.ALPHA, w, h), f.chunk(b"ALPH", f.alph_chunk(
            f._alpha_plane(h, w), 0, 3)), f.chunk(b"VP8 ", vp8)])
    return f.riff([f.vp8x(f.ALPHA | f.ANIMATION, w, h), f.anim(),
                   f.anmf(2, 2, w - 4, h - 2, f.chunk(b"VP8L", f.write_vp8l(
                       rgba[:h - 2, :w - 4])))])


def _webp_scene(root, fmt, n=5):
    ds = tsynthetic.make_synthetic_dataset(n, 18, 26)
    frames = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, img in enumerate((ds.images * 255).astype(np.uint8)):
        name = f"images/frame_{i:05d}.webp"
        with open(os.path.join(root, name), "wb") as f:
            f.write(_frame_file(img, i))
        pose = np.eye(4)
        pose[:3, :4] = ds.cameras.camera_to_worlds[i].numpy()
        frame = {"file_path": name if fmt != "blender" else "./" + name,
                 "transform_matrix": pose.tolist()}
        if fmt == "nerfstudio":
            frame.update(fl_x=24.0 + i, fl_y=23.5, cx=13.1, cy=8.7)
        frames.append(frame)
    if fmt == "blender":
        meta = {"camera_angle_x": 0.69, "frames": frames}
        name = "transforms_train.json"
    else:
        meta = {"frames": frames}
        name = "transforms.json"
    with open(os.path.join(root, name), "w") as f:
        json.dump(meta, f)
    return root


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("fmt", ["blender", "nerfstudio"])
def test_loaders_on_a_webp_scene_match_rsn(tmp_path, fmt, downscale):
    """load_dataset over WebP frames of five kinds (lossless, lossless
    with alpha, lossy, lossy with ALPH, an animation) equals rsn's (PIL's
    decode, Pillow's bilinear shrink, alpha blended to white) with 0 max
    abs difference, and the cameras equal."""
    root = _webp_scene(str(tmp_path), fmt)
    tds = tblender.load_dataset(fmt, root, "train", downscale)
    jds = jblender.load_dataset(fmt, root, "train", downscale)
    assert tds.images.dtype == jds.images.dtype == np.float32
    assert tds.images.shape == jds.images.shape
    assert tds.images.tobytes() == jds.images.tobytes()
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        t = getattr(tds.cameras, k)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(getattr(jds.cameras, k)))
