"""The port's TIFF decoder (rsn_torch/data/tiff.py, native/tiff.cpp and
jpeg.cpp's TIFF entry) against PIL: its tables against PIL's; every
committed fixture of tests/golden/tiff/ against its recorded digest and
PIL; every OPEN_INFO key under each compression, strips and tiles, planar
configuration 1 and 2, against PIL; PIL's own TIFF writer read back; the
refused kinds (NotImplementedError) and the files PIL refuses
(ValueError); Pillow's resize of the new modes; the loaders on a TIFF
scene against rsn's."""
import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from rsn.data import blender as jblender
from rsn_torch.data import blender as tblender
from rsn_torch.data import jpeg as tjpeg
from rsn_torch.data import png as tpng
from rsn_torch.data import synthetic as tsynthetic
from rsn_torch.data import tiff as ttiff

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "tiff")
_spec = importlib.util.spec_from_file_location(
    "tiff_fixtures", os.path.join(GOLDEN, "write_fixtures.py"))
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


def test_tables_are_pils():
    """OPEN_INFO, the prefixes and the compression names are PIL's."""
    assert ttiff.OPEN_INFO == TiffImagePlugin.OPEN_INFO
    assert list(ttiff.PREFIXES) == TiffImagePlugin.PREFIXES
    assert ttiff.COMPRESSION_INFO == TiffImagePlugin.COMPRESSION_INFO


@pytest.mark.parametrize("fname", sorted(RECORDED["files"]))
def test_committed_fixture_digests(fname):
    """PIL still decodes each committed fixture to its recorded digest,
    the writer still writes it byte for byte, and the port decodes it to
    the digest through read_image (chip_smoke.py checks the port's on the
    card's host, which has no PIL)."""
    path = os.path.join(GOLDEN, fname)
    want = RECORDED["files"][fname]
    assert fixtures.digest(*_pil(path)) == want
    assert fixtures.digest(*tjpeg.read_image(path)) == want
    with open(path, "rb") as f:
        assert f.read() == fixtures.case_bytes(fname[:-len(".tif")])


def test_fixture_set_is_whole_and_covers_the_kinds():
    """One fixture per case, a few KB each; together classic and
    BigTIFF, II and MM, strips and tiles, planar 1 and 2, every ported
    compression and both predictors, and every OPEN_INFO key."""
    assert set(RECORDED["files"]) == {fixtures.fixture_name(n)
                                      for n in fixtures.CASES}
    sizes = [os.path.getsize(os.path.join(GOLDEN, f))
             for f in RECORDED["files"]]
    assert max(sizes) < 8 * 1024 and sum(sizes) < 256 * 1024, sizes
    specs = [o for _, _, _, o in fixtures.CASES.values()]
    for key, values in (("bigtiff", {False, True}), ("order", {"<", ">"}),
                        ("planar", {1, 2}), ("predictor", {1, 2, 3}),
                        ("compression", {1, 5, 7, 8, 32773, 32946})):
        seen = {o.get(key, {"bigtiff": False, "order": "<", "planar": 1,
                            "predictor": 1, "compression": 1}[key])
                for o in specs}
        assert values <= seen, (key, seen)
    assert any("tile" in o for o in specs)
    keys = {(b"II" if o.get("order", "<") == "<" else b"MM",
             o["photometric"], (o.get("sample_format", 1),),
             o.get("fill_order", 1),
             (o.get("bits", 8),) * spp, tuple(o.get("extra", ())))
            for _, _, spp, o in fixtures.CASES.values()}
    assert set(TiffImagePlugin.OPEN_INFO) <= keys | {
        k for k in TiffImagePlugin.OPEN_INFO if k[1] == 6}


@pytest.mark.parametrize("compression", [1, 32773, 5, 8, 32946])
def test_every_key_and_layout_matches_pil(tmp_path, compression):
    """Each OPEN_INFO key (but YCbCr) at a seeded size, in strips or
    tiles, planar configuration 1 or 2, predictor 1-3, classic or
    BigTIFF: the port gives PIL's array bit for bit, or raises where PIL
    raises (ValueError) or the kind is not ported (NotImplementedError:
    planar 2 with samples beyond the mode's bands)."""
    rng = random.Random(compression)
    path = str(tmp_path / "k.tif")
    checked = 0
    for key in fixtures.KEYS:
        photo, fmt, fill, bits, extra = key
        for order in "<>":
            if order == ">" and key in fixtures.II_ONLY:
                continue
            pred = rng.choice([1, 2, 3]) if compression != 1 else 1
            if pred == 3 and fmt != 3 or pred == 2 and bits[0] not in (
                    8, 16, 32):
                pred = 1
            w, h = rng.randint(1, 40), rng.randint(1, 37)
            kw = dict(photometric=photo, bits=bits[0], sample_format=fmt,
                      extra=extra, order=order, fill_order=fill,
                      compression=compression, predictor=pred,
                      planar=rng.choice([1, 2]) if len(bits) > 1 else 1,
                      bigtiff=order == "<" and rng.random() < 0.3)
            if photo == 3:
                kw["colormap"] = fixtures._colormap("x", bits[0])
            if rng.random() < 0.5:
                kw["tile"] = (16 * rng.randint(1, 2), 16 * rng.randint(1, 2))
            else:
                kw["rows_per_strip"] = rng.randint(1, h + 2)
            samples = fixtures._seeded(f"{key}{order}", h, w, len(bits),
                                       bits[0], fmt)
            with open(path, "wb") as f:
                f.write(fixtures.write_tiff(samples, **kw))
            try:
                want = _pil(path)
            except (OSError, ValueError, SyntaxError):
                with pytest.raises((ValueError, NotImplementedError)):
                    ttiff.read_tiff(path)
                continue
            try:
                got = ttiff.read_tiff(path)
            except NotImplementedError as e:
                assert kw["planar"] == 2 and len(bits) > {
                    "RGB": 3, "RGBA": 4, "CMYK": 4, "P": 1}[want[0]], e
                continue
            _same(got, want)
            checked += 1
    assert checked > 80


def _pil_saves(mode: str, compression: str):
    """A seeded image of `mode` for PIL's TIFF writer."""
    rng = np.random.default_rng(len(mode) * 31 + len(compression))
    h, w = 13, 21
    if mode in ("I;16", "I;16B"):
        img = Image.frombytes(mode, (w, h), rng.integers(
            0, 65536, (h, w)).astype("<u2" if mode == "I;16" else ">u2")
            .tobytes())
    elif mode == "I":
        img = Image.fromarray(rng.integers(-2 ** 31, 2 ** 31 - 1, (h, w))
                              .astype(np.int32))
    elif mode == "F":
        img = Image.fromarray(rng.standard_normal((h, w)).astype(np.float32))
    else:
        bands = len(Image.new(mode, (1, 1)).getbands())
        img = Image.frombytes(mode, (w, h), rng.integers(
            0, 256, (h, w, bands)).astype(np.uint8).tobytes())
    return img


@pytest.mark.parametrize("compression", ["raw", "packbits", "tiff_lzw",
                                         "tiff_adobe_deflate", "jpeg"])
def test_pils_writer_read_back(tmp_path, compression):
    """Every mode PIL's TIFF writer writes with this compression, read
    back bit for bit (YCbCr without JPEG: NotImplementedError)."""
    written = 0
    for mode in ("1", "L", "LA", "P", "PA", "I", "I;16", "I;16B", "F",
                 "RGB", "RGBA", "RGBX", "CMYK", "LAB", "YCbCr"):
        path = str(tmp_path / f"{mode.replace(';', '_')}.tif")
        try:
            _pil_saves(mode, compression).save(path, "TIFF",
                                               compression=compression)
            want = _pil(path)
        except (OSError, ValueError, KeyError):
            continue  # a mode PIL does not write or read back this way
        written += 1
        if mode == "YCbCr" and compression != "jpeg":
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
                ttiff.read_tiff(path)
            continue
        _same(tjpeg.read_image(path), want)
    assert written >= (4 if compression == "jpeg" else 12), written


@pytest.mark.parametrize("name", sorted(fixtures.REFUSED_CASES))
def test_refused_kind_raises_not_implemented(tmp_path, name):
    """The kinds not ported yet (YCbCr without JPEG, CCITT, LZMA, ZSTD,
    old-style JPEG, SGILog, ThunderScan, old-style LZW) raise
    NotImplementedError naming ROADMAP Queue 1 and rsn/data/blender.py,
    through read_tiff and read_image."""
    path = str(tmp_path / f"{name}.tif")
    fixtures.write_case(name, path)
    for read in (ttiff.read_tiff, tjpeg.read_image):
        with pytest.raises(NotImplementedError) as info:
            read(path)
        msg = str(info.value)
        assert path in msg and "ROADMAP Queue 1" in msg, msg
        assert "rsn/data/blender.py" in msg, msg


@pytest.mark.parametrize("name", sorted(fixtures.BAD_CASES))
def test_file_pil_refuses_raises_value_error(tmp_path, name):
    """A TIFF PIL refuses (an unknown pixel mode, no width, an unknown
    compression, a raw unpacker PIL lacks, a truncated strip of each
    codec, a big-endian BigTIFF, WebP strips): the port raises ValueError
    naming the file."""
    path = str(tmp_path / f"{name}.tif")
    fixtures.write_case(name, path)
    with pytest.raises((OSError, ValueError, SyntaxError)):
        _pil(path)
    with pytest.raises(ValueError) as info:
        tjpeg.read_image(path)
    assert path in str(info.value)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_applied_as_pil_applies_it(tmp_path,
                                                       orientation):
    """TiffImageFile.load_end transposes by the Orientation tag."""
    path = str(tmp_path / "o.tif")
    samples = fixtures._seeded("o", 5, 7, 3, 8, 1)
    with open(path, "wb") as f:
        f.write(fixtures.write_tiff(samples, photometric=2, compression=5,
                                    tags={fixtures.ORIENTATION: (
                                        fixtures.SHORT, [orientation])}))
    _same(ttiff.read_tiff(path), _pil(path))


@pytest.mark.parametrize("mode", ["I", "F", "I;16B", "LAB", "PA"])
def test_resize_bilinear_new_modes_match_pillow(mode):
    """resize_bilinear on the modes TIFF adds: Pillow's 32-bit passes for
    "I" and "F", its 16-bit passes reading "I;16B" in the host's order,
    LAB's a and b offset by 128, PA's bands as they are."""
    rng = np.random.default_rng(3)
    for h, w in ((17, 23), (9, 8), (40, 31), (3, 1)):
        if mode == "I":
            arr = rng.integers(-2 ** 31, 2 ** 31 - 1, (h, w)).astype("<i4")
        elif mode == "F":
            arr = (rng.standard_normal((h, w)) * 1e3).astype("<f4")
        elif mode == "I;16B":
            arr = rng.integers(0, 65536, (h, w)).astype(">u2")
        else:
            arr = rng.integers(0, 256, (h, w, len(mode))).astype(np.uint8)
        img = Image.frombytes(mode, (w, h), arr.tobytes())
        for size in ((w // 2 or 1, h // 2 or 1), (w // 3 or 1, h),
                     (2 * w, h + 1)):
            want = np.asarray(img.resize(size, Image.BILINEAR))
            got = tpng.resize_bilinear(mode, arr, size)
            _same((mode, got), (mode, want))


def test_read_image_dispatch_and_other_formats(tmp_path):
    """read_image sends a TIFF to read_tiff, whatever its name, and
    refuses a format still to port (QOI) naming the queue."""
    path = str(tmp_path / "frame.png")  # a TIFF under another name
    fixtures.write_case("strips_one_row_lzw", path)
    _same(tjpeg.read_image(path), _pil(path))
    qoi = str(tmp_path / "frame.qoi")
    Image.new("RGB", (8, 8), (10, 20, 30)).save(qoi, "QOI")
    with pytest.raises(NotImplementedError) as info:
        tjpeg.read_image(qoi)
    msg = str(info.value)
    assert ("PNG, JPEG, TIFF, WebP, BMP, GIF, PPM, TGA, JPEG 2000 and AVIF"
            in msg)
    assert "QOI" in msg and "ROADMAP Queue 1" in msg
    assert "rsn/data/blender.py" in msg


# ---- the loaders on a TIFF scene -----------------------------------------------

def _frame_files(img: np.ndarray, i: int) -> bytes:
    """Frame i of the scene as a TIFF of another kind: 16-bit RGB (LZW,
    predictor 2), I;16 (Deflate), F (LZW, predictor 3), a palette
    (PackBits), CMYK (no compression, tiles), JPEG YCbCr 4:2:0, RGBA
    (Deflate, planar 2), a 32-bit signed gray (BigTIFF, MM), LAB."""
    gray = img.mean(-1)
    w = fixtures.write_tiff
    if i == 0:
        return w(img.astype(np.uint16) * 257, photometric=2,
                 compression=5, predictor=2, rows_per_strip=5)
    if i == 1:
        return w((gray * 257).astype(np.uint16), photometric=1,
                 compression=8, rows_per_strip=7)
    if i == 2:
        return w((gray / 255).astype(np.float32), photometric=1,
                 sample_format=3, compression=5, predictor=3)
    if i == 3:
        idx = (img[..., 0] // 64 * 16 + img[..., 1] // 64 * 4
               + img[..., 2] // 64).astype(np.uint8)
        return w(idx, photometric=3, colormap=fixtures._colormap("scene", 8),
                 compression=32773)
    if i == 4:
        cmyk = np.concatenate([255 - img, (255 - img.max(-1,
                                                         keepdims=True))],
                              -1).astype(np.uint8)
        return w(cmyk, photometric=5, tile=(16, 16))
    if i == 5:
        return w(img, photometric=6, compression=7, rows_per_strip=16,
                 subsampling=(2, 2),
                 jpeg={"sampling": [(2, 2), (1, 1), (1, 1)], "quality": 90})
    if i == 6:
        rgba = np.concatenate([img, (img[..., :1] // 2 + 100)], -1)
        return w(rgba.astype(np.uint8), photometric=2, extra=(2,),
                 planar=2, compression=8, rows_per_strip=6)
    if i == 7:
        return w((gray * 1000 - 50000).astype(np.int32), photometric=1,
                 sample_format=2, order=">", compression=8)
    return w(img, photometric=8, compression=32946, predictor=2)


def _tiff_scene(root, fmt, n=9):
    ds = tsynthetic.make_synthetic_dataset(n, 18, 26)
    frames = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, img in enumerate((ds.images * 255).astype(np.uint8)):
        name = f"images/frame_{i:05d}.tif"
        with open(os.path.join(root, name), "wb") as f:
            f.write(_frame_files(img, i))
        pose = np.eye(4)
        pose[:3, :4] = ds.cameras.camera_to_worlds[i].numpy()
        frame = {"file_path": name if fmt != "blender" else "./" + name,
                 "transform_matrix": pose.tolist()}
        if fmt == "nerfstudio":
            frame.update(fl_x=24.0 + i, fl_y=23.5, cx=13.1, cy=8.7)
        frames.append(frame)
    if fmt == "blender":
        meta = {"camera_angle_x": 0.69, "frames": frames}
        with open(os.path.join(root, "transforms_train.json"), "w") as f:
            json.dump(meta, f)
    else:
        meta = {"frames": frames}
        if fmt == "instant-ngp":
            meta["camera_angle_x"] = 0.9
        with open(os.path.join(root, "transforms.json"), "w") as f:
            json.dump(meta, f)
    return root


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("fmt", ["blender", "nerfstudio", "instant-ngp"])
def test_loaders_on_a_tiff_scene_match_rsn(tmp_path, fmt, downscale):
    """load_dataset over TIFF frames of nine kinds (16-bit RGB, I;16, F,
    a palette, CMYK, JPEG, planar RGBA, 32-bit signed gray, LAB) equals
    rsn's (PIL's decode, Pillow's bilinear shrink, / 255 in float32 with
    its quirks: values past 1 for I;16, palette indices as gray) with 0
    max abs difference, and the cameras equal."""
    root = _tiff_scene(str(tmp_path), fmt)
    tds = tblender.load_dataset(fmt, root, "train", downscale)
    jds = jblender.load_dataset(fmt, root, "train", downscale)
    assert tds.images.dtype == jds.images.dtype == np.float32
    assert tds.images.shape == jds.images.shape
    assert float(np.abs(tds.images - jds.images).max()) == 0.0
    assert tds.images.tobytes() == jds.images.tobytes()
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        t = getattr(tds.cameras, k)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(getattr(jds.cameras, k)))
