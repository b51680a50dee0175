"""The port's JPEG decoder against PIL: every case of
tests/golden/jpeg/write_fixtures.py written by PIL from its seed and read
back bit for bit (sequential, progressive, restart markers, every
subsampling PIL writes, gray, Adobe RGB, tiny and odd sizes); the
committed fixtures against their recorded digests (PIL's and the port's);
the loaders on a JPEG scene against rsn's; the kinds the decoder once left
out, the kinds PIL refuses and the corrupt files.  The kinds PIL does not
write are tests/test_torch_jpeg_kinds.py's."""
import importlib.util
import io
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
from rsn_torch.data import png as tpng
from rsn_torch.data import synthetic as tsynthetic

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "jpeg")
_spec = importlib.util.spec_from_file_location(
    "jpeg_fixtures", os.path.join(GOLDEN, "write_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)
with open(fixtures.DIGESTS) as _f:
    RECORDED = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "jpeg_kinds_fixtures", os.path.join(os.path.dirname(GOLDEN),
                                        "jpeg_kinds", "write_fixtures.py"))
kinds = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kinds)


def _pil(path):
    img = Image.open(path)
    return img.mode, np.asarray(img)


@pytest.mark.parametrize("name", sorted(fixtures.CASES))
def test_read_jpeg_matches_pil(tmp_path, name):
    """PIL writes the case from its seed; read_jpeg gives PIL's mode and
    np.asarray's array bit for bit, and read_image sends the file there
    by content."""
    path = str(tmp_path / f"{name}.jpg")
    fixtures.write_case(name, path)
    want_mode, want = _pil(path)
    mode, got = tjpeg.read_jpeg(path)
    assert (mode, got.dtype, got.shape) == (want_mode, want.dtype,
                                             want.shape)
    np.testing.assert_array_equal(got, want)
    mode2, got2 = tjpeg.read_image(path)
    assert mode2 == mode and np.array_equal(got2, got)


@pytest.mark.parametrize("fname", sorted(RECORDED["files"]))
def test_committed_fixture_digests(fname):
    """PIL still decodes each committed fixture to its recorded digest,
    and so does the port (chip_smoke.py checks the port's on the card's
    host, which has no PIL)."""
    path = os.path.join(GOLDEN, fname)
    want = RECORDED["files"][fname]
    assert fixtures.digest(*_pil(path)) == want
    assert fixtures.digest(*tjpeg.read_jpeg(path)) == want


def test_fixture_set_is_whole_and_small():
    names = {f"{n}.jpg" for n in fixtures.CASES} | {
        fixtures.frame_name(i) for i in range(fixtures.NUM_FRAMES)}
    assert set(RECORDED["files"]) == names
    total = sum(os.path.getsize(os.path.join(GOLDEN, f))
                for f in os.listdir(GOLDEN))
    assert total < 400 * 1024, total


def test_probe_jpeg():
    assert tnative.probe_jpeg(os.path.join(GOLDEN, "size17x9.jpg")) == (
        "RGB", (9, 17, 3))
    assert tnative.probe_jpeg(os.path.join(GOLDEN, "gray.jpg")) == (
        "L", (45, 67))


def test_exif_orientation_and_mpo_as_pil(tmp_path):
    """EXIF orientation is not applied on open; an MPO file gives its
    first image; a JPEG named .png is still a JPEG (PIL goes by content);
    a JPEG with the JFIF marker stripped stays YCbCr."""
    px = fixtures.case_pixels("sub420")
    exif = Image.Exif()
    exif[0x0112] = 6
    cases = {}
    b = io.BytesIO()
    Image.fromarray(px).save(b, "JPEG", exif=exif.tobytes(),
                             comment=b"a comment")
    cases["exif.jpg"] = b.getvalue()
    b = io.BytesIO()
    Image.fromarray(px).save(b, "MPO", save_all=True,
                             append_images=[Image.fromarray(255 - px)])
    cases["mpo.mpo"] = b.getvalue()
    cases["jpeg.png"] = cases["exif.jpg"]
    d = cases["exif.jpg"]
    i = d.index(b"\xff\xe0")
    cases["nojfif.jpg"] = d[:i] + d[i + 2 + int.from_bytes(d[i + 2:i + 4],
                                                           "big"):]
    for name, data in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        want_mode, want = _pil(path)
        mode, got = tjpeg.read_image(path)
        assert mode == want_mode and np.array_equal(got, want), name


def _patched_sof(marker=None, precision=None, sampling=None):
    """A baseline file with its SOF0 patched: another SOF marker, another
    precision or the first component's sampling byte."""
    b = io.BytesIO()
    Image.fromarray(fixtures.case_pixels("sub444")).save(b, "JPEG",
                                                         subsampling=0)
    d = bytearray(b.getvalue())
    i = d.index(b"\xff\xc0")
    if marker is not None:
        d[i + 1] = marker
    if precision is not None:
        d[i + 4] = precision
    if sampling is not None:
        d[i + 11] = sampling
    return bytes(d)


def _cmyk_bytes():
    b = io.BytesIO()
    Image.fromarray(fixtures.case_pixels("sub444")).convert("CMYK").save(
        b, "JPEG")
    return b.getvalue()


# the kinds the decoder once left out: real files of each (PIL's CMYK, the
# numpy writer's arithmetic, lossless and 4:4:0 frames), which now decode,
# and the two PIL refuses -> what the refusal's message names
UNPORTED = {
    "cmyk": (_cmyk_bytes, None),
    "arithmetic_sof9": (lambda: kinds.case_bytes("arith_seq"), None),
    "lossless_sof3": (lambda: kinds.case_bytes("lossless_p1"), None),
    "sampling440": (lambda: kinds.case_bytes("sampling440"), None),
    "hierarchical_sof5": (lambda: _patched_sof(marker=0xC5), "SOF5"),
    "precision12": (lambda: _patched_sof(precision=12), "12-bit"),
}


@pytest.mark.parametrize("kind", sorted(UNPORTED))
def test_unported_kinds_raise_not_implemented(tmp_path, kind):
    """No kind raises NotImplementedError any more.  CMYK, arithmetic
    coding, lossless frames and 4:4:0 decode to PIL's mode and array
    through read_jpeg, and _load_image gives rsn's frame; a hierarchical
    frame and a 12-bit one raise ValueError naming the file and PIL's
    refusal, through read_jpeg and the loaders' _load_image, where PIL
    raises."""
    make, refused = UNPORTED[kind]
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(make())
    if refused is None:
        want_mode, want = _pil(path)
        mode, got = tjpeg.read_jpeg(path)
        assert (mode, got.shape) == (want_mode, want.shape)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tblender._load_image(path),
                                      jblender._load_image(path))
        return
    with pytest.raises(OSError):
        np.asarray(Image.open(path))
    for read in (tjpeg.read_jpeg, tblender._load_image):
        with pytest.raises(ValueError) as info:
            read(path)
        msg = str(info.value)
        assert ("PIL refuses" in msg and refused in msg and path in msg
                and "ROADMAP" not in msg), msg


def test_truncated_and_corrupt_files_raise_value_error(tmp_path):
    """A truncated file raises ValueError naming it, as PIL raises on one
    (LOAD_TRUNCATED_IMAGES is False): cut before its EOI, in its
    entropy-coded data, in its tables, after its SOI."""
    with open(os.path.join(GOLDEN, "progressive420.jpg"), "rb") as f:
        data = f.read()
    for n, cut in enumerate((len(data) - 2, len(data) // 2, 200, 3)):
        path = str(tmp_path / f"cut{n}.jpg")
        with open(path, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(OSError):
            np.asarray(Image.open(path))
        with pytest.raises(ValueError, match="corrupt JPEG") as info:
            tjpeg.read_jpeg(path)
        assert path in str(info.value)


def test_more_pixels_than_pils_limit_raise_before_decoding(tmp_path):
    """A frame header of 65535 x 65535 pixels: PIL refuses it as a
    decompression bomb; the port raises ValueError before allocating."""
    d = bytearray(_patched_sof())
    i = d.index(b"\xff\xc0")
    d[i + 5:i + 9] = b"\xff\xff\xff\xff"
    path = str(tmp_path / "bomb.jpg")
    with open(path, "wb") as f:
        f.write(bytes(d))
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path)
    with pytest.raises(ValueError, match="decompression-bomb"):
        tjpeg.read_jpeg(path)


def test_read_image_picks_the_decoder_by_content(tmp_path):
    """A PNG named .jpg is read as a PNG; a QOI raises
    NotImplementedError naming ROADMAP Queue 1 and rsn/data/blender.py;
    read_png declines a JPEG without naming a decoder still to come."""
    px = fixtures.case_pixels("sub444")
    png_path = str(tmp_path / "frame.jpg")
    Image.fromarray(px).save(png_path, "PNG")
    mode, got = tjpeg.read_image(png_path)
    assert mode == "RGB" and np.array_equal(got, px)
    qoi = str(tmp_path / "frame.qoi")
    Image.fromarray(px).save(qoi, "QOI")
    with pytest.raises(NotImplementedError) as info:
        tjpeg.read_image(qoi)
    assert ("ROADMAP Queue 1" in str(info.value)
            and "rsn/data/blender.py" in str(info.value))
    with pytest.raises(NotImplementedError, match="not a PNG") as info:
        tpng.read_png(os.path.join(GOLDEN, "gray.jpg"))
    assert "still to come" not in str(info.value)


def test_failed_jpeg_build_raises_with_compiler_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "jpeg.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "JPEG_SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_jpeg_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        tnative.get_jpeg_lib()
    assert "jpeg.cpp" in str(info.value)
    assert os.listdir(tmp_path / "build") == []


def test_jpeg_library_name_follows_its_source(tmp_path):
    """The JPEG decoder builds into its own library, whose name changes
    with its source (an edit rebuilds it); the PNG loader's name stays."""
    png_lib = tnative.library_path()
    jpeg_lib = tnative.library_path(tnative.JPEG_SOURCE, ())
    assert os.path.basename(png_lib).startswith("loader-")
    assert os.path.basename(jpeg_lib).startswith("jpeg-")
    edited = tmp_path / "jpeg.cpp"
    with open(tnative.JPEG_SOURCE) as f:
        edited.write_text(f.read() + "// an edit\n")
    assert tnative.library_path(str(edited), ()) != jpeg_lib


# ---- the loaders on a JPEG scene -------------------------------------------

# frame i's save options: every subsampling, progressive, gray
_FRAME_OPTIONS = ({"subsampling": 2}, {"subsampling": 1},
                  {"subsampling": 0, "quality": 95},
                  {"progressive": True}, {"gray": True})


def _jpeg_scene(root, fmt):
    """Five 18x26 frames of the sphere scene as JPEGs, under a
    transforms.json (nerfstudio, instant-ngp) or transforms_train.json
    (blender) with the frames' extension given."""
    ds = tsynthetic.make_synthetic_dataset(5, 18, 26)
    frames = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, img in enumerate((ds.images * 255).astype(np.uint8)):
        opts = dict(_FRAME_OPTIONS[i])
        pil = Image.fromarray(img)
        if opts.pop("gray", False):
            pil = pil.convert("L")
        name = f"images/frame_{i:05d}.jpg"
        pil.save(os.path.join(root, name), "JPEG", **opts)
        pose = np.eye(4)
        pose[:3, :4] = ds.cameras.camera_to_worlds[i].numpy()
        frame = {"file_path": name if fmt != "blender" else "./" + name,
                 "transform_matrix": pose.tolist()}
        if fmt == "nerfstudio":
            frame.update(fl_x=24.0 + i, fl_y=23.5, cx=13.1, cy=8.7)
        frames.append(frame)
    if fmt == "blender":
        meta = {"camera_angle_x": 0.69, "frames": frames}
        for split in ("train", "val"):
            with open(os.path.join(root, f"transforms_{split}.json"),
                      "w") as f:
                json.dump(meta, f)
    else:
        meta = {"frames": frames, "k1": 0.01}
        if fmt == "instant-ngp":
            meta["camera_angle_x"] = 0.9
        with open(os.path.join(root, "transforms.json"), "w") as f:
            json.dump(meta, f)
    return root


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("fmt", ["blender", "nerfstudio", "instant-ngp"])
def test_loaders_on_a_jpeg_scene_match_rsn(tmp_path, fmt, downscale):
    """load_blender (.jpg frames), load_nerfstudio and load_instant_ngp:
    the images equal rsn's (PIL's decode and Pillow's bilinear shrink)
    bit for bit, the cameras equal."""
    root = _jpeg_scene(str(tmp_path), fmt)
    for split in (("train", "val") if fmt == "blender"
                  else ("train", "test")):
        tds = tblender.load_dataset(fmt, root, split, downscale)
        jds = jblender.load_dataset(fmt, root, split, downscale)
        assert tds.images.dtype == jds.images.dtype == np.float32
        assert tds.images.shape == jds.images.shape
        np.testing.assert_array_equal(tds.images, jds.images)
        for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
            t = getattr(tds.cameras, k)
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(getattr(jds.cameras, k)))
        assert (tds.cameras.width, tds.cameras.height) == (
            jds.cameras.width, jds.cameras.height)

