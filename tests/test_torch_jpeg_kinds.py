"""The port's JPEG decoder against PIL on the kinds PIL reads but does not
write: every case of tests/golden/jpeg_kinds/write_fixtures.py (Motion-JPEG
without DHT, every sampling layout, CMYK / YCCK, arithmetic coding,
lossless frames, progressive files libjpeg smooths) written by its numpy
writer and read back bit for bit; the files PIL refuses against the
port's ValueError; the committed fixtures against their recorded digests;
Pillow's CMYK resize; the loaders on a scene of mixed kinds against
rsn's."""
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
                      "jpeg_kinds")
_spec = importlib.util.spec_from_file_location(
    "jpeg_kinds_fixtures", os.path.join(GOLDEN, "write_fixtures.py"))
kinds = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kinds)
with open(kinds.DIGESTS) as _f:
    RECORDED = json.load(_f)


def _pil(path):
    img = Image.open(path)
    return img.mode, np.asarray(img)


@pytest.mark.parametrize("name", sorted(kinds.CASES))
def test_kind_matches_pil(tmp_path, name):
    """The writer's file of each case: read_jpeg gives PIL's mode and
    np.asarray's array bit for bit, and read_image sends it there."""
    path = str(tmp_path / f"{name}.jpg")
    kinds.write_case(name, path)
    want_mode, want = _pil(path)
    assert want_mode == kinds.MODES[kinds.CASES[name][2]]
    mode, got = tjpeg.read_jpeg(path)
    assert (mode, got.dtype, got.shape) == (want_mode, want.dtype,
                                             want.shape)
    np.testing.assert_array_equal(got, want)
    mode2, got2 = tjpeg.read_image(path)
    assert mode2 == mode and np.array_equal(got2, got)


@pytest.mark.parametrize("name", sorted(
    n for n, (_, _, _, o) in kinds.CASES.items()
    if o.get("coding") == "lossless" and "sampling" not in o))
def test_lossless_kind_gives_the_writers_samples(name):
    """A lossless frame at full size decodes to the writer's samples
    after its point transform (CMYK inverted, as PIL's "CMYK;I")."""
    options = kinds.CASES[name][3]
    pt = options.get("pt", 0)
    want = (kinds.case_pixels(name) >> pt) << pt
    _, got = tjpeg.read_jpeg(os.path.join(GOLDEN, f"{name}.jpg"))
    if got.ndim == 3 and got.shape[-1] == 4:
        got = 255 - got
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("name", sorted(kinds.REFUSED))
def test_refused_kind_raises_value_error(tmp_path, name):
    """Each file PIL refuses (a precision other than 8, hierarchical and
    lossless arithmetic frames, fractional sampling, 2 components, a
    progressive or lossless scan without its Huffman table, a lossless
    frame in YCbCr or YCCK, an undefined table 2): the port raises
    ValueError naming the file and PIL's refusal, not NotImplementedError,
    through read_jpeg and read_image."""
    path = str(tmp_path / f"{name}.jpg")
    kinds.write_case(name, path)
    with pytest.raises(OSError):
        np.asarray(Image.open(path))
    for read in (tjpeg.read_jpeg, tjpeg.read_image):
        with pytest.raises(ValueError) as info:
            read(path)
        msg = str(info.value)
        assert path in msg and "PIL refuses" in msg, msg


@pytest.mark.parametrize("fname", sorted(RECORDED["files"]))
def test_committed_fixture_digests(fname):
    """PIL still decodes each committed fixture to its recorded digest,
    the writer still writes it byte for byte, and the port decodes it to
    the digest (chip_smoke.py checks the port's on the card's host, which
    has no PIL)."""
    path = os.path.join(GOLDEN, fname)
    want = RECORDED["files"][fname]
    assert kinds.digest(*_pil(path)) == want
    assert kinds.digest(*tjpeg.read_jpeg(path)) == want
    with open(path, "rb") as f:
        assert f.read() == kinds.case_bytes(fname[:-len(".jpg")])


def test_fixture_set_is_whole_and_small():
    assert set(RECORDED["files"]) == {kinds.fixture_name(n)
                                      for n in kinds.CASES}
    total = sum(os.path.getsize(os.path.join(GOLDEN, f))
                for f in os.listdir(GOLDEN)
                if f.endswith(".jpg") or f == "digests.json")
    assert total < 200 * 1024, total


def test_writer_tables_are_annex_k():
    """The writer's Annex K.3 Huffman tables and Annex K.1 quantisation
    scaling are the ones libjpeg writes: the DHT and DQT of PIL's
    non-optimised baseline file at quality 75."""
    b = io.BytesIO()
    Image.fromarray(kinds.case_pixels("mjpeg_seq")).save(b, "JPEG",
                                                         quality=75)
    data = b.getvalue()
    tables, i = {}, 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] == 0xC4:
            seg, k = data[i + 4:i + 2 + n], 0
            while k < len(seg):
                counts = tuple(seg[k + 1:k + 17])
                tables[("ac" if seg[k] >> 4 else "dc", seg[k] & 15)] = (
                    counts, tuple(seg[k + 17:k + 17 + sum(counts)]))
                k += 17 + sum(counts)
        i += 2 + n
    assert tables == kinds.STD_HUFFMAN
    quant = Image.open(io.BytesIO(data)).quantization  # natural order
    for t in (0, 1):
        assert kinds.quant_table(75, bool(t)).tolist() == list(quant[t])


def test_probe_jpeg_cmyk_and_layouts():
    assert tnative.probe_jpeg(os.path.join(GOLDEN, "ycck_420.jpg")) == (
        "CMYK", (29, 41, 4))
    assert tnative.probe_jpeg(os.path.join(GOLDEN, "lossless_gray.jpg")) == (
        "L", (17, 23))
    assert tnative.probe_jpeg(os.path.join(GOLDEN, "sampling410.jpg")) == (
        "RGB", (45, 67, 3))


@pytest.mark.parametrize("size", [(20, 13), (7, 30), (41, 29), (3, 1)])
def test_resize_bilinear_cmyk_matches_pillow(size):
    """resize_bilinear on a CMYK array: Pillow's four-band resize,
    nothing premultiplied."""
    arr = kinds.case_pixels("cmyk_adobe")
    want = np.asarray(Image.fromarray(arr, "CMYK").resize(size,
                                                          Image.BILINEAR))
    np.testing.assert_array_equal(tpng.resize_bilinear("CMYK", arr, size),
                                  want)


# ---- the loaders on a scene of mixed kinds ----------------------------------

# frame i's kind: CMYK (Adobe), YCCK 4:2:0, 4:4:0, arithmetic, Motion-JPEG,
# lossless, a progressive file libjpeg smooths
_FRAME_KINDS = (
    {"adobe": 0, "cmyk": True},
    {"adobe": 2, "cmyk": True, "sampling": [(2, 2), (1, 1), (1, 1), (2, 2)]},
    {"sampling": [(1, 2), (1, 1), (1, 1)]},
    {"coding": "arithmetic", "sampling": [(2, 2), (1, 1), (1, 1)],
     "restart": 2},
    {"dht": None, "sampling": [(2, 1), (1, 1), (1, 1)]},
    {"coding": "lossless", "jfif": False, "predictor": 4},
    {"script": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 63, 0, 1)]},
)


def _mixed_scene(root, fmt):
    """Seven 18x26 frames of the sphere scene, each of another kind, under
    a transforms.json (nerfstudio, instant-ngp) or transforms_train.json
    (blender)."""
    n = len(_FRAME_KINDS)
    ds = tsynthetic.make_synthetic_dataset(n, 18, 26)
    frames = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, img in enumerate((ds.images * 255).astype(np.uint8)):
        opts = dict(_FRAME_KINDS[i])
        if opts.pop("cmyk", False):  # K from the image's darkness
            img = np.concatenate([img, 255 - img.max(-1, keepdims=True)],
                                 -1)
        name = f"images/frame_{i:05d}.jpg"
        with open(os.path.join(root, name), "wb") as f:
            f.write(kinds.write_jpeg(img, **opts))
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
def test_loaders_on_a_mixed_kind_jpeg_scene_match_rsn(tmp_path, fmt,
                                                      downscale):
    """load_dataset over frames of every kind equals rsn's (PIL's decode,
    Pillow's bilinear shrink, CMYK's C, M, Y blended over its inverted K
    as if K were alpha) bit for bit, and the cameras equal."""
    root = _mixed_scene(str(tmp_path), fmt)
    split = "val" if fmt == "blender" else "train"
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


# ---- the IDCT out of range ------------------------------------------------------

def _islow_range_table(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jidctint.c's jpeg_idct_islow on (blocks, 64) coefficients, natural
    order, in 64-bit integers, mapped through jdmaster.c's range table
    (index x & 1023): what the decoder gave before it followed the SIMD
    IDCT -> (blocks, 8, 8) uint8."""
    def one_pass(v, shift):
        in0, in1, in2, in3, in4, in5, in6, in7 = v
        z1 = (in2 + in6) * 4433
        tmp2, tmp3 = z1 - in6 * 15137, z1 + in2 * 6270
        tmp0, tmp1 = (in0 + in4) * 8192, (in0 - in4) * 8192
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, \
            tmp1 - tmp2
        z5 = (in7 + in3 + in5 + in1) * 9633
        z1, z2 = (in7 + in1) * -7373, (in5 + in3) * -20995
        z3, z4 = (in7 + in3) * -16069 + z5, (in5 + in1) * -3196 + z5
        o0 = in7 * 2446 + z1 + z3
        o1 = in5 * 16819 + z2 + z4
        o2 = in3 * 25172 + z2 + z3
        o3 = in1 * 12299 + z1 + z4
        out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1,
               t11 - o2, t10 - o3]
        return np.stack([(x + (1 << (shift - 1))) >> shift for x in out])

    deq = (coef * quant.reshape(1, 64)).reshape(-1, 8, 8).astype(np.int64)
    ws = one_pass(deq.transpose(1, 0, 2), 11)          # (8 rows, n, 8 cols)
    out = one_pass(ws.transpose(2, 1, 0), 18)           # (8 cols, n, 8 rows)
    idx = out.transpose(1, 2, 0) & 1023                 # (n, rows, cols)
    table = np.concatenate([np.arange(128, 256), np.full(384, 255),
                            np.zeros(384), np.arange(0, 128)])
    return table[idx].astype(np.uint8)


def test_idct_saturation_fixture_leaves_the_range_table():
    """idct_saturation_gray's coefficients push samples far out of range:
    the range table's wrap (the decoder before it followed the SIMD IDCT)
    differs from PIL on most pixels, and the port equals PIL."""
    width, height, _, options = kinds.CASES["idct_saturation_gray"]
    frame = kinds._Frame(width, height, [(1, 1)], 8)
    coef = options["coefficients"](frame, 0)
    bh, bw = coef.shape[:2]
    old = _islow_range_table(coef.reshape(-1, 64),
                             kinds.quant_table(options["quality"], False))
    old = old.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)[:height, :width]
    path = os.path.join(GOLDEN, "idct_saturation_gray.jpg")
    _, want = _pil(path)
    assert (old != want).mean() > 0.5
    # the model is the decoder's old one: in range the two agree
    assert (old == want).sum() > 0
    _, got = tjpeg.read_jpeg(path)
    np.testing.assert_array_equal(got, want)
