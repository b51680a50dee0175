"""rsn_torch's loaders against rsn's on the same files: the Blender,
nerfstudio and instant-ngp dataparsers (images and cameras), the PNG
decoder and Pillow's resize against PIL, the native decoder against the
port's zlib decoder and against rsn's build of the same source, and
write_blender_scene against rsn's."""
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from rsn.data import blender as jblender
from rsn.data import native as jnative
from rsn.data import synthetic as jsynthetic
from rsn_torch.data import blender as tblender
from rsn_torch.data import native as tnative
from rsn_torch.data import png as tpng
from rsn_torch.data import synthetic as tsynthetic

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ---- a PNG encoder with every filter type, bit depth and interlacing ----

def _pack(samples, depth):
    h, w, ch = samples.shape
    if depth == 16:
        s = samples.astype(np.uint16).reshape(h, w * ch)
        return np.stack([(s >> 8).astype(np.uint8),
                         (s & 255).astype(np.uint8)], -1).reshape(h, -1)
    s = samples.astype(np.uint8).reshape(h, w * ch)
    if depth == 8:
        return s
    bits = ((s[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _filter_rows(rows, bpp):
    """Row y gets filter type y % 5 (None, Sub, Up, Average, Paeth)."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        f = y % 5
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out.append(bytes([f]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def encode_png(samples, color, depth, palette=None, interlace=False):
    samples = samples[..., None] if samples.ndim == 2 else samples
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        data = b"".join(_filter_rows(_pack(samples[y0::dy, x0::dx], depth),
                                     bpp)
                        for x0, y0, dx, dy in _ADAM7
                        if samples[y0::dy, x0::dx].size)
    else:
        data = _filter_rows(_pack(samples, depth), bpp)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    comp = zlib.compress(data, 6)
    out = tpng.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    # two IDAT chunks: the stream is their concatenation
    return (out + chunk(b"IDAT", comp[:len(comp) // 2])
            + chunk(b"IDAT", comp[len(comp) // 2:]) + chunk(b"IEND", b""))


FORMATS = {  # name: (color type, bit depth, interlaced)
    "gray1": (0, 1, False), "gray2": (0, 2, False), "gray4": (0, 4, False),
    "gray8": (0, 8, False), "gray16": (0, 16, False), "rgb8": (2, 8, False),
    "rgb16": (2, 16, False), "palette4": (3, 4, False),
    "palette8": (3, 8, False), "gray_alpha8": (4, 8, False),
    "gray_alpha16": (4, 16, False), "rgba8": (6, 8, False),
    "rgba16": (6, 16, False), "rgb8_adam7": (2, 8, True),
    "rgba8_adam7": (6, 8, True), "palette2_adam7": (3, 2, True),
}


def write_format(path, name, h=13, w=17, seed=0):
    color, depth, interlace = FORMATS[name]
    rng = np.random.default_rng(seed)
    top = 1 << depth
    s = rng.integers(0, top, (h, w, _CH[color]))
    if color in (4, 6):  # alpha: transparent, opaque and in between
        s[..., -1] = rng.choice([0, top - 1, top // 3, top // 2], (h, w))
    pal = rng.integers(0, 256, (top, 3)) if color == 3 else None
    with open(path, "wb") as f:
        f.write(encode_png(s, color, depth, pal, interlace))
    return path


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_png_decode_and_resize_match_pil(tmp_path, name):
    """read_png == np.asarray(Image.open(..)) (mode, dtype, values);
    resize_bilinear == Image.resize(.., BILINEAR) bit for bit at
    downscale 2 and 3, on odd sizes; rsn's _load_image (PIL) ==
    the port's at downscale 1 and 2, bit for bit."""
    path = write_format(str(tmp_path / f"{name}.png"), name)
    im = Image.open(path)
    mode, arr = tpng.read_png(path)
    ref = np.asarray(im)
    assert (mode, arr.dtype, arr.shape) == (im.mode, ref.dtype, ref.shape)
    np.testing.assert_array_equal(arr, ref)
    for ds in (2, 3):
        size = (im.width // ds, im.height // ds)
        np.testing.assert_array_equal(
            tpng.resize_bilinear(mode, arr, size),
            np.asarray(im.resize(size, Image.BILINEAR)))
    for ds in (1, 2):
        got, want = tblender._load_image(path, ds), jblender._load_image(
            path, ds)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_resize_of_a_large_shrink_matches_pil(tmp_path):
    """The widened triangle filter of an 8x shrink and a non-integer
    ratio (101 -> 12), RGBA premultiplied, on a photo-like image."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:97, 0:101]
    rgba = np.stack([xx * 2, yy * 2, (xx * yy) % 256,
                     np.where((xx - 50) ** 2 + (yy - 48) ** 2 < 900, 255,
                              (xx % 5) * 60)], -1)
    rgba[..., :3] += rng.integers(0, 20, (97, 101, 3))
    im = Image.fromarray(np.clip(rgba, 0, 255).astype(np.uint8), "RGBA")
    arr = np.asarray(im)
    for size in ((12, 12), (50, 48), (33, 7)):
        np.testing.assert_array_equal(
            tpng.resize_bilinear("RGBA", arr, size),
            np.asarray(im.resize(size, Image.BILINEAR)))


def _native_emit(mode, px):
    """loader.cpp's emit on the zlib decoder's uint8 pixels: v * (1/255)
    in float32, alpha blended as fma(v * inv, a, 1 - a), the contraction
    g++ makes of `v * inv * a + bg` with -march=native (an fma of float32
    operands is exact in float64 but for its one rounding)."""
    inv = np.float32(1.0) / np.float32(255.0)
    p = px.astype(np.float32)
    if mode in ("L", "RGB"):
        v = p * inv
        return np.repeat(v[..., None], 3, -1) if mode == "L" else v
    a = p[..., -1:] * inv
    bg = np.float32(1.0) - a
    v = p[..., :-1] * inv
    out = (v.astype(np.float64) * a + bg).astype(np.float32)
    return np.repeat(out, 3, -1) if mode == "LA" else out


@pytest.mark.parametrize("name", ["gray8", "rgb8", "gray_alpha8", "rgba8",
                                  "every_value_alpha_pair"])
def test_native_decoder_equals_zlib_decoder(tmp_path, name):
    """The C library's float32 images == the zlib decoder's pixels put
    through the library's arithmetic, bit for bit; an RGBA image with
    every (value, alpha) pair covers the blend's whole domain.  The
    library also equals rsn's build of the same source."""
    path = str(tmp_path / f"{name}.png")
    if name == "every_value_alpha_pair":
        v, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
        Image.fromarray(np.stack([v, 255 - v, (v * 7) % 256, a], -1)
                        .astype(np.uint8), "RGBA").save(path)
    else:
        write_format(path, name, h=24, w=31)
    mode, px = tpng.read_png(path)
    assert tnative.probe_png(path) == px.shape[:2]
    got = tnative.decode_png_batch([path, path], *px.shape[:2])
    np.testing.assert_array_equal(got[0], _native_emit(mode, px))
    np.testing.assert_array_equal(got[1], got[0])
    if jnative.get_lib() is not None:
        np.testing.assert_array_equal(
            got, jnative.decode_png_batch([path, path], *px.shape[:2]))


def test_native_declines_what_it_cannot_decode(tmp_path):
    """Palette, 16-bit and interlaced PNGs, a size that differs from the
    batch's, a missing file: None (the loaders then read with the zlib
    decoder, as rsn reads with PIL), not an error."""
    for name in ("palette8", "rgb16", "rgb8_adam7"):
        path = write_format(str(tmp_path / f"{name}.png"), name)
        assert tnative.probe_png(path) is None
        assert tnative.decode_png_batch([path], 13, 17) is None
    ok = write_format(str(tmp_path / "ok.png"), "rgb8")
    assert tnative.decode_png_batch([ok], 12, 17) is None
    assert tnative.probe_png(str(tmp_path / "missing.png")) is None


def test_failed_native_build_raises_with_compiler_output(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        tnative.get_lib()
    assert "loader.cpp" in str(info.value)
    assert os.listdir(tmp_path / "build") == []  # no half-written library


def _same_cameras(tcams, jcams):
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        t = getattr(tcams, k)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jcams,
                                                                    k)))
    assert (tcams.width, tcams.height, tcams.camera_model) == (
        jcams.width, jcams.height, jcams.camera_model)
    if jcams.distortion is None:
        assert tcams.distortion is None
    else:
        np.testing.assert_array_equal(tcams.distortion.numpy(),
                                      np.asarray(jcams.distortion))


def _same_dataset(tds, jds, atol=0.0):
    assert tds.split == jds.split
    assert tds.images.dtype == jds.images.dtype
    assert tds.images.shape == jds.images.shape
    err = np.abs(tds.images - jds.images)
    print(f"{tds.split}: {int((err > 0).sum())} of {err.size} values "
          f"differ, max {err.max():.3g}")
    assert err.max() <= atol
    _same_cameras(tds.cameras, jds.cameras)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The sphere scene written by each package's write_blender_scene."""
    root = tmp_path_factory.mktemp("scenes")
    return {"rsn": jsynthetic.write_blender_scene(
                str(root / "rsn"), num_cameras=3, H=20, W=24),
            "port": tsynthetic.write_blender_scene(
                str(root / "port"), num_cameras=3, H=20, W=24)}


def test_write_blender_scene_matches_rsn(scenes):
    """The same transforms files and, decoded, the same pixels."""
    for split in ("train", "val", "test"):
        with open(os.path.join(scenes["rsn"],
                               f"transforms_{split}.json")) as f:
            want = json.load(f)
        with open(os.path.join(scenes["port"],
                               f"transforms_{split}.json")) as f:
            assert json.load(f) == want
        for frame in want["frames"]:
            rel = frame["file_path"][2:] + ".png"
            a = np.asarray(Image.open(os.path.join(scenes["rsn"], rel)))
            mode, b = tpng.read_png(os.path.join(scenes["port"], rel))
            assert mode == "RGB"
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["rsn", "port"])
@pytest.mark.parametrize("split,downscale", [("train", 1), ("test", 1),
                                             ("val", 2)])
def test_blender_loader_matches_rsn(scenes, writer, split, downscale):
    """Bit for bit at downscale 1 (the native decoder in both), within
    1/255 at downscale 2 (Pillow's resize and the port's); the cameras
    equal, scale_factor and max_images applied."""
    kw = dict(scale_factor=0.5, max_images=2) if split == "test" else {}
    tds = tblender.load_dataset("blender", scenes[writer], split, downscale,
                                **kw)
    jds = jblender.load_dataset("blender", scenes[writer], split, downscale,
                                **kw)
    _same_dataset(tds, jds, atol=0.0 if downscale == 1 else 1.0 / 255)


@pytest.mark.parametrize("frames", ["rgba8", "palette8", "gray16"])
def test_blender_loader_frame_formats(tmp_path, frames):
    """RGBA frames blend to white in the native decoder; palette and
    16-bit frames, which it declines, take the PIL route in rsn and the
    zlib decoder in the port: the same images either way."""
    meta = {"camera_angle_x": 0.69, "frames": []}
    for i in range(3):
        write_format(str(tmp_path / f"r_{i}.png"), frames, h=10, w=14,
                     seed=i)
        pose = np.eye(4)
        pose[:3, 3] = [0.0, -4.0 + i, 1.0]
        meta["frames"].append({"file_path": f"./r_{i}",
                               "transform_matrix": pose.tolist()})
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump(meta, f)
    _same_dataset(tblender.load_dataset("blender", str(tmp_path), "train"),
                  jblender.load_dataset("blender", str(tmp_path), "train"))


def _capture(root, fmt: str, model: str, n: int = 7, top_level=False):
    """A nerfstudio / instant-ngp transforms.json over n 12x16 frames on
    a tilted ring (auto-orient has work to do)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(len(model) + n)
    frames = []
    for i in range(n):
        theta = 2 * np.pi * i / n
        eye = np.array([3 * np.cos(theta), 1.0 + 0.3 * i,
                        3 * np.sin(theta)], np.float32)
        pose = tsynthetic._look_at_pose(eye)
        name = f"images/frame_{i:05d}.png"
        os.makedirs(os.path.join(root, "images"), exist_ok=True)
        write_format(os.path.join(root, name), "rgba8" if i % 2 else "rgb8",
                     h=12, w=16, seed=i)
        frame = {"file_path": name if fmt == "nerfstudio" else name[:-4],
                 "transform_matrix": pose.tolist()}
        if not top_level:
            frame.update(fl_x=14.0 + i, fl_y=13.5 + i, cx=8.2, cy=5.9)
        frames.append(frame)
    meta = {"frames": frames}
    if model != "OPENCV":
        meta["camera_model"] = model
    if model in ("OPENCV", "OPENCV_FISHEYE"):
        meta.update(k1=0.01 * rng.standard_normal(), k2=0.002)
    if fmt == "instant-ngp":
        meta.update(camera_angle_x=0.9, p1=0.001, aabb_scale=4)
        if not top_level:
            meta.update(fl_x=15.0)
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(meta, f)
    return root


@pytest.mark.parametrize("fmt,model", [
    ("nerfstudio", "OPENCV"), ("nerfstudio", "PINHOLE"),
    ("nerfstudio", "OPENCV_FISHEYE"), ("nerfstudio", "EQUIRECTANGULAR"),
    ("instant-ngp", "OPENCV"), ("instant-ngp", "top-level")])
def test_capture_loaders_match_rsn(tmp_path, fmt, model):
    """The nerfstudio and instant-ngp formats through load_dataset, both
    splits, downscale 1 and 2: the PIL-route images (RGB and RGBA frames)
    and the cameras (auto-orient, center and scale; per-frame and shared
    intrinsics, the camera_angle_x fallback; distortion; fisheye and
    equirectangular models) equal rsn's."""
    top = model == "top-level"
    root = _capture(str(tmp_path), fmt, "OPENCV" if top else model,
                    top_level=top)
    for split, ds in (("train", 1), ("test", 2)):
        tds = tblender.load_dataset(fmt, root, split, ds, scale_factor=0.8)
        jds = jblender.load_dataset(fmt, root, split, ds, scale_factor=0.8)
        _same_dataset(tds, jds)


def test_unknown_camera_model_and_dataparser_raise(tmp_path):
    root = _capture(str(tmp_path), "nerfstudio", "OPENCV", n=2)
    meta = json.load(open(os.path.join(root, "transforms.json")))
    meta["camera_model"] = "FOV"
    json.dump(meta, open(os.path.join(root, "transforms.json"), "w"))
    with pytest.raises(NotImplementedError, match="FOV"):
        tblender.load_dataset("nerfstudio", root, "train")
    with pytest.raises(ValueError, match="unknown dataparser"):
        tblender.load_dataset("colmap", root, "train")


def test_synthetic_dispatch_and_cameras_match_rsn():
    tds = tblender.load_dataset("synthetic", "triple:res=12,cams=3", "test")
    jds = jblender.load_dataset("synthetic", "triple:res=12,cams=3", "test")
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_allclose(tds.cameras.camera_to_worlds.numpy(),
                               np.asarray(jds.cameras.camera_to_worlds),
                               atol=1e-6)
    cams = tblender.load_cameras("synthetic", "triple:res=12,cams=3", "test")
    np.testing.assert_array_equal(cams.camera_to_worlds.numpy(),
                                  tds.cameras.camera_to_worlds.numpy())
