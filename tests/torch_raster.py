"""Shared checks of the port's BMP / DIB, GIF, PPM and TGA readers
(rsn_torch/data/{bmp,gif,ppm,tga}.py, rsn_torch/data/formats.py and
rsn_torch/data/native/raster.cpp) against PIL: the committed fixtures of
tests/golden/<format>/ against their recorded digests, PIL's refusals,
the plugin Image.open picks, and the loaders on a scene of such frames
against rsn's."""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch
from PIL import Image, UnidentifiedImageError

from rsn.data import blender as jblender
from rsn_torch.data import blender as tblender
from rsn_torch.data import formats
from rsn_torch.data import jpeg as tjpeg
from rsn_torch.data import synthetic as tsynthetic

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the port's "not ported" errors name what it decodes
PORTED = "PNG, JPEG, TIFF, WebP, BMP, GIF, PPM, TGA, JPEG 2000 and AVIF"


class Golden:
    """One format's folder: its writer (loaded by path) and digests."""

    def __init__(self, name: str):
        self.dir = os.path.join(GOLDEN, name)
        spec = importlib.util.spec_from_file_location(
            f"{name}_fixtures", os.path.join(self.dir, "write_fixtures.py"))
        self.writer = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self.writer)
        with open(self.writer.DIGESTS) as f:
            self.recorded = json.load(f)

    def path(self, fname: str) -> str:
        return os.path.join(self.dir, fname)

    def case_of(self, fname: str):
        names = {self.writer.fixture_name(n): n for n in {
            **self.writer.CASES, **self.writer.REFUSED_CASES}}
        return names.get(fname)


def pil_read(path: str):
    with Image.open(path, formats=formats.ORDER) as img:
        return img.mode, np.asarray(img)


def pil_choice(path: str):
    """Image.open's plugin, with a fresh PIL's order: its format, None
    when no plugin takes the file, "refused" when a plugin's _open
    raises."""
    try:
        with Image.open(path, formats=formats.ORDER) as img:
            return img.format
    except UnidentifiedImageError:
        return None
    except Exception:  # noqa: BLE001 - a plugin refused the file
        return "refused"


def port_choice(path: str):
    with open(path, "rb") as f:
        data = f.read()
    try:
        return formats.identify(data, path).format
    except ValueError:
        return "refused"


def check_fixture(g: Golden, fname: str) -> None:
    """PIL still decodes the fixture to its recorded digest, the port
    decodes it to the digest through read_image (chip_smoke.py checks the
    port's on the card's host, which has no PIL), and the writer still
    writes its case byte for byte."""
    path = g.path(fname)
    want = g.recorded["files"][fname]
    assert g.writer.digest(*pil_read(path)) == want
    assert g.writer.digest(*tjpeg.read_image(path)) == want
    name = g.case_of(fname)
    if name is not None:
        with open(path, "rb") as f:
            assert f.read() == g.writer.case_bytes(name)


def check_refused(g: Golden, fname: str) -> None:
    """PIL refuses the file (the error recorded), and read_image raises
    ValueError naming it."""
    path = g.path(fname)
    try:
        pil_read(path)
    except Exception as e:  # noqa: BLE001 - PIL's refusal
        assert type(e).__name__ == g.recorded["refused"][fname].split(":")[0]
    else:
        raise AssertionError(f"PIL opens {fname}")
    try:
        tjpeg.read_image(path)
    except ValueError as e:
        assert path in str(e)
    else:
        raise AssertionError(f"the port opens {fname}")
    with open(path, "rb") as f:
        assert f.read() == g.writer.case_bytes(g.case_of(fname))


def check_near_miss(g: Golden, name: str, tmp_path, plugins) -> None:
    """Image.open does not take the file as one of `plugins`, nor refuses
    it; read_image picks what it picks and raises NotImplementedError
    naming ROADMAP Queue 1, rsn/data/blender.py and the formats the port
    decodes."""
    path = str(tmp_path / f"near_miss_{name}")
    with open(path, "wb") as f:
        f.write(g.writer.NEAR_MISSES[name]())
    want = pil_choice(path)
    assert want != "refused" and want not in plugins
    assert port_choice(path) == want
    try:
        tjpeg.read_image(path)
    except NotImplementedError as e:
        msg = str(e)
        assert "ROADMAP Queue 1" in msg and "rsn/data/blender.py" in msg
        assert PORTED in msg, msg
    else:
        raise AssertionError(f"read_image decodes near miss {name}")


def fresh_pil_order() -> list:
    """Image.ID after Image.open's preinit and init in a new process."""
    out = subprocess.run(
        [sys.executable, "-c", "from PIL import Image; Image.preinit(); "
         "Image.init(); print(','.join(Image.ID))"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().split(",")


def same_as_pil(path: str) -> bool:
    """read_image == PIL on one file: the same mode, dtype, shape and
    bytes, or both refuse it (the port with ValueError), or no ported
    plugin takes it (the port with NotImplementedError)."""
    try:
        want = pil_read(path)
    except UnidentifiedImageError:
        want = "none"
    except Exception:  # noqa: BLE001 - PIL's refusal
        want = "refused"
    try:
        got = tjpeg.read_image(path)
    except ValueError:
        got = "refused"
    except NotImplementedError:
        got = "none"
    if isinstance(want, str) or isinstance(got, str):
        return want == got
    return (want[0] == got[0] and want[1].dtype == got[1].dtype
            and want[1].shape == got[1].shape
            and want[1].tobytes() == got[1].tobytes())


def write_scene(root: str, fmt: str, frame_file, ext: str,
                n: int = 5) -> str:
    """A Blender- or nerfstudio-format scene of n frames: frame_file(i,
    img) gives frame i's bytes from the synthetic sphere's (H, W, 3)
    uint8 pixels, the cameras the sphere's."""
    ds = tsynthetic.make_synthetic_dataset(n, 18, 26)
    frames = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, img in enumerate((ds.images * 255).astype(np.uint8)):
        name = f"images/frame_{i:05d}.{ext}"
        with open(os.path.join(root, name), "wb") as f:
            f.write(frame_file(i, img))
        pose = np.eye(4)
        pose[:3, :4] = ds.cameras.camera_to_worlds[i].numpy()
        frame = {"file_path": name if fmt != "blender" else "./" + name,
                 "transform_matrix": pose.tolist()}
        if fmt == "nerfstudio":
            frame.update(fl_x=24.0 + i, fl_y=23.5, cx=13.1, cy=8.7)
        frames.append(frame)
    meta = {"frames": frames}
    if fmt == "blender":
        meta["camera_angle_x"] = 0.69
    with open(os.path.join(root, "transforms_train.json" if fmt == "blender"
                           else "transforms.json"), "w") as f:
        json.dump(meta, f)
    return root


def check_loaders(root: str, fmt: str, downscale: int) -> None:
    """load_dataset over the scene equals rsn's (PIL's decode, Pillow's
    bilinear shrink, alpha blended to white) with 0 max abs difference,
    and the cameras equal."""
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
