"""The JPEG decoder's cases and fixtures.

CASES names each case of tests/test_torch_jpeg.py: a seeded image (numpy)
and the options PIL writes it with.  `python
tests/golden/jpeg/write_fixtures.py` writes one file per case here, five
800x800 frames of the sphere scene (`make_synthetic_dataset(5, 800,
800)`, quality 90, 4:2:0) for chip_smoke.py's JPEG capture, and
digests.json: the mode, shape and sha256 of PIL's decode of each file,
with the PIL and libjpeg-turbo versions that made them.  It needs PIL;
the decoder under test does not.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "digests.json")
NUM_FRAMES = 5
FRAME_SIZE = 800
FRAME_OPTIONS = {"quality": 90, "subsampling": 2}

# name -> (width, height, PIL mode, save options)
_SEQ = {"subsampling": 2}
CASES = {
    "gray": (67, 45, "L", {}),
    "gray_progressive": (67, 45, "L", {"progressive": True}),
    "sub444": (67, 45, "RGB", {"subsampling": 0}),
    "sub422": (67, 45, "RGB", {"subsampling": 1}),
    "sub420": (67, 45, "RGB", {"subsampling": 2}),
    "quality1": (67, 45, "RGB", {"quality": 1}),
    "quality50": (67, 45, "RGB", {"quality": 50}),
    "quality95": (67, 45, "RGB", {"quality": 95}),
    "quality100": (67, 45, "RGB", {"quality": 100}),
    "optimize": (67, 45, "RGB", {"optimize": True}),
    "progressive444": (67, 45, "RGB", {"progressive": True,
                                       "subsampling": 0}),
    "progressive420": (67, 45, "RGB", {"progressive": True,
                                       "subsampling": 2}),
    "restart_blocks": (67, 45, "RGB", {"restart_marker_blocks": 3}),
    "restart_rows": (67, 45, "RGB", {"restart_marker_rows": 1}),
    "progressive_restart_blocks": (67, 45, "RGB", {
        "progressive": True, "restart_marker_blocks": 3}),
    "progressive_restart_rows": (67, 45, "RGB", {
        "progressive": True, "restart_marker_rows": 1}),
    "keep_rgb": (67, 45, "RGB", {"keep_rgb": True}),
    "size1x1": (1, 1, "RGB", _SEQ),
    "size2x1": (2, 1, "RGB", _SEQ),
    "size3x3": (3, 3, "RGB", _SEQ),
    "size17x9": (17, 9, "RGB", _SEQ),
    "size17x9_sub422": (17, 9, "RGB", {"subsampling": 1}),
    "size67x45": (67, 45, "RGB", _SEQ),
    "size801x601": (801, 601, "RGB", _SEQ),
}


def case_pixels(name: str) -> np.ndarray:
    """The case's image, from a seed of its name: smooth colour waves,
    noise, and a saturated checker (IDCT overshoot past 0 and 255)."""
    width, height, mode, _ = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([128 + 90 * np.sin(x / 9.0 + p) * np.cos(y / 7.0 - p)
                    for p in phase], -1)
    img += rng.normal(0.0, 6.0, img.shape)
    checker = ((x // 2 + y // 2) % 2 == 0)[..., None] * 255.0
    box = (x > width * 0.6) & (y < height * 0.4)
    img = np.where(box[..., None], checker, img)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if mode == "L" else img


def write_case(name: str, path: str) -> None:
    from PIL import Image

    _, _, mode, options = CASES[name]
    Image.fromarray(case_pixels(name), mode).save(path, "JPEG", **options)


def frame_pixels() -> np.ndarray:
    """(5, 800, 800, 3) uint8: the sphere scene's train cameras."""
    from rsn_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(NUM_FRAMES, FRAME_SIZE, FRAME_SIZE)
    return (ds.images * 255).astype(np.uint8)


def frame_name(i: int) -> str:
    return f"frame_{i:05d}.jpg"


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def main() -> None:
    from PIL import Image, features

    files = {}
    for name in CASES:
        write_case(name, os.path.join(HERE, f"{name}.jpg"))
        files[f"{name}.jpg"] = None
    for i, px in enumerate(frame_pixels()):
        Image.fromarray(px).save(os.path.join(HERE, frame_name(i)), "JPEG",
                                 **FRAME_OPTIONS)
        files[frame_name(i)] = None
    for fname in files:
        img = Image.open(os.path.join(HERE, fname))
        files[fname] = digest(img.mode, np.asarray(img))
    with open(DIGESTS, "w") as f:
        json.dump({"pil": Image.__version__,
                   "libjpeg_turbo": features.version("libjpeg_turbo"),
                   "files": files}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    main()
