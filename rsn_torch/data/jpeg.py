"""JPEG frames, and the choice of decoder by a file's first bytes (the
port of the `Image.open` calls in rsn/data/blender.py).

rsn opens every frame with PIL, which tells the format by content, not by
extension.  `read_image` does the same: a PNG goes to
rsn_torch.data.png.read_png, a JPEG to `read_jpeg`, a TIFF to
rsn_torch.data.tiff.read_tiff (PIL's mode and array for strips and tiles,
both byte orders, BigTIFF, no compression, PackBits, LZW, Deflate and
JPEG, predictors 2 and 3), a WebP to rsn_torch.data.webp.read_webp (frame
0 of any WebP PIL opens: lossless VP8L, lossy VP8 with or without its
ALPH chunk, an animation's first frame on its canvas), and any other
format raises NotImplementedError.  `read_jpeg` gives what
`np.asarray(Image.open(path))` gives with PIL on libjpeg-turbo (the native
decoder in rsn_torch.data.native, bit for bit): mode "L" as (H, W) uint8,
"RGB" as (H, W, 3) uint8, "CMYK" as (H, W, 4) uint8 (PIL's inverted
Adobe bytes), for every JPEG PIL opens and libjpeg decodes; one PIL
refuses raises ValueError.  EXIF orientation is not applied, as PIL does
not apply it on open.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from rsn_torch.data import native, png, tiff, webp

JPEG_PREFIX = b"\xff\xd8\xff"  # PIL's JpegImagePlugin._accept


# -> (PIL's mode, the array np.asarray gives of the image PIL opens)
read_jpeg = native.decode_jpeg


def read_image(path: str) -> Tuple[str, np.ndarray]:
    """Any frame rsn reads with PIL -> (PIL's mode, np.asarray's array),
    the decoder chosen by the file's first bytes as Image.open chooses."""
    with open(path, "rb") as f:
        head = f.read(16)  # WebP's RIFF, WEBP and first chunk's tag
    if head.startswith(png.SIGNATURE):
        return png.read_png(path)
    if head.startswith(JPEG_PREFIX):
        return read_jpeg(path)
    if tiff.is_tiff(head):
        return tiff.read_tiff(path)
    if webp.is_webp(head):
        return webp.read_webp(path)
    raise NotImplementedError(
        f"{path}: not a PNG, JPEG, TIFF or WebP file; ROADMAP Queue 1: the "
        "port decodes PNG, JPEG, TIFF and WebP frames, rsn/data/blender.py "
        "reads the other formats with PIL")
