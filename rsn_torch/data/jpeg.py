"""JPEG frames, and the choice of decoder by a file's content (the port
of the `Image.open` calls in rsn/data/blender.py).

rsn opens every frame with PIL, which tells the format by content, not by
extension.  `read_image` does the same: rsn_torch.data.formats walks
Image.open's plugins in its order, and the frame goes to the port's
reader of the plugin that takes it: a PNG to rsn_torch.data.png.read_png,
a JPEG to `read_jpeg`, a TIFF to rsn_torch.data.tiff.read_tiff (PIL's
mode and array for strips and tiles, both byte orders, BigTIFF, no
compression, PackBits, LZW, Deflate and JPEG, predictors 2 and 3), a WebP
to rsn_torch.data.webp.read_webp (frame 0 of any WebP PIL opens), a BMP
or DIB to rsn_torch.data.bmp, a GIF (frame 0) to rsn_torch.data.gif, a
PBM / PGM / PPM / PFM to rsn_torch.data.ppm, a TGA to rsn_torch.data.tga,
a JPEG 2000 (a JP2 file or a raw codestream, decoded as OpenJPEG
2.5.4 decodes it for PIL) to rsn_torch.data.jpeg2000 and an AVIF still
image (libavif 1.3.0's parse, AV1 key frames as dav1d 1.5.1 decodes
them, libavif's YUV to RGB through libyuv) to rsn_torch.data.avif.  A
file that an unported plugin may take, or that no plugin takes, raises
NotImplementedError.  `read_jpeg` gives what
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

from rsn_torch.data import formats, native, png, tiff, webp

PORTED = "PNG, JPEG, TIFF, WebP, BMP, GIF, PPM, TGA, JPEG 2000 and AVIF"


# -> (PIL's mode, the array np.asarray gives of the image PIL opens)
read_jpeg = native.decode_jpeg


def read_image(path: str) -> Tuple[str, np.ndarray]:
    """Any frame rsn reads with PIL -> (PIL's mode, np.asarray's array),
    the decoder chosen by the file's content as Image.open chooses."""
    with open(path, "rb") as f:
        data = f.read()
    found = formats.identify(data, path)
    if found.image is not None:
        return found.image.load()
    if found.ported:
        return {"PNG": png.read_png, "JPEG": read_jpeg, "TIFF": tiff.read_tiff,
                "WEBP": webp.read_webp}[found.format](path)
    what = (f"a file PIL's Image.open would try as {found.format} first"
            if found.format else "not a file any of PIL's plugins opens")
    raise NotImplementedError(
        f"{path}: {what}; ROADMAP Queue 1: the port decodes {PORTED} "
        "frames, rsn/data/blender.py reads the other formats with PIL")
