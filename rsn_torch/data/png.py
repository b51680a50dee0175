"""PNG read and write with numpy and zlib, and Pillow's resize, for the
loaders (the port of the PIL calls in rsn/data/blender.py:36-48).

rsn opens a frame with PIL, shrinks it with
`Image.resize(..., Image.BILINEAR)` and reads it as
`np.asarray(img, dtype=np.float32)`.  The port has no PIL, so this module
gives back what those calls give, quirks included (PARITY.md: quirks are
replicated, not fixed):

- `read_png` decodes every PNG that PIL opens (bit depths 1-16, gray,
  RGB, palette, gray + alpha, RGBA, Adam7 interlacing) to PIL's mode and
  to the array `np.asarray` of the opened image gives: 16-bit gray is
  mode "I;16" (uint16 values); 16-bit RGB, gray + alpha and RGBA keep the
  high byte of each sample, and 16-bit gray + alpha opens as RGBA; a palette image is its indices (mode "P");
  1-bit gray is mode "1" (bool); 2- and 4-bit gray are scaled to 8 bits.
  A tRNS chunk is ignored, as `np.asarray` ignores it.
- `resize_bilinear` is Pillow's `Image.resize(size, BILINEAR)`: a
  triangle filter whose support widens by the scale factor on a shrink,
  coefficients in 22-bit fixed point, a horizontal pass then a vertical
  one, each rounded to uint8 (16-bit gray: double coefficients, rounded
  to an integer); RGBA and LA premultiplied by alpha before and divided
  after; palette and 1-bit images resized by nearest neighbour, whatever
  filter is asked for.
- `write_png` writes 8-bit gray, gray + alpha, RGB or RGBA (filter type 0
  on every row).

JPEG and the other formats PIL reads are not decoded here: `read_png`
raises NotImplementedError for them.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import Iterator, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # per PNG color type
_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit resampling


# ---- decode ----------------------------------------------------------------

def _chunks(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError("truncated PNG chunk")
        yield tag, data[pos + 8:pos + 8 + length]
        if tag == b"IEND":
            return
        pos += 12 + length


def _unfilter(raw: memoryview, rows: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the PNG row filters -> (rows, stride) uint8.  Sub and Up run
    in numpy; Average and Paeth depend on the byte bpp to the left, so
    they run byte by byte."""
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(rows):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw[start + 1:start + 1 + stride], np.uint8)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum over each byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = np.frombuffer(_unfilter_serial(line.tobytes(),
                                                 prev.tobytes(), bpp, ftype),
                                np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_serial(line: bytes, prev: bytes, bpp: int, ftype: int
                     ) -> bytearray:
    cur = bytearray(line)
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prev[x]
        if ftype == 3:  # Average
            cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[x - bpp] if x >= bpp else 0  # Paeth
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 0xFF
    return cur


def _samples(rows: np.ndarray, width: int, channels: int, depth: int
             ) -> np.ndarray:
    """Unfiltered rows -> (h, width, channels) samples (uint8 or, for 16
    bits, uint16)."""
    h = rows.shape[0]
    if depth == 8:
        flat = rows[:, :width * channels]
    elif depth == 16:
        pairs = rows[:, :2 * width * channels].reshape(h, -1, 2)
        flat = (pairs[..., 0].astype(np.uint16) << 8) | pairs[..., 1]
    else:  # 1, 2, 4 bits: packed from the high bit
        bits = np.unpackbits(rows, axis=1)
        n = width * channels
        bits = bits[:, :n * depth].reshape(h, n, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        flat = (bits * weights).sum(axis=-1).astype(np.uint8)
    return flat.reshape(h, width, channels)


def read_png(path: str) -> Tuple[str, np.ndarray]:
    """-> (PIL's mode, the array np.asarray gives of the image PIL opens).

    Raises NotImplementedError for a file that is not a PNG (a JPEG
    frame of a nerfstudio capture, say): those go through PIL in rsn."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        kind = "a JPEG" if data[:3] == b"\xff\xd8\xff" else "not a PNG"
        raise NotImplementedError(
            f"{path}: {kind} file; ROADMAP Queue 1: the port decodes PNG "
            "only, rsn/data/blender.py reads other formats with PIL (a "
            "baseline JPEG decoder in the native loader is still to come)")
    ihdr, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = ihdr
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: unsupported PNG color type {color} / "
                         f"bit depth {depth}")
    ch = _CHANNELS[color]
    raw = memoryview(zlib.decompress(b"".join(idat)))
    bpp = max(1, ch * depth // 8)
    dtype = np.uint16 if depth == 16 else np.uint8
    if interlace:
        img = np.zeros((height, width, ch), dtype)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = -(-(width - x0) // dx) if width > x0 else 0
            ph = -(-(height - y0) // dy) if height > y0 else 0
            if pw == 0 or ph == 0:
                continue
            stride = -(-pw * ch * depth // 8)
            rows = _unfilter(raw[pos:pos + ph * (stride + 1)], ph, stride,
                             bpp)
            img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
            pos += ph * (stride + 1)
    else:
        stride = -(-width * ch * depth // 8)
        if len(raw) < height * (stride + 1):
            raise ValueError(f"{path}: PNG image data too short")
        img = _samples(_unfilter(raw, height, stride, bpp), width, ch,
                       depth)
    return _as_pil(img, color, depth)


def _as_pil(img: np.ndarray, color: int, depth: int) -> Tuple[str, np.ndarray]:
    """PNG samples -> PIL's mode and np.asarray's array of that mode."""
    if color == 0:
        g = img[..., 0]
        if depth == 1:
            return "1", g.astype(bool)
        if depth == 16:
            return "I;16", g
        return "L", (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if color == 3:
        return "P", img[..., 0]
    if depth == 16:  # PIL keeps the high byte
        img = (img >> 8).astype(np.uint8)
        if color == 4:  # and opens 16-bit gray + alpha as RGBA
            return "RGBA", img[..., [0, 0, 0, 1]]
    arr = img[..., 0] if img.shape[-1] == 1 else img
    return _MODES[color], arr


# ---- encode ----------------------------------------------------------------

def write_png(path: str, pixels: np.ndarray) -> None:
    """(H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or (H, W, 4)
    RGBA uint8 -> an 8-bit PNG (filter type 0 on every row, zlib level 6)."""
    px = np.ascontiguousarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, ch = px.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, w * ch)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                           0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


# ---- Pillow's resize -------------------------------------------------------

def _coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the triangle (bilinear) filter over
    the whole axis -> (first input index (out,), taps (out, ksize) as
    float64; taps past an output's window are 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        taps = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            taps.append(1.0 - t if t < 1.0 else 0.0)
        ww = _sum_in_order(taps)
        for x, w in enumerate(taps):
            kk[xx, x] = w / ww if ww != 0.0 else w
        first[xx] = xmin
    return first, kk


def _sum_in_order(values) -> float:
    """Left to right, as C adds (Python's sum() compensates)."""
    total = 0.0
    for v in values:
        total += v
    return total


def _fixed_point(kk: np.ndarray) -> np.ndarray:
    """normalize_coeffs_8bpc: each tap to int(+-0.5 + tap * 2^22)."""
    scaled = kk * float(1 << PRECISION_BITS)
    return np.where(kk < 0, scaled - 0.5, scaled + 0.5).astype(np.int64)


def _pass_8bpc(img: np.ndarray, first, kk, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis` (0 rows, 1 columns) of (H, W, C)."""
    taps = _fixed_point(kk)
    n_in = img.shape[axis]
    idx = np.minimum(first[:, None] + np.arange(taps.shape[1]), n_in - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)  # out, ksize on axis
    shape = [1] * src.ndim
    shape[axis], shape[axis + 1] = taps.shape
    ss = (src * taps.reshape(shape)).sum(axis=axis + 1)
    ss += 1 << (PRECISION_BITS - 1)
    return np.clip(ss >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass_16bpc(img: np.ndarray, first, kk, axis: int) -> np.ndarray:
    """One pass on 16-bit gray (H, W): double taps summed in order,
    rounded half up to an integer."""
    n_in = img.shape[axis]
    ss = None
    for k in range(kk.shape[1]):
        idx = np.minimum(first + k, n_in - 1)
        term = np.take(img, idx, axis=axis).astype(np.float64) * (
            kk[:, k] if axis == 1 else kk[:, k][:, None])
        ss = term if ss is None else ss + term
    return np.floor(ss + 0.5).astype(np.uint16)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tmp = a.astype(np.int64) * b + 128
    return ((tmp >> 8) + tmp) >> 8


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa / LA -> La (Pillow's rgbA2rgba / la2lA)."""
    out = img.astype(np.int64)
    alpha = out[..., -1:]
    out[..., :-1] = _muldiv255(out[..., :-1], alpha)
    return out.astype(np.uint8)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA / La -> LA (Pillow's rgba2rgbA / lA2la): 255 c / a,
    truncated and clipped, where 0 < a < 255."""
    out = img.astype(np.int64)
    alpha = out[..., -1:]
    div = np.minimum((255 * out[..., :-1]) // np.maximum(alpha, 1), 255)
    keep = (alpha == 0) | (alpha == 255)
    out[..., :-1] = np.where(keep, out[..., :-1], div)
    return out.astype(np.uint8)


def _nearest(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's ImagingScaleAffine: the input index of output i is the
    truncated (i + 1/2) scale, accumulated in double as Pillow
    accumulates it."""
    def index(n_in: int, n_out: int) -> np.ndarray:
        step = n_in / n_out
        pos = step * 0.5
        out = np.zeros(n_out, np.int64)
        for i in range(n_out):
            out[i] = int(pos)
            pos += step
        return out

    w, h = size
    return arr[index(arr.shape[0], h)][:, index(arr.shape[1], w)]


def resize_bilinear(mode: str, arr: np.ndarray, size: Tuple[int, int]
                    ) -> np.ndarray:
    """`Image.resize(size, Image.BILINEAR)` of an image of PIL mode
    `mode` held as np.asarray's array -> the resized array (same mode).
    size is (width, height), as PIL's."""
    w, h = size
    if w <= 0 or h <= 0:
        raise ValueError("height and width must be > 0")
    if mode in ("1", "P"):
        return _nearest(arr, size)
    if mode == "I;16":
        fx, kx = _coeffs(arr.shape[1], w)
        fy, ky = _coeffs(arr.shape[0], h)
        return _pass_16bpc(_pass_16bpc(arr, fx, kx, 1), fy, ky, 0)
    if mode not in ("L", "RGB", "LA", "RGBA"):
        raise ValueError(f"resize of PIL mode {mode!r} is not ported")
    img = arr[..., None] if arr.ndim == 2 else arr
    if mode in ("LA", "RGBA"):
        img = _premultiply(img)
    fx, kx = _coeffs(img.shape[1], w)
    fy, ky = _coeffs(img.shape[0], h)
    img = _pass_8bpc(img, fx, kx, 1)
    img = _pass_8bpc(img, fy, ky, 0)
    if mode in ("LA", "RGBA"):
        img = _unpremultiply(img)
    return img[..., 0] if arr.ndim == 2 else img
