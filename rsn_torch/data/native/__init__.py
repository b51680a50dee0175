"""ctypes bindings of the native image decoders.

- loader.cpp (rsn's rsn/data/native/loader.cpp unchanged): `probe_png`
  and `decode_png_batch`, a pthread pool that decodes 8-bit
  non-interlaced gray / RGB / gray + alpha / RGBA PNGs and blends alpha
  to white in C.  A file it cannot decode (palette, 16-bit, interlaced,
  another size) is not an error here: probe_png and decode_png_batch
  return None, and the loaders read it with rsn_torch.data.png, as rsn
  reads it with PIL.
- jpeg.cpp: `probe_jpeg` and `decode_jpeg`, the JPEG decoder that gives
  PIL's pixels (libjpeg-turbo's integer IDCT, block smoothing, fancy
  upsampling and colour tables; sequential, progressive and lossless
  frames, Huffman or arithmetic coded, gray, three components or CMYK /
  YCCK).  A JPEG PIL or libjpeg refuses (a precision other than 8,
  hierarchical frames, fractional sampling, ...) raises ValueError saying
  so, as rsn raises on it; a corrupt or truncated file raises ValueError.
  `decode_tiff_jpeg` decodes one JPEG strip or tile of a TIFF as
  libtiff's JPEG codec does (the JPEGTables tag's tables first, YCbCr
  converted to RGB or no colour conversion at all).
- tiff.cpp: `decode_tiff_chunk`, the codecs of a TIFF strip or tile as
  libtiff decodes them (PackBits, LZW, Deflate, FillOrder 2, predictors
  2 and 3, samples swapped to the host's byte order) for
  rsn_torch.data.tiff; a strip it cannot decode raises ValueError.
- webp.cpp: `decode_webp_vp8l` and `decode_webp_vp8`, a WebP frame's
  bitstream as libwebp decodes it for PIL (VP8L; VP8 key frames with their
  ALPH chunk, fancy upsampling and libwebp's YUV to RGB) for
  rsn_torch.data.webp; a stream libwebp refuses raises ValueError.
- raster.cpp: `decode_bmp_rle`, `decode_tga_rle`, `decode_gif_lzw` and
  `decode_ppm_plain`, the host loops of rsn_torch.data's BMP, TGA, GIF
  and PPM readers as PIL runs them (its Python BMP RLE and plain PPM
  decoders, libImaging's TGA RLE and GIF LZW decoders); a stream PIL
  refuses raises ValueError.
- jpeg2000.cpp: `decode_jpeg2000`, a JPEG 2000 codestream tile by tile
  as OpenJPEG 2.5.4 decodes it for PIL (T2, EBCOT, both wavelets, RCT /
  ICT, the level shift), for rsn_torch.data.jpeg2000; a stream OpenJPEG
  refuses raises ValueError, a kind not ported NotImplementedError.  It
  is built with JPEG2000_FLAGS: FLAGS with floating-point contraction
  off, as OpenJPEG's float code runs for PIL without FMAs.
- av1.cpp (with its tables, av1_tables.h): `probe_av1` and `decode_av1`,
  an AV1 key frame as dav1d 1.5.1 decodes it for PIL's AVIF plugin (the
  planes as uint8, a count of each coding tool the frame used), and
  `avif_to_rgb`, libavif 1.3.0's YUV to RGB / RGBA for PIL (libyuv's
  upsampling and fixed point, libavif's own limited-range and identity
  paths, the un-premultiply), for rsn_torch.data.avif; a stream dav1d
  refuses raises ValueError, a coding tool not ported NotImplementedError.

g++ builds each library at first use into rsn_torch/_build/
(git-ignored).  Its name carries a hash of its source (and the headers it
includes), the flags and the host's CPU (the flags hold -march=native),
so an edited source is rebuilt and a library built for another CPU is
never loaded.  A failed build
raises with the compiler's output: the port has no PIL to fall back to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "loader.cpp")
JPEG_SOURCE = os.path.join(_DIR, "jpeg.cpp")
TIFF_SOURCE = os.path.join(_DIR, "tiff.cpp")
WEBP_SOURCE = os.path.join(_DIR, "webp.cpp")
RASTER_SOURCE = os.path.join(_DIR, "raster.cpp")
JPEG2000_SOURCE = os.path.join(_DIR, "jpeg2000.cpp")
AV1_SOURCE = os.path.join(_DIR, "av1.cpp")
AV1_HEADERS = (os.path.join(_DIR, "av1_tables.h"),)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
# rsn/data/native/__init__.py's flags: with -march=native g++ contracts
# the alpha blend into FMAs, and the port's images equal rsn's bit for bit
# only from the same code
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")
JPEG2000_FLAGS = FLAGS + ("-ffp-contract=off",)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_jpeg_lib: Optional[ctypes.CDLL] = None
_tiff_lib: Optional[ctypes.CDLL] = None
_webp_lib: Optional[ctypes.CDLL] = None
_raster_lib: Optional[ctypes.CDLL] = None
_jpeg2000_lib: Optional[ctypes.CDLL] = None
_av1_lib: Optional[ctypes.CDLL] = None


def _cpu_identity() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = (b"model name", b"flags")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


def library_path(source: Optional[str] = None, libs=LIBS,
                 flags=FLAGS, headers=()) -> str:
    source = source or SOURCE
    h = hashlib.sha256(" ".join(tuple(flags) + tuple(libs)).encode())
    for name in (source,) + tuple(headers):
        with open(name, "rb") as f:
            h.update(f.read())
    h.update(_cpu_identity())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _build(path: str, source: Optional[str] = None, libs=LIBS,
           flags=FLAGS) -> None:
    source = source or SOURCE
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native decoder "
                           f"({source}) is built from source at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *flags, source, "-o", tmp, *libs]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: no half-written library


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.isfile(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.rsn_decode_png_batch.restype = ctypes.c_int
            lib.rsn_decode_png_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            lib.rsn_probe_png.restype = ctypes.c_int
            lib.rsn_probe_png.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        return _lib


def probe_png(path: str) -> Optional[Tuple[int, int]]:
    """-> (height, width), or None when the library cannot decode the
    file."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if get_lib().rsn_probe_png(path.encode(), ctypes.byref(h),
                               ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_png_batch(paths: List[str], height: int, width: int,
                     blend_white: bool = True,
                     num_threads: int = 0) -> Optional[np.ndarray]:
    """Decode PNGs in parallel -> (N, H, W, 3) float32 in [0, 1]; None
    when an image fails (another format or size)."""
    if not paths:
        return None
    lib = get_lib()
    out = np.empty((len(paths), height, width, 3), np.float32)
    names = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.rsn_decode_png_batch(
        names, len(paths), height, width, int(blend_white),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    return out if rc == 0 else None


# ---- JPEG (jpeg.cpp) -------------------------------------------------------

# rsn_probe_jpeg / rsn_decode_jpeg return codes
JPEG_REFUSED, JPEG_CORRUPT = 1, 2
_JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}
_u8p = ctypes.POINTER(ctypes.c_uint8)


def get_jpeg_lib() -> ctypes.CDLL:
    """The loaded JPEG library, built first if it is missing."""
    global _jpeg_lib
    with _lock:
        if _jpeg_lib is None:
            path = library_path(JPEG_SOURCE, ())
            if not os.path.isfile(path):
                _build(path, JPEG_SOURCE, ())
            lib = ctypes.CDLL(path)
            cint = ctypes.POINTER(ctypes.c_int)
            lib.rsn_probe_jpeg.restype = ctypes.c_int
            lib.rsn_probe_jpeg.argtypes = [_u8p, ctypes.c_int64, cint, cint,
                                           cint, ctypes.c_char_p,
                                           ctypes.c_int]
            lib.rsn_decode_jpeg.restype = ctypes.c_int
            lib.rsn_decode_jpeg.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                            ctypes.c_int64, ctypes.c_char_p,
                                            ctypes.c_int]
            lib.rsn_decode_tiff_jpeg.restype = ctypes.c_int
            lib.rsn_decode_tiff_jpeg.argtypes = [
                _u8p, ctypes.c_int64, _u8p, ctypes.c_int64, _u8p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int]
            _jpeg_lib = lib
        return _jpeg_lib


def _jpeg_error(path: str, rc: int, msg: bytes) -> Exception:
    what = msg.decode(errors="replace")
    if rc == JPEG_REFUSED:
        return ValueError(
            f"{path}: a JPEG with {what}, which PIL refuses as well "
            "(rsn/data/blender.py raises on it too)")
    return ValueError(f"{path}: corrupt JPEG ({what})")


def _probe(lib, path: str, data: np.ndarray) -> Tuple[str, Tuple[int, ...]]:
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(256)
    rc = lib.rsn_probe_jpeg(data.ctypes.data_as(_u8p), data.size,
                            ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(c), msg, len(msg))
    if rc != 0:
        raise _jpeg_error(path, rc, msg.value)
    shape = (h.value, w.value) + (() if c.value == 1 else (c.value,))
    return _JPEG_MODES[c.value], shape


def _file_bytes(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), np.uint8)


def probe_jpeg(path: str) -> Tuple[str, Tuple[int, ...]]:
    """-> (PIL's mode, the array's shape) from the markers up to the
    frame header: ("L", (H, W)), ("RGB", (H, W, 3)) or ("CMYK",
    (H, W, 4))."""
    return _probe(get_jpeg_lib(), path, _file_bytes(path))


def decode_jpeg(path: str) -> Tuple[str, np.ndarray]:
    """-> (PIL's mode, np.asarray(Image.open(path))): uint8 (H, W) for
    "L", (H, W, 3) for "RGB", (H, W, 4) for "CMYK" (PIL's inverted
    "CMYK;I" bytes).

    Raises ValueError for a corrupt or truncated file and for the kinds
    PIL or libjpeg refuses (a precision other than 8, hierarchical and
    lossless arithmetic frames, fractional sampling, 2 components, a
    progressive or lossless scan without its Huffman table, a lossless
    frame in YCbCr or YCCK)."""
    lib = get_jpeg_lib()
    data = _file_bytes(path)
    mode, shape = _probe(lib, path, data)
    out = np.empty(shape, np.uint8)
    msg = ctypes.create_string_buffer(256)
    rc = lib.rsn_decode_jpeg(data.ctypes.data_as(_u8p), data.size,
                             out.ctypes.data_as(_u8p), out.size, msg,
                             len(msg))
    if rc != 0:
        raise _jpeg_error(path, rc, msg.value)
    return mode, out


def decode_tiff_jpeg(data: bytes, tables: bytes, width: int, height: int,
                     comps: int, rgb: bool, path: str) -> np.ndarray:
    """One JPEG strip or tile of a TIFF as libtiff's JPEG codec decodes it
    for PIL: `tables` (the JPEGTables tag's stream, or b"") read first,
    then the strip's stream; YCbCr to RGB when rgb (PIL sets
    JPEGCOLORMODE_RGB), else the components as they are (libtiff's
    JCS_UNKNOWN); a stream taller than `height` cut to it (the last
    strip) -> (height, width * comps) uint8 rows."""
    lib = get_jpeg_lib()
    src = np.frombuffer(data, np.uint8)
    tab = np.frombuffer(tables, np.uint8)
    out = np.empty((height, width * comps), np.uint8)
    msg = ctypes.create_string_buffer(256)
    rc = lib.rsn_decode_tiff_jpeg(
        tab.ctypes.data_as(_u8p), tab.size, src.ctypes.data_as(_u8p),
        src.size, out.ctypes.data_as(_u8p), width, height, comps, int(rgb),
        msg, len(msg))
    if rc != 0:
        raise ValueError(f"{path}: a JPEG strip or tile libtiff cannot "
                         f"decode ({msg.value.decode(errors='replace')}); "
                         "PIL raises on it too")
    return out


# ---- TIFF codecs (tiff.cpp) ---------------------------------------------------

def get_tiff_lib() -> ctypes.CDLL:
    """The loaded TIFF codec library, built first if it is missing."""
    global _tiff_lib
    with _lock:
        if _tiff_lib is None:
            path = library_path(TIFF_SOURCE, ("-lz",))
            if not os.path.isfile(path):
                _build(path, TIFF_SOURCE, ("-lz",))
            lib = ctypes.CDLL(path)
            lib.rsn_tiff_decode.restype = ctypes.c_int
            lib.rsn_tiff_decode.argtypes = [
                _u8p, ctypes.c_int64, ctypes.c_int, _u8p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            _tiff_lib = lib
        return _tiff_lib


def decode_tiff_chunk(data: bytes, codec: int, size: int, predictor: int,
                      row_bytes: int, bps: int, stride: int,
                      big_endian: bool, reverse: bool,
                      path: str) -> np.ndarray:
    """One compressed TIFF strip or tile -> its `size` bytes as libtiff
    gives them: codec 1 PackBits, 2 LZW, 3 Deflate; FillOrder 2's
    bits reversed first (reverse), predictor 2 or 3 undone per row of
    `row_bytes`, 16 / 32-bit samples in the host's byte order."""
    lib = get_tiff_lib()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    msg = ctypes.create_string_buffer(256)
    swab = big_endian != (sys.byteorder == "big")
    rc = lib.rsn_tiff_decode(
        src.ctypes.data_as(_u8p), src.size, codec, out.ctypes.data_as(_u8p),
        size, predictor, row_bytes, bps, stride, int(swab), int(reverse),
        msg, len(msg))
    if rc != 0:
        raise ValueError(f"{path}: a TIFF strip or tile libtiff cannot "
                         f"decode ({msg.value.decode(errors='replace')}); "
                         "PIL raises on it too")
    return out


# ---- WebP codecs (webp.cpp) ------------------------------------------------------

def get_webp_lib() -> ctypes.CDLL:
    """The loaded WebP codec library, built first if it is missing."""
    global _webp_lib
    with _lock:
        if _webp_lib is None:
            path = library_path(WEBP_SOURCE, ())
            if not os.path.isfile(path):
                _build(path, WEBP_SOURCE, ())
            lib = ctypes.CDLL(path)
            lib.rsn_webp_vp8l.restype = ctypes.c_int
            lib.rsn_webp_vp8l.argtypes = [
                _u8p, ctypes.c_int64, _u8p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.rsn_webp_vp8.restype = ctypes.c_int
            lib.rsn_webp_vp8.argtypes = [
                _u8p, ctypes.c_int64, _u8p, ctypes.c_int64, _u8p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_int]
            _webp_lib = lib
        return _webp_lib


def _webp_error(path: str, msg: bytes) -> ValueError:
    return ValueError(f"{path}: a WebP frame libwebp cannot decode "
                      f"({msg.decode(errors='replace')}); PIL raises on it "
                      "too")


def _rgba_view(out: np.ndarray):
    if (out.ndim != 3 or out.shape[2] != 4 or out.dtype != np.uint8
            or out.strides[1:] != (4, 1)):
        raise ValueError("out must be (height, width, 4) uint8 rows")
    return out.ctypes.data_as(_u8p), out.strides[0], out.shape[1], out.shape[0]


def decode_webp_vp8l(stream: bytes, out: np.ndarray, path: str) -> None:
    """A VP8L chunk's payload -> `out`, an (H, W, 4) uint8 view (rows may be
    a wider canvas's) of the frame's size, as RGBA."""
    src = np.frombuffer(stream, np.uint8)
    ptr, stride, w, h = _rgba_view(out)
    msg = ctypes.create_string_buffer(256)
    if get_webp_lib().rsn_webp_vp8l(src.ctypes.data_as(_u8p), src.size, ptr,
                                    stride, w, h, msg, len(msg)) != 0:
        raise _webp_error(path, msg.value)


def decode_webp_vp8(stream: bytes, alpha: Optional[bytes], out: np.ndarray,
                    path: str) -> None:
    """A VP8 key frame (its chunk's payload to the padded chunk's end) and
    its ALPH chunk's payload (None: opaque) -> `out` as RGBA."""
    src = np.frombuffer(stream, np.uint8)
    a = np.frombuffer(alpha if alpha is not None else b"", np.uint8)
    ptr, stride, w, h = _rgba_view(out)
    msg = ctypes.create_string_buffer(256)
    if get_webp_lib().rsn_webp_vp8(
            src.ctypes.data_as(_u8p), src.size, a.ctypes.data_as(_u8p),
            a.size if alpha is not None else -1, ptr, stride, w, h, msg,
            len(msg)) != 0:
        raise _webp_error(path, msg.value)


# ---- BMP / TGA / GIF / PPM loops (raster.cpp) -----------------------------------

_RASTER_ERRORS = {1: "image file is truncated", 2: "broken data stream",
                  3: "buffer overrun", 4: "codec configuration error"}
_i64p = ctypes.POINTER(ctypes.c_int64)


def get_raster_lib() -> ctypes.CDLL:
    """The loaded raster library, built first if it is missing."""
    global _raster_lib
    with _lock:
        if _raster_lib is None:
            path = library_path(RASTER_SOURCE, ())
            if not os.path.isfile(path):
                _build(path, RASTER_SOURCE, ())
            lib = ctypes.CDLL(path)
            i64, cint = ctypes.c_int64, ctypes.c_int
            lib.rsn_bmp_rle.restype = cint
            lib.rsn_bmp_rle.argtypes = [_u8p, i64, i64, cint, cint, cint, _u8p,
                                        _i64p, ctypes.c_char_p, cint]
            lib.rsn_tga_rle.restype = cint
            lib.rsn_tga_rle.argtypes = [_u8p, i64, i64, cint, i64, cint, _u8p]
            lib.rsn_gif_lzw.restype = cint
            lib.rsn_gif_lzw.argtypes = [_u8p, i64, i64, cint, cint, _u8p, i64,
                                        cint, cint, cint, cint]
            lib.rsn_ppm_plain.restype = cint
            lib.rsn_ppm_plain.argtypes = [_u8p, i64, i64, cint, i64, cint, i64,
                                          _u8p, _i64p, ctypes.c_char_p, cint]
            _raster_lib = lib
        return _raster_lib


def _source(data: bytes, offset: int) -> np.ndarray:
    if offset < 0:
        raise ValueError(f"offset {offset} before the data")
    return np.frombuffer(data, np.uint8)


def _raster_error(path: str, rc: int, what: str) -> ValueError:
    return ValueError(f"{path}: {what} PIL cannot decode "
                      f"({_RASTER_ERRORS.get(rc, rc)}); PIL raises on it too")


def decode_bmp_rle(data: bytes, offset: int, width: int, height: int,
                   rle4: bool, path: str) -> Tuple[np.ndarray, int]:
    """BmpRleDecoder from `offset` -> (the first width * height pixel bytes
    in file order, the length PIL's buffer reached)."""
    src = _source(data, offset)
    if width <= 0 or height <= 0:
        raise ValueError("width and height must be > 0")
    out = np.empty(width * height, np.uint8)
    length = ctypes.c_int64()
    msg = ctypes.create_string_buffer(256)
    if get_raster_lib().rsn_bmp_rle(
            src.ctypes.data_as(_u8p), src.size, offset, width, height,
            int(rle4), out.ctypes.data_as(_u8p), ctypes.byref(length), msg,
            len(msg)) != 0:
        raise ValueError(f"{path}: a BMP RLE stream PIL cannot decode "
                         f"({msg.value.decode(errors='replace')}); PIL "
                         "raises on it too")
    return out, length.value


def decode_tga_rle(data: bytes, offset: int, depth: int, row_bytes: int,
                   rows: int, path: str) -> np.ndarray:
    """TgaRleDecode.c from `offset`, `depth` bytes a pixel -> (rows,
    row_bytes) uint8 in decode order."""
    src = _source(data, offset)
    if row_bytes <= 0 or rows <= 0 or not 0 <= depth <= 4:
        raise ValueError("row_bytes and rows must be > 0, depth 0 to 4")
    out = np.zeros((rows, row_bytes), np.uint8)
    rc = get_raster_lib().rsn_tga_rle(src.ctypes.data_as(_u8p), src.size,
                                      offset, depth, row_bytes, rows,
                                      out.ctypes.data_as(_u8p))
    if rc != 0:
        raise _raster_error(path, rc, "a TGA RLE stream")
    return out


def decode_gif_lzw(data: bytes, offset: int, bits: int, interlace: bool,
                   image: np.ndarray, box: Tuple[int, int, int, int],
                   path: str) -> None:
    """GifDecode.c from `offset` (the frame's sub-blocks) into the box
    (x0, y0, x1, y1) of `image`, an (H, W) uint8 C-contiguous array."""
    src = _source(data, offset)
    x0, y0, x1, y1 = box
    if (image.ndim != 2 or image.dtype != np.uint8
            or not image.flags.c_contiguous or not image.flags.writeable):
        raise ValueError("image must be a writeable C-contiguous (H, W) "
                         "uint8 array")
    if not (0 <= x0 < x1 <= image.shape[1] and 0 <= y0 < y1 <= image.shape[0]):
        raise ValueError(f"box {box} outside the image {image.shape}")
    rc = get_raster_lib().rsn_gif_lzw(
        src.ctypes.data_as(_u8p), src.size, offset, bits, int(interlace),
        image.ctypes.data_as(_u8p), image.strides[0], x0, y0, x1 - x0,
        y1 - y0)
    if rc != 0:
        raise _raster_error(path, rc, "a GIF frame")


def decode_ppm_plain(data: bytes, offset: int, bitonal: bool, maxval: int,
                     out_i32: bool, total: int, path: str) -> np.ndarray:
    """PpmPlainDecoder from `offset` -> the bytes it makes (fewer than
    `total` when the tokens end first): P1's 0xff / 0 bytes, or the
    samples rescaled to 255 (uint8) or 65535 (little-endian int32)."""
    src = _source(data, offset)
    if total < 0 or (out_i32 and total % 4):
        raise ValueError(f"total {total} is not a whole number of samples")
    if not bitonal and maxval <= 0:
        raise ValueError("maxval must be > 0")
    out = np.zeros(total, np.uint8)
    produced = ctypes.c_int64()
    msg = ctypes.create_string_buffer(256)
    if get_raster_lib().rsn_ppm_plain(
            src.ctypes.data_as(_u8p), src.size, offset, int(bitonal), maxval,
            int(out_i32), total, out.ctypes.data_as(_u8p),
            ctypes.byref(produced), msg, len(msg)) != 0:
        raise ValueError(f"{path}: {msg.value.decode(errors='replace')} "
                         "(PIL raises on it too)")
    return out[:produced.value]


# ---- JPEG 2000 codestreams (jpeg2000.cpp) ------------------------------------

J2K_UNPORTED = 2  # rsn_j2k_decode's code for a kind not ported
_i32p = ctypes.POINTER(ctypes.c_int32)


def get_jpeg2000_lib() -> ctypes.CDLL:
    """The loaded JPEG 2000 library, built first if it is missing."""
    global _jpeg2000_lib
    with _lock:
        if _jpeg2000_lib is None:
            path = library_path(JPEG2000_SOURCE, (), JPEG2000_FLAGS)
            if not os.path.isfile(path):
                _build(path, JPEG2000_SOURCE, (), JPEG2000_FLAGS)
            lib = ctypes.CDLL(path)
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            lib.rsn_j2k_decode.restype = ctypes.c_int
            lib.rsn_j2k_decode.argtypes = [
                _u8p, i64, _i32p, i64, _i32p, _i32p, i32, _i32p,
                ctypes.c_char_p, ctypes.c_int]
            _jpeg2000_lib = lib
        return _jpeg2000_lib


def decode_jpeg2000(data: bytes, offset: int, out: np.ndarray,
                    dims: np.ndarray, order: np.ndarray,
                    path: str) -> int:
    """The codestream at data[offset:] (to the file's end, as OpenJPEG
    reads it) -> each tile's components as int32 samples in `out` (tile
    after tile in index order, each tile-component given its full size),
    their decoded (width, height) in `dims` (tiles, components, 2), the
    tiles in the order OpenJPEG decodes them in `order`; returns how many
    were decoded.

    Raises ValueError for a stream OpenJPEG refuses, NotImplementedError
    for a kind the port does not decode."""
    src = _source(data, offset)
    if offset > src.size:
        raise ValueError(f"offset {offset} past the data")
    for name, a, nd in (("out", out, 1), ("dims", dims, 3),
                        ("order", order, 1)):
        if (a.dtype != np.int32 or a.ndim != nd or not a.flags.c_contiguous
                or not a.flags.writeable):
            raise ValueError(f"{name} must be a writeable C-contiguous "
                             f"{nd}-D int32 array")
    if dims.shape[0] != order.size or dims.shape[2] != 2:
        raise ValueError(f"dims {dims.shape} must be (tiles, components, 2)"
                         f" for {order.size} tiles")
    decoded = ctypes.c_int32()
    msg = ctypes.create_string_buffer(256)
    rc = get_jpeg2000_lib().rsn_j2k_decode(
        src[offset:].ctypes.data_as(_u8p), src.size - offset,
        out.ctypes.data_as(_i32p), out.size, dims.ctypes.data_as(_i32p),
        order.ctypes.data_as(_i32p), order.size, ctypes.byref(decoded), msg,
        len(msg))
    what = msg.value.decode(errors="replace")
    if rc == J2K_UNPORTED:
        raise NotImplementedError(
            f"{path}: {what}; ROADMAP Queue 1: the port does not decode "
            "this kind of JPEG 2000 yet, rsn/data/blender.py reads it with "
            "PIL")
    if rc != 0:
        raise ValueError(f"{path}: a JPEG 2000 codestream OpenJPEG cannot "
                         f"decode ({what}); PIL raises on it too")
    return decoded.value


# ---- AV1 frames and libavif's colour conversion (av1.cpp) ------------------

# rsn_av1_* / rsn_avif_to_rgb codes; AV1_SHAPE: planes not the frame's
AV1_INVALID, AV1_UNPORTED, AV1_SHAPE = 1, 2, 3
PROBE_FIELDS = ("width", "height", "subsampling_x", "subsampling_y", "mono",
                "bit_depth", "color_primaries", "transfer", "matrix",
                "full_range")
LAYOUTS = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "4:0:0": 3}


def get_av1_lib() -> ctypes.CDLL:
    """The loaded AV1 library, built first if it is missing."""
    global _av1_lib
    with _lock:
        if _av1_lib is None:
            path = library_path(AV1_SOURCE, (), FLAGS, AV1_HEADERS)
            if not os.path.isfile(path):
                _build(path, AV1_SOURCE, ())
            lib = ctypes.CDLL(path)
            i64, cint, u64p = ctypes.c_int64, ctypes.c_int, ctypes.POINTER(
                ctypes.c_uint64)
            lib.rsn_av1_count_names.restype = ctypes.c_char_p
            lib.rsn_av1_count_names.argtypes = []
            lib.rsn_av1_count_len.restype = cint
            lib.rsn_av1_count_len.argtypes = []
            lib.rsn_av1_probe.restype = cint
            lib.rsn_av1_probe.argtypes = [_u8p, ctypes.c_size_t,
                                          ctypes.POINTER(cint),
                                          ctypes.c_char_p, cint]
            lib.rsn_av1_decode.restype = cint
            lib.rsn_av1_decode.argtypes = [
                _u8p, ctypes.c_size_t, ctypes.POINTER(cint),
                ctypes.POINTER(_u8p), ctypes.POINTER(i64),
                ctypes.POINTER(cint), cint, u64p, ctypes.c_char_p, cint]
            lib.rsn_avif_to_rgb.restype = cint
            lib.rsn_avif_to_rgb.argtypes = [_u8p, i64, _u8p, i64, _u8p, i64,
                                            _u8p, i64, cint, cint, cint, cint,
                                            cint, cint, _u8p, i64, cint]
            _av1_lib = lib
        return _av1_lib


def av1_count_names() -> Tuple[str, ...]:
    """The names of the tool counts decode_av1 fills, in order."""
    names = get_av1_lib().rsn_av1_count_names().decode()
    return tuple(n for n in names.split(",") if n)


def _av1_error(path: str, rc: int, msg: bytes) -> Exception:
    what = msg.decode(errors="replace")
    if rc == AV1_UNPORTED:
        return NotImplementedError(
            f"{path}: an AV1 frame with {what}; ROADMAP Queue 1: the port "
            "does not decode this AVIF kind yet, rsn/data/blender.py reads "
            "it with PIL")
    return ValueError(f"{path}: an AV1 frame dav1d cannot decode ({what}); "
                      "PIL raises on it too")


def probe_av1(obus: bytes, path: str) -> dict:
    """An AV1 item's OBUs -> its sequence and frame headers'
    PROBE_FIELDS."""
    src = np.frombuffer(obus, np.uint8)
    info = (ctypes.c_int * len(PROBE_FIELDS))()
    msg = ctypes.create_string_buffer(256)
    rc = get_av1_lib().rsn_av1_probe(src.ctypes.data_as(_u8p), src.size,
                                     info, msg, len(msg))
    if rc != 0:
        raise _av1_error(path, rc, msg.value)
    return dict(zip(PROBE_FIELDS, info))


def _plane(name: str, a: np.ndarray, shape: Optional[Tuple[int, int]],
           writeable: bool) -> None:
    if (a.dtype != np.uint8 or a.ndim != 2 or a.strides[1] != 1
            or (writeable and not a.flags.writeable)):
        raise ValueError(f"{name} must be a{' writeable' if writeable else ''}"
                         " 2-D uint8 array with contiguous rows")
    if shape is not None and a.shape != shape:
        raise ValueError(f"{name} is {a.shape}, not {shape}")


def decode_av1(obus: bytes, planes: List[np.ndarray], counts: np.ndarray,
               path: str) -> dict:
    """Decode an AV1 item's key frame into `planes` (Y, or Y, U, V: uint8,
    sized as probe_av1 says: chroma ((h + sy) >> sy, (w + sx) >> sx)),
    adding each tool's uses to `counts` (uint64, av1_count_names' order).
    -> the probe's fields, from the headers the decode itself read.

    Raises ValueError for a stream dav1d refuses or planes of another
    count or shape than the frame's (checked in C before any write),
    NotImplementedError for a tool the port does not decode."""
    lib = get_av1_lib()
    if (counts.dtype != np.uint64 or counts.ndim != 1
            or counts.size != lib.rsn_av1_count_len()
            or not counts.flags.c_contiguous or not counts.flags.writeable):
        raise ValueError("counts must be a writeable C-contiguous uint64 "
                         f"array of {lib.rsn_av1_count_len()} counts")
    if len(planes) not in (1, 3):
        raise ValueError(f"1 or 3 planes expected, {len(planes)} given")
    for i, a in enumerate(planes):
        _plane(f"plane {i}", a, None, True)
    n = len(planes)
    ptrs = (_u8p * n)(*(a.ctypes.data_as(_u8p) for a in planes))
    strides = (ctypes.c_int64 * n)(*(a.strides[0] for a in planes))
    dims = (ctypes.c_int * (2 * n))(*(d for a in planes for d in a.shape))
    info = (ctypes.c_int * len(PROBE_FIELDS))()
    msg = ctypes.create_string_buffer(256)
    rc = lib.rsn_av1_decode(
        np.frombuffer(obus, np.uint8).ctypes.data_as(_u8p), len(obus), info,
        ptrs, strides, dims, n,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), msg,
        len(msg))
    if rc == AV1_SHAPE:
        raise ValueError(msg.value.decode())
    if rc != 0:
        raise _av1_error(path, rc, msg.value)
    return dict(zip(PROBE_FIELDS, info))


def avif_to_rgb(planes: List[np.ndarray], alpha: Optional[np.ndarray],
                layout: str, matrix: int, full_range: bool,
                premultiplied: bool, out: np.ndarray, path: str) -> None:
    """libavif's 8-bit YUV (`planes`: Y, or Y, U, V of `layout`) to RGB or,
    with `alpha` (H, W), RGBA into `out` (H, W, 3 or 4) uint8.

    Raises ValueError for a matrix libavif refuses, NotImplementedError
    for one it converts with code the port does not follow."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not one of {tuple(LAYOUTS)}")
    h, w = planes[0].shape[:2]
    channels = 3 if alpha is None else 4
    if (out.dtype != np.uint8 or out.shape != (h, w, channels)
            or out.strides[1:] != (channels, 1) or not out.flags.writeable):
        raise ValueError(f"out must be a writeable ({h}, {w}, {channels}) "
                         "uint8 array with contiguous rows")
    n = 1 if layout == "4:0:0" else 3
    if len(planes) != n:
        raise ValueError(f"{n} planes expected for {layout}")
    sx, sy = {"4:4:4": (0, 0), "4:2:2": (1, 0), "4:2:0": (1, 1),
              "4:0:0": (1, 1)}[layout]
    for i, a in enumerate(planes):
        shape = (h, w) if i == 0 else ((h + sy) >> sy, (w + sx) >> sx)
        _plane(f"plane {i}", a, shape, False)
    if alpha is not None:
        _plane("alpha", alpha, (h, w), False)
    y = planes[0]
    u, v = (planes[1], planes[2]) if n == 3 else (y, y)
    a = y if alpha is None else alpha
    rc = get_av1_lib().rsn_avif_to_rgb(
        y.ctypes.data_as(_u8p), y.strides[0], u.ctypes.data_as(_u8p),
        u.strides[0], v.ctypes.data_as(_u8p), v.strides[0],
        a.ctypes.data_as(_u8p), a.strides[0], w, h, LAYOUTS[layout], matrix,
        int(full_range), int(premultiplied), out.ctypes.data_as(_u8p),
        out.strides[0], channels)
    if rc == AV1_INVALID:
        raise ValueError(
            f"{path}: an AVIF image of matrix coefficients {matrix} "
            f"({layout}), which libavif cannot convert to RGB; PIL raises on "
            "it too")
    if rc != 0:
        raise NotImplementedError(
            f"{path}: an AVIF image of matrix coefficients {matrix} "
            f"({layout}, {'full' if full_range else 'limited'} range), which "
            "libavif converts with code the port does not follow yet; ROADMAP "
            "Queue 1: rsn/data/blender.py reads it with PIL")
