"""WebP frames as PIL 12.1.0 reads them with libwebp 1.6.0 (the port of
the `Image.open` calls in rsn/data/blender.py for WebP).

`read_webp(path)` gives what `np.asarray(Image.open(path))` gives: PIL's
mode and the same array.  PIL opens every WebP, still or animated,
through libwebp's WebPAnimDecoder and loads frame 0; this module follows
the three steps of that path:

- the mode, as PIL's _webp.c sniffs it with WebPGetFeatures over the
  whole file: "RGB" when that succeeds without alpha, else "RGBA".  Alpha
  there is the VP8X chunk's alpha flag, overridden by a VP8L header's
  alpha bit, and set by an ALPH chunk before the image (`_features`);
- the container, as WebPDemux reads it (`_demux`): the RIFF header (its
  size must not pass the file's end; bytes past it are ignored), the
  chunks with their odd-size pad bytes, the VP8X flags and canvas, a
  still image's ALPH (dropped when the alpha flag is off) and VP8 / VP8L
  chunks, the ANIM and ANMF chunks of an animation, every frame checked
  against the canvas, ICCP / EXIF / XMP and unknown chunks skipped;
- frame 0 decoded at its offset on a zeroed canvas, as WebPAnimDecoder
  decodes a key frame (the ANIM background colour is not painted), by
  rsn_torch/data/native/webp.cpp: VP8L, or VP8 with its ALPH.

EXIF orientation is not applied: PIL does not apply it to a WebP either.
A file PIL refuses (truncated, a bad RIFF size, a frame larger than its
canvas, a corrupt bitstream, ...) raises ValueError naming the file.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from rsn_torch.data import native
from rsn_torch.data.imagefile import refused

# WebPImagePlugin._accept: RIFF, WEBP and one of these first chunks
FIRST_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")
ALPHA_FLAG, ANIMATION_FLAG, XMP_FLAG, EXIF_FLAG, ICCP_FLAG = (
    0x10, 0x02, 0x04, 0x08, 0x20)
_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | XMP_FLAG | EXIF_FLAG | ICCP_FLAG
_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
_VP8X_SIZE, _ANIM_SIZE, _ANMF_SIZE = 10, 6, 16


def is_webp(head: bytes) -> bool:
    """WebPImagePlugin._accept on a file's first 16 bytes."""
    return (head.startswith(b"RIFF") and head[8:12] == b"WEBP"
            and head[12:16] in FIRST_CHUNKS)


def _le24(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16


# ---- the bitstreams' headers (VP8GetInfo, VP8LGetInfo) ---------------------------

def _vp8_info(data: bytes, chunk_size: int) -> Optional[Tuple[int, int]]:
    """(width, height) of a VP8 key frame's first 10 bytes, or None where
    VP8GetInfo fails."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        return None
    bits = data[0] | data[1] << 8 | data[2] << 16
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if (bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
            or bits >> 5 >= chunk_size or w == 0 or h == 0):
        return None
    return w, h


def _vp8l_info(data: bytes) -> Optional[Tuple[int, int, int]]:
    """(width, height, alpha bit) of a VP8L stream's 5-byte header, or None
    where VP8LGetInfo fails."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5 != 0:
        return None
    bits = int.from_bytes(data[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


# ---- the mode (WebPGetFeatures over the whole file) ---------------------------

def _features(data: bytes) -> Optional[bool]:
    """has_alpha as WebPGetFeatures gives it over the file (libwebp's
    ParseHeadersInternal with have_all_data 0), or None where it fails."""
    riff_size = struct.unpack_from("<I", data, 4)[0]
    if riff_size < 12 or riff_size > _MAX_CHUNK_PAYLOAD:
        return None
    pos, size = 12, len(data) - 12
    found_vp8x, has_alpha = False, False
    canvas = None
    alpha_seen = False

    def finish(ok: bool) -> Optional[bool]:
        # NOT_ENOUGH_DATA after a VP8X still reports the VP8X's features
        if ok or found_vp8x:
            return has_alpha or alpha_seen
        return None

    if size < 8:
        return None
    if data[pos:pos + 4] == b"VP8X":
        if struct.unpack_from("<I", data, pos + 4)[0] != _VP8X_SIZE:
            return None
        if size < 18:
            return None
        flags = struct.unpack_from("<I", data, pos + 8)[0]
        canvas = (1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15))
        if canvas[0] * canvas[1] >= _MAX_IMAGE_AREA:
            return None
        has_alpha = bool(flags & ALPHA_FLAG)
        found_vp8x = True
        pos, size = pos + 18, size - 18
        if flags & ANIMATION_FLAG:
            return has_alpha
    if size < 4:
        return finish(False)
    if found_vp8x:  # ParseOptionalChunks
        total = 4 + 8 + _VP8X_SIZE
        while True:
            if size < 8:
                return finish(False)
            chunk_size = struct.unpack_from("<I", data, pos + 4)[0]
            if chunk_size > _MAX_CHUNK_PAYLOAD:
                return None
            disk = (8 + chunk_size + 1) & ~1
            total += disk
            if total > riff_size:
                return None
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if size < disk:
                return finish(False)
            if data[pos:pos + 4] == b"ALPH":
                alpha_seen = True
            pos, size = pos + disk, size - disk
    if size < 8:  # ParseVP8Header
        return finish(False)
    tag = data[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        chunk_size = struct.unpack_from("<I", data, pos + 4)[0]
        if riff_size >= 12 and chunk_size > riff_size - 12:
            return None
        lossless = tag == b"VP8L"
        pos, size = pos + 8, size - 8
    else:
        lossless = _vp8l_info(data[pos:]) is not None
        chunk_size = size
    if chunk_size > _MAX_CHUNK_PAYLOAD:
        return None
    stream = data[pos:]
    if not lossless:
        if size < 10:
            return finish(False)
        dims = _vp8_info(stream, chunk_size)
        if dims is None:
            return None
    else:
        if size < 5:
            return finish(False)
        info = _vp8l_info(stream)
        if info is None:
            return None
        dims, has_alpha = info[:2], bool(info[2])
    if found_vp8x and tuple(dims) != canvas:
        return None
    return finish(True)


# ---- the container (WebPDemux) -----------------------------------------------------

class _Frame:
    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.alpha = None   # (chunk offset, chunk size)
        self.image = None   # (chunk offset, chunk size, fourcc)
        self.has_alpha = False
        self.frame_num = 0
        self.complete = False


class _Demux:
    """demux.c over a whole file; `refused` names what WebPDemux rejects."""

    def __init__(self, data: bytes, path: str):
        self.path = path
        if len(data) < 20:
            raise refused(path, "a truncated WebP")
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
            raise refused(path, "a WebP of a bad RIFF size")
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            raise refused(path, "a truncated WebP (the RIFF size passes "
                           "the end of the file)")
        self.buf = data[:self.riff_end]
        self.start = 12
        self.flags = 0
        self.ext = False
        self.canvas = (0, 0)
        self.frames = []
        self.num_frames = 0

    def refused(self, what: str) -> ValueError:
        return refused(self.path, what)

    def left(self) -> int:
        return self.riff_end - self.start

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.start)[0]
        self.start += 4
        return v

    def u24(self) -> int:
        v = _le24(self.buf, self.start)
        self.start += 3
        return v

    def parse(self) -> None:
        first = self.buf[12:16]
        if first == b"VP8X":
            status = self.parse_vp8x()
        else:
            status = self.parse_single()
        if status != "ok":  # incomplete data in a complete file
            raise self.refused("a truncated or malformed WebP container")
        if not (self.valid_ext() if first == b"VP8X" else self.valid_simple()):
            raise self.refused("a WebP whose frames libwebp's demuxer "
                               "rejects (no image, a frame off its canvas, "
                               "a reserved flag)")

    def store_frame(self, frame_num: int, min_size: int,
                    frame: _Frame) -> str:
        if self.left() < 8 or self.left() < min_size:
            return "more"
        alpha_chunks = image_chunks = 0
        status = "ok"
        while True:
            chunk_start = self.start
            fourcc = self.buf[self.start:self.start + 4]
            self.start += 4
            payload = self.u32()
            if payload > _MAX_CHUNK_PAYLOAD:
                return "error"
            padded = payload + (payload & 1)
            available = min(padded, self.left())
            chunk_size = 8 + available
            if padded > self.left():
                return "error"  # SizeIsInvalid: past the RIFF's end
            done = False
            if fourcc == b"VP8L" and alpha_chunks > 0:
                return "error"  # VP8L has its own alpha
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha = (chunk_start, chunk_size)
                frame.has_alpha = True
                frame.frame_num = frame_num
                self.start += available
            elif fourcc in (b"VP8 ", b"VP8L") and image_chunks == 0:
                stream = self.buf[chunk_start + 8:chunk_start + chunk_size]
                if fourcc == b"VP8 ":
                    dims, alpha = _vp8_info(stream, payload), False
                else:
                    info = _vp8l_info(stream)
                    dims, alpha = (info[:2], bool(info[2])) if info else (
                        None, False)
                if dims is None:
                    return "error"
                image_chunks = 1
                frame.image = (chunk_start, chunk_size, fourcc)
                frame.width, frame.height = dims
                frame.has_alpha |= alpha
                frame.frame_num = frame_num
                frame.complete = status == "ok"
                self.start += available
            else:  # the frame ends before this chunk
                self.start -= 8
                done = True
            if self.start == self.riff_end:
                done = True
            elif self.left() < 8:
                status = "more"
            if done or status != "ok":
                return status

    def parse_single(self) -> str:
        if self.frames:
            return "error"
        if self.left() < 8:
            return "more"
        frame = _Frame()
        status = self.store_frame(1, 0, frame)
        if status != "error":
            if not self.flags & ALPHA_FLAG and frame.alpha is not None:
                frame.alpha = None  # the alpha flag is off: no alpha
                frame.has_alpha = False
            if not self.ext and frame.width > 0 and frame.height > 0:
                self.canvas = (frame.width, frame.height)
                if frame.has_alpha:
                    self.flags |= ALPHA_FLAG
            if self.frames and not self.frames[-1].complete:
                return "error"
            self.frames.append(frame)
            self.num_frames = 1
        return status

    def parse_vp8x(self) -> str:
        self.ext = True
        self.start += 4
        size = self.u32()
        if size > _MAX_CHUNK_PAYLOAD or size < _VP8X_SIZE:
            return "error"
        size += size & 1
        if size > self.left():
            return "error"
        self.flags = self.buf[self.start]
        self.start += 4
        self.canvas = (1 + self.u24(), 1 + self.u24())
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            return "error"
        self.start += size - _VP8X_SIZE
        if self.left() < 8:
            return "more"
        animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        status = "ok"
        while status == "ok":
            fourcc = self.buf[self.start:self.start + 4]
            self.start += 4
            size = self.u32()
            if size > _MAX_CHUNK_PAYLOAD:
                return "error"
            padded = size + (size & 1)
            if padded > self.left():
                return "error"
            if fourcc == b"VP8X":
                return "error"
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or animation:
                    return "error"
                self.start -= 8
                status = self.parse_single()
            elif fourcc == b"ANIM":
                if padded < _ANIM_SIZE:
                    return "error"
                anim_chunks += 1
                self.start += padded  # background and loop count unused
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return "error"
                status = self.parse_anmf(padded)
            else:  # ICCP, EXIF, XMP and unknown chunks
                self.start += padded
            if self.start == self.riff_end:
                break
            if self.left() < 8:
                status = "more"
        return status

    def parse_anmf(self, chunk_size: int) -> str:
        if _ANMF_SIZE > self.left() or chunk_size < _ANMF_SIZE:
            return "error"
        frame = _Frame()
        frame.x = 2 * self.u24()
        frame.y = 2 * self.u24()
        frame.width = 1 + self.u24()
        frame.height = 1 + self.u24()
        self.start += 4  # duration, dispose and blend bits
        if frame.width * frame.height >= _MAX_IMAGE_AREA:
            return "error"
        start = self.start
        status = self.store_frame(self.num_frames + 1,
                                  chunk_size - _ANMF_SIZE, frame)
        if status != "error" and self.start - start > chunk_size - _ANMF_SIZE:
            status = "error"
        if (status != "error" and self.flags & ANIMATION_FLAG
                and frame.frame_num > 0):
            if self.frames and not self.frames[-1].complete:
                return "error"
            self.frames.append(frame)
            self.num_frames += 1
        return status

    def valid_simple(self) -> bool:
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            return False
        return self.frames[0].width > 0 and self.frames[0].height > 0

    def valid_ext(self) -> bool:
        animation = bool(self.flags & ANIMATION_FLAG)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            return False
        if self.flags & ~_VALID_FLAGS:
            return False
        for f in self.frames:
            if not animation and f.frame_num > 1:
                return False
            if not f.complete:
                return False
            if f.alpha is None and f.image is None:
                return False
            if (f.alpha is not None and f.image is not None
                    and f.alpha[0] > f.image[0]):
                return False
            if f.width <= 0 or f.height <= 0:
                return False
            if not animation:
                if (f.x, f.y) != (0, 0) or (f.width, f.height) != self.canvas:
                    return False
            elif (f.x + f.width > self.canvas[0]
                  or f.y + f.height > self.canvas[1]):
                return False
        return True


def _decode_frame(d: _Demux, frame: _Frame, out: np.ndarray) -> None:
    """Frame `frame`'s fragment through WebPDecode into `out`, a view of
    (height, width, 4) of the canvas."""
    start, size, fourcc = frame.image
    # the codecs get the image chunk's payload to the end of its padded
    # chunk, as WebPDecode gives them the fragment's rest
    stream = d.buf[start + 8:start + size]
    if fourcc == b"VP8L":
        native.decode_webp_vp8l(stream, out, d.path)
        return
    alpha = None
    if frame.alpha is not None:
        a_start = frame.alpha[0]
        a_size = struct.unpack_from("<I", d.buf, a_start + 4)[0]
        alpha = d.buf[a_start + 8:a_start + 8 + a_size]
    native.decode_webp_vp8(stream, alpha, out, d.path)


def read_webp(path: str) -> Tuple[str, np.ndarray]:
    """-> (PIL's mode, np.asarray(Image.open(path))): (H, W, 3) uint8 for
    "RGB", (H, W, 4) for "RGBA"."""
    with open(path, "rb") as f:
        data = f.read()
    if not is_webp(data[:16]):
        raise NotImplementedError(
            f"{path}: not a WebP file; ROADMAP Queue 1: read_webp decodes "
            "WebP only (rsn_torch.data.jpeg.read_image picks the decoder by "
            "content, as rsn/data/blender.py's Image.open does)")
    has_alpha = _features(data)
    mode = "RGB" if has_alpha is False else "RGBA"
    d = _Demux(data, path)
    d.parse()
    frame = d.frames[0]
    if frame.image is None:
        raise d.refused("a WebP frame without an image")
    width, height = d.canvas
    canvas = np.zeros((height, width, 4), np.uint8)
    _decode_frame(d, frame, canvas[frame.y:frame.y + frame.height,
                                   frame.x:frame.x + frame.width])
    if mode == "RGB":
        return mode, np.ascontiguousarray(canvas[..., :3])
    return mode, canvas
