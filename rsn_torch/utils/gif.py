"""Animated GIF without PIL: a writer for the render CLI's `--video`
where ffmpeg is missing (rsn writes that GIF with PIL) and a reader for
its checks.

The writer maps every frame onto one fixed palette: 6 levels of red, 7
of green and 6 of blue (252 colors, each channel quantised to its nearest
level, no dithering), so a decoded pixel is within half a level step
(25.5 / 255 red and blue, 21.25 / 255 green) of its frame's pixel.  PIL's
adaptive palette is finer; a GIF cannot equal it bit for bit anyway.
LZW in plain Python, codes of 9 to 12 bits, a clear code when the table
is full.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

LEVELS = (6, 7, 6)  # red, green, blue
STEP = tuple(255.0 / (n - 1) for n in LEVELS)  # a level step, 0..255 units
_MIN_CODE = 8  # 256-entry color table
_CLEAR = 1 << _MIN_CODE
_EOI = _CLEAR + 1


def palette() -> np.ndarray:
    """(256, 3) uint8: the 252 colors (red slowest), then black."""
    r, g, b = (np.round(np.arange(n) * (255.0 / (n - 1))) for n in LEVELS)
    rgb = np.stack(np.meshgrid(r, g, b, indexing="ij"), -1).reshape(-1, 3)
    out = np.zeros((256, 3), np.uint8)
    out[:len(rgb)] = rgb
    return out


def quantise(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) palette indices, each channel at its
    nearest level."""
    idx = [np.rint(frame[..., c].astype(np.float64) / STEP[c]).astype(
        np.int64) for c in range(3)]
    return ((idx[0] * LEVELS[1] + idx[1]) * LEVELS[2] + idx[2]).astype(
        np.uint8)


def _lzw_encode(indices: bytes) -> bytes:
    out = bytearray()
    acc = nbits = 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    size = _MIN_CODE + 1
    table = {}
    next_code = _EOI + 1
    emit(_CLEAR, size)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            # the decoder adds its entries one code later: widen once the
            # entry it adds next needs the wider code
            if next_code > (1 << size) and size < 12:
                size += 1
        else:  # the table is full: start again
            emit(_CLEAR, size)
            table.clear()
            next_code = _EOI + 1
            size = _MIN_CODE + 1
        prefix = b
    emit(prefix, size)
    emit(_EOI, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _lzw_decode(data: bytes, min_code: int, n_pixels: int) -> np.ndarray:
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    size = min_code + 1
    table: List[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    prev = None
    acc = nbits = pos = 0
    while len(out) < n_pixels:
        while nbits < size:
            if pos >= len(data):
                raise ValueError("GIF image data ends early")
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            table = table[:clear + 2]
            size = min_code + 1
            prev = None
            continue
        if code == eoi:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif prev is not None and code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"bad LZW code {code}")
        out += entry
        prev = entry
        if len(table) == (1 << size) and size < 12:
            size += 1
    return np.frombuffer(bytes(out[:n_pixels]), np.uint8)


def write_gif(path: str, frames, duration_ms: int) -> None:
    """Frames ((H, W, 3) uint8, one size) -> an animated GIF that loops,
    each frame shown duration_ms (stored in hundredths, as PIL stores
    it)."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    blocks = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
              palette().tobytes(),
              b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    delay = int(duration_ms / 10)
    for frame in frames:
        data = _lzw_encode(quantise(frame).tobytes())
        blocks.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                      + b"\x00\x00")
        blocks.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        blocks.append(bytes([_MIN_CODE]))
        blocks += [bytes([len(data[i:i + 255])]) + data[i:i + 255]
                   for i in range(0, len(data), 255)]
        blocks.append(b"\x00")
    blocks.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(blocks))


def read_gif(path: str) -> Tuple[List[np.ndarray], List[int]]:
    """-> (frames as (H, W, 3) uint8, each frame's delay in hundredths of
    a second).  Reads what write_gif writes: full-size frames, global or
    local color tables, no interlacing."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    _, _, flags, _, _ = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    gct = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        gct = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
        pos += n
    frames, delays = [], []
    delay = 0
    while pos < len(data):
        tag = data[pos]
        pos += 1
        if tag == 0x3B:
            break
        if tag == 0x21:  # extension: label, then sub-blocks
            label = data[pos]
            pos += 1
            if label == 0xF9:
                delay = struct.unpack("<H", data[pos + 2:pos + 4])[0]
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
            continue
        if tag != 0x2C:
            raise ValueError(f"{path}: bad GIF block {tag:#x}")
        _, _, w, h, iflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        if iflags & 0x40:
            raise ValueError(f"{path}: interlaced GIF frames are not read")
        table = gct
        if iflags & 0x80:
            n = 3 << ((iflags & 7) + 1)
            table = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
            pos += n
        min_code = data[pos]
        pos += 1
        chunks = []
        while data[pos]:
            chunks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += data[pos] + 1
        pos += 1
        idx = _lzw_decode(b"".join(chunks), min_code, w * h)
        frames.append(table[idx].reshape(h, w, 3))
        delays.append(delay)
    return frames, delays
