"""A GIF writer for the cases of tests/test_torch_gif.py, and the committed
fixtures beside this file.

Everything here uses numpy and the standard library only (chip_smoke.py
runs it on the card's host, which has no PIL):

  - `lzw(indices, min_code)`: GIF's LZW codes, LSB first, the code width
    grown as the decoder grows it; when the table is full (4096 codes)
    a clear code, or (full="keep") no more entries and 12-bit codes on;
  - `image(x0, y0, w, h, indices, ...)`: an image descriptor, its local
    colour table, the minimum code size and the data in sub-blocks, the
    rows interlaced when asked;
  - `gce(...)`, `comment(...)`, `netscape(...)`, `plain_text(...)`,
    `extension(label, ...)`: the extensions;
  - `gif(width, height, blocks, gct=...)`: the file (GIF87a or GIF89a,
    the logical screen, its global colour table, the blocks, the
    trailer).

CASES names each committed case, REFUSED_CASES files PIL refuses (their
digests.json entry is PIL's error), PIL_CASES the files PIL's own encoder
writes (only `main` needs PIL for those), NEAR_MISSES files Image.open
does not take as GIF.  `python tests/golden/gif/write_fixtures.py` writes
one file per case here and digests.json: the mode, shape, dtype and
sha256 of `np.asarray(Image.open(f))` (frame 0), with the PIL version.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "digests.json")


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(int(hashlib.sha256(name.encode())
                                     .hexdigest()[:8], 16))


def indices(height: int, width: int, n: int, name: str) -> np.ndarray:
    """Seeded indices below n: smooth bands with noise, so LZW finds
    strings, (H, W) uint8."""
    rng = _rng(name)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    v = (np.sin(rng.uniform(0.05, 0.4) * x) * np.cos(rng.uniform(0.05, 0.4)
                                                       * y) + 1) / 2
    v = v + rng.normal(0, 0.05, v.shape)
    return np.clip(np.floor(v * n), 0, n - 1).astype(np.uint8)


def colour_table(n: int, name: str) -> bytes:
    return _rng(name).integers(0, 256, 3 * n, dtype=np.uint8).tobytes()


def gray_ramp(n: int) -> bytes:
    return np.repeat(np.arange(n, dtype=np.uint8), 3).tobytes()


def _table_bits(table: bytes) -> int:
    """The size field of a table of len(table) // 3 entries (2 to 256)."""
    n = len(table) // 3
    return max(0, (n - 1).bit_length() - 1)


def _pack(codes, widths) -> bytes:
    out = bytearray()
    acc = nbits = 0
    for code, width in zip(codes, widths):
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def lzw(values, min_code: int, full: str = "clear",
        clear_first: bool = True, end: bool = True,
        strings: bool = True) -> bytes:
    """Indices -> GIF LZW data (not yet in sub-blocks); strings=False: a
    code for each index (the decoder still grows its table)."""
    data = bytes(np.asarray(values, np.uint8).ravel())
    clear = 1 << min_code
    codes, widths = [], []
    st = {}

    def reset():
        st.update(table={}, enc_next=clear + 2, size=min_code + 1,
                  dec_next=clear + 2, first=True)

    def emit(code):
        codes.append(code)
        widths.append(st["size"])
        if code == clear:
            reset()
        elif st["first"]:
            st["first"] = False
        elif st["dec_next"] < 4096:  # the entry the decoder adds
            if st["dec_next"] == (1 << st["size"]) - 1 and st["size"] < 12:
                st["size"] += 1
            st["dec_next"] += 1

    reset()
    if clear_first:
        emit(clear)
    prefix = None
    for b in data:
        if prefix is None:
            prefix = b
            continue
        code = st["table"].get((prefix, b)) if strings else None
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if st["enc_next"] < 4096:
            st["table"][(prefix, b)] = st["enc_next"]
            st["enc_next"] += 1
        elif full == "clear":
            emit(clear)
        prefix = b
    if prefix is not None:
        emit(prefix)
    if end:
        emit(clear + 1)
    return _pack(codes, widths)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes([len(data[k:k + size])]) + data[k:k + size]
                    for k in range(0, len(data), size)) + b"\x00"


def interlaced(rows: np.ndarray) -> np.ndarray:
    """Rows in GIF's interlaced order: every 8th from 0, from 4, every
    4th from 2, every 2nd from 1."""
    order = [*range(0, len(rows), 8), *range(4, len(rows), 8),
             *range(2, len(rows), 4), *range(1, len(rows), 2)]
    return rows[order]


def image(x0: int, y0: int, values: np.ndarray, min_code: int = 8,
          lct: bytes = b"", interlace: bool = False, data: bytes = None,
          **lzw_kw) -> bytes:
    """An image descriptor at (x0, y0) of values' size and its data."""
    h, w = values.shape
    flags = (0x40 if interlace else 0) | (
        0x80 | _table_bits(lct) if lct else 0)
    if data is None:
        data = lzw(interlaced(values) if interlace else values, min_code,
                   **lzw_kw)
    return (b"," + struct.pack("<HHHHB", x0, y0, w, h, flags) + lct
            + bytes([min_code]) + sub_blocks(data))


def gce(transparency=None, disposal: int = 0, delay: int = 0,
        flag: bool = True) -> bytes:
    flags = disposal << 2 | (1 if transparency is not None and flag else 0)
    return (b"!\xf9\x04" + struct.pack("<BHB", flags, delay,
                                       transparency or 0) + b"\x00")


def extension(label: int, payload: bytes) -> bytes:
    return b"!" + bytes([label]) + sub_blocks(payload)


def comment(text: bytes) -> bytes:
    return extension(0xFE, text)


def netscape(loops: int = 0) -> bytes:
    return (b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loops)
            + b"\x00")


def plain_text() -> bytes:
    return extension(0x01, bytes(range(12)) + b"hello")


def gif(width: int, height: int, blocks, gct: bytes = b"",
        version: bytes = b"GIF89a", background: int = 0,
        trailer: bytes = b";") -> bytes:
    flags = 0x80 | 0x70 | _table_bits(gct) if gct else 0
    return (version + struct.pack("<HHBBB", width, height, flags, background,
                                  0) + gct + b"".join(blocks) + trailer)


def _frame(name: str, w: int, h: int, n: int = 256, **kw) -> bytes:
    return image(0, 0, indices(h, w, n, name), **kw)


def _min_code_case(bits: int) -> bytes:
    n = 1 << bits
    return gif(23, 11, [_frame(f"m{bits}", 23, 11, n, min_code=bits)],
               colour_table(max(n, 2), f"m{bits}"))


def _full_table(full: str) -> bytes:
    v = _rng("full").integers(0, 256, (64, 80), dtype=np.uint8)
    return gif(80, 64, [image(0, 0, v, full=full)], colour_table(256, "full"))


def _two_frames() -> bytes:
    a, b = indices(9, 14, 16, "two_a"), indices(9, 14, 16, "two_b")
    return gif(14, 9, [gce(delay=10), image(0, 0, a, 4), gce(delay=10),
                       image(0, 0, b, 4)], colour_table(16, "two"))


def _small_sub_blocks() -> bytes:
    v = indices(11, 23, 256, "ssb")
    desc = b"," + struct.pack("<HHHHB", 0, 0, 23, 11, 0) + b"\x08"
    return gif(23, 11, [desc + sub_blocks(lzw(v, 8), 7)],
               colour_table(256, "ssb"))


_STRAY = b"\x07\x99"
_TINY = np.array([[1, 2, 3], [4, 5, 6]], np.uint8)
CASES = {
    "global_table_is_P": lambda: gif(23, 11, [_frame("g", 23, 11)],
                                     colour_table(256, "g")),
    "local_table_is_P": lambda: gif(23, 11, [_frame(
        "l", 23, 11, 16, min_code=4, lct=colour_table(16, "l"))]),
    "local_table_over_gray_global": lambda: gif(23, 11, [_frame(
        "lg", 23, 11, 16, min_code=4, lct=colour_table(16, "lg"))],
        gray_ramp(256)),
    "gray_ramp_global_is_L": lambda: gif(23, 11, [_frame("gr", 23, 11)],
                                         gray_ramp(256)),
    "gray_ramp_local_over_colour_global_is_L": lambda: gif(23, 11, [_frame(
        "grl", 23, 11, 16, min_code=4, lct=gray_ramp(16))],
        colour_table(256, "grl")),
    "no_table_is_L": lambda: gif(23, 11, [_frame("nt", 23, 11)]),
    "two_colours": lambda: gif(23, 11, [_frame("two", 23, 11, 2,
                                               min_code=2)],
                               colour_table(2, "two")),
    **{f"min_code_{b}": (lambda b=b: _min_code_case(b))
       for b in (2, 3, 4, 5, 6, 7, 8)},
    "min_code_1_single_codes": lambda: gif(9, 4, [_frame(
        "m1", 9, 4, 2, min_code=1, strings=False)], colour_table(2, "m1")),
    "min_code_8_single_codes": lambda: gif(23, 11, [_frame(
        "m8s", 23, 11, strings=False)], colour_table(256, "m8s")),
    "interlaced": lambda: gif(23, 19, [_frame("il", 23, 19, 64,
                                              interlace=True)],
                              colour_table(64, "il")),
    **{f"interlaced_height_{h}": (lambda h=h: gif(7, h, [_frame(
        f"il{h}", 7, h, 64, interlace=True)], colour_table(64, f"il{h}")))
       for h in (1, 2, 3, 5, 9)},
    "full_table_then_clear": lambda: _full_table("clear"),
    "full_table_kept": lambda: _full_table("keep"),
    "no_clear_code_first": lambda: gif(23, 11, [_frame(
        "ncf", 23, 11, clear_first=False)], colour_table(256, "ncf")),
    "no_end_code": lambda: gif(23, 11, [_frame("nec", 23, 11, end=False)],
                               colour_table(256, "nec")),
    "codes_past_the_image": lambda: gif(3, 2, [image(0, 0, _TINY, 3, data=(
        lzw(np.concatenate([_TINY.ravel(), [7, 7, 7]]), 3)))],
        colour_table(8, "past")),
    "frame_inside_screen_fill_0": lambda: gif(30, 20, [image(
        5, 4, indices(9, 13, 256, "fi"))], colour_table(256, "fi"),
        background=77),
    "frame_inside_screen_fill_transparency": lambda: gif(30, 20, [
        gce(transparency=201), image(5, 4, indices(9, 13, 256, "ft"))],
        colour_table(256, "ft"), background=77),
    "frame_inside_screen_flag_off": lambda: gif(30, 20, [
        gce(transparency=201, flag=False), image(5, 4, indices(
            9, 13, 256, "ff"))], colour_table(256, "ff")),
    "frame_past_screen_edge": lambda: gif(16, 8, [image(
        10, 5, indices(9, 13, 256, "fp"))], colour_table(256, "fp")),
    "screen_zero_frame_sized": lambda: gif(0, 0, [_frame("sz", 12, 6)],
                                           colour_table(256, "sz")),
    "extensions_before_image": lambda: gif(23, 11, [
        netscape(3), comment(b"made by a numpy writer"), plain_text(),
        extension(0x99, b"unknown"), comment(b"x" * 300),
        gce(transparency=3, disposal=2, delay=7), _frame("ext", 23, 11)],
        colour_table(256, "ext")),
    "stray_bytes_between_blocks": lambda: gif(23, 11, [
        _STRAY, comment(b"c"), _STRAY, _frame("sb", 23, 11)],
        colour_table(256, "sb")),
    "gif87a": lambda: gif(23, 11, [_frame("87", 23, 11)],
                          colour_table(256, "87"), version=b"GIF87a"),
    "two_frames_reads_the_first": _two_frames,
    "no_trailer": lambda: gif(23, 11, [_frame("ntr", 23, 11)],
                              colour_table(256, "ntr"), trailer=b""),
    "small_sub_blocks": lambda: _small_sub_blocks(),
}
REFUSED_CASES = {
    "data_truncated": lambda: gif(23, 11, [_frame("dt", 23, 11)],
                                  colour_table(256, "dt"))[:-60],
    "end_code_early": lambda: gif(3, 2, [image(0, 0, _TINY, 3, data=lzw(
        _TINY.ravel()[:4], 3))], colour_table(8, "ee")),
    "code_past_table": lambda: gif(3, 2, [image(0, 0, _TINY, 3, data=_pack(
        [8, 1, 2, 15, 9], [4] * 5))], colour_table(8, "cp")),
    "first_code_past_clear": lambda: gif(3, 2, [image(0, 0, _TINY, 3,
                                                      data=_pack(
        [8, 12, 1, 9], [4] * 4))], colour_table(8, "fc")),
    "min_code_13": lambda: gif(3, 2, [image(0, 0, _TINY, 13, data=b"\x00")],
                               colour_table(8, "m13")),
    "frame_of_width_0": lambda: gif(4, 4, [
        b"," + struct.pack("<HHHHB", 0, 0, 0, 3, 0) + b"\x08\x01\x00\x00"]),
    "decompression_bomb": lambda: gif(20000, 20000, [image(
        0, 0, _TINY, 3)], colour_table(8, "bomb")),
}
# files Image.open does not take as GIF
NEAR_MISSES = {
    "header_only": lambda: gif(4, 4, [], colour_table(4, "h"), trailer=b""),
    "trailer_first": lambda: gif(4, 4, [], colour_table(4, "t")),
    "descriptor_cut_short": lambda: gif(4, 4, [b",\x00\x00\x00"], trailer=b""),
    "gce_of_two_bytes": lambda: gif(4, 4, [b"!\xf9\x02\x01\x00\x00",
                                           image(0, 0, _TINY, 3)]),
    "gif88a": lambda: gif(3, 2, [image(0, 0, _TINY, 3)], version=b"GIF88a"),
    "global_table_cut_on_the_ramp": lambda: b"GIF89a\x04\x00\x04\x00\xf1"
    b"\x00\x00\x00\x00\x00\x01\x01",
}
# the files PIL's own encoder writes: name -> (mode, size, save options)
PIL_CASES = {"pil_P": ("P", (29, 13), {}),
             "pil_L": ("L", (29, 13), {}),
             "pil_RGB_quantised": ("RGB", (29, 13), {}),
             "pil_interlaced": ("P", (29, 13), {"interlace": True}),
             "pil_transparency": ("P", (29, 13), {"transparency": 5}),
             "pil_optimized": ("P", (29, 13), {"optimize": True})}
FRAMES = [f"frame_{i:05d}" for i in range(5)]  # tests/golden/jpeg's pixels


def case_bytes(name: str) -> bytes:
    return {**CASES, **REFUSED_CASES}[name]()


def pil_source(name: str):
    from PIL import Image

    mode, (w, h), _ = PIL_CASES[name]
    idx = indices(h, w, 32, name)
    img = Image.fromarray(idx, "P")
    img.putpalette(colour_table(32, name))
    if mode == "L":
        return Image.fromarray(idx * 7, "L")
    return img.convert("RGB") if mode == "RGB" else img


# the 800x800 kind chip_smoke.py times and trains on
def write_gray(gray: np.ndarray) -> bytes:
    """(H, W) uint8 -> a GIF of its gray levels with the gray ramp for
    its global table (PIL reads it as mode L, the same values)."""
    h, w = gray.shape
    return gif(w, h, [image(0, 0, gray)], gray_ramp(256))


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def fixture_name(name: str) -> str:
    return f"{name}.gif"


def main() -> None:
    from PIL import Image

    files, refused = {}, {}
    for name in {**CASES, **REFUSED_CASES}:
        path = os.path.join(HERE, fixture_name(name))
        with open(path, "wb") as f:
            f.write(case_bytes(name))
        try:
            with Image.open(path) as img:
                files[fixture_name(name)] = digest(img.mode, np.asarray(img))
        except Exception as e:  # noqa: BLE001 - PIL's refusal, recorded
            if name in CASES:
                raise
            refused[fixture_name(name)] = f"{type(e).__name__}: " + str(
                e).replace(path, fixture_name(name))
            continue
        if name in REFUSED_CASES:
            raise RuntimeError(f"{name}: PIL opens it")
    for name, (_, _, opts) in PIL_CASES.items():
        path = os.path.join(HERE, fixture_name(name))
        pil_source(name).save(path, "GIF", **opts)
        with Image.open(path) as img:
            files[fixture_name(name)] = digest(img.mode, np.asarray(img))
    with open(DIGESTS, "w") as f:
        json.dump({"pil": Image.__version__, "files": files,
                   "refused": refused}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    main()
