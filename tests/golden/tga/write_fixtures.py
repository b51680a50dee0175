"""A TGA writer for the cases of tests/test_torch_tga.py, and the committed
fixtures beside this file.

Everything here uses numpy and the standard library only (chip_smoke.py
runs it on the card's host, which has no PIL):

  - `header(image_type, width, height, depth, ...)`: the 18-byte header
    with its colour-map fields, origin and attribute bits;
  - `pixels(values, depth)`: rows of 1, 8, 15 / 16, 24 or 32-bit pixels
    (BGR byte order), bottom-up unless the origin is at the top;
  - `rle(values, depth)`: run and literal packets over the whole image,
    crossing rows as PIL's decoder reads them, or (per_row) packets that
    each stay within a row;
  - `tga(header, data, ...)`: the file with its ID field, colour map and
    a TGA 2.0 footer when asked.

CASES names each committed case, REFUSED_CASES files PIL refuses (their
digests.json entry is PIL's error), PIL_CASES the files PIL's own encoder
writes (only `main` needs PIL for those), NEAR_MISSES files Image.open
does not take as TGA.  `python tests/golden/tga/write_fixtures.py` writes
one file per case here and digests.json: the mode, shape, dtype and
sha256 of `np.asarray(Image.open(f))`, with the PIL version.
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
TOP = 0x20          # origin at the top (rows top-down)
RIGHT = 0x10        # origin at the right (columns right to left)
FOOTER = b"\x00" * 8 + b"TRUEVISION-XFILE.\x00"


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(int(hashlib.sha256(name.encode())
                                     .hexdigest()[:8], 16))


def values(height: int, width: int, depth: int, name: str) -> np.ndarray:
    """Seeded pixel bytes in runs (so RLE finds them): (H, W, depth // 8)
    uint8, or (H, W) 0 / 1 for depth 1."""
    rng = _rng(name)
    n = max(1, depth // 8)
    out = np.empty((height, width, n), np.uint8)
    flat = out.reshape(-1, n)
    k = 0
    while k < len(flat):
        run = int(rng.integers(1, 9))
        flat[k:k + run] = rng.integers(0, 256, n) if rng.integers(0, 2) else (
            rng.integers(0, 256, (min(run, len(flat) - k), n)))
        k += run
    if depth == 1:
        return (out[..., 0] & 1).astype(np.uint8)
    return out


def header(image_type: int, width: int, height: int, depth: int,
           flags: int = 0, id_len: int = 0, map_type: int = 0,
           map_start: int = 0, map_len: int = 0, map_depth: int = 0
           ) -> bytes:
    return struct.pack("<BBBHHBHHHHBB", id_len, map_type, image_type,
                       map_start, map_len, map_depth, 0, 0, width, height,
                       depth, flags)


def pixels(vals: np.ndarray, depth: int, flags: int = 0) -> bytes:
    """Image rows in file order for the origin bits in flags."""
    v = vals if flags & TOP else vals[::-1]
    if flags & RIGHT:
        v = v[:, ::-1]
    if depth == 1:
        return np.packbits(v, axis=1).tobytes()
    return np.ascontiguousarray(v).tobytes()


def rle(vals: np.ndarray, depth: int, flags: int = 0,
        per_row: bool = False) -> bytes:
    """RLE packets of up to 128 pixels: runs of 2 or more equal pixels
    within a row (PIL refuses a run past a row's end), literal packets of
    the rest, crossing rows unless per_row."""
    v = vals if flags & TOP else vals[::-1]
    if flags & RIGHT:
        v = v[:, ::-1]
    n = max(1, depth // 8)
    width = v.shape[1]
    px = np.ascontiguousarray(v).reshape(-1, n)
    raw = px.tobytes()
    # a run goes on where a pixel equals the last one in the same row
    goes_on = np.all(px[1:] == px[:-1], axis=1)
    goes_on &= np.arange(1, len(px)) % width != 0
    starts = np.flatnonzero(np.concatenate([[True], ~goes_on]))
    lengths = np.diff(np.concatenate([starts, [len(px)]]))
    out = bytearray()
    lit = [0, 0]  # the pending literal pixels: start, count

    def flush(end_of_row: bool = False):
        start, count = lit
        while count:
            k = min(count, 128)
            if per_row:  # a packet within the row
                k = min(k, width - start % width)
            out.append(k - 1)
            out.extend(raw[start * n:(start + k) * n])
            start, count = start + k, count - k
        lit[:] = [start, 0]

    for start, length in zip(starts.tolist(), lengths.tolist()):
        if length >= 2:
            flush()
            while length:
                k = min(length, 128)
                out.append(0x80 | (k - 1))
                out.extend(raw[start * n:(start + 1) * n])
                start, length = start + k, length - k
        else:
            if not lit[1]:
                lit[0] = start
            lit[1] += 1
    flush()
    return bytes(out)


def tga(head: bytes, data: bytes, ident: bytes = b"", cmap: bytes = b"",
        footer: bool = False) -> bytes:
    return head + ident + cmap + data + (FOOTER if footer else b"")


def colour_map(n: int, depth: int, name: str) -> bytes:
    return _rng(name).integers(0, 256, n * ((depth + 7) // 8),
                               dtype=np.uint8).tobytes()


def _true(name: str, itype: int, depth: int, w: int = 17, h: int = 9,
          flags: int = TOP, **kw) -> bytes:
    v = values(h, w, depth, name)
    data = rle(v, depth, flags) if itype & 8 else pixels(v, depth, flags)
    bits = 8 if depth in (15, 16) else 0  # attribute bits for 16
    return tga(header(itype, w, h, depth, flags | bits), data, **kw)


def _mapped(name: str, itype: int, map_depth: int = 24, map_len: int = 40,
            map_start: int = 0, w: int = 17, h: int = 9, flags: int = TOP,
            **kw) -> bytes:
    idx = (values(h, w, 8, name).astype(np.int64) % min(
        256, map_start + map_len)).astype(np.uint8)
    data = rle(idx, 8, flags) if itype & 8 else pixels(idx, 8, flags)
    return tga(header(itype, w, h, 8, flags, map_type=1, map_start=map_start,
                      map_len=map_len, map_depth=map_depth), data,
               cmap=colour_map(map_len, map_depth, name), **kw)


def _rle_crossing_rows() -> bytes:
    """A literal packet of 10 gray pixels over rows of 3."""
    data = bytes([9]) + bytes(range(10, 20)) + bytes([0x81, 99])
    return tga(header(11, 3, 4, 8, TOP), data)


CASES = {
    "type1_map24": lambda: _mapped("t1", 1),
    "type1_map16": lambda: _mapped("t1m16", 1, 16),
    "type1_map_first_index": lambda: _mapped("t1fi", 1, 24, 40, 200),
    "type1_map_256": lambda: _mapped("t1m256", 1, 24, 256),
    "type9_map24": lambda: _mapped("t9", 9),
    "type9_map16_bottom_up": lambda: _mapped("t9b", 9, 16, flags=0),
    "type2_16": lambda: _true("t216", 2, 16),
    "type2_16_no_attribute_bits": lambda: tga(header(2, 7, 3, 16, TOP),
                                              pixels(values(3, 7, 16, "na"),
                                                     16, TOP)),
    "type2_24": lambda: _true("t224", 2, 24),
    "type2_32": lambda: _true("t232", 2, 32),
    "type10_16": lambda: _true("t1016", 10, 16),
    "type10_24": lambda: _true("t1024", 10, 24),
    "type10_32": lambda: _true("t1032", 10, 32),
    "type10_24_packets_per_row": lambda: (lambda v: tga(header(
        10, 17, 9, 24, TOP), rle(v, 24, TOP, per_row=True)))(
        values(9, 17, 24, "ppr")),
    "type3_1": lambda: _true("t31", 3, 1),
    "type3_8": lambda: _true("t38", 3, 8),
    "type3_16_is_LA": lambda: _true("t316", 3, 16),
    "type11_8": lambda: _true("t118", 11, 8),
    "type11_16_is_LA": lambda: _true("t1116", 11, 16),
    "type11_literal_crossing_rows": _rle_crossing_rows,
    **{f"origin_{k}": (lambda f=f, k=k: _true(f"o{k}", 2, 24, flags=f))
       for k, f in (("bottom_left", 0), ("bottom_right", RIGHT),
                    ("top_left", TOP), ("top_right", TOP | RIGHT))},
    "origin_bottom_right_rle": lambda: _true("obr", 10, 24, flags=RIGHT),
    "id_field": lambda: _true("id", 2, 24, ident=b"made by numpy"),
    "footer": lambda: _true("ft", 10, 32, footer=True),
    "gray_with_a_map_is_L": lambda: (lambda v: tga(header(
        3, 17, 9, 8, TOP, map_type=1, map_len=16, map_depth=24),
        pixels(v, 8, TOP), cmap=colour_map(16, 24, "gm")))(
        values(9, 17, 8, "gm")),
    "large_1x1000": lambda: _true("lg", 10, 24, w=1000, h=1),
    "true_colour_map_fields_like_a_cur": lambda: tga(header(
        2, 5, 3, 24, TOP, map_start=0x0500), pixels(values(
            3, 5, 24, "cur"), 24, TOP)),
}
REFUSED_CASES = {
    "rle_run_crossing_rows": lambda: tga(header(11, 3, 2, 8, TOP),
                                         bytes([0x84, 9, 0x00, 7])),
    "rle_depth_1": lambda: tga(header(11, 8, 2, 1, TOP), bytes([0x81, 0xff] * 4)),
    "type1_without_map": lambda: tga(header(1, 4, 2, 8, TOP), bytes(8)),
    "type9_without_map": lambda: tga(header(9, 4, 2, 8, TOP),
                                     bytes([0x87, 3])),
    "map_of_32bit_entries": lambda: _mapped("m32", 1, 32),
    "map_past_256": lambda: _mapped("m300", 1, 24, 300),
    "map_first_index_past_256": lambda: _mapped("mfi", 1, 24, 20, 250),
    "map_beside_true_colour": lambda: tga(header(
        2, 2, 1, 24, TOP, map_type=1, map_len=4, map_depth=24),
        bytes(6), cmap=bytes(12)),
    "type2_depth_8": lambda: tga(header(2, 2, 1, 8, TOP), bytes(2)),
    "type1_depth_16": lambda: tga(header(1, 2, 1, 16, TOP, map_type=1,
                                         map_len=2, map_depth=24),
                                  bytes(4), cmap=bytes(6)),
    "truncated": lambda: _true("tr", 2, 24)[:-5],
    "rle_truncated": lambda: _true("rtr", 10, 24)[:-5],
    "decompression_bomb": lambda: tga(header(2, 20000, 20000, 24), bytes(9)),
}
# files Image.open does not take as TGA
NEAR_MISSES = {
    "image_type_0": lambda: tga(header(0, 2, 2, 8), bytes(4)),
    "image_type_4": lambda: tga(header(4, 2, 2, 8), bytes(4)),
    "image_type_12": lambda: tga(header(12, 2, 2, 8), bytes(4)),
    "map_type_2": lambda: tga(header(2, 2, 2, 24, map_type=2), bytes(12)),
    "depth_15": lambda: tga(header(2, 2, 2, 15), bytes(8)),
    "width_0": lambda: tga(header(2, 0, 2, 24), bytes(8)),
    "map_depth_8": lambda: tga(header(1, 2, 2, 8, map_type=1, map_len=2,
                                      map_depth=8), bytes(6)),
    "header_cut_at_17": lambda: tga(header(2, 2, 2, 24), b"")[:17],
}
# the files PIL's own encoder writes: name -> (mode, size, save options)
PIL_CASES = {
    **{f"pil_{m}": (m, (19, 7), {}) for m in ("1", "L", "LA", "P", "RGB",
                                             "RGBA")},
    **{f"pil_{m}_rle": (m, (19, 7), {"rle": True})
       for m in ("L", "P", "RGB", "RGBA")},
    "pil_RGB_top_left": ("RGB", (19, 7), {"orientation": 1}),
}
FRAMES = [f"frame_{i:05d}" for i in range(5)]  # tests/golden/jpeg's pixels


def case_bytes(name: str) -> bytes:
    return {**CASES, **REFUSED_CASES}[name]()


def pil_source(name: str):
    from PIL import Image

    mode, (w, h), _ = PIL_CASES[name]
    v = values(h, w, 32, name)
    return Image.fromarray(v, "RGBA").convert(mode)


# the 800x800 kind chip_smoke.py times and trains on
def write_rle24(rgb: np.ndarray) -> bytes:
    """(H, W, 3) RGB -> an RLE true-colour TGA, origin bottom-left (mode
    RGB, the same pixels)."""
    h, w = rgb.shape[:2]
    return tga(header(10, w, h, 24), rle(rgb[..., ::-1], 24))


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def fixture_name(name: str) -> str:
    return f"{name}.tga"


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
        pil_source(name).save(path, "TGA", **opts)
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
