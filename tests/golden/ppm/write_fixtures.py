"""A PBM / PGM / PPM / PFM writer for the cases of tests/test_torch_ppm.py,
and the committed fixtures beside this file.

Everything here uses numpy and the standard library only (chip_smoke.py
runs it on the card's host, which has no PIL):

  - `header(magic, width, height, maxval, sep=...)`: the header's tokens
    with the separators (spaces, tabs, CR / LF, comments) given;
  - `raw(values, maxval)`: raw samples, 1 byte each up to maxval 255, 2
    (big-endian) past it; `raw_bits(bits)`: P4's rows of packed bits;
  - `plain(values, per_line, sep)`: P2 / P3's decimal tokens, `plain_bits`
    P1's "0" / "1" bytes with or without whitespace;
  - `pfm(values, little_endian)`: a Pf frame, rows bottom-up.

CASES names each committed case, REFUSED_CASES files PIL refuses (their
digests.json entry is PIL's error), PIL_CASES the files PIL's own encoder
writes (only `main` needs PIL for those), NEAR_MISSES files Image.open
does not take as PPM.  `python tests/golden/ppm/write_fixtures.py` writes
one file per case here and digests.json: the mode, shape, dtype and
sha256 of `np.asarray(Image.open(f))`, with the PIL version.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "digests.json")


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(int(hashlib.sha256(name.encode())
                                     .hexdigest()[:8], 16))


def samples(height: int, width: int, bands: int, maxval: int,
            name: str) -> np.ndarray:
    """Seeded samples up to maxval, smooth with noise, (H, W[, bands])."""
    rng = _rng(name)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    out = [0.5 + 0.45 * np.sin(rng.uniform(0.1, 0.7) * x + b)
           * np.cos(rng.uniform(0.1, 0.7) * y)
           + rng.normal(0, 0.03, (height, width)) for b in range(bands)]
    v = np.clip(np.rint(np.stack(out, -1) * maxval), 0, maxval).astype(
        np.int64)
    return v[..., 0] if bands == 1 else v


def header(magic: bytes, width, height, maxval=None,
           sep=(b" ", b" ", b"\n", b"\n")) -> bytes:
    """magic, width, height[, maxval], each followed by its separator
    (the last one ends the header: one whitespace byte)."""
    toks = [magic, str(width).encode(), str(height).encode()]
    if maxval is not None:
        toks.append(str(maxval).encode() if not isinstance(maxval, bytes)
                    else maxval)
    return b"".join(t + s for t, s in zip(toks, sep))


def raw(values: np.ndarray, maxval: int) -> bytes:
    return values.astype(np.uint8 if maxval < 256 else ">u2").tobytes()


def raw_bits(bits: np.ndarray) -> bytes:
    """(H, W) 0 / 1 -> P4 rows, MSB first, 1 is black."""
    return np.packbits(bits.astype(np.uint8), axis=1).tobytes()


def plain(values: np.ndarray, per_line: int = 12, sep: bytes = b" "
          ) -> bytes:
    flat = [str(int(v)).encode() for v in values.ravel()]
    lines = [sep.join(flat[k:k + per_line])
             for k in range(0, len(flat), per_line)]
    return b"\n".join(lines) + b"\n"


def plain_bits(bits: np.ndarray, spaced: bool = True) -> bytes:
    rows = [(b" " if spaced else b"").join(b"1" if v else b"0" for v in row)
            for row in bits]
    return b"\n".join(rows) + b"\n"


def pfm(values: np.ndarray, little_endian: bool) -> bytes:
    """(H, W) float32 -> a Pf file, rows bottom-up."""
    h, w = values.shape
    dt = "<f4" if little_endian else ">f4"
    scale = b"-1.0" if little_endian else b"1.0"
    return header(b"Pf", w, h, scale) + values[::-1].astype(dt).tobytes()


def _bits(name: str, h: int, w: int) -> np.ndarray:
    return _rng(name).integers(0, 2, (h, w))


def _raw_case(magic: bytes, bands: int, maxval: int, name: str,
              w: int = 13, h: int = 7, **kw) -> bytes:
    return header(magic, w, h, maxval, **kw) + raw(
        samples(h, w, bands, maxval, name), maxval)


def _plain_case(magic: bytes, bands: int, maxval: int, name: str,
                w: int = 13, h: int = 7, **kw) -> bytes:
    return header(magic, w, h, maxval) + plain(
        samples(h, w, bands, maxval, name), **kw)


_COMMENTED = (b"\n# a comment\n", b"\t#another\r", b"\r\n#c\n ", b"\n")
_COMMENTS_IN_DATA = (b"255\n1 2#c\n3 4 5 6 7 8 9\n# whole line\n10 11 12 "
                     b"13 14 15 16\r\n")
CASES = {
    "p1_spaced": lambda: header(b"P1", 19, 5) + plain_bits(_bits("p1", 5, 19)),
    "p1_unspaced": lambda: header(b"P1", 19, 5) + plain_bits(
        _bits("p1u", 5, 19), False),
    "p1_comments": lambda: header(b"P1", 4, 2) + b"1 0#c\n 1 1\n0#x\r0 1 1",
    "p4": lambda: header(b"P4", 19, 5) + raw_bits(_bits("p4", 5, 19)),
    "p4_width_8": lambda: header(b"P4", 8, 3) + raw_bits(_bits("p48", 3, 8)),
    "p2_255": lambda: _plain_case(b"P2", 1, 255, "p2"),
    "p2_maxval_15": lambda: _plain_case(b"P2", 1, 15, "p2m15"),
    "p2_maxval_1000_is_I": lambda: _plain_case(b"P2", 1, 1000, "p2m1000"),
    "p2_maxval_65535_is_I": lambda: _plain_case(b"P2", 1, 65535, "p2m65535"),
    "p2_tokens_python_int": lambda: header(b"P2", 3, 2, 255)
    + b"+7 0_1_2 007\n-0 1_0 255\n",
    "p2_comments_in_data": lambda: header(b"P2", 5, 3)
    + _COMMENTS_IN_DATA,
    "p3_255": lambda: _plain_case(b"P3", 3, 255, "p3"),
    "p3_maxval_7": lambda: _plain_case(b"P3", 3, 7, "p3m7", per_line=5),
    "p3_maxval_4095": lambda: _plain_case(b"P3", 3, 4095, "p3m4095",
                                          sep=b"\t"),
    "p5_255": lambda: _raw_case(b"P5", 1, 255, "p5"),
    "p5_maxval_100": lambda: _raw_case(b"P5", 1, 100, "p5m100"),
    "p5_maxval_100_values_past": lambda: header(b"P5", 4, 2, 100)
    + bytes([0, 50, 100, 101, 150, 200, 254, 255]),
    "p5_maxval_1000_is_I": lambda: _raw_case(b"P5", 1, 1000, "p5m1000"),
    "p5_maxval_65535_is_I": lambda: _raw_case(b"P5", 1, 65535, "p5m65535"),
    "p5_maxval_1": lambda: _raw_case(b"P5", 1, 1, "p5m1"),
    "p6_255": lambda: _raw_case(b"P6", 3, 255, "p6"),
    "p6_maxval_31": lambda: _raw_case(b"P6", 3, 31, "p6m31"),
    "p6_maxval_1000": lambda: _raw_case(b"P6", 3, 1000, "p6m1000"),
    "p6_maxval_65535": lambda: _raw_case(b"P6", 3, 65535, "p6m65535"),
    "p6_header_comments": lambda: _raw_case(b"P6", 3, 255, "p6c",
                                            sep=_COMMENTED),
    "p6_comment_inside_token": lambda: b"P6\n1#split\n3 4\n255\n" + raw(
        samples(4, 13, 3, 255, "p6t"), 255),
    "p6_whitespace_kinds": lambda: _raw_case(
        b"P6", 3, 255, "p6w", sep=(b"\x0b", b"\x0c", b"\t\r\n ", b"\r")),
    "p6_trailing_bytes": lambda: _raw_case(b"P6", 3, 255, "p6x") + b"junk",
    "pf_little_endian": lambda: pfm(samples(7, 9, 1, 255, "pfl").astype(
        np.float32) / 17 - 3, True),
    "pf_big_endian": lambda: pfm(samples(7, 9, 1, 255, "pfb").astype(
        np.float32) / 17 - 3, False),
    "p0cmyk": lambda: _raw_case(b"P0CMYK", 4, 255, "cmyk"),
    "pyp": lambda: _raw_case(b"PyP", 1, 255, "pyp"),
    "pyrgba": lambda: _raw_case(b"PyRGBA", 4, 255, "pyrgba"),
    "pycmyk": lambda: _raw_case(b"PyCMYK", 4, 255, "pycmyk"),
    "pyrgba_maxval_100": lambda: _raw_case(b"PyRGBA", 4, 100, "pyrgba100"),
}
REFUSED_CASES = {
    "maxval_0": lambda: header(b"P5", 4, 2, 0) + bytes(8),
    "maxval_65536": lambda: header(b"P5", 4, 2, 65536) + bytes(16),
    "header_token_too_long": lambda: b"P5 12345678901 2 255\n" + bytes(8),
    "header_not_a_number": lambda: b"P6 4 2 2x5\n" + bytes(24),
    "header_cut_short": lambda: b"P5 4 2",
    "pf_scale_zero": lambda: header(b"Pf", 2, 2, b"0.0") + bytes(16),
    "pf_scale_infinite": lambda: header(b"Pf", 2, 2, b"inf") + bytes(16),
    "p6_truncated": lambda: _raw_case(b"P6", 3, 255, "p6tr")[:-5],
    "p5_maxval_100_truncated": lambda: _raw_case(b"P5", 1, 100, "tr")[:-1],
    "p1_invalid_token": lambda: header(b"P1", 3, 1) + b"0 1 2\n",
    "p1_too_few": lambda: header(b"P1", 3, 2) + b"0 1 0 1\n",
    "p2_value_past_maxval": lambda: header(b"P2", 2, 1, 10) + b"3 11\n",
    "p2_negative": lambda: header(b"P2", 2, 1, 10) + b"3 -1\n",
    "p2_token_too_long": lambda: header(b"P2", 2, 1, 10) + b"3 00000000001\n",
    "p2_not_a_number": lambda: header(b"P2", 2, 1, 10) + b"3 x\n",
    "p3_too_few": lambda: header(b"P3", 2, 2, 255) + b"1 2 3 4 5 6\n",
    "decompression_bomb": lambda: header(b"P5", 20000, 20000, 255) + bytes(9),
}
# files Image.open does not take as PPM
NEAR_MISSES = {
    "p7_pam": lambda: (b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                       b"TUPLTYPE GRAYSCALE\nENDHDR\n\x01\x02"),
    "capital_pf": lambda: header(b"PF", 2, 2, b"1.0") + bytes(48),
    "width_0": lambda: header(b"P5", 0, 2, 255),
    "height_negative": lambda: header(b"P5", 2, -2, 255) + bytes(4),
    "magic_run_on": lambda: b"P6800 600 255\n" + bytes(8),
}
# the files PIL's own encoder writes: name -> (mode, size, format)
PIL_CASES = {"pil_1": ("1", (19, 7), "PPM"), "pil_L": ("L", (19, 7), "PPM"),
             "pil_I": ("I", (19, 7), "PPM"),
             "pil_RGB": ("RGB", (19, 7), "PPM"),
             "pil_F": ("F", (19, 7), "PPM")}


def case_bytes(name: str) -> bytes:
    return {**CASES, **REFUSED_CASES}[name]()


def pil_source(name: str):
    from PIL import Image

    mode, (w, h), _ = PIL_CASES[name]
    v = samples(h, w, 1, 255, name)
    if mode == "I":
        return Image.fromarray((v * 251).astype(np.int32), "I")
    if mode == "F":
        return Image.fromarray(v.astype(np.float32) / 7 - 5, "F")
    img = Image.fromarray(samples(h, w, 3, 255, name).astype(np.uint8),
                          "RGB")
    return img.convert(mode)


# the 800x800 kinds chip_smoke.py times and trains on
def write_p6(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> a raw PPM (mode RGB, the same pixels)."""
    h, w = rgb.shape[:2]
    return header(b"P6", w, h, 255) + raw(rgb, 255)


def write_p5_16bit(gray: np.ndarray) -> bytes:
    """(H, W) uint16 -> a raw PGM of maxval 65535 (mode I, the values)."""
    h, w = gray.shape
    return header(b"P5", w, h, 65535) + raw(gray, 65535)


def digest(mode: str, arr: np.ndarray) -> dict:
    return {"mode": mode, "shape": list(arr.shape), "dtype": arr.dtype.str,
            "sha256": hashlib.sha256(np.ascontiguousarray(arr)
                                     .tobytes()).hexdigest()}


def fixture_name(name: str) -> str:
    ext = {"p1": "pbm", "p4": "pbm", "p2": "pgm", "p5": "pgm", "pf": "pfm"}
    return f"{name}.{ext.get(name[:2], 'ppm')}"


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
    for name, (_, _, fmt) in PIL_CASES.items():
        path = os.path.join(HERE, fixture_name(name))
        pil_source(name).save(path, fmt)
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
