"""Integrated positional encoding and integrated SH (port of
rsn.core.encodings).  The SH coefficient table is rsn's own
(`rsn.core._sh_table`, jax-free); `sh_l8_m7_2x` keeps the reference's
doubled l=8 m=+-7 coefficients (SURVEY.md B#1)."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rsn_torch.core import _sh_table

NUM_FREQUENCIES = 16
MIN_FREQ_EXP = 0.0
MAX_FREQ_EXP = 16.0
IPE_OUT_DIM = 3 * 2 * NUM_FREQUENCIES + 3  # 99
ISH_OUT_DIM = 34

# per-band attenuation exponents l(l+1)/2 for l in {1, 2, 4, 8}
_BAND_SLICES = ((0, 3, 1.0), (3, 8, 3.0), (8, 17, 10.0), (17, 34, 36.0))


@functools.lru_cache(maxsize=8)
def _freqs_np(num: int, max_exp: float) -> np.ndarray:
    """2 ** linspace(0, max_exp, num) with rsn's exact fp32 values: the
    exponents as XLA makes jnp.linspace's in fp32
    (max_exp * (i * f32(1 / (num - 1)))), the power correctly rounded.  torch's linspace and fp32 pow differ
    by a few ulps at the top octaves, where one ulp of the frequency moves
    the sine's phase by ~0.1 rad."""
    step = np.arange(num - 1, dtype=np.float32) * np.float32(1.0 / (num - 1))
    lin = np.append(np.float32(max_exp) * step, np.float32(max_exp))
    return (2.0 ** lin.astype(np.float64)).astype(np.float32)


def _freqs(device=None, num: int = NUM_FREQUENCIES,
           max_exp: float = MAX_FREQ_EXP) -> torch.Tensor:
    return torch.as_tensor(_freqs_np(num, max_exp), device=device)


def ipe_encode(mean: torch.Tensor, cov_diag: torch.Tensor | None = None,
               num_freqs: int = NUM_FREQUENCIES,
               max_freq_exp: float = MAX_FREQ_EXP) -> torch.Tensor:
    """(..., 3) mean [+ (..., 3) cov diagonal] -> (..., 6F + 3)
    [sin terms | cos terms | mean], dim-major over frequencies; the
    variance is not (2 pi)^2-scaled (nerfstudio quirk)."""
    freqs = _freqs(mean.device, num_freqs, max_freq_exp)
    scaled = (2.0 * math.pi * mean)[..., None] * freqs
    scaled = scaled.reshape(*scaled.shape[:-2], -1)
    both = torch.cat([scaled, scaled + math.pi / 2.0], dim=-1)
    # the arguments reach ~1e6 rad; torch's fp32 sin loses ~1e-4 there
    sin = torch.sin(both.double()).float()
    if cov_diag is None:
        enc = sin
    else:
        var = (cov_diag[..., None] * freqs ** 2).reshape(*both.shape[:-1], -1)
        var = torch.cat([var, var], dim=-1)
        enc = torch.exp(-0.5 * var) * sin
    return torch.cat([enc, mean], dim=-1)


@functools.lru_cache(maxsize=4)
def _sh_tables(sh_l8_m7_2x: bool):
    monomials = np.array(_sh_table.MONOMIALS, dtype=np.int32)  # (M, 3)
    coeffs = np.array(_sh_table.COEFFS, dtype=np.float32)      # (M, 34)
    if sh_l8_m7_2x:
        coeffs = coeffs.copy()
        for ci, (l, m) in enumerate(_sh_table.COMPONENTS):
            if l == 8 and abs(m) == 7:
                coeffs[:, ci] *= 2.0
    return monomials.tolist(), coeffs


def sh_basis(directions: torch.Tensor,
             sh_l8_m7_2x: bool = True) -> torch.Tensor:
    """Real SH levels {1, 2, 4, 8} on unit directions -> (..., 34), as
    monomial features x^a y^b z^c times the coefficient table."""
    monomials, coeffs = _sh_tables(sh_l8_m7_2x)
    d = directions.detach()
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xp, yp, zp = [torch.ones_like(x)], [torch.ones_like(y)], [torch.ones_like(z)]
    for _ in range(8):
        xp.append(xp[-1] * x)
        yp.append(yp[-1] * y)
        zp.append(zp[-1] * z)
    feats = torch.stack([xp[a] * yp[b] * zp[c] for a, b, c in monomials],
                        dim=-1)
    return feats @ torch.as_tensor(coeffs, device=d.device)


def _band_attenuation(roughness: torch.Tensor) -> torch.Tensor:
    """exp(-roughness * k_l) broadcast over the 34 components."""
    ks = torch.zeros(ISH_OUT_DIM, device=roughness.device)
    for lo, hi, k in _BAND_SLICES:
        ks[lo:hi] = k
    return torch.exp(-roughness * ks)


def ish_encode(directions: torch.Tensor, roughness: torch.Tensor,
               sh_l8_m7_2x: bool = True) -> torch.Tensor:
    """Roughness-attenuated SH encoding: (..., 3), (..., 1) -> (..., 34)."""
    return sh_basis(directions, sh_l8_m7_2x) * _band_attenuation(roughness)
