"""K16: the port of tools/exp_cheap_sin.py.

`run(mode, x)` (replaces exp_cheap_sin.py::run) applies one elementwise
mode to an (N, 128) f32 tensor -> (N, 128) f32, the tool's micro-benchmark
of what the IPE's sine costs:

  copy        t * 2
  exact       sin(t * f32(2 pi)), full range reduction
  poly        sin(2 pi u), u = t - round(t): the odd degree-9 polynomial
              (the tool's Taylor coefficients, 7.7e-3 from sin near
              u = 1/2; rsn's K1 sine is another, accurate polynomial)
  exp         exp(-|t| / 2)
  exp2        exp2(-0.72134752 |t|)
  exp2_ldexp  the same by a degree-4 polynomial of the fraction and the
              exponent bits of the integer part
  poly_bf16   the wrapped-phase sine polynomial with every product and sum
              rounded to bf16
  cos_poly    cos(2 pi u) by an even polynomial

with the tool's coefficients; round is round-half-to-even, as jnp.round.
The wrapper runs the plain version (run_plain) for a CPU tensor and
launches the CUDA kernel (rsn_torch/csrc/experiments.cu, one template
instance per mode) for a CUDA tensor.

    python -m rsn_torch.experiments.cheap_sin

times every mode on the tool's input (131,072 x 128, normal x 2^(col mod
16)) on the card and prints the poly mode's error against float64 numpy.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from rsn_torch.kernels import field_forward as ff

MODES = ff.CHEAP_SIN_MODES
TWO_PI = 2.0 * np.pi
_LOG2_HALF_E = 0.72134752  # 0.5 / ln 2, the tool's constant
_POLY_BF16 = (-12.2688402, 41.2037313, -76.5796851, 81.5961385, -41.3414194,
              6.28318279)


def sin2pi_poly(u: torch.Tensor) -> torch.Tensor:
    """sin(2 pi u) for u in [-1/2, 1/2): the tool's odd polynomial in u,
    w = u * u."""
    w = u * u
    return u * (6.2831852 + w * (-41.341663 + w * (
        81.602455 + w * (-76.581304 + w * 42.008881))))


def _wrapped(t: torch.Tensor) -> torch.Tensor:
    return t - torch.round(t)


def run_plain(mode: str, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K16: the tool's expression of `mode`, op by op."""
    if mode == "copy":
        return x * 2.0
    if mode == "exact":
        return torch.sin(x * TWO_PI)
    if mode == "poly":
        return sin2pi_poly(_wrapped(x))
    if mode == "exp":
        return torch.exp(-0.5 * x.abs())
    if mode == "exp2":
        return torch.exp2(-_LOG2_HALF_E * x.abs())
    if mode == "exp2_ldexp":
        u = torch.clamp_min(-_LOG2_HALF_E * x.abs(), -126.0)
        i = torch.floor(u)
        f = u - i
        p = 1.0 + f * (0.69314718 + f * (0.24022650 + f * (
            0.05550411 + f * 0.00961813)))
        biased = torch.bitwise_left_shift(i.to(torch.int32) + 127, 23)
        return biased.view(torch.float32) * p
    if mode == "poly_bf16":
        ub = _wrapped(x).to(torch.bfloat16)
        w = ub * ub
        c = [torch.tensor(v, dtype=torch.bfloat16, device=x.device)
             for v in _POLY_BF16]
        p = c[0]
        for cb in c[1:]:
            p = p * w + cb
        return (p * ub).float()
    if mode == "cos_poly":
        u = _wrapped(x)
        w = u * u
        return 0.9999999 + w * (-19.739206 + w * (64.939394 + w * (
            -85.474136 + w * (60.244179 - w * 27.06042))))
    raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (the smallest normal's below it): the
    limit of poly_bf16, whose last rounding may fall either side."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def run(mode: str, x: torch.Tensor) -> torch.Tensor:
    """K16: (N, 128) f32 -> (N, 128) f32 under `mode`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    device = x.device
    n = x.shape[0]
    if n == 0:
        raise ValueError("cheap_sin: empty input")
    ff._check("x", x, (n, 128), torch.float32, device)
    if device.type == "cpu":
        return run_plain(mode, x)
    if device.type != "cuda":
        raise ValueError(f"cheap_sin: unsupported device {device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library("experiments.cu")
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        rc = lib.rsn_cheap_sin(x.data_ptr(), out.data_ptr(), n,
                               MODES.index(mode),
                               torch.cuda.current_stream().cuda_stream)
    name = f"cheap_sin_{mode}"
    ff._raise_on_error(lib, rc, name)
    ff.LAUNCHES[name] += 1
    return out


def tool_input(n: int, device, seed: int = 0) -> torch.Tensor:
    """The tool's IPE-scale arguments: normal x 2^(col mod 16), (n, 128)
    f32, from a seeded generator on `device`."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(n, 128, generator=gen, device=device)
    return x * torch.exp2(torch.arange(128, device=device) % 16).float()


def main(argv=None) -> int:
    """Each mode's ms on the tool's input (median of 10 CUDA-event
    captures), then poly and the fp32 exact sine against float64 numpy on
    the first 1024 rows."""
    from rsn_torch.cli.run_io import entry_device
    from rsn_torch.utils.timing import time_kernel

    device = entry_device()
    x = tool_input(131072, device)
    print(torch.cuda.get_device_name(0), flush=True)
    for mode in MODES:
        print(f"{mode:10}: {time_kernel(run, mode, x):8.4f} ms", flush=True)
    xs = x[:1024]
    exact = np.sin(TWO_PI * xs.cpu().double().numpy())
    poly = run("poly", xs).cpu().double().numpy()
    exact32 = run("exact", xs).cpu().double().numpy()
    print(f"poly max abs err vs f64 sin: {np.abs(poly - exact).max():.2e} "
          f"(bf16 eps ~ 7.8e-3)")
    print(f"fp32-exact-sin vs f64: {np.abs(exact32 - exact).max():.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
