"""K14: the port of tools/exp_interleave.py.

field_forward_v3u (replaces exp_interleave.py::field_forward_v3u) and
field_forward_v3i (replaces exp_interleave.py::field_forward_v3i) compute
the same function: K11's exact-sine IPE (ipe_enc) -> bf16 trunk ->
heads = h @ wh + bh over the unfolded (256, 384) heads -> the mid-MLP seed
bf16(bottleneck) @ w_emb + b_mid, plus sum_k exp(-softplus(rough) k)
g_band_k[row // S] for k in (1, 3, 10, 36) -> bf16(relu) -> the mid head
-> (N, 128) bf16, the V3_* columns 0:14 and zeros in 14:128.  v3u runs a
64-row tile with all 8 warps of a block; v3i runs it as two 32-row halves,
one warp group each, that never meet: the tool's question of whether two
independent halves let one half's elementwise tail run under the other's
products.  Their outputs are equal bit for bit.  Operands:
rsn_torch.kernels.field_forward.pack_params_v3 (22 tensors).

The wrappers run the plain version (field_forward_v3u_plain) for CPU
tensors and launch the CUDA kernel (rsn_torch/csrc/experiments.cu) for
CUDA tensors.

    python -m rsn_torch.experiments.interleave

times v3u, v3i and K1 (field_forward_v3, the shipped kernel, on K1's
folded operands) on the tool's rows (131,072 rows, 128 samples per ray),
on the card.
"""
from __future__ import annotations

import sys

import torch

from rsn_torch.kernels import field_forward as ff

BF16, F32 = torch.bfloat16, torch.float32
V3_OUT = 128   # the tool's output width: columns 0:14 live
# bf16 products per row: the trunk on the IPE's 99 live columns, the 267
# live head columns, the mid seed and the mid head's 3 columns
FLOPS_PER_ROW = 2 * (99 * 256 + 3 * 256 * 256 + (99 + 256) * 256
                     + 3 * 256 * 256 + 256 * 267 + 256 * 128 + 128 * 3)


def unfolded_tail(packed_v3, h: torch.Tensor, g_bands: torch.Tensor,
                  samples_per_ray: int, bneck: torch.Tensor = None):
    """The tools' _half after the trunk, from its last (N, 256) bf16
    activation h -> (heads (N, 384) f32 with their bias, the bf16
    bottleneck, the 4 band attenuations (N, 1), mid_pre (N, 128) f32, hmid
    (N, 128) bf16, mid (N, 3) f32).  bneck: a given (N, 256) bf16
    bottleneck in place of the one rounded from heads (a kernel's own, so
    that the masks of mid_pre > 0 follow the kernel's)."""
    wh, bh, w_emb, b_mid, w_out, b_out = packed_v3[16:]
    n, S = h.shape[0], samples_per_ray
    heads = h.float() @ wh.float() + bh
    if bneck is None:
        bneck = heads[:, ff.OUT_BOTTLENECK].to(BF16)
    rough_raw = heads[:, ff.OUT_ROUGH:ff.OUT_ROUGH + 1]
    rough_sp = torch.logaddexp(rough_raw, torch.zeros_like(rough_raw))
    attens = [torch.exp(-rough_sp * k) for k in ff._BAND_KS]
    mid_pre = (bneck.float() @ w_emb.float() + b_mid).reshape(n // S, S, 128)
    for bi, a in enumerate(attens):
        band = g_bands[:, None, bi * 128:(bi + 1) * 128]
        mid_pre = mid_pre + a.reshape(n // S, S, 1) * band
    mid_pre = mid_pre.reshape(n, 128)
    hmid = torch.relu(mid_pre).to(BF16)
    mid = torch.sigmoid(hmid.float() @ w_out.float() + b_out)[:, 0:3]
    return heads, bneck, attens, mid_pre, hmid, mid


def unfolded_forward_plain(packed_v3, x: torch.Tensor, g_bands: torch.Tensor,
                           samples_per_ray: int) -> torch.Tensor:
    """The tools' _half from the (N, 128) bf16 encoding x: trunk, unfolded
    heads, mid seed, attenuation, mid head -> (N, 128) bf16."""
    h = ff._trunk_plain(packed_v3[:8], packed_v3[8:16], x)
    heads, _, _, _, _, mid = unfolded_tail(packed_v3, h, g_bands,
                                           samples_per_ray)
    diff = torch.sigmoid(heads[:, ff.OUT_DIFF])
    tint = torch.sigmoid(heads[:, ff.OUT_TINT])
    zeros = torch.zeros(x.shape[0], V3_OUT - 14, device=x.device)
    return torch.cat([diff + tint * mid, diff, tint,
                      heads[:, ff.OUT_NORMALS],
                      heads[:, ff.OUT_DENSITY:ff.OUT_DENSITY + 1],
                      heads[:, ff.OUT_ROUGH:ff.OUT_ROUGH + 1], zeros],
                     dim=1).to(BF16)


def field_forward_v3u_plain(packed_v3, mean_cov: torch.Tensor,
                            g_bands: torch.Tensor,
                            samples_per_ray: int) -> torch.Tensor:
    """Plain PyTorch K14 (v3u and v3i): the exact-sine IPE, then
    unfolded_forward_plain."""
    return unfolded_forward_plain(packed_v3, ff.ipe_enc(mean_cov), g_bands,
                                  samples_per_ray)


def launch_forward(name: str, entry: str, plain, packed_v3,
                   mean_cov: torch.Tensor, g_bands: torch.Tensor,
                   samples_per_ray: int, *flags: int) -> torch.Tensor:
    """K14's and K15's wrapper: check (N, 16) f32 mean_cov, (R, 512) f32
    g_bands with N = R * S and the 22 operands; the plain version for CPU
    tensors, the CUDA kernel `entry` for CUDA tensors -> (N, 128) bf16."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    S = int(samples_per_ray)
    if S <= 0 or n == 0 or n % S:
        raise ValueError(f"{n} rows is not a positive multiple of S={S}")
    ff._check("mean_cov", mean_cov, (n, ff.IN_COLS), F32, device)
    ff._check("g_bands", g_bands, (n // S, 512), F32, device)
    ff._check_packed(packed_v3, ff.V3U_SHAPES, ff.V3U_DTYPES, device)
    if device.type == "cpu":
        return plain(packed_v3, mean_cov, g_bands, S)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library("experiments.cu")
    out = torch.empty((n, V3_OUT), dtype=BF16, device=device)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            ff._ipe_consts(device).data_ptr(), ff._ptr_array(packed_v3),
            out.data_ptr(), n, S, *flags,
            torch.cuda.current_stream().cuda_stream)
    ff._raise_on_error(lib, rc, name)
    ff.LAUNCHES[name] += 1
    return out


def field_forward_v3u(packed_v3, mean_cov: torch.Tensor,
                      g_bands: torch.Tensor,
                      samples_per_ray: int) -> torch.Tensor:
    """K14, the whole tile: (N, 16) f32 + (R, 512) f32 -> (N, 128) bf16."""
    return launch_forward("field_forward_v3u", "rsn_field_forward_v3u",
                          field_forward_v3u_plain, packed_v3, mean_cov,
                          g_bands, samples_per_ray)


def field_forward_v3i(packed_v3, mean_cov: torch.Tensor,
                      g_bands: torch.Tensor,
                      samples_per_ray: int) -> torch.Tensor:
    """K14 as two independent halves: the same function as v3u, the same
    bits on the card."""
    return launch_forward("field_forward_v3i", "rsn_field_forward_v3i",
                          field_forward_v3u_plain, packed_v3, mean_cov,
                          g_bands, samples_per_ray)


def tool_inputs(n: int, samples_per_ray: int = 128, seed: int = 1):
    """The tools' rows on the card: a field from seed 0, means normal x 0.5,
    covariances |normal| x 1e-2, unit ray directions -> (field, (N, 16) f32
    mean_cov, (R, 512) f32 g_bands)."""
    from rsn_torch.cli.run_io import entry_device
    from rsn_torch.models.field import Field

    device = entry_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    field = Field(torch.Generator().manual_seed(0)).to(device).eval()
    gen = torch.Generator(device).manual_seed(seed)
    mc = torch.zeros(n, ff.IN_COLS, device=device)
    mc[:, 0:3] = torch.randn(n, 3, generator=gen, device=device) * 0.5
    mc[:, 3:6] = torch.randn(n, 3, generator=gen, device=device).abs() * 1e-2
    d = torch.randn(n // samples_per_ray, 3, generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    return field, mc, ff.mid_g_bands(field, d)


def report(name: str, ms: float, n: int, err: float, against: str) -> None:
    print(f"{name:4}: {ms:8.4f} ms ({n * FLOPS_PER_ROW / ms / 1e9:6.1f} "
          f"TFLOP/s) max |err| {err:.3e} against {against} on columns "
          f"0:14", flush=True)


def main(argv=None) -> int:
    """v3u, v3i and K1 on the tool's rows: ms (median of 10 CUDA-event
    captures), TFLOP/s, and agreement (v3i against v3u bit for bit, K1 on
    columns 0:14)."""
    from rsn_torch.utils.timing import time_kernel

    n, S = 131072, 128
    field, mc, g = tool_inputs(n, S)
    p3, p1 = ff.pack_params_v3(field), ff.pack_params_v3f(field)
    print(torch.cuda.get_device_name(0), flush=True)
    ref = field_forward_v3u(p3, mc, g, S)
    for name, fn, args in (
            ("v3u", field_forward_v3u, (p3, mc, g, S)),
            ("v3i", field_forward_v3i, (p3, mc, g, S)),
            ("K1", ff.field_forward_v3, (p1, mc, g, S))):
        out = fn(*args)
        err = float((out[:, :14].float() - ref[:, :14].float()).abs().max())
        report(name, time_kernel(fn, *args), n, err, "v3u")
    return 0


if __name__ == "__main__":
    sys.exit(main())
