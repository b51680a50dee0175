"""K18: the port of tools/exp_bwd_ablate.py.

run (replaces exp_bwd_ablate.py::run, kernel make_kernel, body _half) is
the unfolded recompute backward on pack_params_v3's 22 operands: K1's
polynomial IPE of (N, 16) f32 mean_cov, the bf16 trunk, the unfolded
(256, 384) heads with the 256-wide bottleneck, the mid seed
bf16(bottleneck) @ w_emb + b_mid plus the roughness-attenuated per-ray SH
band partials g_bands (R, 512) f32, the mid head, all recomputed; then the
backward against d_out (N, 128) bf16 (columns 0:14 live, in the V3_*
order) in one of the tool's four modes:

    ("full", True)         dmc (N, 16), dg (R, 512), the 22 fp32 weight
                           gradients;
    ("full", False)        dmc and dg; the weight gradients are not
                           computed (the tool computes and drops them,
                           which XLA removes);
    ("no_ipe_bwd", False)  dg and dmc = dx[:, 0:16], the encoding
                           gradient's first columns (no IPE backward);
    ("recompute", False)   the forward only: dmc[:, 0] = mid[:, 0] + the
                           density pre-activation, the rest 0, dg = 0.

It returns (dmc, dg, dpacked), dpacked the 22 gradients summed over the
blocks in pack_params_v3's order and shapes, or None.  The roughness ->
attenuation edge carries no gradient; the bias gradients sum the fp32
cotangents, not the bf16 ones.  The wrapper runs the plain version
(bwd_ablate_plain) for CPU tensors and launches the CUDA kernel
(rsn_torch/csrc/experiments_bwd.cu) for CUDA tensors.

    python -m rsn_torch.experiments.bwd_ablate

times the four modes on the tool's rows (131,072 rows, 128 samples per
ray) on the card, with TFLOP/s of the tool's 3x count.
"""
from __future__ import annotations

import sys

import torch

from rsn_torch.experiments.interleave import unfolded_tail
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as ft
from rsn_torch.models.field import SKIP_AT, TRUNK_LAYERS

BF16, F32 = torch.bfloat16, torch.float32
D_OUT_COLS = 128  # the tools' V3_OUT cotangent width: columns 0:14 live
# the tool's (mode, use_wgrad) variants, in its order -> the kernel's mode
# (experiments_bwd.cu Mode)
MODE_CODES = {("full", True): 0, ("full", False): 1, ("no_ipe_bwd", False): 2,
              ("recompute", False): 3}
VARIANTS = tuple(MODE_CODES)
PACK_FLOATS = sum(r * c for r, c in ff.V3U_SHAPES)  # 674432
# the tools' per-row FLOP count (exp_bwd_ablate.py: 3x of 1.343e6)
TOOL_FLOPS_PER_ROW = 1.343e6


def label(mode: str, use_wgrad: bool) -> str:
    """The launch-count label of a variant: bwd_ablate_<mode>[_wgrad]."""
    if (mode, bool(use_wgrad)) not in VARIANTS:
        raise ValueError(f"unknown mode {mode!r} (use_wgrad={use_wgrad}): "
                         f"one of {VARIANTS}")
    return f"bwd_ablate_{mode}" + ("_wgrad" if use_wgrad else "")


def backward_from_acts(packed_v3, hs, x: torch.Tensor, g_bands: torch.Tensor,
                       d_out: torch.Tensor, samples_per_ray: int,
                       mode: str = "full", use_wgrad: bool = True,
                       mean_cov: torch.Tensor = None):
    """The tools' _half after the trunk recompute, from the 8 post-ReLU
    (N, 256) bf16 activations hs and the (N, 128) bf16 encoding x
    -> (dmc (N, 16) or None, dg (R, 512), dpacked (22) or None).
    mean_cov None: no IPE backward and no layer-0 dgrad (K19)."""
    ws = packed_v3[:8]
    wh, _, w_emb, _, w_out, _ = packed_v3[16:]
    n, S = x.shape[0], samples_per_ray
    dev = x.device
    wgrad = use_wgrad and mode == "full"
    dpk = [None] * len(ff.V3U_SHAPES)
    heads, bneck, attens, mid_pre, hmid, mid = unfolded_tail(
        packed_v3, hs[-1], g_bands, S)
    if mode == "recompute":
        dmc = torch.zeros(n, ff.IN_COLS, device=dev)
        dmc[:, 0] = mid[:, 0] + heads[:, ff.OUT_DENSITY]
        return dmc, torch.zeros(n // S, 512, device=dev), None

    dout = d_out.float()
    diff = torch.sigmoid(heads[:, ff.OUT_DIFF])
    tint = torch.sigmoid(heads[:, ff.OUT_TINT])
    dmid_out = dout[:, 0:3]
    ddiff = dmid_out + dout[:, 3:6]
    dtint = dmid_out * mid + dout[:, 6:9]
    dz3 = dmid_out * tint * mid * (1.0 - mid)
    dz_b = dz3.to(BF16).float()
    if wgrad:
        dpk[20] = torch.zeros(128, 128, device=dev)
        dpk[20][:, 0:3] = hmid.float().t() @ dz_b
        dpk[21] = torch.zeros(1, 128, device=dev)
        dpk[21][0, 0:3] = dz3.sum(dim=0)
    dmid_pre = (dz_b @ w_out[:, 0:3].float().t()) * (mid_pre > 0)
    dmid_pre_b = dmid_pre.to(BF16).float()
    if wgrad:
        dpk[18] = bneck.float().t() @ dmid_pre_b
        dpk[19] = dmid_pre.sum(dim=0, keepdim=True)
    dbneck = dmid_pre_b @ w_emb.float().t()
    # the roughness -> attenuation edge carries no gradient
    dg = torch.cat([a * dmid_pre for a in attens], dim=1).reshape(
        n // S, S, 512).sum(dim=1)

    d_heads = torch.cat([dbneck, dout[:, 12:13], ddiff * diff * (1.0 - diff),
                         dtint * tint * (1.0 - tint), dout[:, 13:14],
                         dout[:, 9:12],
                         torch.zeros(n, ff.OUT_DIM - ff.N_HEAD_COLS,
                                     device=dev)], dim=1)
    d_heads_b = d_heads.to(BF16).float()
    if wgrad:
        dpk[16] = hs[-1].float().t() @ d_heads_b
        dpk[17] = d_heads.sum(dim=0, keepdim=True)
    dh = d_heads_b @ wh.float().t()
    dx_extra = None
    for i in range(TRUNK_LAYERS - 1, -1, -1):
        inp = hs[i - 1] if i > 0 else x
        if i == SKIP_AT:
            inp = torch.cat([x, hs[i - 1]], dim=1)
        dpre_f = dh * (hs[i].float() > 0)
        dpre = dpre_f.to(BF16).float()
        if wgrad:
            dpk[i] = inp.float().t() @ dpre
            dpk[8 + i] = dpre_f.sum(dim=0, keepdim=True)
        if i == 0 and mean_cov is None:
            break  # layer 0's dgrad feeds only the (absent) IPE backward
        dinp = dpre @ ws[i].float().t()
        if i == SKIP_AT:
            dx_extra, dh = dinp[:, :ff.ENC_PAD], dinp[:, ff.ENC_PAD:]
        else:
            dh = dinp
    dpacked = tuple(dpk) if wgrad else None
    if mean_cov is None:
        return None, dg, dpacked
    dx = dh + dx_extra
    if mode == "no_ipe_bwd":
        return dx[:, 0:ff.IN_COLS].contiguous(), dg, dpacked
    dmean, dvar = ft._dmean_dvar(dx, mean_cov, want_var=True)
    dmc = torch.cat([dmean, dvar, torch.zeros(n, ff.IN_COLS - 6, device=dev)],
                    dim=1)
    return dmc, dg, dpacked


def bwd_ablate_plain(packed_v3, mean_cov: torch.Tensor,
                     g_bands: torch.Tensor, d_out: torch.Tensor,
                     samples_per_ray: int, mode: str = "full",
                     use_wgrad: bool = True):
    """Plain PyTorch K18: K1's IPE and the trunk recomputed from mean_cov,
    then backward_from_acts."""
    x = ff.ipe_x(mean_cov)
    hs = ft._trunk_acts(packed_v3[:8], packed_v3[8:16], x)
    return backward_from_acts(packed_v3, hs, x, g_bands, d_out,
                              samples_per_ray, mode, use_wgrad, mean_cov)


def unpack_slices(buf: torch.Tensor):
    """(blocks, 674432) per-block gradients -> the 22 gradients summed over
    the blocks, as views in pack_params_v3's shapes."""
    return ft._packed_views(buf.sum(dim=0), ff.V3U_SHAPES)


def check_backward_inputs(name: str, packed_v3, g_bands: torch.Tensor,
                          d_out: torch.Tensor, samples_per_ray: int) -> int:
    """K18's and K19's shared checks -> R; raises ValueError on rows that
    are not a positive multiple of S, a wrong operand count or shape, or a
    device that is neither the CPU nor CUDA."""
    device, n = d_out.device, d_out.shape[0]
    R = ft._rows(n, int(samples_per_ray), name)
    ff._check("g_bands", g_bands, (R, 512), F32, device)
    ff._check("d_out", d_out, (n, D_OUT_COLS), BF16, device)
    ff._check_packed(packed_v3, ff.V3U_SHAPES, ff.V3U_DTYPES, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return R


def run(mode: str, use_wgrad: bool, packed_v3, mean_cov: torch.Tensor,
        g_bands: torch.Tensor, d_out: torch.Tensor, samples_per_ray: int):
    """K18 in one mode: -> (dmc (N, 16) f32, dg (R, 512) f32, the 22
    weight gradients or None)."""
    name = label(mode, use_wgrad)
    S = int(samples_per_ray)
    R = check_backward_inputs(name, packed_v3, g_bands, d_out, S)
    device, n = d_out.device, d_out.shape[0]
    ff._check("mean_cov", mean_cov, (n, ff.IN_COLS), F32, device)
    if device.type == "cpu":
        return bwd_ablate_plain(packed_v3, mean_cov, g_bands, d_out, S, mode,
                                use_wgrad)
    from rsn_torch.kernels.build import load_library

    lib = load_library("experiments_bwd.cu")
    rpb = ft._rays_per_block(R, device, 1)
    blocks = -(-R // rpb)
    dmc = torch.empty((n, ff.IN_COLS), dtype=F32, device=device)
    dg = torch.zeros((R, 512), dtype=F32, device=device)
    buf = (torch.zeros((blocks, PACK_FLOATS), dtype=F32, device=device)
           if use_wgrad else None)
    ws = torch.empty((blocks, ft.TILE_ROWS, ft.ACTS_COLS), dtype=BF16,
                     device=device)
    code = MODE_CODES[mode, bool(use_wgrad)]
    with torch.cuda.device(device):
        rc = lib.rsn_bwd_ablate(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            ff._ipe_consts(device).data_ptr(), d_out.data_ptr(),
            ff._ptr_array(packed_v3), dmc.data_ptr(), dg.data_ptr(),
            None if buf is None else buf.data_ptr(), ws.data_ptr(), R, S,
            rpb, code, torch.cuda.current_stream().cuda_stream)
    ff._raise_on_error(lib, rc, name)
    ff.LAUNCHES[name] += 1
    return dmc, dg, None if buf is None else unpack_slices(buf)


def tool_cotangent(n: int, device, seed: int = 2) -> torch.Tensor:
    """The tools' d_out: (N, 128) standard normal, bf16, from a seeded
    generator on `device`."""
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(n, D_OUT_COLS, generator=gen,
                       device=device).to(BF16)


def main(argv=None) -> int:
    """The four modes on the tool's rows: ms (median of 10 CUDA-event
    captures) and TFLOP/s of the tool's 3x count."""
    from rsn_torch.experiments.interleave import tool_inputs
    from rsn_torch.utils.timing import time_kernel

    n, S = 131072, 128
    field, mc, g = tool_inputs(n, S)
    p3 = ff.pack_params_v3(field)
    d_out = tool_cotangent(n, mc.device)
    print(torch.cuda.get_device_name(0), flush=True)
    for mode, wg in VARIANTS:
        ms = time_kernel(run, mode, wg, p3, mc, g, d_out, S)
        tag = mode + ("+wgrad" if wg else "")
        print(f"{tag:20}: {ms:8.4f} ms ({3 * n * TOOL_FLOPS_PER_ROW / ms / 1e9:6.1f}"
              f" TFLOP/s of 3x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
