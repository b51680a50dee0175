"""The render path's field kernels and the field API's, their packed
operands and their plain PyTorch versions (port of the eval half of
rsn/kernels/field_pallas.py).

K1 `field_forward_v3` (replaces field_pallas.py::field_forward_v3):
IPE -> bf16 trunk 8x256 (skip at 4) -> one (256, 256) product giving the
11 head columns and the folded mid-MLP seed -> roughness attenuation
against the per-ray SH band partials -> mid head -> mid_out.
Output (N, 16) bf16 in the V3_* column layout.

K2 `field_forward_density` (replaces field_pallas.py::
field_forward_density): IPE -> trunk -> density column only.  Output
(N, 8) bf16, column 0 bit-identical to K1's V3_DENSITY column (the two
kernels share the device routines that produce it).

K1 and K2 run on Hopper's wgmma with their weights streamed from a blob
that trunk_sm90.pack_blob pre-packs once per packed tuple
(PackedOperands); the tuples themselves keep the 20 / 18 operands.

K11 `field_forward_v2` (replaces field_pallas.py::field_forward_v2): the
IPE with exact sin and exp (rsn's _ipe_in_kernel, not K1's polynomial) ->
trunk -> one (256, 384) product for every head, the 256-wide bottleneck
included.  Output (N, 384) bf16 in the OUT_* columns (267 live, the rest
zero); the field's kernel route (Field.get_field_outputs with use_pallas
and not differentiable).

K12 `field_forward` (replaces field_pallas.py::field_forward): K11 from a
precomputed (N, 128) bf16 encoding, no IPE.

K11 and K12 run on K1's Hopper block with their weights streamed from a
blob (unfolded_sm90.pack_heads_blob: the trunk, wh's head columns and its
bottleneck) packed once per pack_params tuple (heads_blob).

Each wrapper checks its inputs, runs the plain version for CPU tensors
and launches the CUDA kernel (rsn_torch/csrc/field_forward.cu) for CUDA
tensors; it never falls back from one to the other.  `LAUNCHES` counts
kernel launches per wrapper (of this module and of field_train.py).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rsn_torch.core.encodings import _BAND_SLICES, IPE_OUT_DIM, sh_basis
from rsn_torch.kernels import trunk_sm90, unfolded_sm90
from rsn_torch.models.field import SKIP_AT, TRUNK_LAYERS, TRUNK_WIDTH, Field

BF16 = torch.bfloat16
F32 = torch.float32

IN_COLS = 16     # kernel input rows: [mean(3) | cov_diag(3) | 0 ...]
ENC_PAD = 128    # trunk input width: IPE(99) zero-padded
SKIP_PAD = ENC_PAD + TRUNK_WIDTH  # 384

# K1 eval output columns (field_pallas.V3_*)
V3_EVAL_COLS = 16
V3_MID = slice(0, 3)
V3_DIFF = slice(3, 6)
V3_TINT = slice(6, 9)
V3_NORMALS = slice(9, 12)
V3_DENSITY = 12
V3_ROUGH = 13
DENS_COLS = 8    # K2 output: col 0 = density pre-activation

# K11 / K12 output columns (field_pallas.OUT_*): the bottleneck, then the
# raw heads; [267, 384) zero
OUT_DIM = 384
OUT_BOTTLENECK = slice(0, 256)
OUT_DENSITY = 256
OUT_DIFF = slice(257, 260)
OUT_TINT = slice(260, 263)
OUT_ROUGH = 263
OUT_NORMALS = slice(264, 267)
N_HEAD_COLS = 267

# head columns of the fused (256, 256) heads+mid product (field_pallas.FH_*)
FH_DIFF = slice(1, 4)
FH_TINT = slice(4, 7)
FH_ROUGH = 7
FH_NORMALS = slice(8, 11)
FH_COLS = 11
_BAND_KS = (1.0, 3.0, 10.0, 36.0)

# IPE constants, exactly the values of field_pallas.ipe_matrices():
# sin argument 2 pi f_k mean_d (+ pi/2 on the cos half), damping
# exp(-f_k^2 var_d / 2) (variance not (2 pi)^2-scaled: nerfstudio quirk)
_FREQS = 2.0 ** np.linspace(0.0, 16.0, 16)
IPE_SCALE = (2.0 * np.pi * _FREQS).astype(np.float32)
IPE_VAR = (_FREQS ** 2).astype(np.float32)
_HALF_PI = float(np.float32(np.pi / 2.0))
_INV_2PI = 0.15915494309189535
_HALF_LOG2E = 0.7213475204444817  # 0.5 / ln 2

# launches per kernel wrapper, for every kernel of the port (the training
# kernels' wrappers live in field_train.py, the proposal's in
# proposal_forward.py)
LAUNCHES = {"field_forward_v3": 0, "field_forward_density": 0,
            "field_forward_v6": 0, "field_backward_v5": 0,
            "field_backward_v6": 0, "field_forward_v4": 0,
            "field_forward_v3_train": 0, "field_backward_v4": 0,
            "field_backward_v4_wgrad": 0, "prop_forward": 0,
            "field_forward_v2": 0, "field_forward": 0,
            "field_forward_v5": 0, "field_backward_v3": 0,
            "field_forward_v3u": 0, "field_forward_v3i": 0,
            "field_forward_v3L": 0, "field_forward_v3F": 0,
            "field_backward_whole": 0, "run_noipe": 0, "train_blob": 0,
            "bwd_unfolded_wgrad": 0}
# K13 (field_backward_v3) and K17 (field_backward_whole) count their kernel
# A once per chunk under their own names, their kernel B (K8's) under these,
# and K13 its sum launch
LAUNCHES.update({"field_backward_v3_wgrad": 0, "field_backward_v3_sum": 0,
                 "field_backward_whole_wgrad": 0})
# K18's four modes (rsn_torch.experiments.bwd_ablate), one count each (full
# + wgrad and K19 run_noipe: their kernel A, once per chunk; their kernel B
# counts as bwd_unfolded_wgrad; full's and no_ipe_bwd's body, after kernel
# F, which counts as bwd_ablate_spill)
LAUNCHES.update({f"bwd_ablate_{m}": 0 for m in (
    "full_wgrad", "full", "no_ipe_bwd", "recompute", "spill")})
# K16's modes (rsn_torch.experiments.cheap_sin), one count each
CHEAP_SIN_MODES = ("copy", "exact", "poly", "exp", "exp2", "exp2_ldexp",
                   "poly_bf16", "cos_poly")
LAUNCHES.update({f"cheap_sin_{m}": 0 for m in CHEAP_SIN_MODES})


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- packed operands ------------------------------------------------------

def _w_in_out(layer: torch.nn.Linear) -> torch.Tensor:
    return layer.weight.t().float()


def _trunk_operands(field: Field):
    """fp32 trunk weights (in, out) with the IPE rows zero-padded 99 ->
    128 (layer 4: [enc(128) | h(256)] rows), fp32 (1, 256) biases;
    differentiable in the Field's parameters."""
    ws, bs = [], []
    for i, layer in enumerate(field.mlp_base.layers):
        w = _w_in_out(layer)
        if i == 0 or i == SKIP_AT:
            w = torch.cat([F.pad(w[:IPE_OUT_DIM],
                                 (0, 0, 0, ENC_PAD - IPE_OUT_DIM)),
                           w[IPE_OUT_DIM:]], dim=0)
        ws.append(w)
        bs.append(layer.bias.float().reshape(1, -1))
    return ws, bs


# the bf16 operands of the packings (the rest are fp32 biases and rows)
V3F_BF16 = tuple(range(8)) + (16, 18)


def pack_params_v3f_f32(field: Field) -> Tuple[torch.Tensor, ...]:
    """pack_params_v3f's operands before their bf16 cast, all fp32 and
    differentiable in the Field's parameters: the training path packs
    under autograd, so the chain rule through the padding and through
    w_comb = W_bneck @ W_emb (rsn's _unpack_grads) comes from autograd."""
    ws, bs = _trunk_operands(field)
    heads = (field.field_output_density, field.field_output_diff,
             field.field_output_tint, field.field_output_roughness,
             field.field_output_normals)
    whs = torch.cat([_w_in_out(h.net) for h in heads], dim=1)  # (256, 11)
    bhs = torch.cat([h.net.bias.float() for h in heads])
    whs = F.pad(whs, (0, 128 - FH_COLS))
    bhs = F.pad(bhs, (0, 128 - FH_COLS)).reshape(1, -1)
    wb = _w_in_out(field.field_output_bottleneck.net)            # (256, 256)
    bb = field.field_output_bottleneck.net.bias.float()
    _, w_emb, b_mid = field.mid_weights()
    w_emb, b_mid = w_emb.float(), b_mid.float()
    w_comb = wb @ w_emb
    b_comb = (bb @ w_emb + b_mid).reshape(1, -1)
    w_hc = torch.cat([whs, w_comb], dim=1)
    b_hc = torch.cat([bhs, b_comb], dim=1)
    w_out = F.pad(_w_in_out(field.field_output_mid.net), (0, 125))
    b_out = F.pad(field.field_output_mid.net.bias.float(),
                  (0, 125)).reshape(1, -1)
    return tuple(ws) + tuple(bs) + (w_hc, b_hc, w_out, b_out)


def cast_packed(packed_f32) -> Tuple[torch.Tensor, ...]:
    """The kernels' operands from pack_params_v3f_f32's: weights bf16,
    biases fp32, all contiguous and detached."""
    return tuple((t.detach().to(BF16) if i in V3F_BF16 else t.detach())
                 .contiguous() for i, t in enumerate(packed_f32))


class PackedOperands(tuple):
    """A packed-operand tuple (pack_params_v3f, pack_params_density,
    pack_params, pack_params_v3) that keeps, from the first CUDA launch on,
    its weights pre-packed for its kernels' weight ring, one blob per ring
    format (ring_blob), so a render packs them once and not per chunk.  A
    blob is a copy: editing the tuple's weight tensors in place afterwards
    leaves it stale."""


def ring_blob(packed, fmt: str, pack) -> torch.Tensor:
    """packed's weights in the ring format fmt, built by pack(packed): kept
    under fmt on a PackedOperands, built anew for any other sequence."""
    blobs = (vars(packed).setdefault("blobs", {})
             if isinstance(packed, PackedOperands) else {})
    if fmt not in blobs:
        blobs[fmt] = pack(packed)
    return blobs[fmt]


def _ring_blob(packed, heads: bool) -> torch.Tensor:
    """K1's / K2's ring blob: the trunk's chunks (trunk_sm90.pack_blob),
    and for K1 w_hc's."""
    return ring_blob(packed, "trunk+w_hc" if heads else "trunk",
                     lambda p: trunk_sm90.pack_blob(p[:8], p[16] if heads
                                                    else None))


def heads_blob(packed) -> torch.Tensor:
    """K11's and K12's ring blob (unfolded_sm90.pack_heads_blob)."""
    return ring_blob(packed, "heads", unfolded_sm90.pack_heads_blob)


@torch.no_grad()
def pack_params_v3f(field: Field) -> Tuple[torch.Tensor, ...]:
    """K1 operands (field_pallas.pack_params_v3f): ws(8) + bs(8) +
    (w_hc, b_hc, w_out, b_out).  The bottleneck head is folded into the
    mid-MLP's embedding half in fp32 (w_comb = W_bneck @ W_emb, then
    bf16); w_hc = [heads (FH_* columns, padded to 128) | w_comb]."""
    return PackedOperands(cast_packed(pack_params_v3f_f32(field)))


@torch.no_grad()
def pack_params_density(field: Field) -> Tuple[torch.Tensor, ...]:
    """K2 operands (field_pallas.pack_params_density): ws(8) + bs(8) +
    the density head as a zero-padded (256, 8) matmul (wd, bd)."""
    ws, bs = _trunk_operands(field)
    head = field.field_output_density.net
    wd = F.pad(_w_in_out(head), (0, DENS_COLS - 1)).to(BF16).contiguous()
    bd = F.pad(head.bias.float(),
               (0, DENS_COLS - 1)).reshape(1, -1).contiguous()
    return PackedOperands(tuple(w.to(BF16).contiguous() for w in ws)
                          + tuple(b.detach().contiguous() for b in bs)
                          + (wd, bd))


@torch.no_grad()
def pack_params(field: Field) -> Tuple[torch.Tensor, ...]:
    """K11 / K12 operands (field_pallas.pack_params): ws(8) + bs(8) +
    (wh, bh), wh (256, 384) bf16 = [bottleneck | density | diff | tint |
    roughness | normals] zero-padded, bh (1, 384) fp32."""
    ws, bs = _trunk_operands(field)
    heads = (field.field_output_bottleneck, field.field_output_density,
             field.field_output_diff, field.field_output_tint,
             field.field_output_roughness, field.field_output_normals)
    wh = torch.cat([_w_in_out(h.net) for h in heads], dim=1)  # (256, 267)
    bh = torch.cat([h.net.bias.float() for h in heads])
    wh = F.pad(wh, (0, OUT_DIM - N_HEAD_COLS)).to(BF16).contiguous()
    bh = F.pad(bh, (0, OUT_DIM - N_HEAD_COLS)).reshape(1, -1).contiguous()
    return PackedOperands(tuple(w.to(BF16).contiguous() for w in ws)
                          + tuple(b.detach().contiguous() for b in bs)
                          + (wh, bh))


@torch.no_grad()
def pack_params_v3(field: Field) -> Tuple[torch.Tensor, ...]:
    """K14 / K15 operands (field_pallas.pack_params_v3, the unfolded
    packing): pack_params' 18 + (w_emb, b_mid, w_out, b_out), w_emb the
    mid-MLP's bottleneck rows (256, 128) bf16, b_mid (1, 128) f32, w_out
    the mid head zero-padded to (128, 128) bf16, b_out (1, 128) f32."""
    _, w_emb, b_mid = field.mid_weights()
    w_out = F.pad(_w_in_out(field.field_output_mid.net), (0, 125))
    b_out = F.pad(field.field_output_mid.net.bias.float(), (0, 125))
    return PackedOperands(pack_params(field) + (
        w_emb.float().to(BF16).contiguous(),
        b_mid.detach().float().reshape(1, -1).contiguous(),
        w_out.to(BF16).contiguous(), b_out.reshape(1, -1).contiguous()))


def mid_g_bands_f32(field: Field, ray_dirs: torch.Tensor,
                    sh_l8_m7_2x: bool = True) -> torch.Tensor:
    """Per-ray SH band partials basis_b @ W_enc_b: (R, 3) -> (R, 512) f32,
    differentiable in the mid-MLP's encoder rows (the directions are
    detached, as in sh_basis)."""
    basis = sh_basis(ray_dirs, sh_l8_m7_2x)
    w_enc = field.mid_weights()[0].float()
    parts = [basis[..., lo:hi] @ w_enc[lo:hi] for lo, hi, _ in _BAND_SLICES]
    return torch.cat(parts, dim=-1).float().contiguous()


@torch.no_grad()
def mid_g_bands(field: Field, ray_dirs: torch.Tensor,
                sh_l8_m7_2x: bool = True) -> torch.Tensor:
    """mid_g_bands_f32 without autograd (the render path)."""
    return mid_g_bands_f32(field, ray_dirs, sh_l8_m7_2x)


# ---- plain versions --------------------------------------------------------

def _sin2pi(u: torch.Tensor) -> torch.Tensor:
    """sin(2 pi u) for wrapped u in [-1/2, 1/2] (field_pallas._sin2pi)."""
    w = u * u
    p = torch.full_like(w, -12.2688402)
    for c in (41.2037313, -76.5796851, 81.5961385, -41.3414194, 6.28318279):
        p = p * w + c
    return p * u


def ipe_phase(mean_cov: torch.Tensor):
    """The IPE's damping and wrapped phase of columns [0, 96):
    (N, 16) f32 -> (damp, u), each (N, 96) f32, with
    damp = exp(-f_k^2 var_d / 2) and u = pre / 2pi - rint(pre / 2pi) for
    pre = 2 pi f_k mean_d (+ pi/2 on the cos half [48, 96))."""
    n = mean_cov.shape[0]
    mean, cov = mean_cov[:, 0:3], mean_cov[:, 3:6]
    scale = torch.as_tensor(IPE_SCALE, device=mean_cov.device)
    var_k = torch.as_tensor(IPE_VAR, device=mean_cov.device)
    pre_sin = (mean[:, :, None] * scale).reshape(n, 48)
    pre = torch.cat([pre_sin, pre_sin + _HALF_PI], dim=1)
    var = (cov[:, :, None] * var_k).reshape(n, 48)
    damp = torch.exp2(-_HALF_LOG2E * torch.cat([var, var], dim=1))
    u = pre * _INV_2PI
    return damp, u - torch.round(u)


def ipe_x(mean_cov: torch.Tensor) -> torch.Tensor:
    """The kernels' IPE: (N, 16) f32 -> (N, 128) bf16
    [damp*sin (48) | damp*cos (48) | mean (3) | 0 (29)], with the phase
    wrapped as u = pre / 2pi - rint(pre / 2pi) and the polynomial sine."""
    n = mean_cov.shape[0]
    damp, u = ipe_phase(mean_cov)
    zeros = torch.zeros(n, ENC_PAD - IPE_OUT_DIM, device=mean_cov.device)
    return torch.cat([damp * _sin2pi(u), mean_cov[:, 0:3], zeros],
                     dim=1).to(BF16)


def ipe_matrices(device=None):
    """field_pallas.ipe_matrices as float32 tensors: A (16, 128), bA (1,
    128), V (16, 128), M (1, 128), built from the same float64 values.
    mc @ A + bA is the sin argument 2 pi f_k mean_d (+ pi/2 on the cos half
    [48, 96); mean_d itself in 96..98), mc @ V the f_k^2-scaled variance,
    M marks the damped-sine columns [0, 96).  Their nonzero entries are
    IPE_SCALE, IPE_VAR and _HALF_PI, which ipe_enc applies elementwise."""
    A = np.zeros((IN_COLS, ENC_PAD), np.float32)
    V = np.zeros((IN_COLS, ENC_PAD), np.float32)
    bA = np.zeros((1, ENC_PAD), np.float32)
    M = np.zeros((1, ENC_PAD), np.float32)
    for d in range(3):
        for k in range(16):
            c = d * 16 + k
            A[d, c] = A[d, 48 + c] = 2.0 * np.pi * _FREQS[k]
            V[3 + d, c] = V[3 + d, 48 + c] = _FREQS[k] ** 2
        A[d, 96 + d] = 1.0
    bA[0, 48:96] = np.pi / 2.0
    M[0, 0:96] = 1.0
    return tuple(torch.as_tensor(m, device=device) for m in (A, bA, V, M))


def ipe_enc(mean_cov: torch.Tensor) -> torch.Tensor:
    """K11's IPE (field_pallas._ipe_in_kernel): (N, 16) f32 -> (N, 128)
    bf16 [damp*sin (48) | damp*cos (48) | mean (3) | 0 (29)] with the exact
    sine of pre = f32(2 pi f_k) mean_d (+ f32(pi/2) on the cos half) and
    damp = exp(-0.5 f32(f_k^2) var_d): rsn's mc @ A + bA and mc @ V, whose
    columns each hold one nonzero entry, product for product."""
    n = mean_cov.shape[0]
    dev = mean_cov.device
    mean, cov = mean_cov[:, 0:3], mean_cov[:, 3:6]
    pre = (mean[:, :, None] * torch.as_tensor(IPE_SCALE, device=dev)
           ).reshape(n, 48)
    var = (cov[:, :, None] * torch.as_tensor(IPE_VAR, device=dev)
           ).reshape(n, 48)
    pre = torch.cat([pre, pre + _HALF_PI], dim=1)
    damp = torch.exp(-0.5 * torch.cat([var, var], dim=1))
    zeros = torch.zeros(n, ENC_PAD - IPE_OUT_DIM, device=dev)
    return torch.cat([damp * torch.sin(pre), mean, zeros], dim=1).to(BF16)


def _trunk_plain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """bf16 trunk with fp32 accumulation; post-ReLU activations bf16."""
    h = x
    for i in range(TRUNK_LAYERS):
        if i == SKIP_AT:
            h = torch.cat([x, h], dim=1)
        h = torch.relu(h.float() @ ws[i].float() + bs[i]).to(BF16)
    return h


def _density_head(h: torch.Tensor, w8: torch.Tensor,
                  b8: torch.Tensor) -> torch.Tensor:
    """(N, 256) bf16 @ (256, 8) + b -> (N, 8) f32.  K1 and K2 both take
    their density column from this one product shape, so the column is
    bit-identical between them."""
    return h.float() @ w8.float() + b8


def field_forward_v3_plain(packed, mean_cov: torch.Tensor,
                           g_bands: torch.Tensor,
                           samples_per_ray: int) -> torch.Tensor:
    """Plain PyTorch K1 on the same packed operands -> (N, 16) bf16."""
    ws, bs = packed[:8], packed[8:16]
    w_hc, b_hc, w_out, b_out = packed[16:]
    n, S = mean_cov.shape[0], samples_per_ray
    R = n // S
    h = _trunk_plain(ws, bs, ipe_x(mean_cov))
    hc = h.float() @ w_hc.float() + b_hc
    density = _density_head(h, w_hc[:, 0:DENS_COLS].contiguous(),
                            b_hc[:, 0:DENS_COLS])[:, 0:1]
    diff = torch.sigmoid(hc[:, FH_DIFF])
    tint = torch.sigmoid(hc[:, FH_TINT])
    rough_raw = hc[:, FH_ROUGH:FH_ROUGH + 1]
    normals_raw = hc[:, FH_NORMALS]
    rough_sp = torch.logaddexp(rough_raw, torch.zeros_like(rough_raw))
    mid_pre = hc[:, 128:256].reshape(R, S, 128)
    for bi, k in enumerate(_BAND_KS):
        band = g_bands[:, None, bi * 128:(bi + 1) * 128]
        mid_pre = mid_pre + torch.exp(-rough_sp * k).reshape(R, S, 1) * band
    hmid = torch.relu(mid_pre).reshape(n, 128).to(BF16)
    mid = torch.sigmoid(hmid.float() @ w_out.float() + b_out)[:, 0:3]
    mid_out = diff + tint * mid
    zeros = torch.zeros(n, V3_EVAL_COLS - 14, device=mean_cov.device)
    return torch.cat([mid_out, diff, tint, normals_raw, density, rough_raw,
                      zeros], dim=1).to(BF16)


def field_forward_density_plain(packed,
                                mean_cov: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2 on the same packed operands -> (N, 8) bf16."""
    ws, bs = packed[:8], packed[8:16]
    wd, bd = packed[16:]
    h = _trunk_plain(ws, bs, ipe_x(mean_cov))
    return _density_head(h, wd, bd).to(BF16)


def field_forward_plain(packed, enc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K12: (N, 128) bf16 encoding -> (N, 384) bf16."""
    ws, bs = packed[:8], packed[8:16]
    wh, bh = packed[16:]
    h = _trunk_plain(ws, bs, enc)
    return (h.float() @ wh.float() + bh).to(BF16)


def field_forward_v2_plain(packed, mean_cov: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K11: (N, 16) f32 mean_cov -> (N, 384) bf16."""
    return field_forward_plain(packed, ipe_enc(mean_cov))


def unpack_outputs(out: torch.Tensor):
    """Split the (.., 384) output into its heads (field_pallas.
    unpack_outputs): the bottleneck stays bf16, the rest fp32."""
    return {
        "bottleneck": out[..., OUT_BOTTLENECK],
        "density_preact": out[..., OUT_DENSITY:OUT_DENSITY + 1].float(),
        "diff_raw": out[..., OUT_DIFF].float(),
        "tint_raw": out[..., OUT_TINT].float(),
        "rough_raw": out[..., OUT_ROUGH:OUT_ROUGH + 1].float(),
        "normals_raw": out[..., OUT_NORMALS].float(),
    }


# ---- wrappers --------------------------------------------------------------

_TRUNK_SHAPES = ([(ENC_PAD, 256)] + [(256, 256)] * 3 + [(SKIP_PAD, 256)]
                 + [(256, 256)] * 3, [(1, 256)] * 8)
V3_SHAPES = (_TRUNK_SHAPES[0] + _TRUNK_SHAPES[1]
             + [(256, 256), (1, 256), (128, 128), (1, 128)])
DENSITY_SHAPES = (_TRUNK_SHAPES[0] + _TRUNK_SHAPES[1]
                  + [(256, DENS_COLS), (1, DENS_COLS)])
V2_SHAPES = (_TRUNK_SHAPES[0] + _TRUNK_SHAPES[1]
             + [(256, OUT_DIM), (1, OUT_DIM)])
V3U_SHAPES = V2_SHAPES + [(256, 128), (1, 128), (128, 128), (1, 128)]
_V3_DTYPES = [BF16] * 8 + [F32] * 8 + [BF16, F32, BF16, F32]
_DENSITY_DTYPES = [BF16] * 8 + [F32] * 8 + [BF16, F32]  # and V2's
V3U_DTYPES = _DENSITY_DTYPES + [BF16, F32, BF16, F32]


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    # wmma fragment loads need 32-byte alignment
    if device.type == "cuda" and t.data_ptr() % 32:
        raise ValueError(f"{name}: data pointer not 32-byte aligned")


def _check_packed(packed, shapes, dtypes, device) -> None:
    if len(packed) != len(shapes):
        raise ValueError(f"packed: {len(packed)} operands, "
                         f"expected {len(shapes)}")
    for i, (t, s, d) in enumerate(zip(packed, shapes, dtypes)):
        _check(f"packed[{i}]", t, s, d, device)


@functools.lru_cache(maxsize=8)
def _ipe_consts(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([IPE_SCALE, IPE_VAR]),
                           device=device).contiguous()


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _raise_on_error(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.rsn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def field_forward_v3(packed, mean_cov: torch.Tensor, g_bands: torch.Tensor,
                     samples_per_ray: int) -> torch.Tensor:
    """K1: (N, 16) f32 mean_cov + (R, 512) f32 g_bands, N = R * S
    -> (N, 16) bf16 (V3_* columns)."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    S = int(samples_per_ray)
    if S <= 0 or n == 0 or n % S:
        raise ValueError(f"{n} rows is not a positive multiple of S={S}")
    _check("mean_cov", mean_cov, (n, IN_COLS), F32, device)
    _check("g_bands", g_bands, (n // S, 512), F32, device)
    _check_packed(packed, V3_SHAPES, _V3_DTYPES, device)
    if device.type == "cpu":
        return field_forward_v3_plain(packed, mean_cov, g_bands, S)
    if device.type != "cuda":
        raise ValueError(f"field_forward_v3: unsupported device {device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_forward.cu")
    out = torch.empty((n, V3_EVAL_COLS), dtype=BF16, device=device)
    with torch.cuda.device(device):
        rc = lib.rsn_field_forward_v3(
            mean_cov.data_ptr(), g_bands.data_ptr(),
            _ipe_consts(device).data_ptr(),
            _ring_blob(packed, heads=True).data_ptr(), _ptr_array(packed),
            out.data_ptr(), n, S, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, "field_forward_v3")
    LAUNCHES["field_forward_v3"] += 1
    return out


def field_forward_density(packed, mean_cov: torch.Tensor) -> torch.Tensor:
    """K2: (N, 16) f32 mean_cov -> (N, 8) bf16, col 0 = density preact."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    if n == 0:
        raise ValueError("field_forward_density: empty input")
    _check("mean_cov", mean_cov, (n, IN_COLS), F32, device)
    _check_packed(packed, DENSITY_SHAPES, _DENSITY_DTYPES, device)
    if device.type == "cpu":
        return field_forward_density_plain(packed, mean_cov)
    if device.type != "cuda":
        raise ValueError(
            f"field_forward_density: unsupported device {device}")
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_forward.cu")
    out = torch.empty((n, DENS_COLS), dtype=BF16, device=device)
    with torch.cuda.device(device):
        rc = lib.rsn_field_forward_density(
            mean_cov.data_ptr(), _ipe_consts(device).data_ptr(),
            _ring_blob(packed, heads=False).data_ptr(), _ptr_array(packed),
            out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, "field_forward_density")
    LAUNCHES["field_forward_density"] += 1
    return out


def _check_heads(packed, x: torch.Tensor, label: str, cols: int, dtype,
                 name: str) -> None:
    """K11's and K12's checks: packed = pack_params(field), x (N, cols);
    raises on a device that is neither the CPU nor CUDA."""
    device = x.device
    n = x.shape[0]
    if n == 0:
        raise ValueError(f"{name}: empty input")
    _check(label, x, (n, cols), dtype, device)
    _check_packed(packed, V2_SHAPES, _DENSITY_DTYPES, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


def launch_heads(lib, name: str, packed, x: torch.Tensor) -> torch.Tensor:
    """One launch of K11 (name "field_forward_v2", x the (N, 16) f32
    mean_cov) or K12 ("field_forward", x the (N, 128) bf16 encoding) from
    lib, a build of field_forward.cu (the port's, or one kept for a check
    or an ablation: RSN_K11_FIRST_DESIGN, RSN_ABLATE_*), on CUDA tensors
    the wrappers have checked -> (N, 384) bf16; counts no launch."""
    if name not in ("field_forward_v2", "field_forward"):
        raise ValueError(f"launch_heads: unknown kernel {name!r}")
    n, device = x.shape[0], x.device
    out = torch.empty((n, OUT_DIM), dtype=BF16, device=device)
    blob = heads_blob(packed)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if name == "field_forward_v2":
            rc = lib.rsn_field_forward_v2(
                x.data_ptr(), _ipe_consts(device).data_ptr(),
                blob.data_ptr(), _ptr_array(packed), out.data_ptr(), n,
                stream)
        else:
            rc = lib.rsn_field_forward(x.data_ptr(), blob.data_ptr(),
                                       _ptr_array(packed), out.data_ptr(), n,
                                       stream)
    _raise_on_error(lib, rc, name)
    return out


def field_forward_v2(packed, mean_cov: torch.Tensor) -> torch.Tensor:
    """K11: packed = pack_params(field), (N, 16) f32 mean_cov
    [mean | cov_diag | 0] -> (N, 384) bf16 (OUT_* columns)."""
    _check_heads(packed, mean_cov, "mean_cov", IN_COLS, F32,
                 "field_forward_v2")
    if mean_cov.device.type == "cpu":
        return field_forward_v2_plain(packed, mean_cov)
    from rsn_torch.kernels.build import load_library

    out = launch_heads(load_library("field_forward.cu"), "field_forward_v2",
                       packed, mean_cov)
    LAUNCHES["field_forward_v2"] += 1
    return out


def field_forward(packed, enc: torch.Tensor) -> torch.Tensor:
    """K12: packed = pack_params(field), (N, 128) bf16 IPE encoding (as
    ipe_enc gives it) -> (N, 384) bf16 (OUT_* columns)."""
    _check_heads(packed, enc, "enc", ENC_PAD, BF16, "field_forward")
    if enc.device.type == "cpu":
        return field_forward_plain(packed, enc)
    from rsn_torch.kernels.build import load_library

    out = launch_heads(load_library("field_forward.cu"), "field_forward",
                       packed, enc)
    LAUNCHES["field_forward"] += 1
    return out
