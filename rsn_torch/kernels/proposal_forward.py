"""The proposal field's render-path kernel, its packed operands and its
plain PyTorch version (port of rsn/kernels/proposal_pallas.py).

K9 `prop_forward` (replaces proposal_pallas.py::prop_forward): (N, 16) f32
rows [mean(3) | cov_diag(3) | 0 ...] -> the 8-octave IPE as 64 bf16
columns [damp*sin (24) | damp*cos (24) | mean (3) | 0 (13)] -> 4 x 64 ReLU
trunk (bf16 operands, fp32 sums, bf16 activations) -> the density
pre-activation, (N,) f32.  The IPE is rsn's formula, not
core.encodings.ipe_encode's: phase fl(mean_d * fl32(2 pi f_k)), plus
fl32(pi / 2) on the cos half, variance fl(cov_d * fl32(f_k^2)), the fp32
sine and exp(-var / 2) of the phase and the variance.

It runs on the render path only (passes 1 and 3 of the preset with
use_pallas_proposal and bf16), as in rsn; training evaluates the proposal
with the fp32 composition (models.proposal.proposal_density) under
autograd.

The wrapper checks its inputs, runs the plain version for CPU tensors and
launches the CUDA kernel (rsn_torch/csrc/proposal_forward.cu) for CUDA
tensors; it never falls back from one to the other.  Its launches count
in field_forward.LAUNCHES["prop_forward"].

The kernel keeps a warp's rows in mma.sync m16n8k16 fragments from the IPE
to the head.  a_fragment_map / c_fragment_map give the (row, column) that
each (lane, register) holds, head_gather_map the order in which a lane
gathers its quarter of a row for the head, and prop_ipe_factored the IPE
as the kernel computes it, one exp per (row, d, k) shared by the sine and
the cosine column, laid out through the A fragments.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rsn_torch.core.contract import packed_contract_planes
from rsn_torch.core.rays import RaySamples
from rsn_torch.kernels.field_forward import (BF16, F32, IN_COLS, LAUNCHES,
                                             _check, _check_packed,
                                             _ptr_array, _raise_on_error)
from rsn_torch.models.proposal import (PROP_DENSITY_BIAS, PROP_IN_DIM,
                                       PROP_LAYERS, PROP_MAX_FREQ_EXP,
                                       PROP_NUM_FREQS, PROP_WIDTH,
                                       ProposalField)

ENC_PAD = 64     # the IPE's 51 columns zero-padded to the trunk width
OUT_COLS = 8     # the packed density head's width; column 0 is live

# proposal_pallas.prop_ipe_matrices()'s constants: frequencies in float64,
# each operand rounded once to fp32
_FREQS = 2.0 ** np.linspace(0.0, PROP_MAX_FREQ_EXP, PROP_NUM_FREQS)
PROP_SCALE = (2.0 * np.pi * _FREQS).astype(np.float32)
PROP_VAR = (_FREQS ** 2).astype(np.float32)
_HALF_PI = float(np.float32(np.pi / 2.0))

PROP_SHAPES = ([(ENC_PAD, PROP_WIDTH)] + [(PROP_WIDTH, PROP_WIDTH)] * 3
               + [(1, PROP_WIDTH)] * PROP_LAYERS
               + [(PROP_WIDTH, OUT_COLS), (1, OUT_COLS)])
_PROP_DTYPES = [BF16] * PROP_LAYERS + [F32] * PROP_LAYERS + [BF16, F32]


@torch.no_grad()
def pack_prop_params(prop: ProposalField) -> Tuple[torch.Tensor, ...]:
    """K9 operands (proposal_pallas.pack_prop_params): trunk weights (in,
    out) bf16 with layer 0's rows padded 51 -> 64, biases (1, 64) fp32,
    the density head as a zero-padded (64, 8) bf16 matrix and (1, 8) fp32
    bias."""
    ws, bs = [], []
    for i, layer in enumerate(prop.trunk):
        w = layer.weight.t().float()
        if i == 0:
            w = F.pad(w, (0, 0, 0, ENC_PAD - PROP_IN_DIM))
        ws.append(w.to(BF16).contiguous())
        bs.append(layer.bias.detach().float().reshape(1, -1).contiguous())
    head = prop.density
    wd = F.pad(head.weight.t().float(), (0, OUT_COLS - 1))
    bd = F.pad(head.bias.float(), (0, OUT_COLS - 1)).reshape(1, -1)
    return (tuple(ws) + tuple(bs)
            + (wd.to(BF16).contiguous(), bd.contiguous()))


def prop_ipe(mean_cov: torch.Tensor) -> torch.Tensor:
    """K9's IPE in fp32: (N, 16) -> (N, 64)
    [damp*sin (24) | damp*cos (24) | mean (3) | 0 (13)], columns d * 8 + k
    within each half."""
    n = mean_cov.shape[0]
    dev = mean_cov.device
    mean, cov = mean_cov[:, 0:3], mean_cov[:, 3:6]
    pre = (mean[:, :, None] * torch.as_tensor(PROP_SCALE, device=dev)
           ).reshape(n, 3 * PROP_NUM_FREQS)
    var = (cov[:, :, None] * torch.as_tensor(PROP_VAR, device=dev)
           ).reshape(n, 3 * PROP_NUM_FREQS)
    pre = torch.cat([pre, pre + _HALF_PI], dim=1)
    damp = torch.exp(-0.5 * torch.cat([var, var], dim=1))
    zeros = torch.zeros(n, ENC_PAD - PROP_IN_DIM, device=dev)
    return torch.cat([damp * torch.sin(pre), mean, zeros], dim=1)


MMA_ROWS = 16                 # rows of an m16n8k16 tile
K_STEPS = ENC_PAD // 16       # k-steps of 16 per product
N_TILES = PROP_WIDTH // 8     # n-tiles of 8 columns per product


def a_fragment_map() -> np.ndarray:
    """(32 lanes, K_STEPS, 4 registers, 2 halves) -> (row, column) of the
    16 x 64 bf16 operand of one m-tile that each half of each A register
    holds (PTX's m16n8k16 .bf16 A layout: lane = 4 g + t; register r of
    k-step ks holds row g + 8 (r % 2), columns 16 ks + 8 (r // 2) + 2 t +
    {0, 1}, the lower column in the low half)."""
    out = np.zeros((32, K_STEPS, 4, 2, 2), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for ks in range(K_STEPS):
            for r in range(4):
                for e in range(2):
                    out[lane, ks, r, e] = (g + 8 * (r % 2),
                                           16 * ks + 8 * (r // 2) + 2 * t + e)
    return out


def c_fragment_map() -> np.ndarray:
    """(32 lanes, N_TILES, 4 values) -> (row, column) of the 16 x 64 fp32
    sums of one m-tile (m16n8k16's C layout: value i of n-tile j holds
    row g + 8 (i // 2), column 8 j + 2 t + i % 2)."""
    out = np.zeros((32, N_TILES, 4, 2), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(N_TILES):
            for i in range(4):
                out[lane, j, i] = (g + 8 * (i // 2), 8 * j + 2 * t + i % 2)
    return out


def c_to_a(j: int, i: int) -> Tuple[int, int, int]:
    """The kernel's epilogue: value i of C n-tile j becomes (k-step,
    register, half) of the next product's A operand in the same lane."""
    return j // 2, (j % 2) * 2 + i // 2, i % 2


def head_gather_map() -> np.ndarray:
    """(32 lanes, 2 row halves, 16 steps) -> (source lane, k-step, register,
    half) of the A operand after the last layer: the head's fma chain of
    lane t = q, columns q, q + 4, ..., q + 60 of row g + 8 h in that
    order, step 2 m + p read from lane 4 g + 2 p + t // 2's register pair
    m (k-step m // 2, register 2 (m % 2) + h), half t % 2."""
    out = np.zeros((32, 2, 2 * N_TILES, 4), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for h in range(2):
            for m in range(N_TILES):
                for p in range(2):
                    out[lane, h, 2 * m + p] = (4 * g + 2 * p + t // 2,
                                               m // 2, 2 * (m % 2) + h, t % 2)
    return out


def prop_ipe_factored(mean_cov: torch.Tensor) -> torch.Tensor:
    """prop_ipe as the kernel computes it: (N, 16) -> (N, 64) fp32.  Lane
    t of a row's group holds the columns c = 16 ks + 8 r' + 2 t + e
    (a_fragment_map), so c mod 8 = k = 2 t + e: it computes the damping
    exp(-var / 2) once per (d, k) and multiplies it into the sine of the
    phase (column d * 8 + k) and the sine of the phase + f32(pi / 2)
    (column 24 + d * 8 + k); columns 48..50 take the mean, the rest zero."""
    n = mean_cov.shape[0]
    dev = mean_cov.device
    mean, cov = mean_cov[:, 0:3], mean_cov[:, 3:6]
    out = torch.zeros(n, ENC_PAD, dtype=mean_cov.dtype, device=dev)
    amap = a_fragment_map()
    for t in range(4):
        own = slice(2 * t, 2 * t + 2)  # k = 2 t + e
        pre = mean[:, :, None] * torch.as_tensor(PROP_SCALE[own], device=dev)
        var = cov[:, :, None] * torch.as_tensor(PROP_VAR[own], device=dev)
        damp = torch.exp(-0.5 * var)                   # (N, d, e), once
        halves = (damp * torch.sin(pre), damp * torch.sin(pre + _HALF_PI))
        # row g's registers (r = 0, 2) of lane t (g = 0): its columns
        for col in amap[t, :, ::2, :, 1].reshape(-1).tolist():
            if col < 6 * PROP_NUM_FREQS:
                half, dk = divmod(col, 3 * PROP_NUM_FREQS)
                d, k = divmod(dk, PROP_NUM_FREQS)
                out[:, col] = halves[half][:, d, k - 2 * t]
            elif col < PROP_IN_DIM:
                out[:, col] = mean[:, col - 6 * PROP_NUM_FREQS]
    return out


def prop_forward_plain(packed, mean_cov: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9 on the same packed operands -> (N,) f32."""
    ws, bs = packed[:PROP_LAYERS], packed[PROP_LAYERS:2 * PROP_LAYERS]
    wd, bd = packed[2 * PROP_LAYERS:]
    h = prop_ipe(mean_cov).to(BF16)
    for w, b in zip(ws, bs):
        h = torch.relu(h.float() @ w.float() + b).to(BF16)
    return (h.float() @ wd.float() + bd)[:, 0]


@functools.lru_cache(maxsize=8)
def _prop_consts(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([PROP_SCALE, PROP_VAR]),
                           device=device).contiguous()


def prop_forward(packed, mean_cov: torch.Tensor) -> torch.Tensor:
    """K9: (N, 16) f32 mean_cov -> (N,) f32 density pre-activation
    (softplus(. + 0.5) is the caller's)."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    if n == 0:
        raise ValueError("prop_forward: empty input")
    _check("mean_cov", mean_cov, (n, IN_COLS), F32, device)
    _check_packed(packed, PROP_SHAPES, _PROP_DTYPES, device)
    if device.type == "cpu":
        return prop_forward_plain(packed, mean_cov)
    if device.type != "cuda":
        raise ValueError(f"prop_forward: unsupported device {device}")
    from rsn_torch.kernels.build import load_library

    out = launch_prop(load_library("proposal_forward.cu"), packed, mean_cov)
    LAUNCHES["prop_forward"] += 1
    return out


def launch_prop(lib, packed, mean_cov: torch.Tensor) -> torch.Tensor:
    """One launch of rsn_prop_forward from `lib` (the port's library, or a
    build of the same source under another macro) on checked CUDA
    operands -> (N,) f32.  Counts nothing: prop_forward does."""
    device = mean_cov.device
    n = mean_cov.shape[0]
    out = torch.empty(n, dtype=F32, device=device)
    with torch.cuda.device(device):
        rc = lib.rsn_prop_forward(
            mean_cov.data_ptr(), _prop_consts(device).data_ptr(),
            _ptr_array(packed), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, rc, "prop_forward")
    return out


def proposal_density_kernel(packed,
                            ray_samples: RaySamples) -> torch.Tensor:
    """The render path's proposal density (proposal_pallas.
    proposal_density_kernel) from K9's packed operands: (R, S) frusta ->
    (R, S, 1), softplus(K9 + 0.5)."""
    R, S = ray_samples.starts.shape[:2]
    preact = prop_forward(packed, packed_contract_planes(ray_samples,
                                                         IN_COLS))
    return F.softplus(preact + PROP_DENSITY_BIAS).reshape(R, S, 1)
