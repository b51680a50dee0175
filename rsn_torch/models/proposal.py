"""Proposal-network sampling (port of rsn.models.proposal): the small
density-only field that places the fine samples of the
`reflect-sampling-nerf-proposal` preset, and its two losses.

- `ProposalField`: 8-octave IPE (51 columns) -> 4 x 64 ReLU trunk ->
  density head, ~22k parameters; `trunk` and `density` carry rsn's tree
  names.  Init is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
  the distribution of rsn's `_linear_init`, drawn from an explicit
  torch.Generator.
- `proposal_density`: the fp32 composition (training, and renders without
  the K9 kernel), fp32 whatever the run's compute dtype, as in rsn.
- `interlevel_loss`: mip-NeRF-360's proposal loss, with the compare-matrix
  reductions of rsn (amax / amin split a tie's gradient evenly, as JAX's
  max / min reductions do) and the fine side detached: it trains only the
  proposal field.
- `distortion_per_ray`: mip-NeRF-360's distortion regularizer, O(S) by
  cumsums.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rsn_torch.core.contract import contract_blob
from rsn_torch.core.encodings import ipe_encode
from rsn_torch.core.rays import RaySamples, get_gaussian_blob
from rsn_torch.models.field import _linear

# rsn/models/proposal.py's constants
PROP_NUM_FREQS = 8
PROP_MAX_FREQ_EXP = 8.0
PROP_IN_DIM = 3 * 2 * PROP_NUM_FREQS + 3  # 51
PROP_WIDTH = 64
PROP_LAYERS = 4
PROP_DENSITY_BIAS = 0.5  # same shift as the main field


class ProposalField(nn.Module):
    """trunk: 4 linears (51 -> 64, then 64 -> 64), ReLU after each;
    density: 64 -> 1."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.trunk = nn.ModuleList(
            _linear(PROP_IN_DIM if i == 0 else PROP_WIDTH, PROP_WIDTH,
                    generator) for i in range(PROP_LAYERS))
        self.density = _linear(PROP_WIDTH, 1, generator)


def proposal_density(prop: ProposalField,
                     ray_samples: RaySamples) -> torch.Tensor:
    """(R, S) frusta -> (R, S, 1) density, in fp32: blob -> contraction ->
    8-octave IPE -> MLP -> softplus(preact + 0.5)."""
    mean, cov_diag = contract_blob(get_gaussian_blob(ray_samples))
    enc = ipe_encode(mean, cov_diag, num_freqs=PROP_NUM_FREQS,
                     max_freq_exp=PROP_MAX_FREQ_EXP)
    batch_shape = enc.shape[:-1]
    h = enc.reshape(-1, enc.shape[-1])
    for layer in prop.trunk:
        h = torch.relu(F.linear(h, layer.weight) + layer.bias)
    preact = F.linear(h, prop.density.weight) + prop.density.bias
    density = F.softplus(preact + PROP_DENSITY_BIAS)
    return density.reshape(*batch_shape, 1)


def distortion_per_ray(w: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """sum_ij w_i w_j |u_i - u_j| + (1/3) sum_i w_i^2 (s_{i+1} - s_i), u
    the spacing-domain bin midpoints; the pairwise term as
    2 sum_i w_i (u_i W_{<i} - (wu)_{<i}) with exclusive prefix sums.

    w: (R, S, 1) LIVE fine weights; bins: (R, S+1) spacing-domain edges.
    -> (R,)."""
    w = w[..., 0]
    u = 0.5 * (bins[..., 1:] + bins[..., :-1])
    dw = bins[..., 1:] - bins[..., :-1]
    w_before = torch.cumsum(w, dim=-1) - w
    wu_before = torch.cumsum(w * u, dim=-1) - w * u
    loss_inter = 2.0 * (w * (u * w_before - wu_before)).sum(dim=-1)
    loss_intra = (w ** 2 * dw).sum(dim=-1) / 3.0
    return loss_inter + loss_intra


def interlevel_loss(w_fine: torch.Tensor, bins_fine: torch.Tensor,
                    w_prop: torch.Tensor, bins_prop: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """mean over rays of sum_j relu(w_fine_j - outer_j)^2 / (w_fine_j + eps),
    outer_j the proposal mass of the smallest envelope of fine bin j:
    cw[min{i: t_i >= hi}] - cw[max{i: t_i <= lo}], both lookups reductions
    over a broadcast compare matrix (the edges and cw are sorted).

    w_fine: (R, Sf, 1), bins_fine: (R, Sf+1) — detached here; w_prop:
    (R, Sp, 1), the only live input; bins_prop: (R, Sp+1)."""
    w_fine = w_fine[..., 0].detach()
    bins_fine = bins_fine.detach()
    bins_prop = bins_prop.detach()
    wp = w_prop[..., 0]
    cw = torch.cat([torch.zeros_like(wp[..., :1]),
                    torch.cumsum(wp, dim=-1)], dim=-1)  # (R, Sp+1)
    lo = bins_fine[..., :-1]
    hi = bins_fine[..., 1:]
    big = 2.0  # cw <= ~1; bins in [0, 1]
    cwb = cw[..., None, :]
    # cw at the largest proposal edge <= lo, and at the smallest >= hi
    le = bins_prop[..., None, :] <= lo[..., :, None]  # (R, Sf, Sp+1)
    cw_lo = torch.where(le, cwb, torch.full_like(cwb, -big)).amax(dim=-1)
    ge = bins_prop[..., None, :] >= hi[..., :, None]
    cw_hi = torch.where(ge, cwb, torch.full_like(cwb, big)).amin(dim=-1)
    # fine bins outside the proposal's range clamp to its end masses
    cw_lo = torch.maximum(cw_lo, cw[..., :1])
    cw_hi = torch.minimum(cw_hi, cw[..., -1:])
    # maximum, not clamp_min: a tie at 0 splits the gradient as in JAX
    gap = cw_hi - cw_lo
    outer = torch.maximum(gap, torch.zeros_like(gap))
    excess = torch.relu(w_fine - outer)
    return (excess ** 2 / (w_fine + eps)).sum(dim=-1).mean()
