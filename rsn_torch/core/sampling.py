"""Inverse-CDF (PDF) importance resampling (port of rsn.core.sampling).

nerfstudio PDFSampler semantics: histogram padding 0.01, zero-weight eps
guard 1e-5, stratified u's drawn from an explicit torch.Generator during
training / midpoint u's at eval, searchsorted(side="right") into the
CDF with the index clamps to [0, S], linear re-interpolation inside the
existing spacing-domain bins.  The JAX package's TPU "reduce" form
builds an (R, U, S+1) compare matrix (about 1 GB per temporary at a
16384-ray chunk); here the search is torch.searchsorted plus gathers,
which selects the same bins.
"""
from __future__ import annotations

from typing import Optional

import torch

from rsn_torch.core.rays import RayBundle, RaySamples, get_ray_samples
from rsn_torch.core.spacing import Spacing, spacing_to_euclidean

HISTOGRAM_PADDING = 0.01
EPS = 1e-5


def pdf_sample(ray_bundle: RayBundle, ray_samples: RaySamples,
               weights: torch.Tensor, spacing: Spacing, num_samples: int,
               generator: Optional[torch.Generator] = None) -> RaySamples:
    """Resample `num_samples` bins per ray from (R, S, 1) `weights`;
    generator: the stratified jitter (training), None for the midpoints."""
    num_bins = num_samples + 1
    w = weights[..., 0] + HISTOGRAM_PADDING  # (R, S)
    w_sum = w.sum(dim=-1, keepdim=True)
    padding = torch.relu(EPS - w_sum)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding

    pdf = w / w_sum
    cdf = torch.cumsum(pdf[..., :-1], dim=-1).clamp_max(1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)  # (R, S+1)

    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins,
                       device=cdf.device)
    u = u.expand(*cdf.shape[:-1], num_bins)
    if generator is not None:
        u = u + torch.rand(u.shape, generator=generator, device=cdf.device,
                           dtype=cdf.dtype) / num_bins
    else:
        u = u + 1.0 / (2 * num_bins)
    u = u.contiguous()

    existing_bins = torch.cat([ray_samples.spacing_starts[..., 0],
                               ray_samples.spacing_ends[..., -1:, 0]],
                              dim=-1)  # (R, S+1)
    last = cdf.shape[-1] - 1
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(0, last)
    above = inds.clamp(0, last)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(existing_bins, -1, below)
    bins_g1 = torch.gather(existing_bins, -1, above)

    denom = cdf_g1 - cdf_g0
    t = torch.where(denom > 0,
                    (u - cdf_g0) / torch.where(denom > 0, denom,
                                               torch.ones_like(denom)),
                    torch.zeros_like(denom))
    t = torch.nan_to_num(t).clamp(0.0, 1.0)
    bins = (bins_g0 + t * (bins_g1 - bins_g0)).detach()

    euclidean_bins = spacing_to_euclidean(spacing, ray_bundle, bins)
    return get_ray_samples(ray_bundle, euclidean_bins, bins)
