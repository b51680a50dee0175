"""Spacing functions and the spaced (uniform / reciprocal) sampler
(port of rsn.core.spacing).  Stratified jitter draws from an explicit
torch.Generator; eval (generator=None) uses the bin edges as they are."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from rsn_torch.core.rays import RayBundle, RaySamples, get_ray_samples


class Spacing(NamedTuple):
    """A monotone spacing transform t <-> s."""
    fn: Callable[[torch.Tensor], torch.Tensor]      # t -> s
    fn_inv: Callable[[torch.Tensor], torch.Tensor]  # s -> t


def identity_spacing() -> Spacing:
    return Spacing(fn=lambda x: x, fn_inv=lambda x: x)


def reciprocal_spacing(tan: float = 1.0) -> Spacing:
    """The reference's ReciprocalSampler: s(t) = t / (1/tan + t)."""
    return Spacing(fn=lambda x: x / (1.0 / tan + x),
                   fn_inv=lambda x: x / tan / (1.0 - x))


def stratify_bins(bins: torch.Tensor, num_rays: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Jitter each bin edge uniformly between its neighbouring centres
    (nerfstudio SpacedSampler)."""
    t_rand = torch.rand((num_rays, bins.shape[-1]), generator=generator,
                        device=bins.device, dtype=bins.dtype)
    centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
    upper = torch.cat([centers, bins[..., -1:]], dim=-1)
    lower = torch.cat([bins[..., :1], centers], dim=-1)
    return lower + (upper - lower) * t_rand


def spaced_sample(ray_bundle: RayBundle, spacing: Spacing, num_samples: int,
                  generator: Optional[torch.Generator] = None
                  ) -> RaySamples:
    """`num_samples` frusta per ray, uniform in the spacing domain
    (nerfstudio SpacedSampler.generate_ray_samples)."""
    num_rays = ray_bundle.origins.shape[0]
    bins = torch.linspace(0.0, 1.0, num_samples + 1,
                          device=ray_bundle.origins.device)
    bins = bins.expand(num_rays, num_samples + 1)
    if generator is not None:
        bins = stratify_bins(bins, num_rays, generator)
    euclidean_bins = spacing_to_euclidean(spacing, ray_bundle, bins)
    return get_ray_samples(ray_bundle, euclidean_bins, bins)


def spacing_to_euclidean(spacing: Spacing, ray_bundle: RayBundle,
                         s: torch.Tensor) -> torch.Tensor:
    """Normalised spacing coordinates -> euclidean distance."""
    s_near = spacing.fn(ray_bundle.nears)
    s_far = spacing.fn(ray_bundle.fars)
    return spacing.fn_inv(s * s_far + (1.0 - s) * s_near)
