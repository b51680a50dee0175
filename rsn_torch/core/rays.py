"""Ray containers + conical frustum -> factored Gaussian (port of
rsn.core.rays).  Dataclasses of tensors with the JAX package's layouts:
(R, 3) ray fields, (R, S, 1) starts/ends."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rsn_torch.core.render import safe_sqrt

SQRT_PI = 1.7724538509055159  # nerfstudio Frustums.get_gaussian_blob


@dataclasses.dataclass
class RayBundle:
    origins: torch.Tensor     # (R, 3)
    directions: torch.Tensor  # (R, 3) unit
    pixel_area: torch.Tensor  # (R, 1)
    nears: torch.Tensor       # (R, 1)
    fars: torch.Tensor        # (R, 1)
    camera_indices: Optional[torch.Tensor] = None

    def index(self, sel: torch.Tensor) -> "RayBundle":
        """The rays at indices `sel` (every per-ray field gathered)."""
        return RayBundle(*(None if getattr(self, f.name) is None
                           else getattr(self, f.name)[sel]
                           for f in dataclasses.fields(self)))


@dataclasses.dataclass
class RaySamples:
    origins: torch.Tensor         # (R, S, 3), constant along S
    directions: torch.Tensor      # (R, S, 3), constant along S
    starts: torch.Tensor          # (R, S, 1) euclidean
    ends: torch.Tensor            # (R, S, 1)
    pixel_area: torch.Tensor      # (R, S, 1)
    spacing_starts: torch.Tensor  # (R, S, 1) in [0, 1]
    spacing_ends: torch.Tensor    # (R, S, 1)

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        """w_i = T_i (1 - exp(-sigma_i delta_i)) with the exclusive-cumsum
        transmittance (nerfstudio RaySamples.get_weights)."""
        delta_density = (self.ends - self.starts) * densities
        alphas = 1.0 - torch.exp(-delta_density)
        tau = torch.cumsum(delta_density[..., :-1, :], dim=-2)
        tau = torch.cat([torch.zeros_like(tau[..., :1, :]), tau], dim=-2)
        return torch.nan_to_num(alphas * torch.exp(-tau))


def get_ray_samples(ray_bundle: RayBundle, euclidean_bins: torch.Tensor,
                    spacing_bins: torch.Tensor) -> RaySamples:
    """RaySamples from (R, S+1) euclidean and spacing bin edges; the
    per-ray fields are broadcast views along the sample axis."""
    num_samples = euclidean_bins.shape[-1] - 1

    def broadcast(x):
        return x[..., None, :].expand(*x.shape[:-1], num_samples,
                                      x.shape[-1])

    return RaySamples(
        origins=broadcast(ray_bundle.origins),
        directions=broadcast(ray_bundle.directions),
        starts=euclidean_bins[..., :-1, None],
        ends=euclidean_bins[..., 1:, None],
        pixel_area=broadcast(ray_bundle.pixel_area),
        spacing_starts=spacing_bins[..., :-1, None],
        spacing_ends=spacing_bins[..., 1:, None],
    )


@dataclasses.dataclass
class GaussianBlob:
    """mip-NeRF cone Gaussian in factored form:
    cov = dir_variance d d^T + radius_variance (I - d d^T / |d|^2)."""
    mean: torch.Tensor            # (..., 3)
    directions: torch.Tensor      # (..., 3)
    dir_variance: torch.Tensor    # (..., 1)
    radius_variance: torch.Tensor  # (..., 1)


def conical_frustum_to_factored(origins: torch.Tensor,
                                directions: torch.Tensor,
                                starts: torch.Tensor, ends: torch.Tensor,
                                radius: torch.Tensor) -> GaussianBlob:
    """mip-NeRF cone segment -> factored Gaussian (mip-NeRF eq. 7)."""
    mu = (starts + ends) / 2.0
    hw = (ends - starts) / 2.0
    denom = 3.0 * mu ** 2 + hw ** 2
    means = origins + directions * (mu + (2.0 * mu * hw ** 2) / denom)
    dir_variance = (hw ** 2) / 3.0 - (4.0 / 15.0) * (
        (hw ** 4 * (12.0 * mu ** 2 - hw ** 2)) / denom ** 2)
    radius_variance = radius ** 2 * ((mu ** 2) / 4.0 + (5.0 / 12.0) * hw ** 2
                                     - (4.0 / 15.0) * (hw ** 4) / denom)
    return GaussianBlob(mean=means, directions=directions,
                        dir_variance=dir_variance,
                        radius_variance=radius_variance)


def get_gaussian_blob(ray_samples: RaySamples) -> GaussianBlob:
    """Frustums -> blobs with cone radius sqrt(pixel_area) / sqrt(pi)."""
    cone_radius = safe_sqrt(ray_samples.pixel_area) / SQRT_PI
    return conical_frustum_to_factored(
        ray_samples.origins, ray_samples.directions,
        ray_samples.starts, ray_samples.ends, cone_radius)
