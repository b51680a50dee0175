"""mip-NeRF-360 contraction of Gaussians (port of rsn.core.contract):
`contract` of a mean and a full covariance (the oracle), `contract_blob`
of a factored Gaussian for the plain field path and
`packed_contract_planes`, which builds the field kernels' (N, 16) input."""
from __future__ import annotations

import torch

from rsn_torch.core.rays import SQRT_PI, GaussianBlob, RaySamples
from rsn_torch.core.render import safe_sqrt


def contract(mean: torch.Tensor, cov: torch.Tensor):
    """Gaussian (mean (..., 3), cov (..., 3, 3)) -> its contraction into
    the radius-2 ball: c(x) = (2|x| - 1) / |x|^2 x outside the unit ball,
    cov' = J cov J (J symmetric) with the diagonal ReLU-clamped
    (reference field.py:98-119).  The outside branch's denominators are
    clamped to >= 1 so the unselected branch stays finite."""
    norm2 = (mean ** 2).sum(dim=-1, keepdim=True)
    mask = norm2 > 1.0
    safe_norm2 = norm2.clamp_min(1.0)
    norm = torch.sqrt(safe_norm2)
    mean_contract = torch.where(mask, (2.0 * norm - 1.0) / safe_norm2 * mean,
                                mean)
    norm_e = norm[..., None]
    norm2_e = safe_norm2[..., None]
    outer = mean[..., :, None] * mean[..., None, :] / norm2_e
    eyes = torch.eye(3, dtype=mean.dtype, device=mean.device).expand(
        outer.shape)
    jacobian = torch.where(mask[..., None],
                           ((2.0 * norm_e - 2.0) * (eyes - outer) + eyes)
                           / norm2_e, eyes)
    cov_contract = jacobian @ cov @ jacobian
    diag = torch.diagonal(cov_contract, dim1=-2, dim2=-1)
    return mean_contract, cov_contract + torch.diag_embed(
        torch.relu(diag) - diag)


def contract_blob(blob: GaussianBlob):
    """Factored Gaussian -> (contracted mean, diag of J cov J), with
    J = a I + b u u^T (u = mean / |mean|) and the diagonal ReLU-clamped
    (reference field.py:98-119)."""
    mean = blob.mean
    norm2 = (mean ** 2).sum(dim=-1, keepdim=True)
    mask = norm2 > 1.0
    safe_norm2 = norm2.clamp_min(1.0)
    norm = torch.sqrt(safe_norm2)
    scale = (2.0 * norm - 1.0) / safe_norm2
    mean_contract = torch.where(mask, scale * mean, mean)
    a = torch.where(mask, scale, torch.ones_like(scale))
    b = torch.where(mask, -(2.0 * norm - 2.0) / safe_norm2,
                    torch.zeros_like(scale))
    u = mean / norm

    d = blob.directions
    dv = blob.dir_variance
    rv = blob.radius_variance
    dmag2 = (d ** 2).sum(dim=-1, keepdim=True).clamp_min(1e-10)
    t = (d * u).sum(dim=-1, keepdim=True)
    cov_u = dv * d * t + rv * (u - d * t / dmag2)
    u_cov_u = (u * cov_u).sum(dim=-1, keepdim=True)
    diag0 = dv * d * d + rv * (1.0 - d * d / dmag2)
    diag = (a ** 2 * diag0 + 2.0 * a * b * u * cov_u
            + b ** 2 * u_cov_u * u * u)
    return mean_contract, torch.relu(diag)


def packed_contract_planes(ray_samples: RaySamples,
                           n_cols: int = 16) -> torch.Tensor:
    """Blob + contraction + pack for the field kernels:
    -> (R*S, n_cols) f32 rows [mean(3) | cov_diag(3) | 0 ...].

    Same math as contract_blob(get_gaussian_blob(rs)) computed on (R, S)
    planes; relies on origins / directions / pixel_area being constant
    along the sample axis (true for all four passes)."""
    o = ray_samples.origins[..., 0, :]         # (R, 3)
    dvec = ray_samples.directions[..., 0, :]   # (R, 3)
    st = ray_samples.starts[..., 0]            # (R, S)
    en = ray_samples.ends[..., 0]
    pa = ray_samples.pixel_area[..., 0, :]     # (R, 1)
    R, S = st.shape

    radius = safe_sqrt(pa) / SQRT_PI
    mu = (st + en) / 2.0
    hw = (en - st) / 2.0
    denom = 3.0 * mu ** 2 + hw ** 2
    tmid = mu + (2.0 * mu * hw ** 2) / denom
    dv = hw ** 2 / 3.0 - (4.0 / 15.0) * (
        (hw ** 4 * (12.0 * mu ** 2 - hw ** 2)) / denom ** 2)
    rv = radius ** 2 * ((mu ** 2) / 4.0 + (5.0 / 12.0) * hw ** 2
                        - (4.0 / 15.0) * (hw ** 4) / denom)
    dx = [dvec[:, i:i + 1] for i in range(3)]
    m = [o[:, i:i + 1] + dx[i] * tmid for i in range(3)]

    norm2 = m[0] ** 2 + m[1] ** 2 + m[2] ** 2
    mask = norm2 > 1.0
    sn2 = norm2.clamp_min(1.0)
    norm = torch.sqrt(sn2)
    scale = torch.where(mask, (2.0 * norm - 1.0) / sn2, torch.ones_like(sn2))
    mcon = [scale * mi for mi in m]
    a = scale
    b = torch.where(mask, -(2.0 * norm - 2.0) / sn2, torch.zeros_like(sn2))
    u = [mi / norm for mi in m]
    dmag2 = (dx[0] ** 2 + dx[1] ** 2 + dx[2] ** 2).clamp_min(1e-10)
    tdu = u[0] * dx[0] + u[1] * dx[1] + u[2] * dx[2]
    cov_u = [dv * dx[i] * tdu + rv * (u[i] - dx[i] * tdu / dmag2)
             for i in range(3)]
    ucu = u[0] * cov_u[0] + u[1] * cov_u[1] + u[2] * cov_u[2]
    diag0 = [dv * dx[i] ** 2 + rv * (1.0 - dx[i] ** 2 / dmag2)
             for i in range(3)]
    dg = [torch.relu(a ** 2 * diag0[i] + 2.0 * a * b * u[i] * cov_u[i]
                     + b ** 2 * ucu * u[i] * u[i]) for i in range(3)]
    zeros = torch.zeros_like(mcon[0])
    cols = mcon + dg + [zeros] * (n_cols - 6)
    return torch.stack(cols, dim=-1).reshape(R * S, n_cols).float()
