"""Image metrics: PSNR and the gaussian-window SSIM (port of rsn/metrics.py;
the reference's stack, reflect_sampling_nerf_model.py:130-132).

Images are (H, W, C) float tensors in [0, data_range], on any device.
LPIPS is not ported yet (ROADMAP Queue 1 step 2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the whole image (batch)."""
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def _gaussian_kernel(size: int, sigma: float, like: torch.Tensor
                     ) -> torch.Tensor:
    x = torch.arange(size, dtype=like.dtype, device=like.device) - (
        size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / torch.sum(g)


def ssim(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Structural similarity (Wang et al.; torchmetrics' gaussian-kernel
    defaults): a separable gaussian window, valid padding, channels
    averaged, in the images' floating type.  The blurs run with TF32 off: a lower-precision
    moment's error swamps c2 = 9e-4 in var_p = mu_pp - mu_p^2 on flat
    regions (rsn pins its convolutions to Precision.HIGHEST for the same
    reason)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kern = _gaussian_kernel(kernel_size, sigma, pred)

    def blur(img):  # (H, W, C) -> (C, H', W')
        x = img.permute(2, 0, 1)[:, None]
        x = F.conv2d(x, kern.reshape(1, 1, -1, 1))
        x = F.conv2d(x, kern.reshape(1, 1, 1, -1))
        return x[:, 0]

    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        mu_p, mu_g = blur(pred), blur(gt)
        mu_pp, mu_gg, mu_pg = blur(pred * pred), blur(gt * gt), blur(pred * gt)
    var_p = mu_pp - mu_p ** 2
    var_g = mu_gg - mu_g ** 2
    cov = mu_pg - mu_p * mu_g
    num = (2 * mu_p * mu_g + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_g ** 2 + c1) * (var_p + var_g + c2)
    return torch.mean(num / den)
