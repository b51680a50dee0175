"""Image metrics: PSNR, the gaussian-window SSIM and LPIPS (port of
rsn/metrics.py; the reference's stack, reflect_sampling_nerf_model.py:
130-132, 468-480).

Images are (H, W, C) float tensors in [0, data_range], on any device.
LPIPS needs VGG16 + lpips weights on disk (rsn_torch/lpips.py); without
them `lpips` returns None and eval reports leave the key out.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rsn_torch import lpips as lpips_lib

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def lpips_weight_candidates() -> List[str]:
    """Where LPIPS weights are looked for, in order: $RSN_LPIPS_WEIGHTS,
    ~/.cache/rsn/lpips_vgg.pth, <repo>/weights/lpips_vgg.pth (rsn's
    places)."""
    env = os.environ.get("RSN_LPIPS_WEIGHTS")
    cands = [env] if env else []
    cands += [os.path.expanduser("~/.cache/rsn/lpips_vgg.pth"),
              os.path.join(REPO_DIR, "weights", "lpips_vgg.pth")]
    return cands


def load_lpips(device="cpu") -> Optional[lpips_lib.LPIPS]:
    """LPIPS on `device` from the first candidate file that holds its
    weights, or None.  rsn's second route (torchvision's downloaded VGG,
    unweighted) is left out: it needs a download and a package the card's
    machine lacks."""
    for cand in lpips_weight_candidates():
        net = lpips_lib.load_torch_weights(cand)
        if net is not None:
            return net.to(device)
    return None


def lpips(pred: np.ndarray, gt: np.ndarray,
          net: Optional[lpips_lib.LPIPS] = None) -> Optional[float]:
    """LPIPS(VGG16, normalize=True) of two (H, W, 3) images in [0, 1]
    (reference model.py:132,471), on the device of `net` (default: the
    weights load_lpips finds, on the CPU); None when there are none."""
    net = net if net is not None else load_lpips()
    if net is None:
        return None
    return float(net(torch.as_tensor(pred), torch.as_tensor(gt)))
