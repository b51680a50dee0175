"""LPIPS (Learned Perceptual Image Patch Similarity), VGG16 variant (port
of rsn/lpips.py; the reference's
`LearnedPerceptualImagePatchSimilarity(normalize=True)`,
reflect_sampling_nerf_model.py:132,471).

  x in [0, 1] --(normalize=True)--> 2x - 1
  scaling layer: (x - shift) / scale (fixed constants)
  VGG16 features, taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
  per tap: unit-normalize the channels (eps 1e-10), squared difference,
  the learned 1x1 "lin" head (one output, no bias), spatial mean
  LPIPS = the sum over the 5 taps

The convolutions are F.conv2d (rsn computes them with lax.conv, outside
any Pallas kernel), run with TF32 off.  No weights ship with the repo:
`load_torch_weights` reads a torch checkpoint in the torchvision + lpips
naming or the torchmetrics naming, and the random init (from an explicit
torch.Generator) is for tests only.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision vgg16 .features: the conv indices, their channels, the convs
# with a 2x2 max pool before them, and the convs after whose relu the taps
# are taken
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512,
                  512, 512, 512)
POOL_BEFORE_CONV = (2, 4, 7, 10)
SLICE_AFTER_CONV = (1, 3, 6, 9, 12)
LIN_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """The VGG16 feature stack and the five lin heads.  generator: the
    random init's source (tests only; a usable metric loads weights)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_w = nn.ParameterList()
        self.conv_b = nn.ParameterList()
        in_ch = 3
        for out_ch in VGG16_CHANNELS:
            self.conv_w.append(nn.Parameter(torch.randn(
                (out_ch, in_ch, 3, 3), generator=generator) * 0.1))
            self.conv_b.append(nn.Parameter(torch.randn(
                (out_ch,), generator=generator) * 0.1))
            in_ch = out_ch
        # positive, like the trained heads (per-channel importances)
        self.lins = nn.ParameterList(
            nn.Parameter(torch.randn((c,), generator=generator).abs() * 0.1)
            for c in LIN_CHANNELS)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def features(self, x: torch.Tensor):
        """x: (N, 3, H, W), already scaled -> the 5 tap activations."""
        feats = []
        for i, (w, b) in enumerate(zip(self.conv_w, self.conv_b)):
            if i in POOL_BEFORE_CONV:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(F.conv2d(x, w, b, padding=1))
            if i in SLICE_AFTER_CONV:
                feats.append(x)
        return feats

    @torch.no_grad()
    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        """LPIPS between two (H, W, 3) images, on the module's device.
        normalize=True: the images are in [0, 1] (the reference's
        setting); False: already in [-1, 1]."""
        dev = self.shift.device
        x = torch.stack([img0, img1]).to(dev, torch.float32)
        x = x.permute(0, 3, 1, 2)
        if normalize:
            x = 2.0 * x - 1.0
        x = (x - self.shift) / self.scale
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            feats = self.features(x)
        total = torch.zeros((), device=dev)
        for f, lin in zip(feats, self.lins):
            f = f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
                     + 1e-10)
            d = (f[0] - f[1]) ** 2  # (C, H, W)
            total = total + torch.mean(torch.sum(d * lin[:, None, None],
                                                 dim=0))
        return total


def load_torch_weights(path: str) -> Optional[LPIPS]:
    """LPIPS with the weights of a torch checkpoint, or None when the
    file is missing or does not hold them.  Keys, each optionally under
    `net.` or `net.net.` (the lpips package keeps VGG as self.net and
    torchmetrics wraps the lpips module as self.net again):
    - torchvision vgg16 `features.N.weight/bias` with the lpips heads
      `linN.model.1.weight`, `lins.N.model.1.weight` or `linN.weight`;
    - the lpips / torchmetrics slices `sliceS.N.weight/bias` (N is the
      global torchvision feature index)."""
    if not os.path.exists(path):
        return None
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except (OSError, RuntimeError, ValueError, EOFError,
            pickle.UnpicklingError):
        return None
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()

    def find(*names):
        for n in names:
            for p in ("", "net.", "net.net."):
                if p + n in sd:
                    return torch.as_tensor(sd[p + n], dtype=torch.float32)
        return None

    net = LPIPS(torch.Generator().manual_seed(0))  # overwritten below
    conv_w, conv_b = [], []
    for ci, fi in enumerate(VGG16_CONV_IDX):
        s = sum(1 for b in SLICE_AFTER_CONV if b < ci) + 1
        w = find(f"features.{fi}.weight", f"slice{s}.{fi}.weight")
        b = find(f"features.{fi}.bias", f"slice{s}.{fi}.bias")
        if w is None or b is None or w.shape != net.conv_w[ci].shape:
            return None
        conv_w.append(w)
        conv_b.append(b.reshape(-1))
    lins = []
    for li, c in enumerate(LIN_CHANNELS):
        w = find(f"lin{li}.model.1.weight", f"lins.{li}.model.1.weight",
                 f"lin{li}.weight")
        if w is None or w.numel() != c:
            return None
        lins.append(w.reshape(-1))
    with torch.no_grad():
        for p, v in zip(list(net.conv_w) + list(net.conv_b) + list(net.lins),
                        conv_w + conv_b + lins):
            p.copy_(v)
    return net.eval()


def export_torch_state_dict(net: LPIPS) -> Dict[str, torch.Tensor]:
    """The inverse of load_torch_weights (torchvision + lpips naming)."""
    out: Dict[str, torch.Tensor] = {}
    for ci, fi in enumerate(VGG16_CONV_IDX):
        out[f"features.{fi}.weight"] = net.conv_w[ci].detach().cpu().clone()
        out[f"features.{fi}.bias"] = net.conv_b[ci].detach().cpu().clone()
    for li, lin in enumerate(net.lins):
        out[f"lin{li}.model.1.weight"] = lin.detach().cpu().reshape(
            1, -1, 1, 1).clone()
    return out
