"""Volumetric compositing renderers (port of rsn.core.render).

Same semantics as the JAX module: nerfstudio's RGB / accumulation /
median-depth / normals renderers, the (R, S) plane-layout variants the
kernel branch composites with, the loss-side background blend, and
`safe_sqrt` with its clamped backward.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch


def white(device=None) -> torch.Tensor:
    return torch.ones(3, dtype=torch.float32, device=device)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """(R, S, 1) -> (R, 1)."""
    return weights.sum(dim=-2)


def _background(background_color, comp: torch.Tensor,
                generator: Optional[torch.Generator]):
    if isinstance(background_color, str):
        if background_color != "random":
            raise ValueError(f"unknown background: {background_color}")
        if generator is None:
            raise ValueError("a random background needs a torch.Generator")
        return torch.rand(comp.shape, generator=generator,
                          device=comp.device, dtype=comp.dtype)
    if background_color is None:
        return None
    return torch.as_tensor(background_color, dtype=comp.dtype,
                           device=comp.device)


def render_rgb(rgb: torch.Tensor, weights: torch.Tensor,
               background_color: Union[torch.Tensor, str, None] = None,
               generator: Optional[torch.Generator] = None,
               training: bool = True) -> torch.Tensor:
    """Composite (R, S, 3) rgb with (R, S, 1) weights -> (R, 3).

    Eval (training=False) nan_to_nums the samples and clips the result to
    [0, 1] (nerfstudio RGBRenderer.forward)."""
    if not training:
        rgb = torch.nan_to_num(rgb)
    comp = (weights * rgb).sum(dim=-2)
    acc = weights.sum(dim=-2)
    bg = _background(background_color, comp, generator)
    if bg is not None:
        comp = comp + bg * (1.0 - acc)
    if not training:
        comp = comp.clamp(0.0, 1.0)
    return comp


def render_depth_median(weights: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor) -> torch.Tensor:
    """Median depth (nerfstudio DepthRenderer "median"): the first bin
    midpoint whose cumulative weight reaches 0.5; rays whose weights
    never reach 0.5 clamp to the last midpoint.  (R, S, 1) -> (R, 1)."""
    return render_depth_median_planes(weights[..., 0], starts[..., 0],
                                      ends[..., 0])


def render_depth_expected(weights: torch.Tensor, starts: torch.Tensor,
                          ends: torch.Tensor, eps: float = 1e-10
                          ) -> torch.Tensor:
    """Expected depth sum(w t) / sum(w), clipped to the sampled range
    (nerfstudio DepthRenderer "expected").  (R, S, 1) -> (R, 1)."""
    steps = (starts + ends) / 2.0
    depth = (weights * steps).sum(dim=-2) / (weights.sum(dim=-2) + eps)
    lo = steps[..., 0, :].amin(dim=-1, keepdim=True)
    hi = steps[..., -1, :].amax(dim=-1, keepdim=True)
    return torch.minimum(torch.maximum(depth, lo), hi)


def render_normals(normals: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """(R, S, 3), (R, S, 1) -> (R, 3) weighted sum, no renormalisation."""
    return (weights * normals).sum(dim=-2)


def render_scalar(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return (weights * values).sum(dim=-2)


# ---- plane layout: (R, S) per-component planes -------------------------

def weights_planes(density: torch.Tensor,
                   deltas: torch.Tensor) -> torch.Tensor:
    """Alpha-compositing weights on (R, S) planes (exclusive-cumsum
    transmittance, nerfstudio RaySamples.get_weights)."""
    delta_density = deltas * density
    alphas = 1.0 - torch.exp(-delta_density)
    tau = torch.cumsum(delta_density[..., :-1], dim=-1)
    tau = torch.cat([torch.zeros_like(tau[..., :1]), tau], dim=-1)
    return torch.nan_to_num(alphas * torch.exp(-tau))


def composite_planes(weights: torch.Tensor,
                     *planes: torch.Tensor) -> List[torch.Tensor]:
    """(R, S) weights + planes -> one (R, 1) weighted sum per plane."""
    return [(weights * p).sum(dim=-1, keepdim=True) for p in planes]


def render_rgb_planes(weights: torch.Tensor, rgb_planes,
                      background_color=None,
                      generator: Optional[torch.Generator] = None,
                      training: bool = True) -> torch.Tensor:
    """render_rgb on three (R, S) channel planes -> (R, 3)."""
    if not training:
        rgb_planes = [torch.nan_to_num(p) for p in rgb_planes]
    comp = torch.cat(composite_planes(weights, *rgb_planes), dim=-1)
    acc = weights.sum(dim=-1, keepdim=True)
    bg = _background(background_color, comp, generator)
    if bg is not None:
        comp = comp + bg * (1.0 - acc)
    if not training:
        comp = comp.clamp(0.0, 1.0)
    return comp


def render_depth_median_planes(weights: torch.Tensor, starts: torch.Tensor,
                               ends: torch.Tensor) -> torch.Tensor:
    """render_depth_median on (R, S) planes -> (R, 1)."""
    steps = (starts + ends) / 2.0
    cum = torch.cumsum(weights, dim=-1)
    inf = torch.full_like(steps, float("inf"))
    depth = torch.where(cum >= 0.5, steps, inf).amin(dim=-1, keepdim=True)
    return torch.minimum(depth, steps[..., -1:])


def blend_background_for_loss_computation(pred_image: torch.Tensor,
                                          pred_accumulation: torch.Tensor,
                                          gt_image: torch.Tensor,
                                          background_color=None):
    """RGBRenderer.blend_background_for_loss_computation for a fixed
    background (white by default): an RGBA ground truth is blended
    against it; the prediction is returned unchanged."""
    if gt_image.shape[-1] == 4:
        bg = (white(gt_image.device) if background_color is None
              else background_color)
        rgb, alpha = gt_image[..., :3], gt_image[..., 3:]
        gt_image = rgb * alpha + bg * (1.0 - alpha)
    return pred_image, gt_image


class SafeSqrt(torch.autograd.Function):
    """sqrt with an exact forward and the backward clamped at
    1 / (2 max(sqrt(x), 1e-6)): a live zero (a collapsed roughness makes
    the reflected cone's pixel area 0) would otherwise send an infinite
    cotangent into every parameter (rsn.core.render.safe_sqrt)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, t):
        (y,) = ctx.saved_tensors
        return t / (2.0 * y.clamp_min(1e-6))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return SafeSqrt.apply(x)


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along the last axis; the norm goes through
    safe_sqrt, so the gradient stays finite at v = 0."""
    n = safe_sqrt((v * v).sum(dim=-1, keepdim=True))
    return v / n.clamp_min(eps)
