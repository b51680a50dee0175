"""Camera pose refinement, the "camera_opt" optimizer group (port of
rsn.models.camera_opt).

Mode "SO3xR3": one se(3) delta (omega(3), t(3)) per training camera,
zeros at init, applied about the camera centre of each sampled ray:
origins' = origins + t, dirs' = R(omega) dirs, renormalised.  All rays of
a pinhole camera share their origin, so this is nerfstudio's c2w
right-multiply up to a fixed per-camera reparameterisation, with no
camera-to-world inside the train step.  Mode "off" (the reference's
default: the group binds no parameters) leaves the bundle as it is.

The per-ray lookup is a gather on camera_indices, and the Rodrigues
coefficients are series-guarded, so the gradient is exact and finite at
omega = 0, where every delta starts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rsn_torch.core.rays import RayBundle


def init_camera_opt_params(num_cameras: int, mode: str,
                           device=None) -> Optional[torch.nn.Parameter]:
    """-> an (N, 6) zero Parameter for SO3xR3, None for off."""
    if mode == "off":
        return None
    if mode != "SO3xR3":
        raise ValueError(f"unknown camera_optimizer mode {mode!r}")
    return torch.nn.Parameter(torch.zeros(num_cameras, 6, device=device))


def rotate_rodrigues(omega: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(omega) v for axis-angle omega (..., 3) applied to v (..., 3):
    v + sinc|w| (w x v) + (1 - cos|w|) / |w|^2 w x (w x v), with 2-term
    Taylor coefficients below |w|^2 = 1e-8."""
    theta2 = (omega * omega).sum(dim=-1, keepdim=True)
    small = theta2 < 1e-8
    # double where: the branch not taken still sees a safe denominator,
    # or its derivative is 0/0 = NaN and poisons the backward
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    wxv = torch.linalg.cross(omega, v, dim=-1)
    wxwxv = torch.linalg.cross(omega, wxv, dim=-1)
    return v + a * wxv + b * wxwxv


def apply_to_bundle(bundle: RayBundle, deltas: Optional[torch.Tensor],
                    mode: str = "off") -> RayBundle:
    """The per-camera pose deltas (N, 6) applied to a sampled bundle."""
    if mode == "off" or deltas is None:
        return bundle
    if bundle.camera_indices is None:
        raise ValueError("the camera optimizer needs the bundle's "
                         "camera_indices")
    d = deltas[bundle.camera_indices[..., 0]]  # (R, 6)
    omega, t = d[..., 0:3], d[..., 3:6]
    # the rotation acts about the camera centre (every ray's origin), so it
    # moves the directions only; the translation moves the centre
    dirs = rotate_rodrigues(omega, bundle.directions)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return dataclasses.replace(bundle, origins=bundle.origins + t,
                               directions=dirs)


def regularization_loss(deltas: Optional[torch.Tensor],
                        rot_penalty: float = 1e-3,
                        trans_penalty: float = 1e-2) -> torch.Tensor:
    """L2 penalty on the pose deltas (nerfstudio's rot_l2_penalty /
    trans_l2_penalty): without it the camera / scene gauge freedom lets
    poses drift on scenes whose poses are already good."""
    if deltas is None:
        return torch.zeros(())
    rot = (deltas[..., 0:3] ** 2).sum()
    trans = (deltas[..., 3:6] ** 2).sum()
    return rot_penalty * rot + trans_penalty * trans
