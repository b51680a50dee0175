"""Cameras and ray generation (port of rsn.data.cameras).

nerfstudio Cameras.generate_rays semantics: pixel centres at
(x + 0.5, y + 0.5), OpenGL camera space [(x-cx)/fx, -(y-cy)/fy, -1]
rotated by camera-to-world and normalised, pixel_area = the product of
the finite-difference footprints |d(x+1,y) - d(x,y)| |d(x,y+1) - d(x,y)|
of the normalised directions.  Perspective (OpenCV k1..k4, p1, p2),
fisheye (Kannala-Brandt theta polynomial) and equirectangular models.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class Cameras:
    """Stacked cameras; the leading axis is the camera index."""
    camera_to_worlds: torch.Tensor  # (N, 3, 4)
    fx: torch.Tensor                # (N,)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 0
    height: int = 0
    # perspective: OpenCV [k1 k2 k3 k4 p1 p2]; fisheye: [k1 k2 k3 k4 0 0]
    distortion: Optional[torch.Tensor] = None  # (N, 6)
    camera_model: str = "perspective"  # | "fisheye" | "equirectangular"

    @property
    def num_cameras(self) -> int:
        return self.camera_to_worlds.shape[0]

    def to(self, device) -> "Cameras":
        return dataclasses.replace(
            self, camera_to_worlds=self.camera_to_worlds.to(device),
            fx=self.fx.to(device), fy=self.fy.to(device),
            cx=self.cx.to(device), cy=self.cy.to(device),
            distortion=(None if self.distortion is None
                        else self.distortion.to(device)))


def rescale_cameras(cams: Cameras, factor: float) -> Cameras:
    """Render at 1/factor resolution (ns-render --downscale-factor):
    width/height and the intrinsics scale together, so every pixel keeps
    its world ray; poses, distortion and projection model are unchanged."""
    if factor == 1.0:
        return cams
    if factor <= 0.0:
        raise ValueError(f"downscale factor must be > 0, got {factor}")
    s = 1.0 / float(factor)
    return dataclasses.replace(
        cams, fx=cams.fx * s, fy=cams.fy * s, cx=cams.cx * s, cy=cams.cy * s,
        width=max(1, int(round(cams.width * s))),
        height=max(1, int(round(cams.height * s))))


def undistort_coords(x: torch.Tensor, y: torch.Tensor, dist: torch.Tensor,
                     iters: int = 10):
    """Invert the OpenCV radial + tangential model with Newton steps on
    the residual (nerfstudio radial_and_tangential_undistort)."""
    k1, k2, k3, k4, p1, p2 = dist.unbind(-1)
    eps = 1e-6
    xu, yu = x, y
    for _ in range(iters):
        r = xu * xu + yu * yu
        d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
        fx = d * xu + 2.0 * p1 * xu * yu + p2 * (r + 2.0 * xu * xu) - x
        fy = d * yu + 2.0 * p2 * xu * yu + p1 * (r + 2.0 * yu * yu) - y
        d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + 4.0 * k4 * r))
        d_x = 2.0 * xu * d_r
        d_y = 2.0 * yu * d_r
        fx_x = d + d_x * xu + 2.0 * p1 * yu + 6.0 * p2 * xu
        fx_y = d_y * xu + 2.0 * p1 * xu + 2.0 * p2 * yu
        fy_x = d_x * yu + 2.0 * p2 * yu + 2.0 * p1 * xu
        fy_y = d + d_y * yu + 2.0 * p2 * xu + 6.0 * p1 * yu
        denom = fy_x * fx_y - fx_x * fy_y
        safe = denom.abs() > eps
        denom_s = torch.where(safe, denom, torch.ones_like(denom))
        zero = torch.zeros_like(denom)
        xu = xu + torch.where(safe, (fx * fy_y - fy * fx_y) / denom_s, zero)
        yu = yu + torch.where(safe, (fy * fx_x - fx * fy_x) / denom_s, zero)
    return xu, yu


def distort_coords(x: torch.Tensor, y: torch.Tensor, dist: torch.Tensor):
    """Forward OpenCV distortion (the inverse of undistort_coords)."""
    k1, k2, k3, k4, p1, p2 = dist.unbind(-1)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def fisheye_distort_theta(theta: torch.Tensor,
                          dist: torch.Tensor) -> torch.Tensor:
    """Kannala-Brandt: theta_d = theta (1 + k1 t^2 + k2 t^4 + k3 t^6 +
    k4 t^8)."""
    k1, k2, k3, k4 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def fisheye_undistort_theta(theta_d: torch.Tensor, dist: torch.Tensor,
                            iters: int = 10) -> torch.Tensor:
    """Invert the theta polynomial with Newton steps."""
    k1, k2, k3, k4 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) \
            - theta_d
        fp = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (
            7.0 * k3 + 9.0 * k4 * t2)))
        theta = theta - f / torch.where(fp.abs() > 1e-6, fp,
                                        torch.ones_like(fp))
    return theta


def _camera_space_dirs(x, y, fx, fy, cx, cy, dist=None,
                       camera_model: str = "perspective") -> torch.Tensor:
    """Unnormalised camera-space directions of pixel-centre coordinates."""
    u = (x - cx) / fx
    v = (y - cy) / fy
    if camera_model == "equirectangular":
        theta = -math.pi * u
        phi = math.pi * (0.5 + v)
        sin_phi = torch.sin(phi)
        return torch.stack([-torch.sin(theta) * sin_phi, torch.cos(phi),
                            -torch.cos(theta) * sin_phi], dim=-1)
    if camera_model == "fisheye":
        theta_d = torch.sqrt(u * u + v * v)
        theta = (fisheye_undistort_theta(theta_d, dist)
                 if dist is not None else theta_d)
        scale = torch.where(theta_d > 1e-9,
                            torch.tan(theta) / theta_d.clamp_min(1e-9),
                            torch.ones_like(theta_d))
        u = u * scale
        v = v * scale
    elif dist is not None:
        u, v = undistort_coords(u, v, dist)
    return torch.stack([u, -v, -torch.ones_like(x)], dim=-1)


def generate_rays(cameras: Cameras, camera_indices: torch.Tensor,
                  pixel_y: torch.Tensor, pixel_x: torch.Tensor):
    """Rays of (camera, y, x) index triples, each (R,)
    -> origins (R, 3), unit directions (R, 3), pixel_area (R, 1)."""
    c2w = cameras.camera_to_worlds[camera_indices]
    fx, fy = cameras.fx[camera_indices], cameras.fy[camera_indices]
    cx, cy = cameras.cx[camera_indices], cameras.cy[camera_indices]
    dist = (cameras.distortion[camera_indices]
            if cameras.distortion is not None else None)
    xs = pixel_x.float() + 0.5
    ys = pixel_y.float() + 0.5

    def world_dir(px, py):
        d_cam = _camera_space_dirs(px, py, fx, fy, cx, cy, dist,
                                   cameras.camera_model)
        d = torch.einsum("rij,rj->ri", c2w[..., :3, :3], d_cam)
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)

    d0 = world_dir(xs, ys)
    dx = torch.linalg.norm(d0 - world_dir(xs + 1.0, ys), dim=-1)
    dy = torch.linalg.norm(d0 - world_dir(xs, ys + 1.0), dim=-1)
    return c2w[..., :3, 3], d0, (dx * dy)[..., None]


def generate_image_rays(cameras: Cameras, camera_index: int):
    """All H*W rays of one camera, row-major, on the cameras' device."""
    H, W = cameras.height, cameras.width
    device = cameras.camera_to_worlds.device
    yy, xx = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    idx = torch.full((H * W,), camera_index, dtype=torch.long, device=device)
    return generate_rays(cameras, idx, yy.reshape(-1), xx.reshape(-1))
