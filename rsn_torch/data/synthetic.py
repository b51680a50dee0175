"""The procedural synthetic scenes (port of rsn.data.synthetic): their
camera rings, the numpy ground-truth renderers (the JAX package's own
code, so the images equal rsn's bit for bit), the `synthetic`
dataparser's data string, and `write_blender_scene`, a Blender-format
scene tree for the blender dataparser's tests.  Nothing is downloaded: a
scene is rendered analytically from its cameras.  The dataparser
dispatch is rsn_torch.data.blender.load_dataset."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from rsn_torch.data.cameras import Cameras

SCENES = ("sphere", "triple", "specular", "glossy", "shinyfloor")
# camera ring heights (z mid, z amplitude) on the radius-4 sphere: the
# standard ring, the steeper shinyfloor band, and the extrapolated-view
# eval bands (rsn.data.synthetic.FLOOR_CAM_Z / EXTRAP_BANDS)
RING_Z = (1.2, 0.8)
FLOOR_CAM_Z = (2.2, 0.8)
EXTRAP_BANDS = {"hi": (3.45, 0.25), "lo": (0.85, 0.30)}
CAMERA_ANGLE_X = 0.6911112070083618  # the Blender lego scene's fov


def _look_at_pose(eye: np.ndarray) -> np.ndarray:
    """OpenGL-style camera-to-world looking at the origin (z backward)."""
    forward = eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    if abs(np.dot(up, forward)) > 0.99:
        up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    true_up = np.cross(forward, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = true_up
    pose[:3, 2] = forward
    pose[:3, 3] = eye
    return pose


# ---- the ground-truth renderers (rsn.data.synthetic, unchanged) ----

SPHERE_RADIUS = 1.0
SPHERE_COLOR = np.array([0.8, 0.3, 0.2], np.float32)
LIGHT_DIR = np.array([0.577, 0.577, 0.577], np.float32)

# scene="triple": three off-center colored spheres.  The default
# single centered textureless sphere is (almost) rotationally
# symmetric, which makes camera-pose optimization ILL-POSED on it
# (many pose changes render identically); the triple scene breaks the
# symmetry so pose-refinement experiments are meaningful.
TRIPLE_SPHERES = (  # (center, radius, color)
    (np.array([0.0, 0.0, 0.0], np.float32), 0.8,
     np.array([0.8, 0.3, 0.2], np.float32)),
    (np.array([0.9, 0.6, -0.3], np.float32), 0.35,
     np.array([0.2, 0.6, 0.9], np.float32)),
    (np.array([-0.5, 0.9, 0.5], np.float32), 0.25,
     np.array([0.3, 0.8, 0.3], np.float32)),
)

# scene="specular": a MIRROR sphere at the origin reflecting three
# bright diffuse satellites.  This is the validation scene for the
# method's namesake machinery (the reflected passes 3/4,
# reflect_sampling_nerf_model.py:267-339): the mirror's appearance is
# dominated by one-bounce reflected radiance of distinguishable
# geometry, which a primary-only model (the "mipnerf" method) can only
# explain as view-dependent texture while the full model can resample
# the actual reflected rays.  The analytic render composes each mirror
# pixel exactly the way the model does (model.py:504:
# diff + tint * reflected_env), so the scene is realizable by the
# field's own appearance decomposition.
MIRROR_RADIUS = 0.9
MIRROR_TINT = np.array([0.85, 0.85, 0.9], np.float32)
MIRROR_DIFF = np.array([0.04, 0.04, 0.05], np.float32)
SPEC_SATELLITES = (  # (center, radius, color) — all diffuse
    (np.array([1.45, 0.0, 0.25], np.float32), 0.42,
     np.array([0.9, 0.15, 0.1], np.float32)),
    (np.array([-0.85, 1.25, -0.2], np.float32), 0.38,
     np.array([0.1, 0.4, 0.9], np.float32)),
    (np.array([-0.45, -1.35, 0.5], np.float32), 0.34,
     np.array([0.95, 0.8, 0.1], np.float32)),
)
# Checkerboard ground disk under the mirror: a convex mirror demagnifies
# hard, so the satellites alone cover only ~5% of the mirror's pixels —
# the disk fills the mirror's lower hemisphere with NEAR-FIELD,
# position-dependent (parallax) reflected content that a
# direction-only environment model cannot represent.
DISK_Z = -1.0
DISK_RADIUS = 1.9
DISK_CHECKER = 0.45
DISK_COLORS = (np.array([0.85, 0.12, 0.12], np.float32),
               np.array([0.12, 0.12, 0.85], np.float32))

# scene="glossy": the specular scene with the geometry anchor the
# near-perfect mirror lacks.  The 12- and 48-cam mirror A/Bs
# (BASELINE.md r3) record that on a diffuse-free mirror the density
# field "fakes" reflections and ∇σ normals never become multi-view
# consistent, so the reflected passes fire in wrong directions and
# HURT.  The reference's own target domain (shiny-Blender-style
# scenes) anchors geometry with textured diffuse under a glossy coat —
# here the sphere keeps a strong lat/long-checker Lambert albedo with
# a 0.45 uniform reflective tint over it.  The diffuse parallax pins
# the surface (hence the normals), and the resampled near-field
# reflected content (satellites + ground checker) is what separates
# reflected-ray resampling (reflect_sampling_nerf_model.py:267-339)
# from a direction-smooth ISH environment.
GLOSSY_TINT = np.float32(0.45)
GLOSSY_CHECK = 6  # checker cells per pi of latitude / per 2pi/3 of lon
GLOSSY_COLORS = (np.array([0.78, 0.22, 0.16], np.float32),
                 np.array([0.16, 0.42, 0.78], np.float32))

# scene="shinyfloor": a FLAT glossy checker floor under the three
# diffuse satellites — the scene class where explicit reflected-ray
# resampling (reflect_sampling_nerf_model.py:267-339) has the clearest
# edge over a direction-smooth ISH appearance model.  The curved-mirror
# scenes above fail on NORMALS (∇σ on a volumetric sphere never becomes
# multi-view consistent at this resolution, BASELINE.md r3/r4 A/Bs); a
# plane's normal is a constant, the easiest possible case for both the
# analytic and predicted normal paths — while the reflections of the
# hovering satellites in the floor carry strong PARALLAX (the mirrored
# image shifts with viewpoint), which a primary-only model can only
# explain as view-dependent floor texture that generalizes wrongly to
# held-out views.  This matches the dominant glossy geometry of the
# reference's shiny-Blender target domain (flat glossy surfaces under
# objects).  Albedo kept dim so diffuse + tint*reflection rarely clips.
FLOOR_TINT = np.float32(0.5)
FLOOR_COLORS = (np.array([0.40, 0.12, 0.10], np.float32),
                np.array([0.10, 0.14, 0.40], np.float32))
# Floor checker cells ~2.4x the satellite-scene disk's: at the ring
# cameras' grazing angles the 0.45-unit cells fall below the pixel
# footprint and point-sampled GT turns into aliasing noise NO
# footprint-aware (mip) model can match — the first shinyfloor A/B
# (10k) measured both legs blurring the floor into mud, drowning the
# reflection signal the benchmark exists to isolate.
FLOOR_CHECKER = 1.1
# GT prefilter (supersample factor): the scene's judge must be the
# pixel-footprint-AVERAGED radiance (what an ideal volumetric model
# predicts), not a point sample through the pixel center.
FLOOR_SSAA = 3


def _render_sphere(pose: np.ndarray, H: int, W: int,
                   focal: float) -> np.ndarray:
    """Analytic ray-traced Lambertian sphere, white background."""
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    d_cam = np.stack([(xs - W / 2.0) / focal, -(ys - H / 2.0) / focal,
                      -np.ones_like(xs)], axis=-1)
    d = d_cam @ pose[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = pose[:3, 3]

    b = 2.0 * np.sum(d * o, axis=-1)
    c = float(np.dot(o, o)) - SPHERE_RADIUS**2
    disc = b**2 - 4.0 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, 0.0)
    hit &= t > 0
    p = o + d * t[..., None]
    n = p / max(SPHERE_RADIUS, 1e-9)
    lam = np.clip(np.sum(n * LIGHT_DIR, axis=-1), 0.0, 1.0)
    shade = (0.25 + 0.75 * lam)[..., None] * SPHERE_COLOR
    img = np.where(hit[..., None], shade, 1.0).astype(np.float32)
    return img


def _render_triple(pose: np.ndarray, H: int, W: int,
                   focal: float) -> np.ndarray:
    """Nearest-hit ray trace of the TRIPLE_SPHERES scene."""
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    d_cam = np.stack([(xs - W / 2.0) / focal, -(ys - H / 2.0) / focal,
                      -np.ones_like(xs)], axis=-1)
    d = d_cam @ pose[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = pose[:3, 3]

    best_t = np.full(d.shape[:-1], np.inf, np.float32)
    img = np.ones(d.shape[:-1] + (3,), np.float32)
    for center, radius, color in TRIPLE_SPHERES:
        oc = o - center
        b = 2.0 * np.sum(d * oc, axis=-1)
        c = float(np.dot(oc, oc)) - radius**2
        disc = b**2 - 4.0 * c
        t = np.where(disc > 0,
                     (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, np.inf)
        closer = (t > 0) & (t < best_t)
        p = o + d * np.where(np.isfinite(t), t, 0.0)[..., None]
        n = (p - center) / max(radius, 1e-9)
        lam = np.clip(np.sum(n * LIGHT_DIR, axis=-1), 0.0, 1.0)
        shade = (0.25 + 0.75 * lam)[..., None] * color
        img = np.where(closer[..., None], shade, img)
        best_t = np.where(closer, t, best_t)
    return img.astype(np.float32)


def _sphere_hit(o, d, center, radius):
    """Nearest positive ray-sphere intersection t, +inf where none.

    o broadcasts against d (a (3,) camera origin for primary rays or a
    per-pixel (..., 3) surface point for reflected rays)."""
    oc = o - center
    b = 2.0 * np.sum(d * oc, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    disc = b**2 - 4.0 * c
    t = np.where(disc > 0,
                 (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, np.inf)
    return np.where(t > 1e-4, t, np.inf)


def _lambert(p, center, radius, color):
    n = (p - center) / max(radius, 1e-9)
    lam = np.clip(np.sum(n * LIGHT_DIR, axis=-1), 0.0, 1.0)
    return (0.25 + 0.75 * lam)[..., None] * color


def _trace_satellites(o, d):
    """Nearest diffuse radiance (satellites + checker disk) along
    (o, d); white bg where nothing is hit."""
    best_t = np.full(d.shape[:-1], np.inf, np.float32)
    rgb = np.ones(d.shape[:-1] + (3,), np.float32)
    for center, radius, color in SPEC_SATELLITES:
        t = _sphere_hit(o, d, center, radius)
        closer = t < best_t
        p = o + d * np.where(np.isfinite(t), t, 0.0)[..., None]
        rgb = np.where(closer[..., None], _lambert(p, center, radius, color),
                       rgb)
        best_t = np.where(closer, t, best_t)
    # checker disk at z = DISK_Z (normal +z; LIGHT_DIR gives a constant
    # Lambert factor per tile)
    oz = np.broadcast_to(np.asarray(o)[..., 2], d.shape[:-1])
    dz = d[..., 2]
    t_disk = np.where(np.abs(dz) > 1e-6, (DISK_Z - oz) / dz, np.inf)
    t_disk = np.where(t_disk > 1e-4, t_disk, np.inf)
    p = np.asarray(o) + d * np.where(np.isfinite(t_disk), t_disk,
                                     0.0)[..., None]
    in_disk = (p[..., 0] ** 2 + p[..., 1] ** 2) < DISK_RADIUS**2
    t_disk = np.where(in_disk, t_disk, np.inf)
    closer = t_disk < best_t
    parity = ((np.floor(p[..., 0] / DISK_CHECKER)
               + np.floor(p[..., 1] / DISK_CHECKER)) % 2).astype(int)
    lam = 0.25 + 0.75 * max(float(LIGHT_DIR[2]), 0.0)
    tile_rgb = lam * np.where(parity[..., None] == 0, DISK_COLORS[0],
                              DISK_COLORS[1])
    rgb = np.where(closer[..., None], tile_rgb, rgb)
    best_t = np.where(closer, t_disk, best_t)
    return rgb, best_t


def _render_specular(pose: np.ndarray, H: int, W: int,
                     focal: float) -> np.ndarray:
    """One-bounce ray trace of the mirror-sphere scene.

    Mirror pixels composite exactly like the model's reflected pass
    (model.py:504): diff_lambert + tint * radiance(reflected ray).
    The reflected ray leaves a convex sphere outward, so it can never
    re-hit the mirror — a single satellite trace is exact."""
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    d_cam = np.stack([(xs - W / 2.0) / focal, -(ys - H / 2.0) / focal,
                      -np.ones_like(xs)], axis=-1)
    d = d_cam @ pose[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = pose[:3, 3]

    sat_rgb, sat_t = _trace_satellites(o, d)
    mir_t = _sphere_hit(o, d, np.zeros(3, np.float32), MIRROR_RADIUS)

    # mirror shading where the mirror is the nearest hit
    tm = np.where(np.isfinite(mir_t), mir_t, 0.0)[..., None]
    p = o + d * tm
    n = p / MIRROR_RADIUS
    refl = d - 2.0 * np.sum(d * n, axis=-1, keepdims=True) * n
    env_rgb, _ = _trace_satellites(p, refl)
    mir_rgb = np.clip(
        _lambert(p, np.zeros(3, np.float32), MIRROR_RADIUS, MIRROR_DIFF)
        + MIRROR_TINT * env_rgb, 0.0, 1.0)

    img = np.ones(d.shape[:-1] + (3,), np.float32)  # white background
    img = np.where((sat_t < mir_t)[..., None], sat_rgb, img)
    img = np.where((mir_t <= sat_t)[..., None] & np.isfinite(mir_t)[..., None],
                   mir_rgb, img)
    return img.astype(np.float32)


def _trace_satellites_only(o, d):
    """Nearest diffuse satellite radiance along (o, d); white bg where
    nothing is hit (the shinyfloor scene's environment: no disk)."""
    best_t = np.full(d.shape[:-1], np.inf, np.float32)
    rgb = np.ones(d.shape[:-1] + (3,), np.float32)
    for center, radius, color in SPEC_SATELLITES:
        t = _sphere_hit(o, d, center, radius)
        closer = t < best_t
        p = o + d * np.where(np.isfinite(t), t, 0.0)[..., None]
        rgb = np.where(closer[..., None],
                       _lambert(p, center, radius, color), rgb)
        best_t = np.where(closer, t, best_t)
    return rgb, best_t


def _render_shinyfloor(pose: np.ndarray, H: int, W: int,
                       focal: float) -> np.ndarray:
    """One-bounce ray trace of the glossy-floor scene: checker Lambert
    albedo + FLOOR_TINT * radiance(reflected ray), the exact composite
    the model's reflected pass produces (model.py:504).  The floor is
    the DISK_Z plane disk; reflected rays mirror about +z and see the
    satellites (parallax) or the white sky."""
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    d_cam = np.stack([(xs - W / 2.0) / focal, -(ys - H / 2.0) / focal,
                      -np.ones_like(xs)], axis=-1)
    d = d_cam @ pose[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = pose[:3, 3]

    sat_rgb, sat_t = _trace_satellites_only(o, d)

    oz = np.broadcast_to(np.asarray(o)[..., 2], d.shape[:-1])
    dz = d[..., 2]
    t_f = np.where(np.abs(dz) > 1e-6, (DISK_Z - oz) / dz, np.inf)
    t_f = np.where(t_f > 1e-4, t_f, np.inf)
    p = np.asarray(o) + d * np.where(np.isfinite(t_f), t_f, 0.0)[..., None]
    in_disk = (p[..., 0] ** 2 + p[..., 1] ** 2) < DISK_RADIUS**2
    t_f = np.where(in_disk, t_f, np.inf)

    par = ((np.floor(p[..., 0] / FLOOR_CHECKER)
            + np.floor(p[..., 1] / FLOOR_CHECKER)) % 2).astype(int)
    albedo = np.where(par[..., None] == 0, FLOOR_COLORS[0],
                      FLOOR_COLORS[1])
    lam = 0.25 + 0.75 * max(float(LIGHT_DIR[2]), 0.0)  # n = +z
    refl = d * np.array([1.0, 1.0, -1.0], np.float32)  # mirror about z
    env_rgb, _ = _trace_satellites_only(p, refl)
    floor_rgb = np.clip(lam * albedo + FLOOR_TINT * env_rgb, 0.0, 1.0)

    img = np.ones(d.shape[:-1] + (3,), np.float32)  # white background
    img = np.where((sat_t < t_f)[..., None], sat_rgb, img)
    img = np.where((t_f <= sat_t)[..., None] & np.isfinite(t_f)[..., None],
                   floor_rgb, img)
    return img.astype(np.float32)


def _render_glossy(pose: np.ndarray, H: int, W: int,
                   focal: float) -> np.ndarray:
    """One-bounce ray trace of the glossy-sphere scene: textured
    Lambert diffuse + GLOSSY_TINT * radiance(reflected ray), the exact
    composite the model's reflected pass produces (model.py:504)."""
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    d_cam = np.stack([(xs - W / 2.0) / focal, -(ys - H / 2.0) / focal,
                      -np.ones_like(xs)], axis=-1)
    d = d_cam @ pose[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = pose[:3, 3]

    sat_rgb, sat_t = _trace_satellites(o, d)
    mir_t = _sphere_hit(o, d, np.zeros(3, np.float32), MIRROR_RADIUS)

    tm = np.where(np.isfinite(mir_t), mir_t, 0.0)[..., None]
    p = o + d * tm
    n = p / MIRROR_RADIUS
    refl = d - 2.0 * np.sum(d * n, axis=-1, keepdims=True) * n
    env_rgb, _ = _trace_satellites(p, refl)
    # lat/long checker albedo — the diffuse texture that anchors the
    # surface (and therefore the analytic normals) across views
    lon = np.arctan2(n[..., 1], n[..., 0])  # [-pi, pi)
    lat = np.arcsin(np.clip(n[..., 2], -1.0, 1.0))  # [-pi/2, pi/2]
    par = (np.floor((lon / np.pi + 1.0) * 1.5 * GLOSSY_CHECK)
           + np.floor((lat / np.pi + 0.5) * GLOSSY_CHECK)).astype(int) % 2
    albedo = np.where(par[..., None] == 0, GLOSSY_COLORS[0],
                      GLOSSY_COLORS[1])
    lam = np.clip(np.sum(n * LIGHT_DIR, axis=-1), 0.0, 1.0)
    shade = (0.25 + 0.75 * lam)[..., None] * albedo
    mir_rgb = np.clip(shade + GLOSSY_TINT * env_rgb, 0.0, 1.0)

    img = np.ones(d.shape[:-1] + (3,), np.float32)  # white background
    img = np.where((sat_t < mir_t)[..., None], sat_rgb, img)
    img = np.where((mir_t <= sat_t)[..., None] & np.isfinite(mir_t)[..., None],
                   mir_rgb, img)
    return img.astype(np.float32)


def make_synthetic_cameras(num_cameras: int = 12, H: int = 64, W: int = 64,
                           split: str = "train", scene: str = "sphere",
                           extrap: str = "") -> Cameras:
    """The camera ring of rsn.data.synthetic.make_synthetic_dataset:
    `num_cameras` poses on the radius-4 sphere looking at the origin,
    lego's field of view; non-train splits are offset by half a step."""
    if scene not in SCENES:
        raise ValueError(f"unknown synthetic scene: {scene}")
    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    phase = 0.0 if split == "train" else 0.5 * (2 * np.pi / max(num_cameras, 1))
    z_mid, z_amp = FLOOR_CAM_Z if scene == "shinyfloor" else RING_Z
    if extrap and split != "train":
        z_mid, z_amp = EXTRAP_BANDS[extrap]
    poses = []
    for i in range(num_cameras):
        theta = 2.0 * np.pi * i / num_cameras + phase
        z = z_mid + z_amp * np.sin(3 * theta + 1.0)
        eye = np.array([4.0 * np.cos(theta), 4.0 * np.sin(theta), z],
                       np.float32)
        eye *= 4.0 / np.linalg.norm(eye)
        poses.append(_look_at_pose(eye))
    N = num_cameras
    return Cameras(
        camera_to_worlds=torch.as_tensor(np.stack(poses)[:, :3, :4]),
        fx=torch.full((N,), focal, dtype=torch.float32),
        fy=torch.full((N,), focal, dtype=torch.float32),
        cx=torch.full((N,), W / 2.0, dtype=torch.float32),
        cy=torch.full((N,), H / 2.0, dtype=torch.float32),
        width=W, height=H)


def parse_synthetic_spec(spec: str) -> Dict:
    """`scene[:cams=N,res=R,extrap=hi|lo]` (the synthetic dataparser's
    `data` string, rsn/data/blender.py) -> make_synthetic_cameras kwargs."""
    scene, _, opts = (spec or "sphere").partition(":")
    kw: Dict = {"scene": scene or "sphere"}
    for item in filter(None, opts.split(",")):
        k, _, v = item.partition("=")
        if k == "cams":
            kw["num_cameras"] = int(v)
        elif k == "res":
            kw["H"] = kw["W"] = int(v)
        elif k == "extrap":
            if v not in EXTRAP_BANDS:
                raise ValueError(f"unknown extrap band: {v}")
            kw["extrap"] = v
        else:
            raise ValueError(f"unknown synthetic-scene option: {item}")
    return kw


@dataclasses.dataclass
class Dataset:
    """One split: images (N, H, W, 3) float32 numpy, cameras on the CPU."""
    images: np.ndarray
    cameras: Cameras
    split: str


RENDERERS = {"sphere": _render_sphere, "triple": _render_triple,
             "specular": _render_specular, "glossy": _render_glossy,
             "shinyfloor": _render_shinyfloor}


def make_synthetic_dataset(num_cameras: int = 12, H: int = 64, W: int = 64,
                           split: str = "train", scene: str = "sphere",
                           extrap: str = "") -> Dataset:
    """The split's cameras (make_synthetic_cameras) and their analytic
    ground-truth images (rsn.data.synthetic.make_synthetic_dataset);
    shinyfloor is supersampled FLOOR_SSAA x and box-filtered."""
    cams = make_synthetic_cameras(num_cameras, H, W, split, scene, extrap)
    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)  # float64, as rsn's
    ss = FLOOR_SSAA if scene == "shinyfloor" else 1
    poses = np.eye(4, dtype=np.float32)[None].repeat(num_cameras, 0)
    poses[:, :3, :4] = cams.camera_to_worlds.numpy()
    images = []
    for pose in poses:
        img = RENDERERS[scene](pose, H * ss, W * ss, focal * ss)
        if ss > 1:  # box prefilter back to (H, W)
            img = img.reshape(H, ss, W, ss, 3).mean(axis=(1, 3))
        images.append(img.astype(np.float32))
    return Dataset(images=np.stack(images), cameras=cams, split=split)


def write_blender_scene(out_dir: str, num_cameras: int = 6, H: int = 32,
                        W: int = 32) -> str:
    """Write a Blender-format scene tree (transforms_{train,val,test}.json
    and 8-bit RGB PNGs of the sphere) as rsn.data.synthetic's
    write_blender_scene writes it: the same poses and the same
    `(img * 255).astype(uint8)` pixels, so both packages' loaders read
    identical pixels."""
    from rsn_torch.data.png import write_png

    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    for split, phase in (("train", 0.0), ("val", 0.3), ("test", 0.6)):
        frames = []
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        for i in range(num_cameras):
            theta = 2 * np.pi * i / num_cameras + phase
            eye = np.array([4 * np.cos(theta), 4 * np.sin(theta), 1.5],
                           np.float32)
            eye *= 4.0 / np.linalg.norm(eye)
            pose = _look_at_pose(eye)
            img = _render_sphere(pose, H, W, focal)
            rel = f"./{split}/r_{i}"
            write_png(os.path.join(out_dir, rel.replace("./", "") + ".png"),
                      (img * 255).astype(np.uint8))
            frames.append({"file_path": rel,
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames},
                      f)
    return out_dir
