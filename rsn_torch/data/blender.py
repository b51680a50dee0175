"""The Blender-synthetic (transforms_<split>.json), nerfstudio-format and
instant-ngp-format loaders, and the dataparser dispatch (port of
rsn/data/blender.py).

A split comes back as a Dataset: images (N, H, W, 3) float32 numpy in
[0, 1] (RGBA blended to white, BlenderDataParser's alpha_color) and
Cameras on the CPU; the trainer and the CLIs move them to the device.

Images: rsn decodes 8-bit non-interlaced PNGs at downscale 1 with its
native library and every other frame with PIL.  The port takes the same
routes: the same C++ library (rsn_torch.data.native), and for the PIL
frames rsn_torch.data.jpeg.read_image, which picks the decoder by the
file's first bytes as Image.open does and gives what PIL gives: PNGs
through rsn_torch.data.png (palette indices, 16-bit gray values), JPEGs
through the native JPEG decoder (libjpeg-turbo's pixels, CMYK included),
TIFFs through rsn_torch.data.tiff (every mode PIL opens them as: 1, L,
I;16, I;16B, I, F, LA, RGB, RGBA, P, PA, CMYK, LAB), WebPs through
rsn_torch.data.webp (RGB or RGBA, libwebp's pixels), BMP / DIB, GIF
(frame 0's palette indices), the PPM family (1, L, I, F, RGB and PIL's
P, RGBA, CMYK) and TGA (1, L, LA, P, RGB, RGBA) through
rsn_torch.data.bmp, gif, ppm and tga, JPEG 2000 through
rsn_torch.data.jpeg2000, AVIF still images (RGB or RGBA) through
rsn_torch.data.avif, and Pillow's bilinear shrink for each mode.  A
file PIL refuses raises ValueError, as rsn's PIL raises; a format none of
these, or a TIFF, JPEG 2000 or AVIF kind not ported yet, raises
NotImplementedError (ROADMAP Queue 1).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from rsn_torch.data import native, png
from rsn_torch.data.jpeg import read_image
from rsn_torch.data.cameras import Cameras
from rsn_torch.data.synthetic import (Dataset, make_synthetic_cameras,
                                      make_synthetic_dataset,
                                      parse_synthetic_spec)


def _load_image(path: str, downscale: int = 1) -> np.ndarray:
    """One frame as rsn's PIL path reads it: resized by
    `Image.resize((w // downscale, h // downscale), BILINEAR)`, divided
    by 255 in float32, gray repeated to 3 channels, RGBA blended to white,
    the first 3 channels kept (a gray + alpha or palette + alpha frame
    keeps its 2, as rsn's does; a CMYK frame has C, M, Y blended over its
    K as rsn blends them, K taken for alpha; I;16, I and F values are
    divided as they are, past 1 where they are past 255; a mode 1 frame's
    bools are 0 and 1 before the division, so 1 / 255 at most)."""
    mode, img = read_image(path)
    if downscale > 1:
        img = png.resize_bilinear(mode, img, (img.shape[1] // downscale,
                                              img.shape[0] // downscale))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 4:  # alpha-blend to white (BlenderDataParser)
        arr = arr[..., :3] * arr[..., 3:] + (1.0 - arr[..., 3:])
    return arr[..., :3]


def _load_images_batch(paths: List[str], downscale: int = 1) -> np.ndarray:
    """Same-size frames -> (N, H, W, 3) float32: the native decoder (the
    white blend in C) for PNGs at downscale 1 when it decodes all of
    them, else _load_image per frame."""
    if downscale == 1 and paths and paths[0].lower().endswith(".png"):
        probed = native.probe_png(paths[0])
        if probed is not None:
            out = native.decode_png_batch(paths, *probed, blend_white=True)
            if out is not None:
                return out
    return np.stack([_load_image(p, downscale) for p in paths])


def _f32(values) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32))


def load_blender(data_dir: str, split: str = "train", downscale: int = 1,
                 scale_factor: float = 1.0,
                 max_images: Optional[int] = None) -> Dataset:
    """A NeRF-synthetic scene split from transforms_<split>.json."""
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if max_images is not None:
        frames = frames[:max_images]

    paths: List[str] = []
    poses: List[np.ndarray] = []
    for frame in frames:
        fname = os.path.join(data_dir, frame["file_path"].replace("./", ""))
        if not os.path.splitext(fname)[1]:
            fname = fname + ".png"
        paths.append(fname)
        poses.append(np.array(frame["transform_matrix"], dtype=np.float32))

    imgs = _load_images_batch(paths, downscale)  # (N, H, W, 3)
    poses_np = np.stack(poses)  # (N, 4, 4)
    poses_np[:, :3, 3] *= scale_factor
    N, H, W = imgs.shape[:3]

    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    cameras = Cameras(
        camera_to_worlds=torch.from_numpy(
            np.ascontiguousarray(poses_np[:, :3, :4])),
        fx=torch.full((N,), focal, dtype=torch.float32),
        fy=torch.full((N,), focal, dtype=torch.float32),
        cx=torch.full((N,), W / 2.0, dtype=torch.float32),
        cy=torch.full((N,), H / 2.0, dtype=torch.float32),
        width=W, height=H)
    return Dataset(images=imgs, cameras=cameras, split=split)


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues;
    nerfstudio camera_utils.rotation_matrix semantics)."""
    c = float(np.dot(a, b))
    if c < -1.0 + 1e-6:
        # near anti-parallel: 1 / (1 + c) cancels; rotate pi about any
        # axis orthogonal to a
        helper = np.array([1.0, 0.0, 0.0])
        if abs(a[0]) > 0.9:
            helper = np.array([0.0, 1.0, 0.0])
        axis = np.cross(a, helper)
        axis = axis / np.linalg.norm(axis)
        return (2.0 * np.outer(axis, axis) - np.eye(3)).astype(np.float32)
    v = np.cross(a, b)
    if np.linalg.norm(v) < 1e-8:  # parallel
        return np.eye(3, dtype=np.float32)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(poses: np.ndarray, method: str = "up",
                                 center_method: str = "poses"):
    """nerfstudio camera_utils.auto_orient_and_center_poses defaults:
    center on the mean camera origin, rotate the mean camera up vector
    (+y column of the OpenGL c2w) onto world +z.  poses: (N, 3 or 4, 4)
    -> (N, 3, 4)."""
    poses = np.asarray(poses, np.float32)[:, :3, :4].copy()
    if center_method == "poses":
        center = poses[:, :3, 3].mean(axis=0)
    else:
        center = np.zeros(3, np.float32)
    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / max(np.linalg.norm(up), 1e-8)
        rot = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
    else:
        rot = np.eye(3, dtype=np.float32)
    poses[:, :3, 3] = (poses[:, :3, 3] - center) @ rot.T
    poses[:, :3, :3] = np.einsum("ij,njk->nik", rot, poses[:, :3, :3])
    return poses.astype(np.float32)


def auto_scale_poses(poses: np.ndarray) -> float:
    """nerfstudio auto_scale_poses: 1 / the largest camera-origin norm."""
    return float(1.0 / max(np.linalg.norm(poses[:, :3, 3], axis=-1).max(),
                           1e-8))


_DIST_KEYS = ("k1", "k2", "k3", "k4", "p1", "p2")


def _normalized_poses(frames, scale_factor: float) -> np.ndarray:
    """Every frame's pose oriented, centered and scaled into the unit
    ball, computed over ALL frames before the split (nerfstudio computes
    the transform once, so train and eval cameras share a world)."""
    all_poses = np.stack([np.array(f["transform_matrix"], np.float32)
                          for f in frames])
    all_poses = auto_orient_and_center_poses(all_poses)
    all_poses[:, :3, 3] *= auto_scale_poses(all_poses) * scale_factor
    return all_poses


def _split_indices(n: int, split: str, train_fraction: float,
                   max_images: Optional[int]) -> np.ndarray:
    idx = np.arange(n)
    n_train = int(round(n * train_fraction))
    train_idx = np.linspace(0, n - 1, n_train, dtype=int)
    eval_idx = np.setdiff1d(idx, train_idx)
    sel = train_idx if split == "train" else eval_idx
    return sel if max_images is None else sel[:max_images]


def _cameras(poses_np, fx, fy, cx, cy, W, H, dist, camera_model):
    dist_np = np.asarray(dist, np.float32)
    return Cameras(
        camera_to_worlds=torch.from_numpy(
            np.ascontiguousarray(poses_np[:, :3, :4])),
        fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
        width=W, height=H,
        distortion=(torch.from_numpy(dist_np)
                    if np.any(dist_np != 0.0) else None),
        camera_model=camera_model)


def load_nerfstudio(data_dir: str, split: str = "train", downscale: int = 1,
                    train_fraction: float = 0.9,
                    max_images: Optional[int] = None,
                    scale_factor: float = 1.0) -> Dataset:
    """A nerfstudio-format capture (transforms.json, per-frame
    intrinsics), split by train_fraction; NerfstudioDataParser's default
    pose processing (orient up, center, scale to the unit ball); the
    OpenCV distortion carried into the Cameras (undistorted at ray
    generation)."""
    with open(os.path.join(data_dir, "transforms.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]

    camera_model = meta.get("camera_model", "OPENCV")
    if camera_model in ("OPENCV", "PINHOLE", "SIMPLE_PINHOLE"):
        cam_model = "perspective"
    elif camera_model == "OPENCV_FISHEYE":
        cam_model = "fisheye"  # Kannala-Brandt theta polynomial (k1-k4)
    elif camera_model == "EQUIRECTANGULAR":
        cam_model = "equirectangular"  # intrinsics derived from W / H
    else:
        # unknown projections must fail loudly, not generate wrong rays
        raise NotImplementedError(
            f"camera_model {camera_model!r} is not supported "
            "(OPENCV/PINHOLE perspective, OPENCV_FISHEYE, or "
            "EQUIRECTANGULAR)")

    all_poses = _normalized_poses(frames, scale_factor)
    sel = _split_indices(len(frames), split, train_fraction, max_images)

    def gkey(frame, key):
        return frame.get(key, meta.get(key))

    images, fx, fy, cx, cy, dist = [], [], [], [], [], []
    for i in sel:
        frame = frames[i]
        images.append(_load_image(os.path.join(data_dir, frame["file_path"]),
                                  downscale))
        if cam_model != "equirectangular":  # panoramas carry no focals
            fx.append(float(gkey(frame, "fl_x")) / downscale)
            fy.append(float(gkey(frame, "fl_y")) / downscale)
            cx.append(float(gkey(frame, "cx")) / downscale)
            cy.append(float(gkey(frame, "cy")) / downscale)
        dist.append([float(gkey(frame, k) or 0.0) for k in _DIST_KEYS])

    imgs = np.stack(images)
    N, H, W = imgs.shape[:3]
    if cam_model == "equirectangular":
        # normalized panorama intrinsics (rsn_torch.data.cameras): azimuth
        # spans +-pi across the width, polar 0..pi over the height
        fx, fy, cx, cy = ([W / 2.0] * N, [float(H)] * N, [W / 2.0] * N,
                          [H / 2.0] * N)
    cameras = _cameras(all_poses[sel], fx, fy, cx, cy, W, H, dist, cam_model)
    return Dataset(images=imgs, cameras=cameras, split=split)


def load_instant_ngp(data_dir: str, split: str = "train",
                     downscale: int = 1, train_fraction: float = 0.9,
                     max_images: Optional[int] = None,
                     scale_factor: float = 1.0) -> Dataset:
    """An instant-ngp-format capture (transforms.json with shared
    top-level intrinsics, camera_angle_x / _y as the focal fallback,
    OpenCV k1 k2 p1 p2; per-frame keys win).  As rsn does, the poses are
    oriented, centered and scaled into the unit ball like the nerfstudio
    format's (nerfstudio keeps raw NGP coordinates and widens its scene
    box by aabb_scale instead: the same scene up to a similarity)."""
    with open(os.path.join(data_dir, "transforms.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    all_poses = _normalized_poses(frames, scale_factor)
    sel = _split_indices(len(frames), split, train_fraction, max_images)

    def gkey(frame, key, default=None):
        v = frame.get(key, meta.get(key))
        return default if v is None else v

    images, fx, fy, cx, cy, dist = [], [], [], [], [], []
    for i in sel:
        frame = frames[i]
        fname = os.path.join(data_dir, frame["file_path"])
        if not os.path.splitext(fname)[1]:
            fname = fname + ".png"
        images.append(_load_image(fname, downscale))
        h_, w_ = images[-1].shape[:2]
        flx = gkey(frame, "fl_x")
        if flx is None:  # camera_angle fallback (instant-ngp synthetic)
            flx = 0.5 * w_ * downscale / np.tan(
                0.5 * float(gkey(frame, "camera_angle_x")))
        fly = gkey(frame, "fl_y")
        if fly is None:
            ay = gkey(frame, "camera_angle_y")
            fly = (0.5 * h_ * downscale / np.tan(0.5 * float(ay))
                   if ay is not None else flx)
        fx.append(float(flx) / downscale)
        fy.append(float(fly) / downscale)
        cx.append(float(gkey(frame, "cx", w_ * downscale / 2.0)) / downscale)
        cy.append(float(gkey(frame, "cy", h_ * downscale / 2.0)) / downscale)
        dist.append([float(gkey(frame, k, 0.0) or 0.0)
                     for k in _DIST_KEYS])

    imgs = np.stack(images)
    N, H, W = imgs.shape[:3]
    cameras = _cameras(all_poses[sel], fx, fy, cx, cy, W, H, dist,
                       "perspective")
    return Dataset(images=imgs, cameras=cameras, split=split)


def load_dataset(parser: str, data_dir: str, split: str,
                 downscale: int = 1, scale_factor: float = 1.0,
                 max_images: Optional[int] = None) -> Dataset:
    """A split of the run's dataset by its dataparser: blender,
    nerfstudio, instant-ngp or synthetic (data =
    `scene[:cams=N,res=R,extrap=hi|lo]`, rsn_torch.data.synthetic)."""
    if parser == "blender":
        return load_blender(data_dir, split, downscale, scale_factor,
                            max_images)
    if parser == "nerfstudio":
        return load_nerfstudio(data_dir, split, downscale,
                               max_images=max_images,
                               scale_factor=scale_factor)
    if parser == "instant-ngp":
        return load_instant_ngp(data_dir, split, downscale,
                                max_images=max_images,
                                scale_factor=scale_factor)
    if parser == "synthetic":
        return make_synthetic_dataset(split=split,
                                      **parse_synthetic_spec(data_dir))
    raise ValueError(f"unknown dataparser: {parser}")


def load_cameras(parser: str, data_dir: str, split: str,
                 downscale: int = 1, scale_factor: float = 1.0) -> Cameras:
    """The cameras of a split; the synthetic parser's without rendering
    its images."""
    if parser == "synthetic":
        return make_synthetic_cameras(split=split,
                                      **parse_synthetic_spec(data_dir))
    return load_dataset(parser, data_dir, split, downscale,
                        scale_factor).cameras
