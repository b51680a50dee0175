"""Camera rings of the procedural synthetic scenes (port of the camera
half of rsn.data.synthetic).  The numpy ground-truth renderers come
with the eval slice; rendering needs only the cameras."""
from __future__ import annotations

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


def load_cameras(dataparser: str, data: str, split: str) -> Cameras:
    """The cameras of a run's dataset split.  Only the synthetic
    dataparser is ported; blender / nerfstudio / instant-ngp come with
    rsn/data/blender.py (ROADMAP Queue 1 step 9)."""
    if dataparser != "synthetic":
        raise NotImplementedError(
            f"dataparser {dataparser!r}: ROADMAP Queue 1 step 9 "
            "(rsn/data loaders) is not ported yet; only 'synthetic' is")
    return make_synthetic_cameras(split=split, **parse_synthetic_spec(data))
