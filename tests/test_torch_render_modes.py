"""rsn_torch's render modes against rsn's: the quaternion helpers, slerp,
interpolate / spiral / path cameras; the GIF writer and reader (against
PIL's decoder); the render CLI's split, generated-path and --video
modes on a tiny run."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from rsn.cli import render as jrender
from rsn.data.cameras import Cameras as JCameras
from rsn_torch.cli import render as trender
from rsn_torch.cli.registry import get_method
from rsn_torch.data.cameras import Cameras
from rsn_torch.data.png import read_png
from rsn_torch.data.synthetic import _look_at_pose
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.models.field import Field
from rsn_torch.utils import gif


def _ring(model="perspective", distortion=True, n=4, w=32, h=24):
    """The same cameras in both packages: a partial ring, per-camera
    intrinsics and distortion."""
    rng = np.random.default_rng(n)
    poses = []
    for i in range(n):
        theta = 2.0 * np.pi * i / n * 0.4
        eye = np.array([np.cos(theta), np.sin(theta), 0.4], np.float32)
        eye *= 4.0 / np.linalg.norm(eye)
        poses.append(_look_at_pose(eye)[:3, :4])
    c2w = np.stack(poses)
    intr = (30.0 + rng.random((4, n)) * 3).astype(np.float32)
    dist = (0.01 * rng.standard_normal((n, 6))).astype(np.float32)
    kw = dict(width=w, height=h, camera_model=model)
    t = Cameras(torch.from_numpy(c2w), *map(torch.from_numpy, intr),
                distortion=torch.from_numpy(dist) if distortion else None,
                **kw)
    j = JCameras(jnp.asarray(c2w), *map(jnp.asarray, intr),
                 distortion=jnp.asarray(dist) if distortion else None, **kw)
    return t, j


def _same(t, j, atol=1e-6):
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        got = getattr(t, k)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j, k)),
                                   rtol=0, atol=atol, err_msg=k)
    assert (t.width, t.height, t.camera_model) == (j.width, j.height,
                                                   j.camera_model)
    assert (t.distortion is None) == (j.distortion is None)
    if j.distortion is not None:
        np.testing.assert_allclose(t.distortion.numpy(),
                                   np.asarray(j.distortion), rtol=0,
                                   atol=atol)


def test_quaternions_and_slerp_match_rsn():
    rng = np.random.default_rng(0)
    for i in range(40):
        q = rng.normal(size=4)
        if i % 4 == 0:  # trace <= 0: each branch of the largest diagonal
            q[0] = 0.05 * q[0]
        q /= np.linalg.norm(q)
        R = trender._quat_to_rot(q)
        np.testing.assert_allclose(R, jrender._quat_to_rot(q), atol=1e-6)
        np.testing.assert_allclose(trender._rot_to_quat(R),
                                   jrender._rot_to_quat(R), atol=1e-6)
        q1 = rng.normal(size=4)
        q1 /= np.linalg.norm(q1)
        for t in (0.0, 0.3, 1.0):
            np.testing.assert_allclose(trender._slerp(q, q1, t),
                                       jrender._slerp(q, q1, t), atol=1e-6)
        near = q + 1e-4 * rng.normal(size=4)  # the lerp branch
        np.testing.assert_allclose(trender._slerp(q, near, 0.5),
                                   jrender._slerp(q, near, 0.5), atol=1e-6)


@pytest.mark.parametrize("model,distortion,max_frames", [
    ("perspective", True, 0), ("perspective", False, 7),
    ("fisheye", True, 5)])
def test_interpolate_cameras_match_rsn(model, distortion, max_frames):
    t, j = _ring(model, distortion)
    _same(trender.interpolate_cameras(t, 4, max_frames),
          jrender.interpolate_cameras(j, 4, max_frames))


@pytest.mark.parametrize("model,distortion", [("perspective", True),
                                              ("equirectangular", False)])
def test_spiral_cameras_match_rsn(model, distortion):
    t, j = _ring(model, distortion)
    _same(trender.spiral_cameras(t, 9), jrender.spiral_cameras(j, 9))


@pytest.mark.parametrize("schema", ["frames", "frames_per_frame_keys",
                                    "nerfstudio"])
def test_path_cameras_match_rsn(tmp_path, schema):
    rng = np.random.default_rng(1)
    mats = [_look_at_pose(rng.normal(size=3).astype(np.float32) * 3)
            for _ in range(3)]
    if schema == "nerfstudio":
        doc = {"camera_path": [{"camera_to_world": m.reshape(-1).tolist(),
                                "fov": 40.0 + i} for i, m in
                               enumerate(mats)],
               "render_height": 20, "render_width": 30}
    else:
        frames = [{"camera_to_world": m[:3].tolist()} for m in mats]
        doc = {"frames": frames, "fx": 21.0, "width": 40}
        if schema == "frames_per_frame_keys":
            for i, f in enumerate(frames):
                f.update(fl_x=25.0 + i, cy=9.0, w=36, h=18,
                         transform_matrix=f.pop("camera_to_world"))
    path = str(tmp_path / "path.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    t, j = _ring()
    _same(trender.path_cameras(path, t), jrender.path_cameras(path, j))


def _check_gif(path, frames, delay):
    """The port's reader and PIL's decoder give the same frames, each
    pixel within half a palette level of its source frame."""
    got, delays = gif.read_gif(path)
    assert len(got) == len(frames) and delays == [delay] * len(frames)
    im = Image.open(path)
    for i, (g, f) in enumerate(zip(got, frames)):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), g)
        err = np.abs(g.astype(np.float64) - f.astype(np.float64))
        assert (err <= np.asarray(gif.STEP) / 2 + 1e-9).all()


def test_gif_round_trip(tmp_path):
    """A smooth frame, a noisy one (past 4096 LZW codes: the table
    restarts) and a flat one."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:61, 0:83]
    frames = [np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1) % 256,
              rng.integers(0, 256, (61, 83, 3)),
              np.full((61, 83, 3), 200)]
    frames = [f.astype(np.uint8) for f in frames]
    path = str(tmp_path / "a.gif")
    gif.write_gif(path, frames, duration_ms=42)
    _check_gif(path, frames, 4)


def test_save_video_writes_gif_without_ffmpeg(tmp_path, monkeypatch):
    """No ffmpeg: the .mp4 name becomes .gif, as rsn renames it."""
    monkeypatch.setattr(trender.shutil, "which", lambda name: None)
    rng = np.random.default_rng(0)
    frames = [rng.uniform(size=(12, 16, 3)).astype(np.float32)
              for _ in range(3)]
    out = trender.save_video(str(tmp_path / "orbit.mp4"), frames, fps=10)
    assert out == str(tmp_path / "orbit.gif")
    _check_gif(out, [(f * 255).astype(np.uint8) for f in frames], 10)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("render")
    cfg = get_method("reflect-sampling-nerf").config_factory()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline,
        model=dataclasses.replace(
            cfg.pipeline.model, num_coarse_samples=8,
            num_importance_samples=8, num_reflect_coarse_samples=8,
            num_reflect_importance_samples=8),
        datamanager=dataclasses.replace(cfg.pipeline.datamanager,
                                        dataparser="synthetic",
                                        data="sphere:res=8,cams=3")))
    run = str(root / "run")
    tckpt.dump_config(run, cfg)
    tckpt.save_checkpoint(os.path.join(run, "checkpoints"), 0,
                          Field(torch.Generator().manual_seed(0)))
    return run


def test_render_cli_split_is_the_default(run, tmp_path):
    """A bare call renders the split's cameras with the three panels;
    --downscale-factor is refused in split mode, as rsn refuses it."""
    out = str(tmp_path / "split")
    assert trender.main(["--load-dir", run, "--max-images", "2",
                         "--output-dir", out], device="cpu") == 0
    names = sorted(os.listdir(out))
    assert names == [f"{i:05d}-{p}.png" for i in range(2)
                     for p in ("accumulation", "depth", "img")]
    widths = {"img": 24, "accumulation": 16, "depth": 16}
    for name in names:
        mode, px = read_png(os.path.join(out, name))
        kind = name.split("-")[1][:-4]
        assert mode == "RGB" and px.shape == (8, widths[kind], 3)
    with pytest.raises(SystemExit):
        trender.main(["--load-dir", run, "--downscale-factor", "2"],
                     device="cpu")


@pytest.mark.parametrize("mode", ["interpolate", "spiral", "path"])
def test_render_cli_generated_paths_and_video(run, tmp_path, mode,
                                              monkeypatch):
    monkeypatch.setattr(trender.shutil, "which", lambda name: None)
    out = str(tmp_path / mode)
    flags = ["--load-dir", run, "--mode", mode, "--num-frames", "4",
             "--video", "--fps", "5", "--output-dir", out]
    if mode == "path":
        path = str(tmp_path / "path.json")
        mats = [_look_at_pose(np.array([4.0, i, 1.0], np.float32))
                for i in range(3)]
        with open(path, "w") as f:
            json.dump({"frames": [{"camera_to_world": m.tolist()}
                                  for m in mats], "width": 6,
                       "height": 4}, f)
        flags += ["--camera-path", path]
    else:
        flags += ["--downscale-factor", "2"]
    assert trender.main(flags, device="cpu") == 0
    n = 3 if mode == "path" else 4
    frames, _ = gif.read_gif(os.path.join(out, f"{mode}.gif"))
    assert len(frames) == n
    shape = (4, 6, 3) if mode == "path" else (4, 4, 3)
    for i, frame in enumerate(frames):
        _, px = read_png(os.path.join(out, f"frame_{i:05d}.png"))
        assert px.shape == frame.shape == shape
        assert (np.abs(px.astype(int) - frame) <= 26).all()
    if mode == "path":
        with pytest.raises(SystemExit):
            trender.main(["--load-dir", run, "--mode", "path"],
                         device="cpu")
