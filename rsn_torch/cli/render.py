"""rsn_torch render — the port of rsn-render (the `ns-render`
equivalent): render a run's eval cameras with the reference's panels, or
a generated camera path, to PNGs (and a video).

    python -m rsn_torch.cli.render --load-dir RUN [--split test] \
        [--max-images N] [--output-dir DIR]          # split (default)
    python -m rsn_torch.cli.render --load-dir RUN \
        --mode orbit|interpolate|spiral|path [--num-frames N] \
        [--camera-path FILE] [--downscale-factor F] [--video] [--fps 24]

split: each camera of the split, the three panels of the reference's eval
images (img = gt | coarse | fine, accumulation, depth; rendered in full,
K1 on all four passes).  orbit / interpolate / spiral / path: rgb frames
of a generated path (product-only renders: K2 on passes 1 and 3, K1 on 2
and 4); --video also writes them as an mp4 through ffmpeg where it is on
the path, else as an animated GIF (rsn_torch.utils.gif).  Renders on the
CUDA card, and raises when torch sees none; a Python caller may ask for
the CPU with main(argv, device="cpu").  A run whose num_devices is above
1 (or 0, with several cards) renders over the mesh, as rsn's does: one
spawned rank per device (rsn_torch.parallel.mesh.launch), each image
sharded over the ranks (render_image's mesh), rank 0 writing the PNGs,
the video and the lines.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rsn_torch.data.cameras import Cameras
from rsn_torch.data.png import write_png
from rsn_torch.data.synthetic import _look_at_pose
from rsn_torch.utils import gif
from rsn_torch.utils._turbo_table import TURBO

_TURBO = np.asarray(TURBO, np.float64)  # matplotlib's lookup table


def apply_colormap(x: np.ndarray) -> np.ndarray:
    """Scalar (H, W, 1) -> turbo RGB (H, W, 3) float32 (nerfstudio's
    default), as matplotlib.colormaps["turbo"] maps it: v clipped to
    [0, 1] picks entry min(int(v * 256), 255), the product taken in v's
    type; NaN maps to black."""
    v = np.clip(x[..., 0], 0.0, 1.0)
    bad = np.isnan(v)
    scaled = np.where(bad, 0, v * v.dtype.type(len(_TURBO)))
    idx = np.minimum(scaled.astype(np.int64), len(_TURBO) - 1)
    rgb = _TURBO[idx]
    rgb[bad] = 0.0
    return rgb.astype(np.float32)


def apply_depth_colormap(depth: np.ndarray, accumulation: np.ndarray,
                         near: float, far: float) -> np.ndarray:
    """Depth -> turbo, normalized by the collider near / far planes and
    modulated by the accumulation (reference model.py:444-455)."""
    v = np.clip((depth - near) / max(far - near, 1e-6), 0.0, 1.0)
    rgb = apply_colormap(v)
    return rgb * accumulation + (1.0 - accumulation)


def render_panels(out: dict, gt: np.ndarray, near: float, far: float):
    """The reference's three eval panels (model.py:457-459): img = gt |
    coarse | fine rgb, accumulation = coarse | fine, depth = coarse | fine,
    each (H, k W, 3)."""
    from rsn_torch.models.model import final_rgb

    rgb = np.concatenate([gt, np.clip(out["mid_rgb_coarse"], 0, 1),
                          np.clip(final_rgb(out), 0, 1)], axis=1)
    acc = np.concatenate([apply_colormap(out["accumulation_coarse"]),
                          apply_colormap(out["accumulation_fine"])], axis=1)
    depth = np.concatenate([
        apply_depth_colormap(out["depth_coarse"], out["accumulation_coarse"],
                             near, far),
        apply_depth_colormap(out["depth_fine"], out["accumulation_fine"],
                             near, far)], axis=1)
    return {"img": rgb, "accumulation": acc, "depth": depth}


def save_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) float in [0, 1] -> 8-bit RGB PNG (zlib + struct only)."""
    write_png(path, (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))


def save_video(path: str, frames, fps: int = 24) -> str:
    """Frames (float (H, W, 3) in [0, 1]) -> an .mp4 through ffmpeg where
    it is on the path, else an animated .gif (rsn_torch.utils.gif; the
    .mp4 name becomes .gif, as rsn renames it).  -> the path written."""
    imgs = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]
    if path.endswith(".mp4") and shutil.which("ffmpeg"):
        with tempfile.TemporaryDirectory() as td:
            for i, im in enumerate(imgs):
                write_png(os.path.join(td, f"{i:05d}.png"), im)
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", str(fps), "-i",
                 os.path.join(td, "%05d.png"), "-pix_fmt", "yuv420p",
                 path], check=True, capture_output=True)
        return path
    if path.endswith(".mp4"):
        path = path[:-4] + ".gif"
    gif.write_gif(path, imgs, duration_ms=max(1, round(1000 / fps)))
    return path


def _full(v, n: int) -> torch.Tensor:
    return torch.full((n,), float(v[0]), dtype=torch.float32)


def orbit_cameras(reference_cameras: Cameras, num_frames: int = 60,
                  elevation: float = 0.35) -> Cameras:
    """An orbit at the reference cameras' mean radius looking at the
    origin, with the first reference camera's intrinsics."""
    c2w = reference_cameras.camera_to_worlds.cpu().numpy()
    radius = float(np.linalg.norm(c2w[:, :3, 3], axis=-1).mean())
    poses = []
    for i in range(num_frames):
        theta = 2.0 * np.pi * i / num_frames
        eye = np.array([np.cos(theta), np.sin(theta), np.sin(elevation)],
                       np.float32)
        eye *= radius / np.linalg.norm(eye)
        poses.append(_look_at_pose(eye))
    n = num_frames
    ref = reference_cameras
    return Cameras(camera_to_worlds=torch.as_tensor(np.stack(poses)[:, :3, :4]),
                   fx=_full(ref.fx, n), fy=_full(ref.fy, n),
                   cx=_full(ref.cx, n), cy=_full(ref.cy, n),
                   width=ref.width, height=ref.height)


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> unit quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2.0
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    if np.dot(q0, q1) < 0:  # shortest arc
        q1 = -q1
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if d > 0.9995:  # nearly parallel: lerp
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(d)
    return (np.sin((1 - t) * theta) * q0
            + np.sin(t * theta) * q1) / np.sin(theta)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def interpolate_cameras(reference_cameras: Cameras,
                        steps_per_transition: int = 10,
                        max_frames: int = 0) -> Cameras:
    """ns-render `interpolate`: a path through the cameras' poses,
    rotation slerp and translation / intrinsics lerp between consecutive
    cameras, steps_per_transition frames a segment.  Keyframes are the
    cameras themselves (projection model and distortion too; between
    keyframes the distortion is the segment's start camera's).
    max_frames > 0 subsamples the path evenly to that many frames, the
    first and last kept."""
    ref = reference_cameras
    c2w = _numpy(ref.camera_to_worlds)
    quats = [_rot_to_quat(m[:3, :3]) for m in c2w]
    intr = np.stack([_numpy(ref.fx), _numpy(ref.fy), _numpy(ref.cx),
                     _numpy(ref.cy)], axis=-1)
    dist = None if ref.distortion is None else _numpy(ref.distortion)
    poses, intrs, dists = [], [], []
    for a in range(len(c2w) - 1):
        for s in range(steps_per_transition):
            t = s / steps_per_transition
            m = np.eye(4, dtype=np.float32)[:3, :4].copy()
            m[:3, :3] = _quat_to_rot(_slerp(quats[a], quats[a + 1], t))
            m[:3, 3] = (1 - t) * c2w[a, :3, 3] + t * c2w[a + 1, :3, 3]
            poses.append(m)
            intrs.append((1 - t) * intr[a] + t * intr[a + 1])
            if dist is not None:
                dists.append(dist[a])
    poses.append(c2w[-1, :3, :4])
    intrs.append(intr[-1])
    if dist is not None:
        dists.append(dist[-1])
    poses_np = np.stack(poses)
    intrs = np.stack(intrs).astype(np.float32)
    dists_np = None if dist is None else np.stack(dists)
    n = len(poses_np)
    if 0 < max_frames < n:
        idx = np.unique(np.linspace(0, n - 1, max_frames).round()
                        .astype(np.int64))
        poses_np, intrs = poses_np[idx], intrs[idx]
        dists_np = None if dists_np is None else dists_np[idx]
    return Cameras(
        camera_to_worlds=torch.from_numpy(np.ascontiguousarray(poses_np)),
        fx=torch.from_numpy(intrs[:, 0].copy()),
        fy=torch.from_numpy(intrs[:, 1].copy()),
        cx=torch.from_numpy(intrs[:, 2].copy()),
        cy=torch.from_numpy(intrs[:, 3].copy()),
        width=ref.width, height=ref.height,
        distortion=(None if dists_np is None
                    else torch.from_numpy(np.ascontiguousarray(dists_np))),
        camera_model=ref.camera_model)


def spiral_cameras(reference_cameras: Cameras, num_frames: int = 60,
                   radius_frac: float = 0.1, zrate: float = 0.5,
                   rotations: int = 2) -> Cameras:
    """ns-render `spiral`: the eye of the first camera offset in its
    right / up plane (radius = radius_frac x its distance to the origin)
    with a slow swing along its view axis, every frame aimed at the world
    origin (the scene center after the loaders' pose normalisation); the
    first camera's intrinsics, projection model and distortion on every
    frame."""
    ref = reference_cameras
    base = _numpy(ref.camera_to_worlds)[0]
    eye0 = base[:3, 3]
    right, up = base[:3, 0], base[:3, 1]
    radius = radius_frac * float(np.linalg.norm(eye0))
    poses = []
    for i in range(num_frames):
        theta = 2.0 * np.pi * rotations * i / num_frames
        eye = (eye0 + radius * np.cos(theta) * right
               + radius * np.sin(theta) * up
               + radius * zrate * np.sin(theta * 0.5) * base[:3, 2])
        poses.append(_look_at_pose(eye.astype(np.float32)))
    n = num_frames
    return Cameras(
        camera_to_worlds=torch.from_numpy(
            np.ascontiguousarray(np.stack(poses)[:, :3, :4])),
        fx=_full(ref.fx, n), fy=_full(ref.fy, n),
        cx=_full(ref.cx, n), cy=_full(ref.cy, n),
        width=ref.width, height=ref.height,
        distortion=(None if ref.distortion is None
                    else ref.distortion[0].cpu().expand(n, 6).clone()),
        camera_model=ref.camera_model)


def path_cameras(path_file: str, reference_cameras: Cameras) -> Cameras:
    """Cameras from a camera-path JSON, in either schema:
    - {"frames": [{"camera_to_world" | "transform_matrix": 3x4 or 4x4,
      optional fl_x / fl_y / cx / cy / w / h}, ...]} with optional
      top-level fx / fy / cx / cy / width / height (default: the first
      reference camera's): rsn's viewer and `rsn-export cameras`;
    - nerfstudio's `ns-render --camera-path-filename` format:
      {"camera_path": [{"camera_to_world": 16 floats, "fov": vertical
      degrees}, ...], "render_height": H, "render_width": W}."""
    with open(path_file) as f:
        doc = json.load(f)
    ref = reference_cameras
    if "camera_path" in doc and "frames" not in doc:
        frames = doc["camera_path"]
        c2w = np.asarray([f["camera_to_world"] for f in frames],
                         np.float32).reshape(len(frames), 4, 4)[:, :3, :4]
        n = c2w.shape[0]
        H = int(doc.get("render_height", ref.height))
        W = int(doc.get("render_width", ref.width))
        fovs = np.asarray([float(f.get("fov", 50.0)) for f in frames],
                          np.float32)
        fy = torch.from_numpy(
            (H / (2.0 * np.tan(np.radians(fovs) / 2.0))).astype(np.float32))
        return Cameras(
            camera_to_worlds=torch.from_numpy(np.ascontiguousarray(c2w)),
            fx=fy, fy=fy.clone(),
            cx=torch.full((n,), W / 2.0), cy=torch.full((n,), H / 2.0),
            width=W, height=H)
    frames = doc["frames"]
    c2w = np.asarray([f.get("camera_to_world", f.get("transform_matrix"))
                      for f in frames], np.float32)[:, :3, :4]

    def intr(name, frame_key, default):
        # per-frame transforms.json keys win over the top-level value;
        # the first reference camera is the fallback
        return torch.tensor([float(f.get(frame_key, doc.get(name, default)))
                             for f in frames], dtype=torch.float32)

    w0 = frames[0].get("w", doc.get("width", ref.width))
    h0 = frames[0].get("h", doc.get("height", ref.height))
    return Cameras(
        camera_to_worlds=torch.from_numpy(np.ascontiguousarray(c2w)),
        fx=intr("fx", "fl_x", ref.fx[0]), fy=intr("fy", "fl_y", ref.fy[0]),
        cx=intr("cx", "cx", ref.cx[0]), cy=intr("cy", "cy", ref.cy[0]),
        width=int(w0), height=int(h0))


def _generated_cameras(ns, p, reference: Cameras) -> Cameras:
    if ns.mode == "path":
        if not ns.camera_path:
            p.error("--mode path requires --camera-path")
        return path_cameras(ns.camera_path, reference)
    if ns.mode == "interpolate":
        n_cams = reference.num_cameras
        return interpolate_cameras(
            reference,
            steps_per_transition=max(1, ns.num_frames // max(1, n_cams - 1)),
            max_frames=ns.num_frames)
    if ns.mode == "spiral":
        return spiral_cameras(reference, ns.num_frames)
    return orbit_cameras(reference, ns.num_frames)


def _parser():
    import argparse

    p = argparse.ArgumentParser(description="render a run (PyTorch port)")
    p.add_argument("--load-dir", required=True)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--mode", default="split",
                   choices=("split", "orbit", "path", "interpolate",
                            "spiral"),
                   help="split: eval cameras with gt panels; orbit: "
                        "generated orbit rgb frames; path: rgb frames "
                        "along --camera-path; interpolate: smooth path "
                        "through the split's poses (ns-render "
                        "interpolate); spiral: spiral about the first "
                        "camera (ns-render spiral)")
    p.add_argument("--num-frames", type=int, default=60)
    p.add_argument("--camera-path", default=None,
                   help="camera-path JSON for --mode path")
    p.add_argument("--video", action="store_true",
                   help="also write the generated path's frames as a "
                        "video (mp4 through ffmpeg when present, else an "
                        "animated gif)")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--downscale-factor", type=float, default=1.0,
                   help="render the generated camera paths (orbit/path/"
                        "interpolate/spiral) at 1/N resolution "
                        "(ns-render --downscale-factor); split-mode "
                        "panels compare against gt at dataset "
                        "resolution -- downscale those with "
                        "--pipeline.datamanager.downscale-factor at "
                        "train time instead")
    return p


def main(argv=None, device=None) -> int:
    """The CLI; device: the caller's choice of device (default the card)."""
    from rsn_torch.cli.run_io import entry_device, load_config
    from rsn_torch.parallel import mesh as mesh_lib

    argv = list(sys.argv[1:] if argv is None else argv)
    p = _parser()
    ns = p.parse_args(argv)
    if ns.mode == "split" and ns.downscale_factor != 1.0:
        p.error("--downscale-factor applies to generated camera paths; "
                "split renders follow the dataset resolution "
                "(use the datamanager downscale-factor)")
    if ns.mode == "path" and not ns.camera_path:
        p.error("--mode path requires --camera-path")
    device = str(entry_device(device))
    k = mesh_lib.local_ranks_for(load_config(ns.load_dir).num_devices, 1,
                                 device)
    if k > 1:
        mesh_lib.launch(render_rank, k, (argv,), device=device)
    else:
        render_rank(None, argv, device)
    return 0


def render_rank(mesh, argv, device=None) -> None:
    """The render of one rank of `mesh` (of the whole run without one):
    every image sharded over the ranks, rank 0's files and lines."""
    from rsn_torch.cli.run_io import load_run_full
    from rsn_torch.data.blender import load_cameras, load_dataset
    from rsn_torch.data.cameras import rescale_cameras
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image
    from rsn_torch.models.model import final_rgb

    p = _parser()
    ns = p.parse_args(argv)
    device = mesh.device if mesh is not None else torch.device(device)
    primary = mesh is None or mesh.is_primary
    field, config, _, extras = load_run_full(ns.load_dir, device)
    dm = config.pipeline.datamanager
    mcfg = config.pipeline.model
    out_dir = ns.output_dir or os.path.join(
        ns.load_dir,
        f"renders_{ns.split if ns.mode == 'split' else ns.mode}")
    os.makedirs(out_dir, exist_ok=True)
    chunk = preferred_eval_chunk(config, device)
    proposal = extras.get("proposal")
    memo = {}

    if ns.mode == "split":
        dataset = load_dataset(dm.dataparser, dm.data or "", ns.split,
                               dm.downscale_factor, dm.scale_factor)
        cams = dataset.cameras.to(device)
        n = min(cams.num_cameras, ns.max_images or cams.num_cameras)
        for i in range(n):
            t0 = time.perf_counter()
            out = render_image(field, cams, i, config, rays_per_chunk=chunk,
                               mesh=mesh, reflect_memo=memo,
                               proposal=proposal)
            seconds = time.perf_counter() - t0
            if not primary:
                continue
            panels = render_panels(out, dataset.images[i],
                                   mcfg.collider_near_plane,
                                   mcfg.collider_far_plane)
            for name, img in panels.items():
                save_png(os.path.join(out_dir, f"{i:05d}-{name}.png"), img)
            print(f"rendered {i + 1}/{n}: {seconds:.4f} s", flush=True)
        if primary:
            print(f"wrote {out_dir}")
        return

    cams = _generated_cameras(ns, p, load_cameras(
        dm.dataparser, dm.data or "", ns.split, dm.downscale_factor,
        dm.scale_factor))
    cams = rescale_cameras(cams, ns.downscale_factor).to(device)
    n = min(cams.num_cameras, ns.max_images or cams.num_cameras)
    frames = []
    for i in range(n):
        t0 = time.perf_counter()
        out = render_image(field, cams, i, config, rays_per_chunk=chunk,
                           product_only=True, mesh=mesh, reflect_memo=memo,
                           proposal=proposal)
        seconds = time.perf_counter() - t0
        frame = final_rgb(out)
        if not np.isfinite(frame).all():
            raise RuntimeError(f"frame {i}: non-finite pixels")
        if not primary:
            continue
        save_png(os.path.join(out_dir, f"frame_{i:05d}.png"), frame)
        if ns.video:
            frames.append(np.clip(frame, 0, 1))
        rays = cams.width * cams.height
        mask = float(out["mask"].mean()) if "mask" in out else 0.0
        bucket = next(iter(memo.values()), 1.0)  # one config, one chunk
        print(f"rendered {i + 1}/{n}: {seconds:.4f} s, "
              f"{rays / seconds:.1f} rays/s, mask fraction {mask:.6f}, "
              f"reflect bucket {bucket}, rgb range [{frame.min():.9g}, "
              f"{frame.max():.9g}]", flush=True)
    if frames:
        video = save_video(os.path.join(out_dir, f"{ns.mode}.mp4"), frames,
                           fps=ns.fps)
        print(f"wrote {video}")
    if primary:
        print(f"wrote {out_dir}")


if __name__ == "__main__":
    sys.exit(main())
