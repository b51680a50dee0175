"""rsn_torch render — the port of rsn-render's orbit mode: render an orbit
around the scene from a run dir to PNG frames.

    python -m rsn_torch.cli.render --load-dir RUN --mode orbit \
        --num-frames N [--max-images M] [--downscale-factor F] \
        [--output-dir DIR]

Renders on the CUDA card, and raises when torch sees none; a Python
caller may ask for the CPU with main(argv, device="cpu").

Ported: the orbit mode on runs whose dataparser is `synthetic`, and the
eval panels (render_panels, the turbo colormaps) that the trainer's eval
hook writes.  The split-panel mode, the path / interpolate / spiral modes
and the other dataparsers come with rsn/cli/render.py and
rsn/data/blender.py (ROADMAP Queue 1).
"""
from __future__ import annotations

import os
import struct
import sys
import time
import zlib

import numpy as np
import torch

from rsn_torch.data.cameras import Cameras
from rsn_torch.data.synthetic import _look_at_pose
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
    rgb = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)  # filter 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


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

    def full(v):
        return torch.full((n,), float(v[0]), dtype=torch.float32)

    ref = reference_cameras
    return Cameras(camera_to_worlds=torch.as_tensor(np.stack(poses)[:, :3, :4]),
                   fx=full(ref.fx), fy=full(ref.fy), cx=full(ref.cx),
                   cy=full(ref.cy), width=ref.width, height=ref.height)


def main(argv=None, device=None) -> int:
    """The CLI; device: the caller's choice of device (default the card)."""
    import argparse

    from rsn_torch.cli.run_io import entry_device, load_run_full
    from rsn_torch.data.cameras import rescale_cameras
    from rsn_torch.data.synthetic import load_cameras
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image
    from rsn_torch.models.model import final_rgb

    p = argparse.ArgumentParser(description="render a run (PyTorch port)")
    p.add_argument("--load-dir", required=True)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--mode", default="split", choices=("split", "orbit"),
                   help="orbit: generated orbit rgb frames; split (eval "
                        "cameras with gt panels) is not ported yet")
    p.add_argument("--num-frames", type=int, default=60)
    p.add_argument("--downscale-factor", type=float, default=1.0,
                   help="render the orbit at 1/N resolution")
    ns = p.parse_args(argv)
    if ns.mode != "orbit":
        raise NotImplementedError(
            f"--mode {ns.mode}: ROADMAP Queue 1: rsn/cli/render.py (render "
            "modes with dataset panels) is not ported yet; use --mode "
            "orbit")
    device = entry_device(device)

    field, config, _, extras = load_run_full(ns.load_dir, device)
    dm = config.pipeline.datamanager
    cams = orbit_cameras(load_cameras(dm.dataparser, dm.data or "",
                                      ns.split), ns.num_frames)
    cams = rescale_cameras(cams, ns.downscale_factor).to(device)
    out_dir = ns.output_dir or os.path.join(ns.load_dir, "renders_orbit")
    os.makedirs(out_dir, exist_ok=True)
    chunk = preferred_eval_chunk(config, device)
    n = min(cams.num_cameras, ns.max_images or cams.num_cameras)
    memo = {}
    for i in range(n):
        t0 = time.perf_counter()
        out = render_image(field, cams, i, config, rays_per_chunk=chunk,
                           product_only=True, reflect_memo=memo,
                           proposal=extras.get("proposal"))
        seconds = time.perf_counter() - t0
        frame = final_rgb(out)
        if not np.isfinite(frame).all():
            raise RuntimeError(f"frame {i}: non-finite pixels")
        save_png(os.path.join(out_dir, f"frame_{i:05d}.png"), frame)
        rays = cams.width * cams.height
        mask = float(out["mask"].mean()) if "mask" in out else 0.0
        bucket = next(iter(memo.values()), 1.0)  # one config, one chunk
        print(f"rendered {i + 1}/{n}: {seconds:.4f} s, "
              f"{rays / seconds:.1f} rays/s, mask fraction {mask:.6f}, "
              f"reflect bucket {bucket}, rgb range [{frame.min():.9g}, "
              f"{frame.max():.9g}]", flush=True)
    print(f"wrote {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
