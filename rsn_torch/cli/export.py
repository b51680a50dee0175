"""rsn_torch export — the port of rsn-export (the `ns-export` equivalent):
geometry from a trained run.

    python -m rsn_torch.cli.export pointcloud|mesh|tsdf|cameras \
        --load-dir RUN [--output-path FILE] [--max-images N] \
        [--resolution R] [--bbox B] [--density-threshold T] ...

- `pointcloud`: render the dataset cameras (render_image in full, K1 on
  all four passes with bf16), backproject the median depth along each
  pixel ray, keep the pixels whose accumulation clears a threshold, and
  write a colored PLY with the field's analytic normals.
- `mesh`: the field's density on a dense grid, plane by plane on the
  card (points contracted as in training, the point IPE without a
  covariance, the plain field at the run's compute dtype, as rsn queries
  it), isosurfaced on the host with marching tetrahedra
  (rsn_torch.core.mesh); the vertices colored with the diffuse head and
  given -normalize(d density_preact / d x) through the contraction, both
  on the card.
- `tsdf`: render every dataset camera, fuse the median-depth maps into a
  projective truncated signed-distance grid on the card, and isosurface
  the zero crossing on the host.
- `cameras`: a transforms.json-style pose / intrinsics dump, which
  `python -m rsn_torch.cli.render --mode path` reads.

Geometry modes write binary PLY (rsn_torch.core.mesh.write_ply).  Runs on
the CUDA card, and raises when torch sees none; a Python caller may ask
for the CPU with main(argv, device="cpu").
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from rsn_torch.core.encodings import _freqs
from rsn_torch.core.mesh import marching_tetrahedra, write_ply
from rsn_torch.models.field import Field


# The point IPE (no covariance) multiplies the contracted point by up to
# 2 pi 2^16 unattenuated, so one ulp of its argument moves a top-octave
# phase by ~0.05 rad and the density by ~1e-4.  The grid query therefore
# rounds as rsn's compiled query rounds on the CPU, where XLA fuses a
# product and the sum that follows into one fused multiply-add: |x|^2 is
# x0^2 then two fused multiply-adds, each rounded to fp32 once; the cos
# argument 2 pi m f + pi/2 is rounded once.  Both are computed in fp64
# (the products exact) and rounded, and the square root in fp64 (torch's
# fp32 sqrt on the CPU is an ulp off for ~0.6% of values), so the card
# and the CPU give the same bits.


def contract_pts(x: torch.Tensor) -> torch.Tensor:
    """The scene contraction of points (no covariance); the denominators
    are clamped to >= 1 so the unselected branch's gradient stays
    finite."""
    sq = x.double() ** 2  # exact
    n2 = sq[..., 0:1].float()
    for i in (1, 2):
        n2 = (sq[..., i:i + 1] + n2.double()).float()
    safe = n2.clamp_min(1.0)
    n = torch.sqrt(safe.double()).float()
    return torch.where(n2 > 1.0, (2.0 * n - 1.0) / safe * x, x)


_HALF_PI = float(np.float32(math.pi / 2.0))  # rsn's fp32 constant


def point_ipe(mean: torch.Tensor) -> torch.Tensor:
    """ipe_encode(mean, None) with the cos argument 2 pi m f + pi/2
    rounded once (a fused multiply-add) -> (N, 99)."""
    freqs = _freqs(mean.device)
    a = (2.0 * math.pi * mean)[..., None]  # fp32, as ipe_encode
    sin_arg = (a * freqs).flatten(-2)
    cos_arg = (a.double() * freqs.double() + _HALF_PI).float().flatten(-2)
    both = torch.cat([sin_arg, cos_arg], dim=-1)
    return torch.cat([torch.sin(both.double()).float(), mean], dim=-1)


def _density(field: Field, x: torch.Tensor, dtype: torch.dtype):
    return field.get_density_encoded(point_ipe(contract_pts(x)), dtype)


def query(field: Field, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """(N, 3) world points -> {"density" (N,), "diff" (N, 3)}: the plain
    field at `dtype` on the point IPE (no covariance)."""
    with torch.no_grad():
        density, emb, _ = _density(field, x, dtype)
        return {"density": density[..., 0], "diff": field.get_diff(emb)}


def normals(field: Field, x: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, 3) world points -> -normalize(d density_preact / d x), the
    gradient taken through the contraction."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        _, _, preact = _density(field, x, dtype)
        (g,) = torch.autograd.grad(preact.sum(), x)
    return (-g / torch.linalg.norm(g, dim=-1, keepdim=True).clamp_min(
        1e-12)).detach()


def query_dtype(config) -> torch.dtype:
    """The run's compute dtype, at which rsn queries the plain field."""
    from rsn_torch.models.model import _field_cfg

    return _field_cfg(config.pipeline.model).compute_dtype


def _chunked(fn: Callable, pts: torch.Tensor, chunk: int = 65536):
    """fn over `chunk` rows at a time (to bound memory); the outputs (a
    tensor or a dict of them) concatenated."""
    outs = [fn(pts[i:i + chunk]) for i in range(0, pts.shape[0], chunk)]
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return torch.cat(outs)


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _field_device(field: Field) -> torch.device:
    return next(field.parameters()).device


def density_plane(field: Field, ax: torch.Tensor, i: int,
                  dtype: torch.dtype, chunk: int = 65536) -> torch.Tensor:
    """The density on grid plane x = ax[i]: (res, res) on ax's device."""
    res = ax.shape[0]
    yy, zz = torch.meshgrid(ax, ax, indexing="ij")
    pts = torch.stack([ax[i].expand(res, res), yy, zz],
                      dim=-1).reshape(-1, 3)
    return _chunked(lambda p: query(field, p, dtype)["density"], pts,
                    chunk).reshape(res, res)


def export_mesh(field: Field, config, out_path: str, resolution: int = 256,
                bbox: float = 1.5, density_threshold: float = 15.0,
                with_colors: bool = True) -> dict:
    """Marching-tetrahedra mesh of the density field -> binary PLY.  The
    grid, the colors and the normals on the field's device, the
    isosurface on the host; each part's seconds printed."""
    device = _field_device(field)
    dtype = query_dtype(config)
    ax = torch.from_numpy(np.linspace(-bbox, bbox, resolution,
                                      dtype=np.float32)).to(device)
    t0 = time.perf_counter()
    grid = torch.stack([density_plane(field, ax, i, dtype)
                        for i in range(resolution)])
    grid = _numpy(grid)
    t1 = time.perf_counter()
    print(f"grid {resolution}^3 on {device.type}: {t1 - t0:.4f} s",
          flush=True)
    verts_idx, faces = marching_tetrahedra(grid, density_threshold)
    scale = (2.0 * bbox) / (resolution - 1)
    verts = verts_idx * scale - bbox
    t2 = time.perf_counter()
    print(f"isosurface on the host: {t2 - t1:.4f} s, {len(verts)} "
          f"vertices, {len(faces)} faces", flush=True)
    colors = vnormals = None
    if len(verts) and with_colors:
        v = torch.from_numpy(verts.astype(np.float32)).to(device)
        colors = _numpy(_chunked(lambda p: query(field, p, dtype)["diff"],
                                 v))
        vnormals = _numpy(_chunked(lambda p: normals(field, p, dtype), v))
        t3 = time.perf_counter()
        print(f"colors and normals on {device.type}: {t3 - t2:.4f} s",
              flush=True)
    write_ply(out_path, verts, faces=faces, colors=colors, normals=vnormals)
    return {"vertices": int(len(verts)), "faces": int(len(faces))}


def _render(field, cams, i, config, memo, proposal):
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image

    device = cams.camera_to_worlds.device
    t0 = time.perf_counter()
    out = render_image(field, cams, i, config,
                       rays_per_chunk=preferred_eval_chunk(config, device),
                       proposal=proposal, reflect_memo=memo)
    return out, time.perf_counter() - t0


def export_pointcloud(field: Field, config, dataset, out_path: str,
                      num_points: int = 1_000_000,
                      min_accumulation: float = 0.5,
                      max_images: int = 0, extras=None,
                      seed: int = 0) -> dict:
    """Backprojected depth point cloud (rgb + analytic normals) -> PLY.
    Renders on the field's device (full renders, one reflect memo across
    the images)."""
    from rsn_torch.data.cameras import generate_image_rays
    from rsn_torch.models.model import final_rgb

    extras = extras or {}
    device = _field_device(field)
    cams = dataset.cameras.to(device)
    far = config.pipeline.model.collider_far_plane
    n = cams.num_cameras
    if max_images:
        n = min(n, max_images)
    memo: dict = {}
    pts, cols = [], []
    for i in range(n):
        out, seconds = _render(field, cams, i, config, memo,
                               extras.get("proposal"))
        o, d, _ = generate_image_rays(cams, i)
        o, d = _numpy(o), _numpy(d)
        depth = out["depth_fine"].reshape(-1)
        acc = out["accumulation_fine"].reshape(-1)
        keep = (acc > min_accumulation) & (depth < 0.99 * far)
        pts.append((o + depth[:, None] * d)[keep])
        cols.append(np.clip(final_rgb(out), 0.0, 1.0).reshape(-1, 3)[keep])
        print(f"backprojected {i + 1}/{n}: {seconds:.4f} s", flush=True)
    pts = np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))
    cols = np.concatenate(cols, axis=0) if cols else np.zeros((0, 3))
    if len(pts) > num_points:
        sel = np.random.default_rng(seed).choice(len(pts), num_points,
                                                 replace=False)
        pts, cols = pts[sel], cols[sel]
    pnormals = None
    if len(pts):
        dtype = query_dtype(config)
        pnormals = _numpy(_chunked(
            lambda p: normals(field, p, dtype),
            torch.from_numpy(pts.astype(np.float32)).to(device)))
    write_ply(out_path, pts, colors=cols, normals=pnormals)
    return {"points": int(len(pts))}


def fuse_tsdf(depths, accs, rgbs, cameras, resolution: int = 128,
              bbox: float = 1.5, trunc: float = 0.0,
              min_accumulation: float = 0.5):
    """Fuse per-camera depth maps into a truncated signed-distance grid,
    on the cameras' device.

    depths / accs: (N, H, W); rgbs: (N, H, W, 3) numpy; cameras:
    perspective Cameras.  Depth is the Euclidean distance along the unit
    pixel ray (the median depth), so the SDF is depth(px) - |X - origin|
    (projective TSDF).  -> numpy (tsdf (res, res, res), -trunc where
    unobserved; colors (res^3, 3); seen (res, res, res) bool).
    trunc <= 0 picks 4 voxel widths."""
    res = resolution
    voxel = (2.0 * bbox) / (res - 1)
    if trunc <= 0.0:
        trunc = 4.0 * voxel
    device = cameras.camera_to_worlds.device
    ax = np.linspace(-bbox, bbox, res, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.from_numpy(np.stack([x, y, z], axis=-1).reshape(-1, 3)).to(
        device)
    H, W = cameras.height, cameras.width
    n_pts = pts.shape[0]
    tsdf_sum = torch.zeros(n_pts, device=device)
    w_sum = torch.zeros(n_pts, device=device)
    col_sum = torch.zeros(n_pts, 3, device=device)
    for i in range(depths.shape[0]):
        depth = torch.from_numpy(np.asarray(depths[i], np.float32)).to(device)
        acc = torch.from_numpy(np.asarray(accs[i], np.float32)).to(device)
        rgb = torch.from_numpy(np.asarray(rgbs[i], np.float32)).to(device)
        c2w = cameras.camera_to_worlds[i]
        R, t = c2w[:, :3], c2w[:, 3]
        x_cam = (pts - t) @ R  # R^T (X - t): the columns of c2w are axes
        zc = x_cam[:, 2]
        inv = 1.0 / torch.clamp_min(-zc, 1e-9)
        px = cameras.cx[i] + cameras.fx[i] * x_cam[:, 0] * inv
        py = cameras.cy[i] - cameras.fy[i] * x_cam[:, 1] * inv
        # round half to even, as jnp.round; clamped before the integer
        # conversion, so a point far off the image stays in range
        ix = torch.round(px - 0.5).clamp(0, W - 1).long()
        iy = torch.round(py - 0.5).clamp(0, H - 1).long()
        in_view = ((zc < -1e-6) & (px >= 0.0) & (px <= W - 1.0)
                   & (py >= 0.0) & (py <= H - 1.0))
        sdf = depth[iy, ix] - torch.linalg.norm(pts - t, dim=-1)
        w = (in_view & (acc[iy, ix] > min_accumulation)
             & (sdf > -trunc)).float()
        tsdf_sum += w * sdf.clamp(-trunc, trunc)
        w_sum += w
        col_sum += w[:, None] * rgb[iy, ix]
    tsdf_sum, w_sum, col_sum = (_numpy(tsdf_sum), _numpy(w_sum),
                                _numpy(col_sum))
    seen = w_sum > 0
    # unobserved = solid (-trunc): deep-interior voxels (beyond the
    # truncation band, never integrated) continue the negative side
    # instead of flipping to free space, which would put a spurious inner
    # shell one band behind every surface; crossings against unobserved
    # space are dropped by drop_unobserved_faces
    tsdf = np.where(seen, tsdf_sum / np.maximum(w_sum, 1e-9),
                    np.float32(-trunc))
    colors = col_sum / np.maximum(w_sum[:, None], 1e-9)
    return (tsdf.reshape(res, res, res).astype(np.float32),
            colors.astype(np.float32), seen.reshape(res, res, res))


def drop_unobserved_faces(verts_idx: np.ndarray, faces: np.ndarray,
                          seen: np.ndarray):
    """Keep only faces whose every vertex lies on an edge between two
    observed voxels (marching-tetrahedra vertices sit on lattice edges,
    so the edge endpoints are the per-component floor / ceil).  Returns
    (verts_idx, faces) compacted."""
    if len(verts_idx) == 0:
        return verts_idx, faces
    lo = np.floor(verts_idx).astype(np.int64)
    hi = np.ceil(verts_idx).astype(np.int64)
    ok = (seen[lo[:, 0], lo[:, 1], lo[:, 2]]
          & seen[hi[:, 0], hi[:, 1], hi[:, 2]])
    keep_face = ok[faces].all(axis=1)
    faces = faces[keep_face]
    used = np.zeros(len(verts_idx), bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return verts_idx[used], remap[faces]


def export_tsdf(field: Field, config, dataset, out_path: str,
                resolution: int = 128, bbox: float = 1.5,
                min_accumulation: float = 0.5, max_images: int = 0,
                extras=None) -> dict:
    """`ns-export tsdf`: render every dataset camera (full renders on the
    field's device), fuse the median-depth maps into a projective TSDF,
    isosurface its zero crossing and write a colored PLY."""
    from rsn_torch.models.model import final_rgb

    extras = extras or {}
    cams = dataset.cameras.to(_field_device(field))
    n = cams.num_cameras
    if max_images:
        n = min(n, max_images)
    H, W = cams.height, cams.width
    depths = np.empty((n, H, W), np.float32)
    accs = np.empty((n, H, W), np.float32)
    rgbs = np.empty((n, H, W, 3), np.float32)
    memo: dict = {}
    for i in range(n):
        out, seconds = _render(field, cams, i, config, memo,
                               extras.get("proposal"))
        depths[i] = out["depth_fine"].reshape(H, W)
        accs[i] = out["accumulation_fine"].reshape(H, W)
        rgbs[i] = np.clip(final_rgb(out), 0.0, 1.0).reshape(H, W, 3)
        print(f"rendered {i + 1}/{n}: {seconds:.4f} s", flush=True)

    tsdf, colors, seen = fuse_tsdf(depths, accs, rgbs, cams, resolution,
                                   bbox, min_accumulation=min_accumulation)
    # marching_tetrahedra expects density-like values (larger inside)
    verts_idx, faces = marching_tetrahedra(-tsdf, 0.0)
    verts_idx, faces = drop_unobserved_faces(verts_idx, faces, seen)
    scale = (2.0 * bbox) / (resolution - 1)
    verts = verts_idx * scale - bbox
    vcols = None
    if len(verts):
        nearest = np.clip(np.round(verts_idx).astype(np.int64), 0,
                          resolution - 1)
        flat = (nearest[:, 0] * resolution + nearest[:, 1]) * resolution \
            + nearest[:, 2]
        vcols = colors[flat]
    write_ply(out_path, verts, faces=faces, colors=vcols)
    return {"vertices": int(len(verts)), "faces": int(len(faces))}


def export_cameras(config, dataset, out_path: str) -> dict:
    """`ns-export cameras`: the run's camera poses and intrinsics as a
    transforms.json-style document (read by the nerfstudio / instant-ngp
    dataparsers and by the render CLI's --mode path)."""
    cams = dataset.cameras
    n = cams.num_cameras

    def f64(x):
        return x.detach().cpu().numpy().astype(np.float64)

    c2w, fx, fy, cx, cy = (f64(cams.camera_to_worlds), f64(cams.fx),
                           f64(cams.fy), f64(cams.cx), f64(cams.cy))
    frames = []
    bottom = np.array([[0.0, 0.0, 0.0, 1.0]])
    for i in range(n):
        frames.append({
            "camera_index": i,
            "transform_matrix": np.concatenate(
                [c2w[i], bottom], axis=0).tolist(),
            "fl_x": fx[i], "fl_y": fy[i], "cx": cx[i], "cy": cy[i],
            "w": cams.width, "h": cams.height,
        })
    doc = {"camera_model": cams.camera_model, "frames": frames}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    return {"cameras": n}


def main(argv=None, device=None) -> int:
    """The CLI; device: the caller's choice of device (default the card)."""
    import argparse

    from rsn_torch.cli.run_io import entry_device, load_run_full
    from rsn_torch.data.blender import load_dataset

    p = argparse.ArgumentParser(
        description="export geometry from a trained run (ns-export "
                    "equivalent, PyTorch port)")
    p.add_argument("mode", choices=("pointcloud", "mesh", "tsdf",
                                    "cameras"))
    p.add_argument("--load-dir", required=True)
    p.add_argument("--output-path", default=None,
                   help="output .ply (default <load-dir>/exports/<mode>.ply)")
    p.add_argument("--split", default="train")
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--num-points", type=int, default=1_000_000)
    p.add_argument("--min-accumulation", type=float, default=0.5)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--bbox", type=float, default=1.5,
                   help="mesh grid half-extent (world units)")
    p.add_argument("--density-threshold", type=float, default=15.0)
    p.add_argument("--no-colors", action="store_true")
    ns = p.parse_args(argv)
    device = entry_device(device)

    field, config, _, extras = load_run_full(ns.load_dir, device)
    ext = "json" if ns.mode == "cameras" else "ply"
    out_path = ns.output_path or os.path.join(
        ns.load_dir, "exports", f"{ns.mode}.{ext}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    if ns.mode == "mesh":
        stats = export_mesh(field, config, out_path,
                            resolution=ns.resolution, bbox=ns.bbox,
                            density_threshold=ns.density_threshold,
                            with_colors=not ns.no_colors)
    else:
        dm = config.pipeline.datamanager
        dataset = load_dataset(dm.dataparser, dm.data or "", ns.split,
                               dm.downscale_factor, dm.scale_factor)
        if ns.mode == "cameras":
            stats = export_cameras(config, dataset, out_path)
        elif ns.mode == "tsdf":
            stats = export_tsdf(
                field, config, dataset, out_path,
                resolution=ns.resolution, bbox=ns.bbox,
                min_accumulation=ns.min_accumulation,
                max_images=ns.max_images, extras=extras)
        else:
            stats = export_pointcloud(
                field, config, dataset, out_path,
                num_points=ns.num_points,
                min_accumulation=ns.min_accumulation,
                max_images=ns.max_images, extras=extras)
    print(f"wrote {out_path} {stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
