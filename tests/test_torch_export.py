"""rsn_torch.cli.export against rsn.cli.export on the CPU, fp32, with the
same weights carried across (torch_parity.rsn_params / port_field) and
the same numpy inputs.

Tolerances (measured on these inputs, then rounded up):
- query (density, diff) against rsn's compiled _density_fns: atol 1e-5,
  as tests/test_torch_field.py holds fp32 (measured 1.2e-7 / 6e-8: the
  port rounds the point contraction and the point IPE's cos argument as
  XLA's compiled graph does, see contract_pts);
- normals: atol NORMALS_TOL = 1e-5 (measured 1.5e-6 on the seeded
  points; the gradient is dominated by the 2^16 octave, whose cos the two
  packages evaluate from the same fp32 argument).  On the mesh's vertices
  2 rows of 14970 differ by up to 0.197 although the forward there is
  equal bit for bit: XLA's compiled gradient rounds a top-octave argument
  (an ulp is ~0.03 rad at 4e5 rad) otherwise than its compiled query.
  So a set of normals holds if at most NORMALS_SHARE = 5e-4 of its rows
  lie beyond NORMALS_TOL and none beyond NORMALS_MAX = 0.25;
- the mesh grid: atol GRID_TOL = 1e-6 (measured 1.2e-7); the faces are
  held equal only where no grid value lies within GRID_TOL of the iso
  (asserted), and the vertices, which divide the grid's error by
  vb - va, within VERT_TOL = 1e-2 of a grid cell (measured 6.4e-4);
- the TSDF: `seen` equal, tsdf and colors within 1e-5 on shared depth
  maps (measured 0); through the renders (render_image held at atol 1e-4
  by tests/test_torch_render.py; here the depths 4.8e-7 apart) within
  TSDF_TOL = 2e-4 (measured 4.8e-7), faces equal where no fused value
  lies within TSDF_TOL of 0 (asserted); the point cloud's points within
  1e-3 (measured 4.8e-7);
- PLY colors: within one level of 255 (uchar of values 1e-4 apart).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsn.cli import export as jexport
from rsn.configs import ModelConfig as JModelConfig
from rsn.configs import PipelineConfig as JPipelineConfig
from rsn.configs import TrainerConfig as JTrainerConfig
from rsn.core.mesh import marching_tetrahedra
from rsn.data.cameras import Cameras as JCameras
from rsn.data.cameras import generate_image_rays as jrays
from rsn.data.synthetic import make_synthetic_dataset as jsynthetic
from rsn.engine import trainer as jtrainer
from rsn_torch import configs as tconfigs
from rsn_torch.cli import export as texport
from rsn_torch.core.mesh import read_ply
from rsn_torch.data.cameras import Cameras
from rsn_torch.data.synthetic import Dataset
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.models.field import Field
from torch_parity import jax_params, port_field, rsn_params

QUERY_TOL = 1e-5
NORMALS_TOL = 1e-5
NORMALS_SHARE = 5e-4
NORMALS_MAX = 0.25
GRID_TOL = 1e-6
VERT_TOL = 1e-2     # of a grid cell
TSDF_TOL = 2e-4
FUSE_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    tree = rsn_params(0)
    return jax_params(tree), port_field(tree)


def _configs():
    kw = dict(num_coarse_samples=8, num_importance_samples=8,
              num_reflect_coarse_samples=8,
              num_reflect_importance_samples=8)
    jcfg = JTrainerConfig(pipeline=JPipelineConfig(model=JModelConfig(**kw)))
    tcfg = tconfigs.TrainerConfig(pipeline=tconfigs.PipelineConfig(
        model=tconfigs.ModelConfig(**kw)))
    return jcfg, tcfg


def _points(n=2048, seed=0):
    """Seeded points inside and outside the unit ball."""
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 3)).astype(
        np.float32)


def test_query_and_normals_match_rsn(weights):
    params, field = weights
    jcfg, tcfg = _configs()
    jquery, jnormals = jexport._density_fns(params, jcfg.pipeline.model)
    pts = _points()
    assert (np.linalg.norm(pts, axis=-1) < 1).any()
    assert (np.linalg.norm(pts, axis=-1) > 1).any()
    dtype = texport.query_dtype(tcfg)
    assert dtype == torch.float32
    ref = jquery(jnp.asarray(pts))
    got = texport.query(field, torch.from_numpy(pts), dtype)
    for k in ("density", "diff"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=QUERY_TOL, err_msg=k)
    nj = np.asarray(jnormals(jnp.asarray(pts)))
    nt = texport.normals(field, torch.from_numpy(pts), dtype).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=NORMALS_TOL)
    np.testing.assert_allclose(np.linalg.norm(nt, axis=-1), 1.0, atol=1e-6)
    # chunking changes only the matmuls' blocking
    again = texport._chunked(lambda p: texport.query(field, p, dtype),
                             torch.from_numpy(pts), chunk=300)
    np.testing.assert_allclose(again["density"].numpy(),
                               got["density"].numpy(), rtol=0, atol=1e-6)


def _close_normals(got: np.ndarray, ref: np.ndarray) -> None:
    err = np.abs(got - ref).max(axis=-1)
    beyond = int((err > NORMALS_TOL).sum())
    assert beyond <= NORMALS_SHARE * len(err), (beyond, len(err))
    assert err.max() <= NORMALS_MAX, err.max()


def _gap_iso(grid: np.ndarray) -> float:
    """The midpoint of the widest gap between sorted grid values in the
    middle third of their range: an iso in the middle of the density
    range with no grid value near it."""
    v = np.unique(grid.reshape(-1))
    lo, hi = v[0] + (v[-1] - v[0]) / 3, v[-1] - (v[-1] - v[0]) / 3
    v = v[(v >= lo) & (v <= hi)]
    i = int(np.argmax(np.diff(v)))
    return float((v[i] + v[i + 1]) / 2)


def test_export_mesh_matches_rsn(weights, tmp_path):
    params, field = weights
    jcfg, tcfg = _configs()
    res, bbox = 24, 1.0
    jquery, _ = jexport._density_fns(params, jcfg.pipeline.model)
    ax = np.linspace(-bbox, bbox, res, dtype=np.float32)
    yy, zz = np.meshgrid(ax, ax, indexing="ij")
    ref_grid = np.stack([jexport._chunked(jquery, np.stack(
        [np.full_like(yy, x), yy, zz], axis=-1).reshape(-1, 3))["density"]
        .reshape(res, res) for x in ax])
    tax = torch.from_numpy(ax)
    grid = torch.stack([texport.density_plane(field, tax, i, torch.float32)
                        for i in range(res)]).numpy()
    np.testing.assert_allclose(grid, ref_grid, rtol=0, atol=GRID_TOL)
    iso = _gap_iso(ref_grid)
    # the precondition of equal topology: no grid value near the iso
    assert np.abs(ref_grid - iso).min() > GRID_TOL
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    sj = jexport.export_mesh(params, jcfg, pj, resolution=res, bbox=bbox,
                             density_threshold=iso)
    st = texport.export_mesh(field, tcfg, pt, resolution=res, bbox=bbox,
                             density_threshold=iso)
    assert st == sj and st["faces"] > 100
    vj, fj, cj, nj = read_ply(pj)
    vt, ft, ct, nt = read_ply(pt)
    assert np.array_equal(ft, fj)
    cell = 2.0 * bbox / (res - 1)
    err = float(np.abs(vt - vj).max()) / cell
    assert err <= VERT_TOL, f"vertices {err:.3g} of a cell"
    assert np.abs(ct - cj).max() <= 1 / 255 + 1e-6
    np.testing.assert_allclose(np.linalg.norm(nt, axis=-1), 1.0, atol=1e-3)
    # the normals at the port's own vertices, against rsn's function
    _, jnormals = jexport._density_fns(params, jcfg.pipeline.model)
    _close_normals(nt, np.asarray(jnormals(jnp.asarray(vt))))


def _look_at_c2w(eye):
    eye = np.asarray(eye, np.float32)
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(right, fwd), -fwd, eye], axis=1)


def _sphere_views(res_px=24, n_cam=6, r_sphere=0.6):
    """Analytic depth maps of a sphere from rsn's rays, seeded colors,
    -> (rsn Cameras, port Cameras, depths, accs, rgbs)."""
    eyes = [[2.5 * np.cos(t), 2.5 * np.sin(t), 1.2 if k % 2 else -1.2]
            for k, t in enumerate(np.linspace(0, 2 * np.pi, n_cam,
                                              endpoint=False))]
    c2w = np.stack([_look_at_c2w(e) for e in eyes]).astype(np.float32)
    f = np.full((n_cam,), 20.0, np.float32)
    c = np.full((n_cam,), res_px / 2.0, np.float32)
    jc = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(f),
                  fy=jnp.asarray(f), cx=jnp.asarray(c), cy=jnp.asarray(c),
                  width=res_px, height=res_px)
    tc = Cameras(torch.from_numpy(c2w), *(torch.from_numpy(a) for a in
                                          (f, f, c, c)),
                 width=res_px, height=res_px)
    depths = np.zeros((n_cam, res_px, res_px), np.float32)
    accs = np.zeros_like(depths)
    for i in range(n_cam):
        o, d, _ = jrays(jc, i)
        o, d = np.asarray(o), np.asarray(d)
        b = np.sum(o * d, axis=-1)
        disc = b * b - (np.sum(o * o, axis=-1) - r_sphere ** 2)
        hit = disc > 0
        depths[i] = np.where(hit, -b - np.sqrt(np.maximum(disc, 0.0)),
                             1e3).reshape(res_px, res_px)
        accs[i] = hit.reshape(res_px, res_px)
    rgbs = np.random.default_rng(7).uniform(
        size=(n_cam, res_px, res_px, 3)).astype(np.float32)
    return jc, tc, depths, accs, rgbs


def test_fuse_tsdf_and_drop_unobserved_faces_match_rsn():
    jc, tc, depths, accs, rgbs = _sphere_views()
    res, bbox = 32, 1.0
    tj, cj, sj = jexport.fuse_tsdf(depths, accs, rgbs, jc, res, bbox)
    tt, ct, st = texport.fuse_tsdf(depths, accs, rgbs, tc, res, bbox)
    assert st.dtype == bool and np.array_equal(st, sj)
    assert 0 < sj.mean() < 1
    np.testing.assert_allclose(tt, tj, rtol=0, atol=FUSE_TOL)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=FUSE_TOL)
    assert tt.dtype == ct.dtype == np.float32
    verts, faces = marching_tetrahedra(-tj, 0.0)
    vj, fj = jexport.drop_unobserved_faces(verts, faces, sj)
    vt, ft = texport.drop_unobserved_faces(verts, faces, sj)
    assert np.array_equal(vt, vj) and np.array_equal(ft, fj)
    assert 0 < len(fj) < len(faces)
    # an empty mesh passes through
    empty = texport.drop_unobserved_faces(verts[:0], faces[:0], sj)
    assert len(empty[0]) == 0 and len(empty[1]) == 0


@pytest.fixture(scope="module")
def scene(weights):
    """A 16x16, 2-camera synthetic scene, the same cameras and images in
    both packages."""
    jds = jsynthetic(num_cameras=2, H=16, W=16)
    arrays = [np.asarray(getattr(jds.cameras, k)) for k in
              ("camera_to_worlds", "fx", "fy", "cx", "cy")]
    tds = Dataset(images=np.asarray(jds.images),
                  cameras=Cameras(*(torch.from_numpy(np.array(a))
                                    for a in arrays), width=16, height=16),
                  split="train")
    return jds, tds


class _Recorder:
    """Wraps a module's render_image and keeps each render's outputs."""

    def __init__(self, module, monkeypatch):
        self.outs = []
        real = module.render_image

        def record(*args, **kwargs):
            out = real(*args, **kwargs)
            self.outs.append({k: np.asarray(v) for k, v in out.items()})
            return out

        monkeypatch.setattr(module, "render_image", record)


def test_export_pointcloud_matches_rsn(weights, scene, tmp_path,
                                       monkeypatch):
    params, field = weights
    jds, tds = scene
    jcfg, tcfg = _configs()
    rj, rt = (_Recorder(jtrainer, monkeypatch),
              _Recorder(ttrainer, monkeypatch))
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    kw = dict(num_points=300, min_accumulation=0.5, seed=3)
    sj = jexport.export_pointcloud(params, jcfg, jds, pj, **kw)
    st = texport.export_pointcloud(field, tcfg, tds, pt, **kw)
    assert len(rj.outs) == len(rt.outs) == 2
    # the precondition of equal keep masks: no accumulation near the cut
    for out in rj.outs:
        assert np.abs(out["accumulation_fine"] - 0.5).min() > 1e-3
    for a, b in zip(rt.outs, rj.outs):
        np.testing.assert_allclose(a["depth_fine"], b["depth_fine"],
                                   rtol=0, atol=1e-4)
    assert st == sj == {"points": 300}  # subsampled by the seeded choice
    vj, fj, cj, nj = read_ply(pj)
    vt, ft, ct, nt = read_ply(pt)
    assert fj is None and ft is None
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-3)
    assert np.abs(ct - cj).max() <= 1 / 255 + 1e-6
    # the normals at the port's own points, against rsn's function
    _, jnormals = jexport._density_fns(params, jcfg.pipeline.model)
    _close_normals(nt, np.asarray(jnormals(jnp.asarray(vt))))


def test_export_tsdf_matches_rsn(weights, scene, tmp_path, monkeypatch):
    params, field = weights
    jds, tds = scene
    jcfg, tcfg = _configs()
    rj, rt = (_Recorder(jtrainer, monkeypatch),
              _Recorder(ttrainer, monkeypatch))
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    kw = dict(resolution=16, bbox=1.5, min_accumulation=0.5)
    sj = jexport.export_tsdf(params, jcfg, jds, pj, **kw)
    st = texport.export_tsdf(field, tcfg, tds, pt, **kw)

    def fused(outs, module, cams):
        depth = np.stack([o["depth_fine"][..., 0] for o in outs])
        acc = np.stack([o["accumulation_fine"][..., 0] for o in outs])
        rgb = np.zeros(depth.shape + (3,), np.float32)
        return module.fuse_tsdf(depth, acc, rgb, cams, 16, 1.5)

    tsdf_j, _, seen_j = fused(rj.outs, jexport, jds.cameras)
    tsdf_t, _, seen_t = fused(rt.outs, texport, tds.cameras)
    assert np.array_equal(seen_t, seen_j) and seen_j.any()
    np.testing.assert_allclose(tsdf_t, tsdf_j, rtol=0, atol=TSDF_TOL)
    # the precondition of equal topology: no fused value near the iso
    assert np.abs(tsdf_j).min() > TSDF_TOL
    assert st == sj and sj["faces"] > 0
    vj, fj, cj, _ = read_ply(pj)
    vt, ft, ct, _ = read_ply(pt)
    assert np.array_equal(ft, fj)
    cell = 3.0 / 15
    assert np.abs(vt - vj).max() / cell <= VERT_TOL
    assert np.abs(ct - cj).max() <= 1 / 255 + 1e-6


def test_export_cameras_matches_rsn(scene, tmp_path):
    jds, tds = scene
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    assert (jexport.export_cameras(None, jds, pj)
            == texport.export_cameras(None, tds, pt) == {"cameras": 2})
    with open(pj) as a, open(pt) as b:
        assert json.load(a) == json.load(b)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port run dir: the registry's config on an 8x8 synthetic sphere,
    seeded weights."""
    from rsn_torch.cli.registry import get_method

    cfg = get_method("reflect-sampling-nerf").config_factory()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline,
        model=dataclasses.replace(
            cfg.pipeline.model, num_coarse_samples=8,
            num_importance_samples=8, num_reflect_coarse_samples=8,
            num_reflect_importance_samples=8),
        datamanager=dataclasses.replace(cfg.pipeline.datamanager,
                                        dataparser="synthetic",
                                        data="sphere:res=8,cams=2")))
    run = str(tmp_path_factory.mktemp("export") / "run")
    tckpt.dump_config(run, cfg)
    tckpt.save_checkpoint(os.path.join(run, "checkpoints"), 0,
                          Field(torch.Generator().manual_seed(0)))
    return run


@pytest.mark.parametrize("mode", ["pointcloud", "mesh", "tsdf", "cameras"])
def test_export_cli_modes_write_files_that_read_back(run, mode):
    argv = [mode, "--load-dir", run]
    if mode == "mesh":
        field = Field(torch.Generator().manual_seed(0)).eval()
        d = texport.query(field, torch.from_numpy(_points(512)))["density"]
        iso = float((d.min() + d.max()) / 2)
        argv += ["--resolution", "12", "--density-threshold", str(iso)]
    if mode == "tsdf":
        argv += ["--resolution", "12", "--max-images", "1"]
    if mode == "pointcloud":
        argv += ["--max-images", "1", "--num-points", "20"]
    assert texport.main(argv, device="cpu") == 0
    ext = "json" if mode == "cameras" else "ply"
    path = os.path.join(run, "exports", f"{mode}.{ext}")
    if mode == "cameras":
        with open(path) as f:
            doc = json.load(f)
        assert len(doc["frames"]) == 2 and doc["frames"][0]["w"] == 8
        return
    v, f, c, n = read_ply(path)
    assert len(v) > 0 and np.isfinite(v).all()
    assert (f is None) == (mode == "pointcloud")
    if mode != "tsdf":
        assert n.shape == v.shape
        np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0,
                                   atol=1e-3)
    assert c.shape == v.shape and 0 <= c.min() and c.max() <= 1


def test_export_cli_raises_without_a_card(run):
    if torch.cuda.is_available():
        pytest.skip("holds on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        texport.main(["cameras", "--load-dir", run])
