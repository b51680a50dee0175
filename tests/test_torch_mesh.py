"""rsn_torch.core.mesh against rsn.core.mesh: marching tetrahedra and
write_ply bit for bit (the port's copy is host numpy, as rsn's), and each
package's read_ply reads the other's file.  No tolerance: every
comparison is exact."""
import itertools

import numpy as np
import pytest

from rsn.core import mesh as jmesh
from rsn_torch.core import mesh as tmesh


def _sphere(n=24, extent=1.0):
    ax = np.linspace(-extent, extent, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 - np.sqrt(x ** 2 + y ** 2 + z ** 2)


def _ties():
    """A grid on a coarse lattice of values, many equal to the iso:
    degenerate faces (two vertices on one grid point) are dropped."""
    rng = np.random.default_rng(4)
    return rng.integers(0, 3, size=(9, 8, 7)).astype(np.float32) * 0.25


GRIDS = {
    "seeded": (lambda: np.random.default_rng(0).normal(
        size=(13, 11, 9)).astype(np.float32), 0.3, (16,)),
    "seeded_float64": (lambda: np.random.default_rng(1).uniform(
        size=(10, 12, 14)), 0.5, (16,)),
    "sphere": (_sphere, 0.4, (4, 64)),
    "sphere_wide": (lambda: _sphere(31, 1.5), 0.55, (4, 64)),
    "empty": (lambda: np.zeros((8, 8, 8), np.float32), 0.5, (16,)),
    "all_inside": (lambda: np.ones((6, 5, 4), np.float32), 0.5, (16,)),
    "flat": (lambda: np.random.default_rng(2).normal(
        size=(1, 9, 9)).astype(np.float32), 0.0, (16,)),
    "two_layers": (lambda: np.random.default_rng(3).normal(
        size=(2, 2, 6)).astype(np.float32), 0.0, (1, 16)),
    "ties_at_iso": (_ties, 0.25, (2, 16)),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_marching_tetrahedra_bit_for_bit(name):
    make, iso, slabs = GRIDS[name]
    grid = make()
    for slab in slabs:
        vj, fj = jmesh.marching_tetrahedra(grid, iso, slab=slab)
        vt, ft = tmesh.marching_tetrahedra(grid, iso, slab=slab)
        assert vt.dtype == vj.dtype and ft.dtype == fj.dtype
        assert vt.shape == vj.shape and ft.shape == fj.shape
        assert np.array_equal(vt, vj) and np.array_equal(ft, fj)
    if name.startswith("sphere"):
        assert len(vt) > 100
    if name in ("empty", "all_inside", "flat"):
        assert len(vt) == 0 and len(ft) == 0
    if name == "ties_at_iso":
        # the precondition of the case: some grid values equal the iso
        assert (grid == iso).any() and len(ft) > 0
    if len(slabs) > 1 and name.startswith("sphere"):
        # slab 4 against slab 64: the same vertices, the same faces up to
        # their emission order (both packages)
        v4, f4 = tmesh.marching_tetrahedra(grid, iso, slab=slabs[0])
        v64, f64 = tmesh.marching_tetrahedra(grid, iso, slab=slabs[1])
        assert np.array_equal(v4, v64)

        def canon(f):
            rows = np.sort(f, axis=1)
            return rows[np.lexsort(rows.T[::-1])]

        assert np.array_equal(canon(f4), canon(f64))


def _mesh(rng, n=57, nf=40):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    f = rng.integers(0, n, size=(nf, 3)).astype(np.int32)
    c = rng.uniform(-0.2, 1.2, size=(n, 3))  # float64, clipped by the writer
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    return v, f, c, nrm


@pytest.mark.parametrize("faces,colors,normals",
                         list(itertools.product((False, True), repeat=3)))
def test_write_ply_bytes_equal_rsn(tmp_path, faces, colors, normals):
    v, f, c, nrm = _mesh(np.random.default_rng(5))
    kw = dict(faces=f if faces else None, colors=c if colors else None,
              normals=nrm if normals else None)
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jmesh.write_ply(pj, v, **kw)
    tmesh.write_ply(pt, v, **kw)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def test_read_ply_reads_the_other_packages_file(tmp_path):
    v, f, c, nrm = _mesh(np.random.default_rng(6))
    for writer, reader in ((jmesh, tmesh), (tmesh, jmesh)):
        for kw in (dict(faces=f, colors=c, normals=nrm), dict(colors=c),
                   dict()):
            path = str(tmp_path / "m.ply")
            writer.write_ply(path, v, **kw)
            got = reader.read_ply(path)
            ref = writer.read_ply(path)
            for a, b in zip(got, ref):
                assert (a is None) == (b is None)
                if a is not None:
                    assert np.array_equal(a, b)
            assert np.array_equal(got[0], v)
            if "faces" in kw:
                assert np.array_equal(got[1], f)
            if "colors" in kw:
                want = (np.clip(c, 0, 1) * 255 + 0.5).astype(np.uint8)
                assert np.array_equal(np.round(got[2] * 255.0), want)
