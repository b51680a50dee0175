"""Isosurface extraction and PLY IO for the export CLI (the port's own
copy of rsn.core.mesh: host numpy, bit for bit with it).

- `marching_tetrahedra`: vectorized numpy isosurfacing of a dense
  scalar grid.  Each grid cube splits into the 6 Freudenthal/Kuhn
  tetrahedra sharing the main diagonal (translation-consistent, so
  faces of adjacent cubes tessellate compatibly -> crack-free), and
  each tetrahedron's 16 sign cases emit 0-2 triangles with vertices
  interpolated on cut edges.
- global edge-keyed vertex dedup: a cut vertex lives on a grid edge
  (pair of grid-vertex ids), shared by every tetrahedron containing
  that edge, so keying vertices by the id pair makes the mesh
  watertight by construction.
- triangle orientation is fixed globally AFTER extraction by the grid
  gradient (density decreases outward, so outward = -grad sigma).

All pure numpy (host-side post-processing of a device-computed grid).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# cube corner c = dx*4 + dy*2 + dz; the 6 tetrahedra share diagonal 0-7
_CUBE_TETS = np.array([
    [0, 4, 6, 7],
    [0, 6, 2, 7],
    [0, 2, 3, 7],
    [0, 3, 1, 7],
    [0, 1, 5, 7],
    [0, 5, 4, 7],
], dtype=np.int64)

# tet edges by local vertex pair; triangles below index into this list
_TET_EDGES = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64)

# case -> triangles (edge indices); bit i of the case = "vertex i inside".
# Quads are triangulated along their cut-polygon cycle (no bowties);
# complementary cases cut the same edges (winding fixed later).
_TRI_TABLE = {
    1: [(0, 1, 2)],
    2: [(0, 3, 4)],
    3: [(1, 3, 4), (1, 4, 2)],
    4: [(1, 5, 3)],
    5: [(0, 3, 5), (0, 5, 2)],
    6: [(0, 4, 5), (0, 5, 1)],
    7: [(2, 4, 5)],
}
for _m in range(8, 15):
    _TRI_TABLE[_m] = _TRI_TABLE[15 - _m]


def marching_tetrahedra(values: np.ndarray, iso: float,
                        slab: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `values == iso` surface from a dense (Nx, Ny, Nz) grid.

    Returns (vertices (V, 3) float32 in GRID INDEX coordinates,
    faces (F, 3) int32), vertices deduplicated across the whole grid
    and faces wound so normals point toward decreasing `values`.
    Processes `slab` cube-layers at a time to bound peak memory.
    """
    values = np.asarray(values, np.float32)
    nx, ny, nz = values.shape
    if min(nx, ny, nz) < 2:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    flat = values.reshape(-1)
    tri_keys = []  # (T, 3) int64 canonical edge keys per slab

    # global grid-vertex id and its 8-corner offsets
    corner_off = np.array(
        [((c >> 2) & 1) * ny * nz + ((c >> 1) & 1) * nz + (c & 1)
         for c in range(8)], dtype=np.int64)

    for x0 in range(0, nx - 1, slab):
        x1 = min(x0 + slab, nx - 1)
        xs = np.arange(x0, x1, dtype=np.int64)
        ys = np.arange(ny - 1, dtype=np.int64)
        zs = np.arange(nz - 1, dtype=np.int64)
        base = ((xs[:, None, None] * ny + ys[None, :, None]) * nz
                + zs[None, None, :]).reshape(-1)  # (ncubes,)
        corners = base[:, None] + corner_off[None, :]          # (nc, 8)
        tets = corners[:, _CUBE_TETS].reshape(-1, 4)           # (nt, 4)
        svals = flat[tets]                                     # (nt, 4)
        case = ((svals > iso).astype(np.int64)
                * (1 << np.arange(4))).sum(axis=1)             # (nt,)
        for m, tris in _TRI_TABLE.items():
            sel = tets[case == m]                              # (k, 4)
            if not sel.size:
                continue
            for tri in tris:
                pairs = _TET_EDGES[list(tri)]                  # (3, 2)
                ga = sel[:, pairs[:, 0]]                       # (k, 3)
                gb = sel[:, pairs[:, 1]]
                lo = np.minimum(ga, gb).astype(np.int64)
                hi = np.maximum(ga, gb).astype(np.int64)
                tri_keys.append(lo * (ny * nz * nx) + hi)

    if not tri_keys:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    keys = np.concatenate(tri_keys, axis=0)                    # (T, 3)
    uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    a_id = (uniq // (ny * nz * nx)).astype(np.int64)
    b_id = (uniq % (ny * nz * nx)).astype(np.int64)

    def id_to_xyz(i):
        return np.stack([i // (ny * nz), (i // nz) % ny, i % nz],
                        axis=-1).astype(np.float32)

    va, vb = flat[a_id], flat[b_id]
    t = np.clip((iso - va) / np.where(vb == va, 1.0, vb - va), 0.0, 1.0)
    verts = (id_to_xyz(a_id)
             + t[:, None] * (id_to_xyz(b_id) - id_to_xyz(a_id)))

    # drop degenerate faces (possible when a grid value equals iso)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]

    # orient: normal . (-grad values) > 0 (outward = density decreasing)
    gx, gy, gz = np.gradient(values)
    cent = verts[faces].mean(axis=1)
    ci = np.clip(np.round(cent).astype(np.int64), 0,
                 [nx - 1, ny - 1, nz - 1])
    g = np.stack([gx[ci[:, 0], ci[:, 1], ci[:, 2]],
                  gy[ci[:, 0], ci[:, 1], ci[:, 2]],
                  gz[ci[:, 0], ci[:, 1], ci[:, 2]]], axis=-1)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    flip = (n * -g).sum(axis=1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces


def write_ply(path: str, vertices: np.ndarray,
              faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY.  colors float [0,1] -> uchar."""
    v = np.asarray(vertices, "<f4")
    n_vert = v.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [v]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.asarray(normals, "<f4"))
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        cols.append((np.clip(np.asarray(colors), 0, 1) * 255 + 0.5)
                    .astype(np.uint8))
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_vert}"] + props
    if faces is not None:
        header += [f"element face {faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header += ["end_header"]

    fields = []
    for c in cols:
        if c.dtype == np.uint8:
            fields += [(f"c{len(fields)}{i}", "u1") for i in range(3)]
        else:
            fields += [(f"f{len(fields)}{i}", "<f4") for i in range(3)]
    rec = np.zeros(n_vert, dtype=fields)
    i = 0
    for c in cols:
        for j in range(3):
            rec[rec.dtype.names[i]] = c[:, j]
            i += 1
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())
        if faces is not None:
            fr = np.zeros(faces.shape[0],
                          dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            fr["n"] = 3
            fr["idx"] = np.asarray(faces, "<i4")
            f.write(fr.tobytes())


def read_ply(path: str):
    """Minimal reader for the writer above (round-trip tests/tools).

    Returns (vertices (V, 3) f32, faces (F, 3) i32 or None,
    colors (V, 3) f32 or None, normals (V, 3) f32 or None).
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    n_vert = n_face = 0
    props = []  # vertex property names in order
    elem = None
    for line in header:
        parts = line.split()
        if parts[0] == "element":
            elem = parts[1]
            if elem == "vertex":
                n_vert = int(parts[2])
            elif elem == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and elem == "vertex":
            props.append((parts[-1], parts[1]))
    fields = [(name, "u1" if typ == "uchar" else "<f4")
              for name, typ in props]
    rec = np.frombuffer(data, dtype=fields, count=n_vert, offset=end)
    off = end + rec.itemsize * n_vert

    def grab(names, scale=1.0):
        if not all(n in rec.dtype.names for n in names):
            return None
        return np.stack([rec[n].astype(np.float32) for n in names],
                        axis=-1) / scale

    verts = grab(["x", "y", "z"])
    normals = grab(["nx", "ny", "nz"])
    colors = grab(["red", "green", "blue"], scale=255.0)
    faces = None
    if n_face:
        fr = np.frombuffer(data, dtype=[("n", "u1"), ("idx", "<i4", (3,))],
                           count=n_face, offset=off)
        faces = np.asarray(fr["idx"])
    return verts, faces, colors, normals
