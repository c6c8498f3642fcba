"""Isosurface extraction and vertex-colored mesh export.

Counterpart of ``one2345_tpu/recon/mesh_extract.py``:

- ``marching_tetrahedra``: the host C++ extractor (``native/marching_tets.cpp``,
  a copy of the JAX package's) over the whole lattice: 6-tet cube
  decomposition, vertices shared per grid edge, faces oriented along the
  field gradient;
- ``marching_tetrahedra_np``: the same contract in numpy, the plain
  version the tests hold the C++ one against (its vertex order differs);
- ``grid_to_world``, ``apply_mesh_transforms``: grid index -> normalized
  space -> world;
- ``convert_mesh_axes``: the axis flips of the reference's obj/glb export;
- ``save_ply`` / ``load_ply``: binary little-endian PLY with uint8 vertex
  colors, and a reader of what ``save_ply`` writes.
"""

from __future__ import annotations

import numpy as np

# 6-tetrahedra decomposition of the unit cube around the 0-6 diagonal.
# Cube corner numbering: bit0 = +x, bit1 = +y, bit2 = +z is NOT used here;
# corners are listed explicitly for clarity.
_CORNERS = np.array(
    [
        [0, 0, 0],  # 0
        [1, 0, 0],  # 1
        [1, 1, 0],  # 2
        [0, 1, 0],  # 3
        [0, 0, 1],  # 4
        [1, 0, 1],  # 5
        [1, 1, 1],  # 6
        [0, 1, 1],  # 7
    ],
    dtype=np.int64,
)

_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    dtype=np.int64,
)

# Per-case triangle table for a tetrahedron (a,b,c,d); bit i set = vertex i
# "inside" (value > threshold).  Edges are vertex-index pairs; triangle
# winding is normalized afterwards against the field gradient, so only the
# topology matters here.
_E = {
    "ab": (0, 1), "ac": (0, 2), "ad": (0, 3),
    "bc": (1, 2), "bd": (1, 3), "cd": (2, 3),
}
_TET_TABLE: dict[int, list[tuple[str, str, str]]] = {
    1: [("ab", "ac", "ad")],
    2: [("ab", "bc", "bd")],
    3: [("ac", "ad", "bd"), ("ac", "bd", "bc")],
    4: [("ac", "bc", "cd")],
    5: [("ab", "ad", "cd"), ("ab", "cd", "bc")],
    6: [("ab", "bd", "cd"), ("ab", "cd", "ac")],
    7: [("ad", "bd", "cd")],
    8: [("ad", "bd", "cd")],
    9: [("ab", "ac", "cd"), ("ab", "cd", "bd")],
    10: [("ab", "bc", "cd"), ("ab", "cd", "ad")],
    11: [("ac", "bc", "cd")],
    12: [("ac", "bc", "bd"), ("ac", "bd", "ad")],
    13: [("ab", "bc", "bd")],
    14: [("ab", "ac", "ad")],
}


def marching_tetrahedra(field: np.ndarray, threshold: float = 0.0):
    """The ``field == threshold`` surface of an [X, Y, Z] field, by the C++
    extractor (built at first use; a failed build raises).

    :return: (vertices [N, 3] f32 in grid-index coordinates, faces [M, 3]
        int32 oriented toward increasing field)
    """
    from one2345_tpu_torch.native.build import marching_tetrahedra_native

    return marching_tetrahedra_native(field, threshold)


def marching_tetrahedra_np(
    field: np.ndarray, threshold: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Extract the ``field == threshold`` isosurface.

    :param field: [X, Y, Z] scalar field (the caller passes -sdf, matching
        extract_fields' negation at sparse_neus_renderer.py:904)
    :return: (vertices [N, 3] in grid-index coordinates, faces [M, 3] int32).
        Triangles are oriented so normals point toward increasing field
        (outward for an occupancy-style field).
    """
    X, Y, Z = field.shape
    f = np.asarray(field, dtype=np.float32)

    inside = f > threshold
    # active cubes: corners disagree
    cnt = np.zeros((X - 1, Y - 1, Z - 1), dtype=np.uint8)
    for dx, dy, dz in _CORNERS:
        c = inside[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]
        cnt = cnt + c.astype(np.uint8)
    active = (cnt > 0) & (cnt < 8)
    cx, cy, cz = np.nonzero(active)
    if cx.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # global grid-vertex ids of each cube corner: [M, 8]
    def vid(dx, dy, dz):
        return ((cx + dx) * Y + (cy + dy)) * Z + (cz + dz)

    corner_ids = np.stack([vid(*c) for c in _CORNERS], axis=1)  # [M, 8]
    corner_vals = np.stack(
        [f[cx + dx, cy + dy, cz + dz] for dx, dy, dz in _CORNERS], axis=1
    )  # [M, 8]

    tri_v0, tri_v1 = [], []  # each entry [K, 3]: triangle edge endpoints
    for tet in _TETS:
        tids = corner_ids[:, tet]  # [M, 4]
        tvals = corner_vals[:, tet]
        case = (
            (tvals[:, 0] > threshold).astype(np.int64)
            | ((tvals[:, 1] > threshold).astype(np.int64) << 1)
            | ((tvals[:, 2] > threshold).astype(np.int64) << 2)
            | ((tvals[:, 3] > threshold).astype(np.int64) << 3)
        )
        for c, tris in _TET_TABLE.items():
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            for tri in tris:
                tri_v0.append(np.stack([tids[sel, _E[e][0]] for e in tri], axis=1))
                tri_v1.append(np.stack([tids[sel, _E[e][1]] for e in tri], axis=1))

    v0 = np.concatenate(tri_v0)  # [T, 3]
    v1 = np.concatenate(tri_v1)
    lo = np.minimum(v0, v1)
    hi = np.maximum(v0, v1)
    keys = (lo * np.int64(X * Y * Z) + hi).reshape(-1)
    uniq, inv = np.unique(keys, return_inverse=True)

    ulo = (uniq // (X * Y * Z)).astype(np.int64)
    uhi = (uniq % (X * Y * Z)).astype(np.int64)

    def unflatten(ids):
        z = ids % Z
        y = (ids // Z) % Y
        x = ids // (Y * Z)
        return np.stack([x, y, z], axis=-1).astype(np.float32)

    p0 = unflatten(ulo)
    p1 = unflatten(uhi)
    f0 = f.reshape(-1)[ulo]
    f1 = f.reshape(-1)[uhi]
    t = (threshold - f0) / np.where(np.abs(f1 - f0) < 1e-12, 1e-12, f1 - f0)
    t = np.clip(t, 0.0, 1.0)
    verts = p0 + t[:, None] * (p1 - p0)

    faces = inv.reshape(-1, 3)
    # drop degenerate faces (shared interpolated vertex)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # orient faces along the field gradient (outward normals)
    gx, gy, gz = np.gradient(f)
    centroid = verts[faces].mean(axis=1)
    ci = np.clip(np.round(centroid).astype(np.int64), 0, [X - 1, Y - 1, Z - 1])
    grad = np.stack(
        [g[ci[:, 0], ci[:, 1], ci[:, 2]] for g in (gx, gy, gz)], axis=-1
    )
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    normal = np.cross(e1, e2)
    flip = np.sum(normal * grad, axis=-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    return verts.astype(np.float32), faces.astype(np.int32)


def grid_to_world(
    verts: np.ndarray, bound_min, bound_max, resolution: int
) -> np.ndarray:
    """Grid-index -> world coords (extract_geometry scaling,
    sparse_neus_renderer.py:933-936)."""
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    return verts / (resolution - 1.0) * (bmax - bmin)[None] + bmin[None]


def apply_mesh_transforms(
    verts: np.ndarray, scale_mat: np.ndarray | None, trans_mat: np.ndarray | None
) -> np.ndarray:
    """Normalized-space -> world: scale + ref-camera transform
    (trainer_generic.py:1365-1372)."""
    v = verts
    if scale_mat is not None:
        v = v * scale_mat[0, 0] + scale_mat[:3, 3][None]
    if trans_mat is not None:
        vh = np.concatenate([v, np.ones_like(v[:, :1])], axis=1)
        v = (trans_mat @ vh.T).T[:, :3]
    return v


def convert_mesh_axes(verts: np.ndarray, faces: np.ndarray):
    """The reference's obj/glb export flips (utils/utils.py:31-47):
    rotate pi/2 about x, pi about z, then mirror x (with face reversal)."""
    rx = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    rz = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], np.float32)
    v = verts @ (rz @ rx).T
    v[:, 0] = -v[:, 0]
    f = faces[:, ::-1].copy()
    return v, f


def save_ply(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
) -> None:
    """Binary little-endian PLY with optional uint8 vertex colors."""
    n_v, n_f = len(verts), len(faces)
    has_c = colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n_v}"]
    header += [f"property float {a}" for a in "xyz"]
    if has_c:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += [
        f"element face {n_f}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        if has_c:
            rec = np.zeros(
                n_v,
                dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
            )
            rec["xyz"] = verts.astype("<f4")
            rec["rgb"] = colors.astype("u1")
            fh.write(rec.tobytes())
        else:
            fh.write(verts.astype("<f4").tobytes())
        frec = np.zeros(n_f, dtype=[("n", "u1"), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces.astype("<i4")
        fh.write(frec.tobytes())


def load_ply(path: str):
    """Reader of the PLYs ``save_ply`` writes: (vertices [N, 3] f32, faces
    [M, 3] int32, colors [N, 3] uint8 or None)."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n_v = int(next(l for l in header if l.startswith("element vertex")).split()[-1])
        n_f = int(next(l for l in header if l.startswith("element face")).split()[-1])
        has_c = any("uchar red" in l for l in header)
        vdt = [("xyz", "<f4", 3)] + ([("rgb", "u1", 3)] if has_c else [])
        vrec = np.frombuffer(fh.read(n_v * (12 + (3 if has_c else 0))), dtype=vdt)
        frec = np.frombuffer(fh.read(n_f * 13), dtype=[("n", "u1"), ("idx", "<i4", 3)])
    verts = vrec["xyz"].copy()
    colors = vrec["rgb"].copy() if has_c else None
    return verts, frec["idx"].copy(), colors
