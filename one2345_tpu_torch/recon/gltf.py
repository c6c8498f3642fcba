"""Minimal binary glTF (.glb) writer and reader for vertex-colored meshes.

A copy of ``one2345_tpu/recon/gltf.py`` (numpy and ``struct`` only), which
replaces the reference's trimesh glb export (utils/utils.py:44-46:
`mesh.export(path, file_type='glb')`).  It writes a spec-conformant glTF 2.0
binary with POSITION, COLOR_0 and indices, byte for byte what the JAX
package writes for the same mesh (the generator string included).
"""

from __future__ import annotations

import json
import struct

import numpy as np

_COMPONENT_F32 = 5126
_COMPONENT_U32 = 5125
_TARGET_ARRAY = 34962
_TARGET_ELEMENT = 34963


def _pad4(b: bytes, pad: bytes = b"\x00") -> bytes:
    return b + pad * ((4 - len(b) % 4) % 4)


def save_glb(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
) -> None:
    """:param verts: [N, 3] float; :param faces: [M, 3] int;
    :param colors: [N, 3] float in [0, 1] (optional)."""
    verts = np.ascontiguousarray(verts, np.float32)
    idx = np.ascontiguousarray(faces.reshape(-1), np.uint32)

    bufs = [verts.tobytes(), idx.tobytes()]
    if colors is not None:
        bufs.append(np.ascontiguousarray(colors, np.float32).tobytes())

    views, accessors = [], []
    offset = 0
    # positions
    views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(bufs[0]),
                  "target": _TARGET_ARRAY})
    accessors.append({
        "bufferView": 0, "componentType": _COMPONENT_F32, "count": len(verts),
        "type": "VEC3",
        "min": verts.min(0).tolist() if len(verts) else [0, 0, 0],
        "max": verts.max(0).tolist() if len(verts) else [0, 0, 0],
    })
    offset += len(_pad4(bufs[0]))
    # indices
    views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(bufs[1]),
                  "target": _TARGET_ELEMENT})
    accessors.append({
        "bufferView": 1, "componentType": _COMPONENT_U32, "count": len(idx),
        "type": "SCALAR",
    })
    offset += len(_pad4(bufs[1]))

    attributes = {"POSITION": 0}
    if colors is not None:
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(bufs[2]),
                      "target": _TARGET_ARRAY})
        accessors.append({
            "bufferView": 2, "componentType": _COMPONENT_F32,
            "count": len(verts), "type": "VEC3",
        })
        attributes["COLOR_0"] = 2

    gltf = {
        "asset": {"version": "2.0", "generator": "one2345_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "indices": 1, "mode": 4}]}],
        "buffers": [{"byteLength": sum(len(_pad4(b)) for b in bufs)}],
        "bufferViews": views,
        "accessors": accessors,
    }

    json_chunk = _pad4(json.dumps(gltf, separators=(",", ":")).encode(), b" ")
    bin_chunk = b"".join(_pad4(b) for b in bufs)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)

    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))  # glTF magic
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))  # JSON
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))  # BIN
        f.write(bin_chunk)


def load_glb(path: str):
    """Minimal reader for round-trip testing of our own GLBs."""
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67 and version == 2
        jlen, jtype = struct.unpack("<II", f.read(8))
        gltf = json.loads(f.read(jlen))
        blen, btype = struct.unpack("<II", f.read(8))
        blob = f.read(blen)

    _NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}
    _DTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
              5125: np.uint32, 5126: np.float32}

    def read_accessor(i):
        acc = gltf["accessors"][i]
        view = gltf["bufferViews"][acc["bufferView"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        dt = np.dtype(_DTYPE[acc["componentType"]])
        n = _NCOMP[acc["type"]]
        count = acc["count"]
        stride = view.get("byteStride") or dt.itemsize * n
        if stride == dt.itemsize * n:
            arr = np.frombuffer(blob, dt, count * n, start).reshape(count, n)
        else:  # interleaved attributes
            raw = np.frombuffer(blob, np.uint8, stride * count, start)
            arr = np.stack([
                np.frombuffer(raw[k * stride:(k + 1) * stride].tobytes(), dt, n)
                for k in range(count)
            ])
        return arr[:, 0] if n == 1 else arr

    # Walk the scene graph (external GLBs like the reference's
    # render/examples/objaverse/backpack_gt.glb split the object into many
    # node-transformed meshes); merge every triangle primitive into one mesh.
    def node_matrix(node):
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        M = np.eye(4, dtype=np.float32)
        if "scale" in node:
            M[:3, :3] *= np.asarray(node["scale"], np.float32)
        if "rotation" in node:  # quaternion x, y, z, w
            x, y, z, w = node["rotation"]
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ], np.float32)
            M[:3, :3] = R @ M[:3, :3]
        if "translation" in node:
            M[:3, 3] = node["translation"]
        return M

    all_v, all_f, all_c = [], [], []
    n_verts = 0

    def visit(node_idx, parent_m):
        nonlocal n_verts
        node = gltf["nodes"][node_idx]
        M = parent_m @ node_matrix(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]]["primitives"]:
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                v = read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
                if "indices" in prim:
                    f = np.asarray(read_accessor(prim["indices"]), np.int64).reshape(-1, 3)
                else:
                    f = np.arange(len(v), dtype=np.int64).reshape(-1, 3)
                v = v @ M[:3, :3].T + M[:3, 3]
                all_v.append(v)
                all_f.append(f + n_verts)
                if "COLOR_0" in prim["attributes"]:
                    ci = prim["attributes"]["COLOR_0"]
                    c = np.asarray(read_accessor(ci), np.float32)
                    ct = gltf["accessors"][ci]["componentType"]
                    if ct != _COMPONENT_F32:
                        # normalized integer colors (uint8/uint16) -> [0,1]
                        c = c / np.float32(np.iinfo(_DTYPE[ct]).max)
                else:
                    c = np.full((len(v), 3), 0.7, np.float32)
                all_c.append(c[:, :3])
                n_verts += len(v)
        for child in node.get("children", []):
            visit(child, M)

    if gltf.get("scenes"):
        roots = gltf["scenes"][gltf.get("scene", 0)]["nodes"]
    elif gltf.get("nodes"):
        roots = range(len(gltf["nodes"]))
    else:
        roots = []
        all_v = [read_accessor(gltf["meshes"][0]["primitives"][0]["attributes"]["POSITION"])]
        prim0 = gltf["meshes"][0]["primitives"][0]
        all_f = [np.asarray(read_accessor(prim0["indices"]), np.int64).reshape(-1, 3)]
        all_c = [np.full((len(all_v[0]), 3), 0.7, np.float32)]
    eye = np.eye(4, dtype=np.float32)
    for r in roots:
        visit(r, eye)

    verts = np.concatenate(all_v).astype(np.float32)
    faces = np.concatenate(all_f).astype(np.int32)
    colors = np.concatenate(all_c).astype(np.float32)
    return verts, faces, colors
