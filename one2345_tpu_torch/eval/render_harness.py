"""The 24-view mesh evaluation renders, self-contained.

Counterpart of ``one2345_tpu/eval/render_harness.py`` (reference:
render/launch_render_eval.py + render/single_render_eval.py): GT and
predicted meshes are rendered from 24 fixed viewpoints (12 azimuths at 30
degrees elevation and 12 at 0, camera distance 1.3, the mesh normalised
into a 0.8 box) with per-vertex colours and Lambert shading on white.
``blender_command`` gives the equivalent BlenderProc call.

``rasterize`` is the JAX function's z-buffer as a batched pass on the card
(the JAX package loops over the faces on the host): every face's bounding
box is expanded into candidate pixels in chunks of ``RASTER_CHUNK``, the
barycentrics and depths are computed in float64 with the JAX formulas
(pixel centres, the same culling at z > 1e-4 and |det| < 1e-12 skip), and
each pixel keeps the least key (f32 depth bits << 32 | face index) by
``scatter_reduce(amin)``.  Every step is an elementwise IEEE operation or
an exact reduction (min, floor), so the card and the CPU give the same
pixels.  The JAX loop stores its depth buffer in f32 and
overwrites on a strictly nearer face, so its winner always has the least
f32 depth; the key keeps the same depth and, among faces of equal f32
depth, the lowest index, where the loop keeps the first face whose float64
depth beat the stored one.  Renders therefore differ only at such ties.
"""

from __future__ import annotations

import numpy as np
import torch

from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.eval.metrics import normalize_to_unit_box

EVAL_RES = 512
EVAL_CAM_DIST = 1.3
EVAL_AZIMUTHS = np.arange(12) * 30.0
EVAL_ELEVATIONS = (30.0, 0.0)
RASTER_CHUNK = 1 << 22  # candidate (face, pixel) pairs per pass
_NO_FACE = torch.iinfo(torch.int64).max


def eval_cameras(res: int = EVAL_RES):
    """[24] (K, w2c) of the protocol (single_render_eval.py:170-213: 12
    azimuths at polar 60 degrees, 12 at polar 90)."""
    from one2345_tpu_torch.geometry.cameras import BLENDER2OPENCV, spherical_look_at_poses

    polar = np.radians([90.0 - e for e in EVAL_ELEVATIONS for _ in range(12)])
    azim = np.radians(np.concatenate([EVAL_AZIMUTHS, EVAL_AZIMUTHS]))
    c2ws = spherical_look_at_poses(polar, azim, radius=EVAL_CAM_DIST) @ BLENDER2OPENCV
    w2cs = np.linalg.inv(c2ws)
    focal = res / (2 * np.tan(np.radians(20.0)))  # ~40 degree field of view
    K = np.array([[focal, 0, res / 2], [0, focal, res / 2], [0, 0, 1]])
    return [(K, w2cs[i]) for i in range(24)]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _face_colors(verts, faces, colors, shade: bool):
    """[F, 3, 3] vertex colours of each face, Lambert-shaded against a
    fixed light (0.55 + 0.45 |n . l|, clipped to [0, 1]) or as given.  The
    normals are float64 (the JAX loop's are in the vertices' f32, a shade
    ~1e-7 away): in f32 the card's and the CPU's normals differed in the
    last bit on some faces."""
    tri_c = colors[faces]
    if not shade:
        return tri_c
    v = verts.double()
    e1 = v[faces[:, 1]] - v[faces[:, 0]]
    e2 = v[faces[:, 2]] - v[faces[:, 0]]
    n = _cross(e1, e2)
    norm = torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2])
    n = n / (norm + 1e-12)[:, None]
    light = np.array([0.5, 0.5, 1.0])
    light = light / np.linalg.norm(light)
    lam = 0.55 + 0.45 * (n[:, 0] * light[0] + n[:, 1] * light[1] + n[:, 2] * light[2]).abs()
    return (tri_c.double() * lam[:, None, None]).clamp(0, 1)


def _affine(x, A, b):
    """x @ A.T + b for [N, 3] x, as separate products and sums, so that the
    card and the CPU round alike (a matmul's summation order and fused
    multiply-adds differ between the two)."""
    return torch.stack([x[:, 0] * A[i, 0] + x[:, 1] * A[i, 1] + x[:, 2] * A[i, 2] + b[i]
                        for i in range(3)], dim=1)


def rasterize(verts, faces, colors, K, w2c, res: int = EVAL_RES, shade: bool = True,
              device=None) -> tuple[np.ndarray, np.ndarray]:
    """Z-buffer rasterisation with barycentric vertex colours.

    :param verts: [N, 3]; :param faces: [M, 3] int; :param colors: [N, 3]
    :param K: [3, 3]; :param w2c: [4, 4] (OpenCV axes)
    :return: (rgb [res, res, 3] f32 on white, alpha [res, res] bool)
    """
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(verts), device=dev)
    f = torch.as_tensor(np.asarray(faces), device=dev).long()
    c = torch.as_tensor(np.asarray(colors), device=dev)
    w2c = torch.as_tensor(np.asarray(w2c, np.float64), device=dev)
    K = torch.as_tensor(np.asarray(K, np.float64), device=dev)
    vc = _affine(v.double(), w2c[:3, :3], w2c[:3, 3])
    uvw = _affine(vc, K, torch.zeros(3, dtype=K.dtype, device=dev))
    z = uvw[:, 2]
    uv = uvw[:, :2] / z.clamp(min=1e-6)[:, None]

    tri_c = _face_colors(v, f, c, shade)
    tri_uv = uv[f]  # [F, 3, 2]
    tri_z = z[f]
    p0, p1, p2 = tri_uv[:, 0], tri_uv[:, 1], tri_uv[:, 2]
    m00, m01 = p1[:, 0] - p0[:, 0], p2[:, 0] - p0[:, 0]
    m10, m11 = p1[:, 1] - p0[:, 1], p2[:, 1] - p0[:, 1]
    det = m00 * m11 - m01 * m10
    x0 = torch.floor(tri_uv[..., 0].amin(dim=1)).clamp(min=0)
    x1 = (torch.ceil(tri_uv[..., 0].amax(dim=1)) + 1).clamp(max=res)
    y0 = torch.floor(tri_uv[..., 1].amin(dim=1)).clamp(min=0)
    y1 = (torch.ceil(tri_uv[..., 1].amax(dim=1)) + 1).clamp(max=res)
    keep = ((tri_z > 1e-4).all(dim=1) & (x0 < x1) & (y0 < y1) & (det.abs() >= 1e-12))
    ids = torch.nonzero(keep)[:, 0]
    x0, y0 = x0[ids].long(), y0[ids].long()
    w, h = x1[ids].long() - x0, y1[ids].long() - y0
    counts = w * h
    ends = torch.cumsum(counts, 0)
    # inverse of the edge matrix, as the JAX loop forms it
    inv = torch.stack([m11, -m01, -m10, m00], dim=-1)[ids] / det[ids, None]

    best = torch.full((res * res,), _NO_FACE, dtype=torch.int64, device=dev)
    rgb = torch.ones((res * res, 3), dtype=torch.float32, device=dev)
    ends_host = ends.cpu()
    start = 0
    while start < len(ids):
        base = int(ends_host[start - 1]) if start else 0
        stop = max(start + 1, int(torch.searchsorted(ends_host, base + RASTER_CHUNK,
                                                     right=True)))
        sel = slice(start, stop)
        total = int(ends_host[stop - 1]) - base
        rep = torch.repeat_interleave(torch.arange(stop - start, device=dev), counts[sel],
                                      output_size=total)
        local = torch.arange(total, device=dev) - (ends[sel] - counts[sel] - base)[rep]
        fw = w[sel][rep]
        px = x0[sel][rep] + local % fw
        py = y0[sel][rep] + local // fw
        fi = ids[sel][rep]
        q0, q = tri_uv[fi, 0], inv[start:stop][rep]
        d0 = (px.double() + 0.5) - q0[:, 0]
        d1 = (py.double() + 0.5) - q0[:, 1]
        b1 = d0 * q[:, 0] + d1 * q[:, 1]
        b2 = d0 * q[:, 2] + d1 * q[:, 3]
        b0 = 1.0 - b1 - b2
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        tz = tri_z[fi]
        zi = b0 * tz[:, 0] + b1 * tz[:, 1] + b2 * tz[:, 2]
        key = (zi.float().view(torch.int32).long() << 32) | fi
        key = torch.where(inside, key, _NO_FACE)
        pix = py * res + px
        chunk_best = torch.full_like(best, _NO_FACE).scatter_reduce_(0, pix, key, "amin")
        tc = tri_c[fi]
        ci = b0[:, None] * tc[:, 0] + b1[:, None] * tc[:, 1] + b2[:, None] * tc[:, 2]
        win = inside & (key == chunk_best[pix]) & (chunk_best[pix] < best[pix])
        rgb[pix[win]] = ci[win].float()
        best = torch.minimum(best, chunk_best)
        start = stop
    alpha = (best != _NO_FACE).reshape(res, res)
    return rgb.reshape(res, res, 3).cpu().numpy(), alpha.cpu().numpy()


def render_eval_views(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray | None = None,
                      res: int = 256, normalize: bool = True, device=None) -> np.ndarray:
    """[24, res, res, 3] renders of the protocol (grey 0.7 without colours)."""
    v = normalize_to_unit_box(verts, 0.8) if normalize else verts
    c = colors if colors is not None else np.full((len(v), 3), 0.7, np.float32)
    return np.stack([rasterize(v, faces, c, K, w2c, res, device=device)[0]
                     for K, w2c in eval_cameras(res)])


def blender_command(mesh_path: str, out_dir: str) -> list[str]:
    """The BlenderProc invocation equivalent to launch_render_eval.py (for an
    eval host with blenderproc and Blender)."""
    return [
        "blenderproc", "run", "render_eval.py",
        "--object_path", mesh_path, "--output_dir", out_dir,
        "--camera_dist", str(EVAL_CAM_DIST), "--resolution", str(EVAL_RES),
    ]
