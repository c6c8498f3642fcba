"""3-D mesh metrics: Chamfer distance and F-score.

Counterpart of ``one2345_tpu/eval/metrics.py`` (the paper's Table 1
metrics, arXiv 2306.16928; the reference ships no metric code): uniform
surface sampling by area (numpy, the same generator and draw order),
symmetric Chamfer-L2 and -L1, F-score at a distance threshold, and the
0.8-box normalisation of the Blender eval.

The nearest-neighbour distances, which the JAX package takes from scipy's
``cKDTree``, are an exact brute-force search on the card: float64, in
chunks of query points, with explicit coordinate differences (the
|a|^2 + |b|^2 - 2 a.b form of a matmul cancels badly near zero).
"""

from __future__ import annotations

import numpy as np
import torch

from one2345_tpu_torch.core.device import resolve_device

NN_CHUNK = 1 << 24  # query x reference pairs per chunk of nn_dists


def sample_surface(verts: np.ndarray, faces: np.ndarray, n_points: int,
                   seed: int = 0) -> np.ndarray:
    """Uniform-by-area point sampling on a triangle mesh -> [n, 3] f32."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0 or len(faces) == 0:
        return np.zeros((0, 3), np.float32)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(faces), size=n_points, p=areas / total)
    r1 = np.sqrt(rng.uniform(size=(n_points, 1)))
    r2 = rng.uniform(size=(n_points, 1))
    return ((1 - r1) * v0[idx] + r1 * (1 - r2) * v1[idx] + r1 * r2 * v2[idx]).astype(np.float32)


def nn_dists(a: np.ndarray, b: np.ndarray, device=None) -> np.ndarray:
    """For each point of ``a`` [N, 3], the Euclidean distance to its
    nearest point of ``b`` [M, 3] (float64, exact)."""
    dev = resolve_device(device)
    A = torch.as_tensor(np.asarray(a, np.float64), device=dev)
    B = torch.as_tensor(np.asarray(b, np.float64), device=dev)
    out = torch.empty(len(A), dtype=torch.float64, device=dev)
    rows = max(1, NN_CHUNK // max(len(B), 1))
    for i in range(0, len(A), rows):
        d = A[i:i + rows, None, :] - B[None]
        out[i:i + rows] = (d * d).sum(dim=-1).amin(dim=1)
    return torch.sqrt(out).cpu().numpy()


def chamfer_distance(pts_a: np.ndarray, pts_b: np.ndarray, squared: bool = True,
                     device=None) -> float:
    """Symmetric Chamfer distance (mean of both directions)."""
    d_ab = nn_dists(pts_a, pts_b, device)
    d_ba = nn_dists(pts_b, pts_a, device)
    if squared:
        return float(np.mean(d_ab**2) + np.mean(d_ba**2)) / 2.0
    return float(np.mean(d_ab) + np.mean(d_ba)) / 2.0


def f_score(pts_pred: np.ndarray, pts_gt: np.ndarray, threshold: float = 0.05,
            device=None) -> float:
    """F-score at a distance threshold (harmonic mean of precision and
    recall)."""
    d_pg = nn_dists(pts_pred, pts_gt, device)
    d_gp = nn_dists(pts_gt, pts_pred, device)
    precision = float(np.mean(d_pg < threshold))
    recall = float(np.mean(d_gp < threshold))
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def normalize_to_unit_box(verts: np.ndarray, scale: float = 0.8) -> np.ndarray:
    """Centre a mesh and scale its longest extent to ``scale``, the Blender
    eval's normalisation (render/single_render_eval.py:141-152)."""
    bb_min, bb_max = verts.min(0), verts.max(0)
    center = (bb_min + bb_max) / 2
    extent = (bb_max - bb_min).max()
    return (verts - center) / (extent + 1e-12) * scale


def evaluate_mesh_pair(pred_verts, pred_faces, gt_verts, gt_faces, n_points: int = 16384,
                       fscore_threshold: float = 0.05, normalize: bool = True,
                       device=None) -> dict:
    """Chamfer-L2, Chamfer-L1 and F-score between a predicted and a GT mesh
    (both normalised), on ``n_points`` surface samples each (seeds 0 / 1)."""
    pv = normalize_to_unit_box(pred_verts) if normalize else pred_verts
    gv = normalize_to_unit_box(gt_verts) if normalize else gt_verts
    pp = sample_surface(pv, pred_faces, n_points)
    gp = sample_surface(gv, gt_faces, n_points, seed=1)
    return {
        "chamfer_l2": chamfer_distance(pp, gp, squared=True, device=device),
        "chamfer_l1": chamfer_distance(pp, gp, squared=False, device=device),
        "f_score": f_score(pp, gp, fscore_threshold, device=device),
    }
