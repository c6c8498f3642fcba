"""Per-point features of the blending network (the mesh-coloring pass).

Counterpart of ``compute_ray_diff`` and ``projector_features`` of
``one2345_tpu/recon/renderer.py`` (reference: models/projector.py:16-229).
The volume renderer itself (``render_rays``) is training's and is not
ported yet.
"""

from __future__ import annotations

import torch

from one2345_tpu_torch.geometry.projection import sample_features_from_maps
from one2345_tpu_torch.geometry.sampling import trilinear_sample


def compute_ray_diff(pts_flat: torch.Tensor, ray2tar: torch.Tensor,
                     support_c2ws: torch.Tensor) -> torch.Tensor:
    """[V, N, 4] direction-difference features (projector.py:16-63).

    :param ray2tar: [N, 3] unit vectors toward the query camera or, on the
        mesh-color path, surface normals
    """
    sup_centers = support_c2ws[:, :3, 3]  # [V, 3]
    r2s = sup_centers[:, None, :] - pts_flat[None, :, :]
    r2s = r2s / (torch.linalg.vector_norm(r2s, dim=-1, keepdim=True) + 1e-6)
    diff = ray2tar[None] - r2s
    diff_norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    dot = (ray2tar[None] * r2s).sum(dim=-1, keepdim=True)
    direction = diff / diff_norm.clamp(min=1e-6)
    return torch.cat([direction, dot], dim=-1).detach()


def projector_features(pts, volume, mask_volume, feature_maps, color_maps, w2cs, intrinsics,
                       size_hw, ray2tar):
    """Per-sample inputs of the rendering network (Projector.compute,
    projector.py:99-229).

    :param pts: [N_rays, n_samples, 3] (normalized space)
    :param volume: [X, Y, Z, G]; :param mask_volume: [X, Y, Z, 1]
    :param feature_maps: [V, H, W, F]; :param color_maps: [V, H, W, 3]
    :param ray2tar: [N_rays * n_samples, 3]
    :return: (geo_feat [Nr, Ns, G], rgb_feat [V, Nr, Ns, 3 + F],
              ray_diff [V, Nr, Ns, 4], mask [V, Nr, Ns] bool)
    """
    Nr, Ns, _ = pts.shape
    flat = pts.reshape(-1, 3)

    geo_feat = trilinear_sample(volume, flat)
    in_cube = (flat.abs() < 1.0).all(dim=-1)
    occ = trilinear_sample(mask_volume, flat)[..., 0] > 0
    geo_mask = in_cube & occ

    both = torch.cat([color_maps, feature_maps], dim=-1)
    feats, pmask = sample_features_from_maps(flat, both, w2cs, intrinsics, size_hw)

    ray_diff = compute_ray_diff(flat, ray2tar, torch.linalg.inv(w2cs))

    final_mask = pmask & geo_mask[None]
    V = feats.shape[0]
    return (
        geo_feat.reshape(Nr, Ns, -1),
        feats.reshape(V, Nr, Ns, -1),
        ray_diff.reshape(V, Nr, Ns, 4),
        final_mask.reshape(V, Nr, Ns),
    )
