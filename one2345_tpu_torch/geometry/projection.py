"""World -> pixel projection and the per-view feature fetch.

Counterpart of ``one2345_tpu/geometry/projection.py``: ``project_points``,
``back_project_features``, ``frustum_mask``, ``sample_features_from_maps``
and ``aggregate_multiview_features``.  Feature maps are channels-last
[V, H, W, C], as in the JAX package.  The two depth rules differ on
purpose, as in the reference:
- ``project_points`` (the cost volume's back-projection, and so
  ``back_project_features`` and ``frustum_mask``) clamps z >= 0 to
  ``z_clamp`` before the divide and keeps negative z; a point counts where
  |g| <= 1 and z > 0;
- ``sample_features_from_maps`` (the render-time fetch) clamps z to 1e-3
  and keeps a point where |g| < 1 strictly.
"""

from __future__ import annotations

import torch

from one2345_tpu_torch.geometry.sampling import bilinear_sample


def project_points(pts: torch.Tensor, proj: torch.Tensor, z_clamp: float = 1e-6):
    """Project world points [..., 3] through a 4x4 projection (K @ w2c).

    :return: (x_pix, y_pix, z) each [...]; z is the signed camera depth."""
    x = proj[0, 0] * pts[..., 0] + proj[0, 1] * pts[..., 1] + proj[0, 2] * pts[..., 2] + proj[0, 3]
    y = proj[1, 0] * pts[..., 0] + proj[1, 1] * pts[..., 1] + proj[1, 2] * pts[..., 2] + proj[1, 3]
    z = proj[2, 0] * pts[..., 0] + proj[2, 1] * pts[..., 1] + proj[2, 2] * pts[..., 2] + proj[2, 3]
    z_safe = torch.where(z >= 0, z.clamp(min=z_clamp), z)
    return x / z_safe, y / z_safe, z


def _frustum(pts: torch.Tensor, proj: torch.Tensor, size_hw):
    """Normalized coordinates (gx, gy) of ``pts`` in one view calibrated for
    ``size_hw``, and the mask of the points inside its frustum."""
    sH, sW = size_hw
    x, y, z = project_points(pts, proj)
    gx = 2.0 * x / (sW - 1) - 1.0
    gy = 2.0 * y / (sH - 1) - 1.0
    return gx, gy, (gx.abs() <= 1.0) & (gy.abs() <= 1.0) & (z > 0)


def back_project_features(pts: torch.Tensor, feats: torch.Tensor, projs: torch.Tensor,
                          size_hw=None):
    """Every view's feature at the projections of ``pts`` (the dense form of
    the reference's back_project_sparse_type, ops/back_project.py:5-86).

    :param pts: [N, 3] world points; :param feats: [V, H, W, C];
    :param projs: [V, 4, 4] (K @ w2c); :param size_hw: the (H, W) the
        projections are calibrated for (default: the maps' size)
    :return: (features [N, V, C], mask [N, V] bool: inside the frustum with
        positive depth)
    """
    H, W = feats.shape[1], feats.shape[2]
    size_hw = size_hw if size_hw is not None else (H, W)
    px, py, masks = [], [], []
    for proj in projs:
        gx, gy, mask = _frustum(pts, proj, size_hw)
        px.append((gx + 1.0) * 0.5 * (W - 1))
        py.append((gy + 1.0) * 0.5 * (H - 1))
        masks.append(mask)
    features = bilinear_sample(feats, torch.stack(px), torch.stack(py))  # [V, N, C]
    return features.transpose(0, 1), torch.stack(masks, 1)


def frustum_mask(pts: torch.Tensor, projs: torch.Tensor, size_hw,
                 min_visible_views: int = 2) -> torch.Tensor:
    """[N] bool: the point lies inside at least ``min_visible_views`` view
    frusta (the reference's culling, sparse_sdf_network.py:326-334, keeps
    more than 1)."""
    visible = sum(_frustum(pts, proj, size_hw)[2].to(torch.int32) for proj in projs)
    return visible >= min_visible_views


def sample_features_from_maps(pts: torch.Tensor, feats: torch.Tensor, w2cs: torch.Tensor,
                              intrinsics: torch.Tensor, size_hw):
    """Bilinear fetch of every view's map at the projections of ``pts``.

    :param pts: [N, 3]; :param feats: [V, H, W, C]; :param w2cs: [V, 4, 4];
    :param intrinsics: [V, 3, 3]; :param size_hw: the (H, W) the
        intrinsics are calibrated for
    :return: (features [V, N, C], mask [V, N] bool)
    """
    H, W = feats.shape[1], feats.shape[2]
    sH, sW = size_hw
    proj = (intrinsics @ w2cs[:, :3, :4])[:, :, :, None]  # [V, 3, 4, 1]
    p = pts.T[None]  # [1, 3, N]
    x = proj[:, 0, 0] * p[:, 0] + proj[:, 0, 1] * p[:, 1] + proj[:, 0, 2] * p[:, 2] + proj[:, 0, 3]
    y = proj[:, 1, 0] * p[:, 0] + proj[:, 1, 1] * p[:, 1] + proj[:, 1, 2] * p[:, 2] + proj[:, 1, 3]
    z = proj[:, 2, 0] * p[:, 0] + proj[:, 2, 1] * p[:, 1] + proj[:, 2, 2] * p[:, 2] + proj[:, 2, 3]
    z = z.clamp(min=1e-3)
    gx = 2.0 * (x / z) / (sW - 1) - 1.0
    gy = 2.0 * (y / z) / (sH - 1) - 1.0
    mask = (gx.abs() < 1.0) & (gy.abs() < 1.0)
    px = (gx + 1.0) * 0.5 * (W - 1)
    py = (gy + 1.0) * 0.5 * (H - 1)
    return bilinear_sample(feats, px, py), mask


def aggregate_multiview_features(features: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Variance and mean over the view axis, as sparse_sdf_network.py:221-250:
    the sums run over every view (an invisible one adds its zero-padded
    features) but divide by the visible views' count.

    :param features: [N, V, C]; :param masks: [N, V] (bool or 0/1)
    :return: [N, 2C], concat(variance, mean)
    """
    inv = 1.0 / (masks.to(features.dtype).sum(1) + 1e-5)
    mean = features.sum(1) * inv[:, None]
    var = (features**2).sum(1) * inv[:, None] - mean**2
    return torch.cat([var, mean], dim=-1)
