"""World -> pixel projection and the per-view feature fetch.

Counterpart of ``project_points`` and ``sample_features_from_maps`` of
``one2345_tpu/geometry/projection.py``.  Feature maps are channels-last
[V, H, W, C], as in the JAX package.  The two depth rules differ on
purpose, as in the reference:
- ``project_points`` (the cost volume's back-projection) clamps z >= 0 to
  ``z_clamp`` before the divide and keeps negative z;
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
