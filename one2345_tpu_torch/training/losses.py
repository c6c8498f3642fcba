"""Auxiliary reconstruction losses and the depth metric suite.

Counterpart of ``one2345_tpu/training/losses.py`` (reference:
reconstruction/loss/depth_loss.py, depth_metric.py, ncc.py).
"""

from __future__ import annotations

import torch


def depth_l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Masked L1; ground truth <= 0 is invalid (depth_loss.py:6-29)."""
    valid = (gt > 0).to(pred.dtype)
    return ((pred - gt).abs() * valid).sum() / (valid.sum() + 1e-8)


def depth_smooth_loss(depth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness of a [H, W] depth map guided by a
    [H, W, 3] image (depth_loss.py DepthSmoothLoss)."""
    dd_x = (depth[:, 1:] - depth[:, :-1]).abs()
    dd_y = (depth[1:, :] - depth[:-1, :]).abs()
    di_x = (image[:, 1:] - image[:, :-1]).abs().mean(dim=-1)
    di_y = (image[1:, :] - image[:-1, :]).abs().mean(dim=-1)
    return (dd_x * torch.exp(-di_x)).mean() + (dd_y * torch.exp(-di_y)).mean()


def ncc_loss(patch_a: torch.Tensor, patch_b: torch.Tensor, mask=None) -> torch.Tensor:
    """1 - NCC over the pixels of [N, P, C] patches, weighted by a [N, P]
    mask (loss/ncc.py:7-29)."""
    if mask is None:
        mask = torch.ones(patch_a.shape[:2], dtype=patch_a.dtype, device=patch_a.device)
    w = mask[..., None] / (mask.sum(dim=1, keepdim=True)[..., None] + 1e-8)
    mu_a = (patch_a * w).sum(dim=1, keepdim=True)
    mu_b = (patch_b * w).sum(dim=1, keepdim=True)
    va, vb = patch_a - mu_a, patch_b - mu_b
    cov = (va * vb * w).sum(dim=1)
    std = torch.sqrt((va**2 * w).sum(dim=1) * (vb**2 * w).sum(dim=1) + 1e-8)
    return (1.0 - (cov / std).clamp(-1.0, 1.0)).mean()


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """abs-rel, sq-rel, rmse, rmse-log and the delta accuracies over the
    valid (gt > 0) pixels (depth_metric.py:4-204)."""
    valid = gt > 0
    n = valid.sum() + 1e-8
    p = torch.where(valid, pred, 1.0)
    g = torch.where(valid, gt, 1.0)
    err = p - g
    zero = torch.zeros_like(err)
    out = {
        "abs_rel": torch.where(valid, err.abs() / g, zero).sum() / n,
        "sq_rel": torch.where(valid, err**2 / g, zero).sum() / n,
        "rmse": torch.sqrt(torch.where(valid, err**2, zero).sum() / n),
        "rmse_log": torch.sqrt(
            torch.where(valid, (torch.log(p.clamp(min=1e-8)) - torch.log(g)) ** 2, zero).sum() / n
        ),
    }
    ratio = torch.maximum(p / g, g / p)
    for i in (1, 2, 3):
        out[f"delta_{i}"] = torch.where(valid, (ratio < 1.25**i).to(err.dtype), zero).sum() / n
    return out
