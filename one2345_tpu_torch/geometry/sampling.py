"""Bilinear / trilinear sampling (plain PyTorch, differentiable in the
coordinates).

Counterpart of ``one2345_tpu/geometry/sampling.py`` (``bilinear_sample``,
``trilinear_sample``) with its ``zeros`` padding, the only one the
reconstruction uses.  Conventions, as torch's ``grid_sample`` with
align_corners=True and zeros padding: a normalized coordinate g in [-1, 1]
maps to index (g + 1) / 2 * (size - 1), and each corner tap that lies
outside the map contributes zero.  Coordinates stay f32 whatever the map's
dtype; the weights are cast to the map's dtype, as the JAX functions cast
them.

Volumes are [X, Y, Z, C] and points (x, y, z) index X, Y, Z, so no axis
flip is needed (``grid_sample``'s grid is (W, H, D), innermost first).
"""

from __future__ import annotations

import torch


def _unnormalize(g: torch.Tensor, size: int) -> torch.Tensor:
    return (g + 1.0) * 0.5 * (size - 1)


def bilinear_sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` at pixel coordinates (x, y) (0..W-1, 0..H-1).

    ``image`` is [H, W, C] with ``x``/``y`` of any shape -> [..., C], or a
    stack [B, H, W, C] with ``x``/``y`` [B, ...] -> [B, ..., C], map b
    sampled at row b of the coordinates."""
    H, W = image.shape[-3], image.shape[-2]
    batch = ()
    if image.dim() == 4:
        b = torch.arange(image.shape[0], device=image.device)
        batch = (b.view((-1,) + (1,) * (x.dim() - 1)),)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0

    def tap(ix, iy):
        ix_c = ix.clamp(0, W - 1).long()
        iy_c = iy.clamp(0, H - 1).long()
        ok = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        return image[batch + (iy_c, ix_c)] * ok[..., None].to(image.dtype)

    dt = image.dtype
    w00 = ((1 - tx) * (1 - ty))[..., None].to(dt)
    w01 = (tx * (1 - ty))[..., None].to(dt)
    w10 = ((1 - tx) * ty)[..., None].to(dt)
    w11 = (tx * ty)[..., None].to(dt)
    return (
        tap(x0, y0) * w00
        + tap(x0 + 1, y0) * w01
        + tap(x0, y0 + 1) * w10
        + tap(x0 + 1, y0 + 1) * w11
    )


def trilinear_sample(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample ``volume`` [X, Y, Z, C] at normalized pts [..., 3] in [-1, 1]
    (pts[..., 0] indexes X, [..., 1] Y, [..., 2] Z) -> [..., C]."""
    X, Y, Z = volume.shape[0], volume.shape[1], volume.shape[2]
    fx = _unnormalize(pts[..., 0], X)
    fy = _unnormalize(pts[..., 1], Y)
    fz = _unnormalize(pts[..., 2], Z)
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    tx, ty, tz = fx - x0, fy - y0, fz - z0

    def tap(ix, iy, iz):
        v = volume[
            ix.clamp(0, X - 1).long(), iy.clamp(0, Y - 1).long(), iz.clamp(0, Z - 1).long()
        ]
        ok = (
            (ix >= 0) & (ix <= X - 1)
            & (iy >= 0) & (iy <= Y - 1)
            & (iz >= 0) & (iz <= Z - 1)
        )
        return v * ok[..., None].to(volume.dtype)

    out = 0.0
    for dx, wx in ((0, 1 - tx), (1, tx)):
        for dy, wy in ((0, 1 - ty), (1, ty)):
            for dz, wz in ((0, 1 - tz), (1, tz)):
                w = (wx * wy * wz)[..., None].to(volume.dtype)
                out = out + tap(x0 + dx, y0 + dy, z0 + dz) * w
    return out
