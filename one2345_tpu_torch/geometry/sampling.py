"""Bilinear / trilinear sampling (plain PyTorch, differentiable in the
coordinates).

Counterpart of ``one2345_tpu/geometry/sampling.py``: ``bilinear_sample``,
``bilinear_sample_normalized``, ``trilinear_sample``,
``nearest_sample_volume`` and ``sample_pdf``.
Conventions, as torch's ``grid_sample`` with align_corners=True: a
normalized coordinate g in [-1, 1] maps to index (g + 1) / 2 * (size - 1);
with ``zeros`` padding each corner tap that lies outside the map
contributes zero, with ``border`` it reads the clamped edge pixel or
voxel.  Coordinates stay f32 whatever the map's dtype; the weights are
cast to the map's dtype, as the JAX functions cast them.

Volumes are [X, Y, Z, C] and points (x, y, z) index X, Y, Z, so no axis
flip is needed (``grid_sample``'s grid is (W, H, D), innermost first).
"""

from __future__ import annotations

import torch


def _unnormalize(g: torch.Tensor, size: int) -> torch.Tensor:
    return (g + 1.0) * 0.5 * (size - 1)


def bilinear_sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    padding: str = "zeros") -> torch.Tensor:
    """Sample ``image`` at pixel coordinates (x, y) (0..W-1, 0..H-1), with
    ``zeros`` or ``border`` padding.

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
        v = image[batch + (iy.clamp(0, H - 1).long(), ix.clamp(0, W - 1).long())]
        if padding == "border":
            return v
        ok = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        return v * ok[..., None].to(image.dtype)

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


def bilinear_sample_normalized(image: torch.Tensor, grid: torch.Tensor,
                               padding: str = "zeros") -> torch.Tensor:
    """Sample ``image`` [H, W, C] at ``grid`` [..., 2], (gx, gy) in [-1, 1]
    -> [..., C]."""
    H, W = image.shape[-3], image.shape[-2]
    return bilinear_sample(image, _unnormalize(grid[..., 0], W), _unnormalize(grid[..., 1], H),
                           padding=padding)


def trilinear_sample(volume: torch.Tensor, pts: torch.Tensor, padding: str = "zeros") -> torch.Tensor:
    """Sample ``volume`` [X, Y, Z, C] at normalized pts [..., 3] in [-1, 1]
    (pts[..., 0] indexes X, [..., 1] Y, [..., 2] Z) -> [..., C].  Built from
    gathers and lerps, so twice differentiable in ``pts`` and ``volume``
    (the eikonal loss differentiates the SDF's gradient)."""
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
        if padding == "border":
            return v
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


def nearest_sample_volume(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel sampling of ``volume`` [X, Y, Z, C] at normalized pts
    [..., 3] -> [..., C], zero outside (grid_sample mode='nearest', the
    renderer's validity masks, sparse_neus_renderer.py:155-168).  Rounds
    half to even, as ``jnp.round``."""
    X, Y, Z = volume.shape[0], volume.shape[1], volume.shape[2]
    ix = torch.round(_unnormalize(pts[..., 0], X))
    iy = torch.round(_unnormalize(pts[..., 1], Y))
    iz = torch.round(_unnormalize(pts[..., 2], Z))
    ok = (ix >= 0) & (ix <= X - 1) & (iy >= 0) & (iy <= Y - 1) & (iz >= 0) & (iz <= Z - 1)
    v = volume[ix.clamp(0, X - 1).long(), iy.clamp(0, Y - 1).long(), iz.clamp(0, Z - 1).long()]
    return v * ok[..., None].to(volume.dtype)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF importance sampling along rays (models/render_utils.py:8-51).

    :param bins: [N_rays, M] bin edges (z values)
    :param weights: [N_rays, M - 1] or [N_rays, M] (the CDF then has M + 1
        entries; bin indices are clamped into ``bins``)
    :param u: [N_rays, n_samples] uniforms; None -> the deterministic
        mid-bin quantiles (the reference's det=True path)
    """
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, M+1]
    n_rays = cdf.shape[0]
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device)
        u = u.expand(n_rays, n_samples).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    nb = bins.shape[-1]
    bins_g0 = torch.gather(bins, -1, below.clamp(max=nb - 1))
    bins_g1 = torch.gather(bins, -1, above.clamp(max=nb - 1))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
