"""Sphere-traced depth maps of an SDF volume (the lod1 depth-filtered
pruning).

Counterpart of ``one2345_tpu/recon/fast_renderer.py`` (reference:
reconstruction/models/fast_renderer.py, IDR-style sphere tracing and
secant refinement): a fixed number of march and secant steps over every
ray at once, the volume sampled with border padding.
"""

from __future__ import annotations

import torch

from one2345_tpu_torch.geometry.rays import rays_from_camera
from one2345_tpu_torch.geometry.sampling import trilinear_sample


def sphere_trace_depth(sdf_volume: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                       near, far, n_steps: int = 64, n_secant: int = 8,
                       threshold: float = 1e-3):
    """March rays against a dense SDF volume.

    :param sdf_volume: [X, Y, Z, 1] sdf over the [-1, 1]^3 cube
    :param rays_o / rays_d: [N, 3]; :param near / far: [N] or scalars
    :return: (depth [N], 0 where missed; hit [N] bool)
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    near = torch.as_tensor(near, dtype=torch.float32, device=dev).expand(N)
    far = torch.as_tensor(far, dtype=torch.float32, device=dev).expand(N)

    def sdf_at(t):
        return trilinear_sample(sdf_volume, rays_o + rays_d * t[:, None], padding="border")[:, 0]

    t = near
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        s = sdf_at(t)
        done = done | (s.abs() < threshold)
        # conservative step (the sdf as step length, clamped to stay in range)
        step = torch.where(done, 0.0, s.clamp(-0.2, 0.2))
        t = torch.minimum(torch.maximum(t + step, near), far)

    # secant refinement between the last outside / inside bracket
    eps = 2.0 / sdf_volume.shape[0]
    lo = torch.maximum(t - eps, near)
    hi = torch.minimum(t + eps, far)
    for _ in range(n_secant):
        s_lo, s_hi = sdf_at(lo), sdf_at(hi)
        denom = s_hi - s_lo
        mid = torch.where(denom.abs() > 1e-9, lo - s_lo * (hi - lo) / denom, 0.5 * (lo + hi))
        mid = torch.minimum(torch.maximum(mid, lo), hi)
        s_mid = sdf_at(mid)
        lo, hi = torch.where(s_mid > 0, mid, lo), torch.where(s_mid > 0, hi, mid)
    depth = 0.5 * (lo + hi)
    hit = done & (depth < far - 1e-4)
    return torch.where(hit, depth, 0.0), hit


def extract_depth_maps(sdf_volume: torch.Tensor, intrinsics: torch.Tensor, c2ws: torch.Tensor,
                       H: int, W: int, near, far):
    """[V, H, W] ray-distance depth maps and hit masks by sphere tracing,
    every view's rays in one march (extract_depth_maps,
    sparse_neus_renderer.py:939-985)."""
    rays = [rays_from_camera(H, W, K, c2w) for K, c2w in zip(intrinsics, c2ws)]
    rays_o = torch.cat([r[0] for r in rays])
    rays_d = torch.cat([r[1] for r in rays])
    depth, hit = sphere_trace_depth(sdf_volume, rays_o, rays_d, near, far)
    V = len(rays)
    return depth.reshape(V, H, W), hit.reshape(V, H, W)
