"""The conditional NeuS volume renderer and the blending network's inputs.

Counterpart of ``one2345_tpu/recon/renderer.py`` (reference:
models/sparse_neus_renderer.py, SparseNeuSRenderer, and models/projector.py,
Projector):
- ``projector_features`` / ``compute_ray_diff``: per-point features of the
  blending network (the renderer and the mesh-coloring pass);
- ``render_rays``: stratified samples, 4 rounds of NeuS importance
  sampling under ``no_grad``, the projector + blending net (or a fitted
  color function), NeuS alpha compositing, the eikonal error.

Every sample is evaluated and masked, as in the JAX function (the
reference boolean-indexes the valid ones).  The random draws (the
stratified jitter, the normal-query mix) come from a ``torch.Generator``
or are given in ``draws``; JAX's threefry draws cannot be reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from one2345_tpu_torch.geometry.projection import sample_features_from_maps
from one2345_tpu_torch.geometry.sampling import (
    nearest_sample_volume,
    sample_pdf,
    trilinear_sample,
)


class RenderParams(NamedTuple):
    n_samples: int = 64
    n_importance: int = 64
    n_importance_rounds: int = 4
    perturb: bool = False
    alpha_inter_ratio: float = 0.0
    background_rgb: float | None = None  # scalar (white = 1.0)
    # the JAX package's training extension (0.0 = the reference): the
    # probability that a training ray queries the blending net with the
    # surface normal instead of the direction to the query camera, the
    # direction the mesh-coloring pass uses
    normal_query_prob: float = 0.0


def pts_mask_from_volume(pts: torch.Tensor, mask_volume: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel occupancy at [..., 3] points -> [...] float
    (sparse_neus_renderer.py:154-168)."""
    return nearest_sample_volume(mask_volume, pts)[..., 0]


def up_sample_z(z_vals, sdf, pts_mask, n_importance: int, inv_variance: float) -> torch.Tensor:
    """One round of NeuS slope-aware importance sampling
    (sparse_neus_renderer.py:73-115): [N, S] z, sdf and mask -> [N,
    n_importance] new z, no graph."""
    N = z_vals.shape[0]
    seg_mask = pts_mask[:, :-1] * pts_mask[:, 1:]
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    dot_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_dot = torch.cat([torch.zeros_like(dot_val[:, :1]), dot_val[:, :-1]], dim=-1)
    dot_val = torch.minimum(prev_dot, dot_val)
    dot_val = dot_val.clamp(-10.0, 0.0) * seg_mask

    dist = next_z - prev_z
    prev_esti = mid_sdf - dot_val * dist * 0.5
    next_esti = mid_sdf + dot_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_variance)
    next_cdf = torch.sigmoid(next_esti * inv_variance)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    alpha = alpha * seg_mask
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], dim=-1), dim=-1
    )[:, :-1]
    return sample_pdf(z_vals, alpha * trans, n_importance).detach()


def cat_and_sort_z(z_vals, sdf, new_z_vals, new_sdf):
    """Merge and sort samples along each ray (cat_z_vals, renderer:117-151);
    a stable sort, as ``jnp.argsort``."""
    z = torch.cat([z_vals, new_z_vals], dim=-1)
    s = torch.cat([sdf, new_sdf], dim=-1)
    z, order = torch.sort(z, dim=-1, stable=True)
    return z, torch.gather(s, -1, order)


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


def render_rays(sdf_fn, sdf_grad_fn, rendering_net_fn, inv_variance, rays_o, rays_d, near, far,
                volume, mask_volume, feature_maps, color_maps, w2cs, intrinsics, size_hw,
                query_cam_center, params: RenderParams = RenderParams(), generator=None,
                draws=None, fitted_color_fn=None) -> dict:
    """Render a batch of rays (SparseNeuSRenderer.render + render_core,
    sparse_neus_renderer.py:171-635).

    ``sdf_fn(pts [N, 3]) -> (sdf [N, 1], feat [N, H])`` and
    ``sdf_grad_fn(pts) -> (sdf, feat, grad [N, 3])`` close over the
    conditional volume; in training ``sdf_grad_fn`` keeps its graph
    (``SdfVolumeNetwork.sdf_and_gradient(create_graph=True)``).
    ``fitted_color_fn(pts, dirs, feat, grads) -> [N, 3]`` replaces the
    projector and the blending net (the per-shape fitted rendering,
    render_core:236-296).

    Random draws, as the JAX function's ``key``: with ``generator`` (or
    ``draws``) and ``params.perturb``, the stratified jitter ``t_rand``
    [N_rays, n_samples] in [0, 1); with ``params.normal_query_prob`` > 0,
    ``normal_query`` [N_rays] bool (Bernoulli).  ``draws`` gives either
    tensor instead of drawing it.  Without both, no randomness.
    """
    draws = draws or {}
    random = generator is not None or bool(draws)
    N_rays = rays_o.shape[0]
    ns = params.n_samples
    dev = rays_o.device
    dt = rays_o.dtype
    near = torch.as_tensor(near, dtype=dt, device=dev)
    far = torch.as_tensor(far, dtype=dt, device=dev)
    sample_dist = ((far - near) / ns).mean()

    z_vals = torch.linspace(0.0, 1.0, ns, dtype=dt, device=dev)[None, :]
    z_vals = (near + (far - near) * z_vals).expand(N_rays, ns)
    if params.perturb and random:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        t_rand = draws.get("t_rand")
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=generator, device=dev)
        z_vals = lower + (upper - lower) * torch.as_tensor(t_rand, device=dev)

    def along(z):
        return rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]

    # ---- importance sampling (no_grad in the reference)
    if params.n_importance > 0:
        with torch.no_grad():
            sdf = sdf_fn(along(z_vals).reshape(-1, 3))[0].reshape(N_rays, ns)
            n_per_round = params.n_importance // params.n_importance_rounds
            for i in range(params.n_importance_rounds):
                pmask = pts_mask_from_volume(along(z_vals).reshape(-1, 3), mask_volume)
                new_z = up_sample_z(z_vals, sdf, pmask.reshape(z_vals.shape), n_per_round,
                                    64 * 2**i)
                new_pts = along(new_z).reshape(-1, 3)
                new_mask = pts_mask_from_volume(new_pts, mask_volume)
                new_sdf = sdf_fn(new_pts)[0][:, 0]
                # masked-out new samples get sdf=100 (cat_z_vals, renderer:138-143)
                new_sdf = torch.where(new_mask > 0, new_sdf, 100.0).reshape(new_z.shape)
                z_vals, sdf = cat_and_sort_z(z_vals, sdf, new_z, new_sdf)
    n_total = z_vals.shape[1]

    # ---- render core (sparse_neus_renderer.py:171-455)
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, sample_dist.expand(N_rays, 1)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = along(mid_z)  # [N, S, 3]
    flat = pts.reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    pts_mask = pts_mask_from_volume(flat, mask_volume).reshape(N_rays, n_total).detach()
    flat_mask = pts_mask.reshape(-1, 1)

    sdf, feat, gradients = sdf_grad_fn(flat)
    sdf = torch.where(flat_mask > 0, sdf, 100.0)
    feat = feat * flat_mask
    gradients = gradients * flat_mask

    if fitted_color_fn is not None:
        sampled_color = fitted_color_fn(flat, dirs, feat, gradients).reshape(N_rays, n_total, 3)
        rendering_valid_mask = torch.ones((N_rays, 1), dtype=torch.bool, device=dev)
    else:
        ray2tar = query_cam_center[None, :] - flat
        ray2tar = ray2tar / (torch.linalg.vector_norm(ray2tar, dim=-1, keepdim=True) + 1e-6)
        if params.normal_query_prob > 0.0 and random:
            # per-ray Bernoulli mix of camera directions and surface
            # normals; normals at masked samples are zero vectors, which
            # those samples' masks already exclude from the blend
            normals = gradients * torch.rsqrt((gradients**2).sum(dim=-1, keepdim=True) + 1e-12)
            use_n = draws.get("normal_query")
            if use_n is None:
                use_n = torch.rand((N_rays,), generator=generator, device=dev) < params.normal_query_prob
            use_n = torch.as_tensor(use_n, device=dev).reshape(N_rays, 1, 1)
            use_n = use_n.expand(N_rays, n_total, 1).reshape(-1, 1)
            ray2tar = torch.where(use_n, normals.detach(), ray2tar)
        geo_feat, rgb_feat, ray_diff, ren_mask = projector_features(
            pts, volume, mask_volume, feature_maps, color_maps, w2cs, intrinsics, size_hw,
            ray2tar,
        )
        sampled_color, rendering_valid_mask = rendering_net_fn(geo_feat, rgb_feat, ray_diff,
                                                               ren_mask)
    sampled_color = sampled_color.to(torch.promote_types(sampled_color.dtype, dt))

    # ---- NeuS alpha compositing
    true_dot = (dirs * gradients).sum(dim=-1, keepdim=True)
    air = params.alpha_inter_ratio
    iter_cos = -(torch.relu(-true_dot * 0.5 + 0.5) * (1.0 - air) + torch.relu(-true_dot) * air)
    iter_cos = iter_cos * flat_mask
    d_half = iter_cos.clamp(-10.0, 10.0) * dists.reshape(-1, 1) * 0.5
    prev_cdf = torch.sigmoid((sdf - d_half) * inv_variance)
    next_cdf = torch.sigmoid((sdf + d_half) * inv_variance)
    p = prev_cdf - next_cdf
    c = prev_cdf
    alpha = ((p + 1e-5) / (c + 1e-5)).clamp(0.0, 1.0).reshape(N_rays, n_total)
    alpha = alpha * pts_mask
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], dim=-1), dim=-1
    )[:, :-1]
    weights = alpha * trans
    weights_sum = weights.sum(dim=-1, keepdim=True)

    color = (sampled_color * weights[:, :, None]).sum(dim=1)
    if params.background_rgb is not None:
        color = color + params.background_rgb * (1.0 - weights_sum)

    grad_res = gradients.reshape(N_rays, n_total, 3)
    # eps inside the sqrt: gradients are zeroed at masked samples, and the
    # derivative of ||x|| at x = 0 is NaN (render_core:236-239)
    grad_norm = torch.sqrt((grad_res**2).sum(dim=-1) + 1e-12)
    gradient_error = (grad_norm - 1.0) ** 2
    gradient_error = (pts_mask * gradient_error).sum() / (pts_mask.sum() + 1e-5)

    depth = (mid_z * weights).sum(dim=1, keepdim=True)
    depth_var = ((mid_z - depth) ** 2 * weights).sum(dim=-1, keepdim=True)
    return {
        "color_fine": color,
        "color_fine_mask": rendering_valid_mask,
        "depth": depth,
        "depth_variance": depth_var,
        "sdf": sdf.reshape(N_rays, n_total),
        "gradients": grad_res,
        "weights": weights,
        "weights_sum": weights_sum,
        "alpha_sum": alpha.sum(dim=-1, keepdim=True).mean(),
        "alpha_mean": alpha.mean(),
        "gradient_error_fine": gradient_error,
        "variance": 1.0 / inv_variance,
        "mid_z_vals": mid_z,
        "pts_mask": pts_mask,
    }
