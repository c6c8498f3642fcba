"""World-space rays of a pinhole camera (reconstruction/models/rays.py).

Counterpart of ``one2345_tpu/geometry/rays.py``.  Images are channels-last
[H, W, C].  The JAX random ray draw uses threefry keys, which torch cannot
reproduce: ``random_rays_from_image`` draws its pixel indices from a
``torch.Generator``, or takes them as given (the parity tests feed the
indices JAX drew).
"""

from __future__ import annotations

import torch


def rays_from_camera(H: int, W: int, intrinsic: torch.Tensor, c2w: torch.Tensor):
    """Rays through every pixel center (integer coordinates), directions
    normalised in camera space and then rotated (gen_rays_from_single_image,
    models/rays.py:11-56).

    :param intrinsic: [3, 3] or [4, 4]; :param c2w: [4, 4]
    :return: (rays_o [H * W, 3], rays_d [H * W, 3]), row-major pixels
    """
    dev, dt = c2w.device, torch.promote_types(c2w.dtype, torch.float32)
    ys, xs = torch.meshgrid(
        torch.linspace(0.0, H - 1.0, H, dtype=dt, device=dev),
        torch.linspace(0.0, W - 1.0, W, dtype=dt, device=dev),
        indexing="ij",
    )
    p = torch.stack([xs, ys, torch.ones_like(ys)], dim=-1).reshape(-1, 3)
    k_inv = torch.linalg.inv(intrinsic.to(dt))
    p = p @ k_inv[:3, :3].T
    rays_v = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    rays_v = rays_v @ c2w[:3, :3].to(dt).T
    rays_o = c2w[:3, 3].to(dt).expand(rays_v.shape)
    return rays_o, rays_v


def ray_indices(generator: torch.Generator, N_rays: int, n_px: int, mask=None,
                fg_fraction: float = 0.5) -> torch.Tensor:
    """[N_rays] pixel indices: with a [H * W] ``mask``, the first
    ``int(N_rays * fg_fraction)`` uniform (with replacement) over the
    foreground pixels (mask > 0.5) and the rest over the background ones;
    a side whose set is empty draws uniformly over all pixels, as the JAX
    function falls back.  Without a mask, uniform over all pixels."""
    dev = generator.device

    def uniform(n, pool=None):
        if pool is None:
            return torch.randint(0, n_px, (n,), generator=generator, device=dev)
        pick = torch.randint(0, len(pool), (n,), generator=generator, device=dev)
        return pool[pick]

    if mask is None:
        return uniform(N_rays)
    fg = mask.reshape(-1).to(dev) > 0.5
    n_fg = int(N_rays * fg_fraction)
    out = []
    for n, pool in ((n_fg, torch.nonzero(fg)[:, 0]), (N_rays - n_fg, torch.nonzero(~fg)[:, 0])):
        out.append(uniform(n, pool if len(pool) else None))
    return torch.cat(out)


def random_rays_from_image(generator, N_rays: int, image: torch.Tensor,
                           intrinsic: torch.Tensor, c2w: torch.Tensor, mask=None,
                           fg_fraction: float = 0.5, depth=None, idx=None) -> dict:
    """Random training rays with foreground-importance sampling
    (gen_random_rays_from_single_image, models/rays.py:57-157).

    :param image: [H, W, 3]; :param mask: [H, W] in {0, 1}; :param depth: [H, W]
    :param idx: [N_rays] pixel indices to use instead of a draw from
        ``generator`` (``ray_indices``)
    :return: {'rays_o', 'rays_v', 'rays_color' [N, 3], 'rays_mask' [N, 1]
        (and 'rays_depth' [N, 1])}
    """
    H, W = image.shape[0], image.shape[1]
    if idx is None:
        idx = ray_indices(generator, N_rays, H * W, mask, fg_fraction)
    idx = torch.as_tensor(idx, device=image.device).long()
    rays_o, rays_v = rays_from_camera(H, W, intrinsic, c2w)
    sample = {
        "rays_o": rays_o[idx],
        "rays_v": rays_v[idx],
        "rays_color": image.reshape(-1, 3)[idx],
        "rays_mask": (
            mask.reshape(-1, 1)[idx].to(torch.float32) if mask is not None
            else torch.ones((N_rays, 1), device=image.device)
        ),
    }
    if depth is not None:
        sample["rays_depth"] = depth.reshape(-1, 1)[idx]
    return sample
