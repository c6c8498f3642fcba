"""Shared pieces of the one2345_tpu_torch parity tests (tests/test_torch_*.py).

Every comparison runs the JAX module and its port on the same numpy-seeded
inputs and weights, on the CPU, in f32, with JAX matmuls pinned to full
precision (XLA's default f32 matmul precision is reduced).
"""

from __future__ import annotations

import numpy as np
import torch

_FREE_SMALL = ("class_embedding", "positional_embedding")


def randomize(tree, seed: int):
    """A copy of a flax variables tree with every leaf redrawn from numpy:
    kernels and projections N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2),
    biases N(0, 0.1^2), CLIP embeddings N(0, 0.02^2), batch-norm running
    means N(0, 0.1^2) and running variances 1 + U(0, 0.5) (a variance must
    stay positive: rsqrt(var + eps) of a negative one is NaN on both sides).
    The JAX init leaves several output convs at exactly zero, which would
    make a parity check check nothing."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key in sorted(node):
            value = node[key]
            if hasattr(value, "items"):
                out[key] = walk(value)
                continue
            shape = np.shape(value)
            if key == "scale":
                leaf = 1.0 + 0.1 * rng.standard_normal(shape)
            elif key == "bias":
                leaf = 0.1 * rng.standard_normal(shape)
            elif key == "mean":
                leaf = 0.1 * rng.standard_normal(shape)
            elif key == "var":
                leaf = 1.0 + 0.5 * rng.uniform(size=shape)
            elif key in _FREE_SMALL:
                leaf = 0.02 * rng.standard_normal(shape)
            else:  # conv / dense kernels, CLIP 'proj', CCProjection kernel
                fan_in = int(np.prod(shape[:-1]))
                leaf = rng.standard_normal(shape) / np.sqrt(fan_in)
            out[key] = leaf.astype(np.float32)
        return out

    return walk(tree)


def tiny_config(torch_side: bool):
    """The verify skill's tiny Zero123 config, from either package."""
    if torch_side:
        from one2345_tpu_torch.core import config as c
    else:
        from one2345_tpu.core import config as c
    return c.DiffusionConfig(
        ddim_steps_stage1=3,
        ddim_steps_stage2=2,
        image_size=32,
        latent_size=4,
        unet=c.UNetConfig(
            model_channels=32, channel_mult=(1, 2), attention_resolutions=(1,),
            num_heads=4, dtype="float32",
        ),
        vae=c.VAEConfig(base_channels=16, channel_mult=(1, 2, 2, 2), dtype="float32"),
        clip=c.CLIPVisionConfig(
            image_size=28, patch_size=14, width=32, layers=2, heads=2, dtype="float32"
        ),
    )


def max_err(a, b) -> float:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def tiny_recon_scene(V: int = 3, H: int = 32, W: int = 32, N: int = 8, seed: int = 0,
                     spread: float = 0.01) -> dict:
    """The synthetic scene of tests/test_training.py's recon steps: V cameras
    on a 1.8 sphere looking at the origin, K with f=35 at HxW, N rays from
    view 0 toward the origin, directions jittered by ``spread``; numpy f32,
    no scene axis."""
    from one2345_tpu_torch.geometry.cameras import BLENDER2OPENCV, spherical_look_at_poses

    rng = np.random.default_rng(seed)
    polar = np.radians(np.linspace(60.0, 80.0, V))
    azim = np.radians(np.arange(V) * 360.0 / V)
    c2ws = spherical_look_at_poses(polar, azim, radius=1.8) @ BLENDER2OPENCV
    w2cs = np.linalg.inv(c2ws)
    K = np.array([[35.0 * W / 32, 0, W / 2], [0, 35.0 * H / 32, H / 2], [0, 0, 1.0]])
    affines = np.tile(np.eye(4)[None], (V, 1, 1))
    affines[:, :3, :4] = np.einsum("ij,vjk->vik", K, w2cs[:, :3, :4])
    rays_o = np.tile(c2ws[0, :3, 3][None], (N, 1))
    dirs = -c2ws[0, :3, 3] / np.linalg.norm(c2ws[0, :3, 3])
    rays_v = np.tile(dirs[None], (N, 1)) + rng.normal(0, spread, (N, 3))
    rays_v /= np.linalg.norm(rays_v, axis=-1, keepdims=True)
    scene = {
        "images": rng.uniform(size=(V, H, W, 3)),
        "affines": affines,
        "w2cs": w2cs,
        "intrinsics": np.tile(K[None], (V, 1, 1)),
        "near_far": np.array([0.8, 2.8]),
        "rays_o": rays_o,
        "rays_v": rays_v,
        "rays_color": rng.uniform(size=(N, 3)),
        "rays_mask": (rng.uniform(size=(N, 1)) > 0.3),
    }
    return {k: np.asarray(v, np.float32) for k, v in scene.items()}


def recon_test_params(config: dict, seed: int, latent_std: float = 0.05,
                      variance: float = 0.3) -> dict:
    """A JAX ``ReconStage.params`` tree for parity checks of the ``ReconConfig``
    fields ``config``, built with no compile: the structure from
    ``jax.eval_shape``, every leaf redrawn by ``randomize`` except the SDF
    MLPs, which take the port's geometric init (a sphere) with the latent
    rows of their middle and last layers drawn N(0, latent_std^2) so that
    the volume moves the field, and the variance scalars, set to
    ``variance`` (inv_variance exp(10 v))."""
    import jax

    from one2345_tpu.core.config import ReconConfig as JaxReconConfig
    from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage

    shapes = jax.eval_shape(
        JaxReconStage(JaxReconConfig(**config), params={}).init_params, jax.random.key(0))
    out = randomize(shapes, seed)
    sphere = ReconStage(ReconConfig(**config), seed=seed, device="cpu").modules()
    rng = np.random.default_rng(seed + 1000)
    d_latent = ReconConfig(**config).regnet_d_out
    for key in out:
        if key.startswith("variance"):
            out[key]["params"]["variance"] = np.float32(variance)
        if not key.startswith("sdf"):
            continue
        sd = sphere[key].sdf_layer.state_dict()
        for layer, leaves in out[key]["params"]["sdf_layer"].items():
            for name in leaves:
                leaves[name] = sd[f"{layer}.{name}"].numpy().copy()
            if layer != "lin0":
                v = leaves["v"]
                v[-d_latent:] = latent_std * rng.standard_normal(v[-d_latent:].shape)
    return out
