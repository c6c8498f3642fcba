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
