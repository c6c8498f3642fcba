"""one2345_tpu_torch VAE and CLIP tower against the JAX modules (tiny
configs, f32, CPU), weights carried over by utils.convert_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.diffusion import clip as jax_clip
from one2345_tpu.diffusion import vae as jax_vae
from one2345_tpu_torch.diffusion import clip as port_clip
from one2345_tpu_torch.diffusion import vae as port_vae
from one2345_tpu_torch.utils.convert_jax import flax_to_state_dict
from tests.torch_port_helpers import max_err, randomize

VAE = dict(base_channels=16, channel_mult=(1, 2, 2, 2), num_res_blocks=2, z_channels=4)
CLIP = dict(image_size=28, patch_size=14, width=32, layers=2, heads=2, embed_dim=768)
CLIP_FREE = ("class_embedding", "positional_embedding", "proj")


def _run_jax(module, variables, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(module.apply)(variables, *args))


def _images(B, size, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=(B, size, size, 3)).astype(np.float32)


def test_encoder_matches_jax():
    jm = jax_vae.Encoder(**VAE, dtype=jnp.float32)
    x = _images(2, 32, seed=1)
    variables = randomize(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x)), seed=21)
    tm = port_vae.Encoder(**VAE).eval()
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    ref = _run_jax(jm, variables, x)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (2, 4, 4, 8)
    assert max_err(out, ref) < 1e-4
    assert max_err(port_vae.moments_mode(out), jax_vae.moments_mode(ref)) < 1e-4


def test_decoder_matches_jax():
    jm = jax_vae.Decoder(**VAE, dtype=jnp.float32)
    z = np.random.default_rng(2).standard_normal((2, 4, 4, 4)).astype(np.float32)
    variables = randomize(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(z)), seed=22)
    tm = port_vae.Decoder(**VAE).eval()
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    ref = _run_jax(jm, variables, z)
    with torch.no_grad():
        out = tm(torch.from_numpy(z))
    assert out.shape == (2, 32, 32, 3)
    assert max_err(out, ref) < 1e-4


def test_clip_tower_matches_jax():
    jm = jax_clip.CLIPVisionTower(**CLIP, dtype=jnp.float32)
    x = _images(3, 28, seed=3)
    variables = randomize(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x)), seed=23)
    tm = port_clip.CLIPVisionTower(**CLIP).eval()
    tm.load_state_dict(flax_to_state_dict(variables, free=CLIP_FREE), strict=True)
    ref = _run_jax(jm, variables, x)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (3, 768)
    assert max_err(out, ref) < 1e-4


@pytest.mark.parametrize("src,size", [(256, 224), (32, 28)])
def test_preprocess_for_clip_matches_jax(src, size):
    """Bicubic antialiased resize: the full-size 256 -> 224 and the tiny
    config's 32 -> 28."""
    x = _images(2, src, seed=src)
    ref = np.asarray(jax_clip.preprocess_for_clip(jnp.asarray(x), size))
    out = port_clip.preprocess_for_clip(torch.from_numpy(x), size)
    assert out.shape == (2, size, size, 3)
    assert max_err(out, ref) < 1e-4
