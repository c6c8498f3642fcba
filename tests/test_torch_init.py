"""Seeded stages draw each leaf from its flax initialiser's distribution.

A JAX stage built from a seed takes flax's initialisers; the port's
``Zero123Stage(params=None)`` / ``ReconStage(params=None)`` and the
finetune's blending net take them through ``nn.init.flax_init_``.  The
JAX trees are built with ``jax.jit(init)`` at the tiny sizes and mapped to
the port's names with ``utils.convert_jax``.  Per leaf: a leaf that is all
zeros, all ones, or the identity in JAX is equal in the port; a random leaf
of 1000 or more elements has its mean within 0.05 sigma of the JAX leaf's
(widened to 4 standard errors of a mean, 4 sigma / sqrt(n), where that is
larger: at n = 1000 a sample mean's own error is 0.032 sigma) and its
standard deviation within 10 % of the JAX leaf's.
"""

import functools
import math

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import example_diffusion_config as diffusion_config

RECON_TINY = dict(vol_dims=(16, 16, 16), voxel_size=2.0 / 15, image_hw=(32, 32))


def _compare(jax_sd: dict, port_sd: dict, where: str) -> int:
    """Check every leaf; return how many random leaves were held by their
    moments."""
    assert set(jax_sd) == set(port_sd), (where, set(jax_sd) ^ set(port_sd))
    n_random = 0
    for key, ref in jax_sd.items():
        ref = ref.numpy().astype(np.float64)
        got = port_sd[key].detach().cpu().numpy().astype(np.float64)
        assert ref.shape == got.shape, (where, key)
        constant = np.all(ref == ref.flat[0]) and ref.flat[0] in (0.0, 1.0)
        identity = ref.ndim == 2 and np.array_equal(ref, np.eye(*ref.shape))
        if constant or identity or ref.size == 1:
            np.testing.assert_array_equal(got, ref, err_msg=f"{where}.{key}")
            continue
        assert np.unique(got).size > 1, f"{where}.{key} is constant in the port"
        if ref.size < 1000:
            continue
        sigma, se = ref.std(), ref.std() / math.sqrt(ref.size)
        # the distribution's mean: zero where the JAX leaf's is, within 4
        # standard errors (every kernel), else the JAX leaf's own (the SDF
        # MLP's last layer), with the error of both means
        if abs(ref.mean()) <= 4.0 * se:
            mu, tol = 0.0, max(0.05 * sigma, 4.0 * se)
        else:
            mu, tol = ref.mean(), max(0.05 * sigma, 4.0 * math.sqrt(2.0) * se)
        assert abs(got.mean() - mu) <= tol, (where, key, got.mean(), ref.mean(), sigma)
        assert abs(got.std() / sigma - 1.0) <= 0.10, (where, key, got.std(), sigma)
        n_random += 1
    return n_random


@pytest.fixture(scope="module")
def jax_stages():
    """The JAX stages' own seeded ``init_params`` (each module's init under
    ``jax.jit``), compiled at XLA's lowest optimisation level: the leaves are
    the same draws, in half the compile time."""
    import jax

    from one2345_tpu.core.config import ReconConfig as JaxReconConfig
    from one2345_tpu.diffusion.zero123 import Zero123Stage as JaxZero123Stage
    from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage

    jit = jax.jit

    def quick_jit(fn=None, **kwargs):
        if fn is None or set(kwargs) - {"static_argnums"}:  # any other use of jax.jit
            return jit(fn, **kwargs) if fn is not None else functools.partial(jit, **kwargs)
        static = kwargs.get("static_argnums", ())
        static = (static,) if isinstance(static, int) else tuple(static)

        def call(*args):
            compiled = jit(fn, static_argnums=static).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
            return compiled(*(a for i, a in enumerate(args) if i not in static))

        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", quick_jit)
        z = JaxZero123Stage(diffusion_config(False), seed=3)
        r = JaxReconStage(JaxReconConfig(**RECON_TINY), seed=3)
    # the finetune's blending net, with JaxFinetuneTrainer.init_state's inputs
    import jax.numpy as jnp

    from one2345_tpu.recon.finetune import FinetuneTrainer as JaxFinetuneTrainer

    net = JaxFinetuneTrainer(r).blend_net
    blend = quick_jit(net.init)(
        jax.random.key(2), jnp.zeros((4, 3)), jnp.zeros((4, 3)), jnp.zeros((4, 3)),
        jnp.zeros((4, net.d_feature)), jnp.zeros((4, 2, 3)), jnp.ones((4, 2)))
    return jax.device_get(z.params), jax.device_get(r.params), jax.device_get(blend)


def test_zero123_stage_takes_flax_initialisers(jax_stages):
    from one2345_tpu_torch.diffusion.zero123 import MODULES, Zero123Stage
    from one2345_tpu_torch.utils.convert_jax import zero123_from_jax

    ref = zero123_from_jax(jax_stages[0])
    stage = Zero123Stage(diffusion_config(True), seed=5, device="cpu")
    n = sum(_compare(ref[m], getattr(stage, m).state_dict(), m) for m in MODULES)
    assert n >= 30, n
    # the zero-initialised outputs stay zero, the CCProjection is the identity
    assert not stage.unet.conv_out.weight.any()
    kernel = stage.cc_projection.kernel
    assert torch.equal(kernel[: kernel.shape[1]], torch.eye(kernel.shape[1]))
    # two builds from one seed are equal; another seed draws other leaves
    again = Zero123Stage(diffusion_config(True), seed=5, device="cpu")
    other = Zero123Stage(diffusion_config(True), seed=6, device="cpu")
    w = stage.unet.conv_in.weight
    assert torch.equal(w, again.unet.conv_in.weight)
    assert not torch.equal(w, other.unet.conv_in.weight)


def test_recon_stage_and_blending_net_take_flax_initialisers(jax_stages):
    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.finetune import FinetuneTrainer
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.utils.convert_jax import finetune_from_jax, recon_from_jax

    ref = recon_from_jax(jax_stages[1])
    stage = ReconStage(ReconConfig(**RECON_TINY), seed=5, device="cpu")
    mods = stage.modules()
    assert set(mods) == set(ref)
    n = sum(_compare(ref[k], m.state_dict(), k) for k, m in mods.items())
    assert n >= 10, n

    # the finetune's blending net (flax WNDense: lecun_normal directions)
    ft = FinetuneTrainer(stage, seed=9)
    ft.init_state(torch.zeros(16, 16, 16, 16), torch.ones(16, 16, 16, 1))
    assert _compare(finetune_from_jax(jax_stages[2]), ft.blend_net.state_dict(), "blend") >= 4
