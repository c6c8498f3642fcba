"""one2345_tpu_torch.diffusion.unet against the JAX UNet, weights carried
over by utils.convert_jax (tiny config, f32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.core.profiling import unet_flops_per_eval as jax_flops
from one2345_tpu.diffusion import unet as jax_unet
from one2345_tpu.diffusion.schedule import timestep_embedding as jax_temb
from one2345_tpu_torch.core.profiling import Timer, unet_flops_per_eval
from one2345_tpu_torch.diffusion import unet as port_unet
from one2345_tpu_torch.diffusion.schedule import timestep_embedding
from one2345_tpu_torch.utils.convert_jax import flax_to_state_dict
from tests.torch_port_helpers import max_err, randomize

TINY = dict(
    model_channels=32, channel_mult=(1, 2), attention_resolutions=(1, 2), num_heads=4
)


@pytest.fixture(scope="module")
def tiny_pair():
    jm = jax_unet.UNetModel(**TINY, dtype=jnp.float32)
    variables = jax.jit(jm.init)(
        jax.random.key(0), jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 1, 768)),
    )
    variables = randomize(variables, seed=11)
    tm = port_unet.UNetModel(**TINY).eval()
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jm, variables, tm


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 8, 8, 8)).astype(np.float32)
    t = rng.integers(0, 1000, size=(B,)).astype(np.int32)
    ctx = rng.standard_normal((B, 1, 768)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("B", [1, 3])
def test_unet_matches_jax(tiny_pair, B):
    jm, variables, tm = tiny_pair
    x, t, ctx = _inputs(B, seed=B)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jm.apply)(variables, x, t, ctx)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert out.dtype == torch.float32 and out.shape == (B, 8, 8, 4)
    assert float(np.abs(np.asarray(ref)).mean()) > 1e-2  # the check checks something
    assert max_err(out, ref) < 1e-4


def test_fresh_unet_outputs_zero():
    """Zero-initialised conv_out, as in the JAX module's init."""
    tm = port_unet.UNetModel(**TINY)
    x, t, ctx = _inputs(2, seed=5)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert torch.count_nonzero(out) == 0


def test_state_dict_names_follow_the_flax_scopes(tiny_pair):
    _, variables, tm = tiny_pair
    keys = set(flax_to_state_dict(variables))
    assert keys == set(tm.state_dict())
    assert "in_0_0_attn.block0.attn1.to_q.weight" in keys
    assert "in_0_0_res.in_norm.weight" in keys


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    ref = jax_temb(jnp.asarray(t), 320)
    out = timestep_embedding(torch.from_numpy(t), 320)
    assert max_err(out, ref) < 1e-4


def test_geglu_uses_the_tanh_gelu():
    g = port_unet.GEGLU(4, 2)
    with torch.no_grad():
        g.proj.weight.zero_()
        g.proj.bias.copy_(torch.tensor([1.0, 1.0, 1.0, 1.0]))
        out = g(torch.zeros(1, 4))
    ref = float(jax.nn.gelu(jnp.float32(1.0)))  # flax's nn.gelu default
    assert abs(float(out[0, 0]) - ref) < 1e-6


@pytest.mark.parametrize("B", [8, 56])
def test_unet_flop_count_matches_jax(B):
    assert unet_flops_per_eval(B) == jax_flops(B)


def test_timer_accumulates_named_spans_on_cpu():
    timer = Timer(device="cpu")
    for _ in range(2):
        with timer.span("a"):
            pass
    with timer.span("b"):
        pass
    assert set(timer.report()) == {"a", "b"}
    assert timer.total() == pytest.approx(sum(timer.report().values()))
