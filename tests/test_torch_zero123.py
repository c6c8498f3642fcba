"""one2345_tpu_torch's schedule, DDIM loop and Zero123 stages against the
JAX package (tiny config, f32, CPU), with the JAX noise injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.diffusion import ddim as jax_ddim
from one2345_tpu.diffusion import schedule as jax_schedule
from one2345_tpu.diffusion import zero123 as jax_z
from one2345_tpu_torch.diffusion import ddim, schedule
from one2345_tpu_torch.diffusion import zero123 as port_z
from one2345_tpu_torch.utils.convert_jax import zero123_from_jax
from tests.torch_port_helpers import max_err, randomize, tiny_config


@pytest.fixture(autouse=True)
def _full_matmul_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("steps,eta", [(75, 1.0), (50, 1.0), (3, 1.0), (25, 0.0)])
def test_schedule_is_bit_identical(steps, eta):
    ref = jax_schedule.make_ddim_schedule(steps, 1000, eta)
    out = schedule.make_ddim_schedule(steps, 1000, eta)
    for a, b in zip(out.arrays, ref.arrays):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    trimmed, ref_trimmed = ddim.trim_for_sample(out), jax_ddim.trim_for_sample(ref)
    assert trimmed.trimmed and trimmed.num_steps == ref_trimmed.num_steps
    for a, b in zip(trimmed.arrays, ref_trimmed.arrays):
        assert np.array_equal(a, b)
    assert np.array_equal(
        schedule.make_beta_schedule(), jax_schedule.make_beta_schedule()
    )


def test_executed_step_counts():
    """75 and 50 DDIM steps run as 76 and 49 UNet steps."""
    assert ddim.trim_for_sample(schedule.make_ddim_schedule(75)).num_steps == 76
    assert ddim.trim_for_sample(schedule.make_ddim_schedule(50)).num_steps == 49


@pytest.mark.parametrize("with_noise", [True, False])
def test_ddim_loop_matches_jax(with_noise):
    sched = jax_ddim.trim_for_sample(jax_schedule.make_ddim_schedule(10))
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    table = rng.standard_normal((sched.num_steps + 1, 2, 4, 4, 3)).astype(np.float32)

    def jax_eps(x, t):
        return 0.3 * x + jnp.sin(t / 100.0)

    def port_eps(x, t):
        return 0.3 * x + float(np.sin(np.float32(t) / np.float32(100.0)))

    jt = jnp.asarray(table)
    ref = jax_ddim.ddim_sample(
        jax_eps, jnp.asarray(x0), sched, (lambda d, s: jt[d]) if with_noise else None
    )
    out = ddim.ddim_sample(
        port_eps, torch.from_numpy(x0), sched,
        (lambda d, s: torch.from_numpy(table[d])) if with_noise else None,
    )
    assert max_err(out, ref) < 1e-4


def test_view_tables_and_pose_tokens():
    assert port_z.STAGE1_DELTA_X == jax_z.STAGE1_DELTA_X
    assert port_z.STAGE1_DELTA_Y == jax_z.STAGE1_DELTA_Y
    assert port_z.STAGE2_DELTA_X == jax_z.STAGE2_DELTA_X
    assert port_z.STAGE2_DELTA_Y == jax_z.STAGE2_DELTA_Y
    dx, dy = jax_z.STAGE1_DELTA_X, jax_z.STAGE1_DELTA_Y
    assert np.array_equal(port_z.pose_tokens(dx, dy), jax_z.pose_tokens(dx, dy))


def test_cc_projection_identity_init():
    x = torch.randn(2, 1, 772)
    out = port_z.CCProjection()(x)
    assert torch.equal(out, x[..., :768])


@pytest.fixture(scope="module")
def stages():
    jst = jax_z.Zero123Stage(tiny_config(torch_side=False), seed=0)
    jst.params = randomize(jst.params, seed=31)
    pst = port_z.Zero123Stage(
        tiny_config(torch_side=True), params=zero123_from_jax(jst.params), device="cpu"
    )
    return jst, pst


def _jax_noise(jst, key):
    def noise_fn(draw, view_ids, shape):
        return np.array(jst._per_view_noise(key, jnp.asarray(view_ids, jnp.uint32), draw, shape))

    return noise_fn


def _input_image():
    img = np.ones((32, 32, 3), np.float32)  # white background
    yy, xx = np.mgrid[:32, :32]
    blob = (yy - 15.5) ** 2 + (xx - 15.5) ** 2 < 100
    img[blob] = np.random.default_rng(4).uniform(0.1, 0.9, size=(int(blob.sum()), 3))
    return img


def test_encode_conditioning_matches_jax(stages):
    jst, pst = stages
    cond = _input_image()[None].repeat(2, 0) * 2.0 - 1.0
    T = jax_z.pose_tokens([0.0, 30.0], [0.0, 120.0])
    ctx_ref, concat_ref = jst.encode_conditioning(jst.params, jnp.asarray(cond), jnp.asarray(T))
    ctx, concat = pst.encode_conditioning(torch.from_numpy(cond), torch.from_numpy(T))
    assert max_err(ctx, ctx_ref) < 1e-4
    assert max_err(concat, concat_ref) < 1e-4


def test_stage1_and_stage2_match_jax(stages):
    jst, pst = stages
    img = _input_image()
    k1, k2 = jax.random.key(1), jax.random.key(2)
    ref1 = np.asarray(jst.stage1(img, k1, indices=[0, 5], steps=3))
    out1 = pst.stage1(img, seed=0, indices=[0, 5], steps=3, noise_fn=_jax_noise(jst, k1))
    assert out1.shape == (2, 32, 32, 3)
    inside = float(np.mean((ref1 > 0.01) & (ref1 < 0.99)))
    assert inside > 0.2, inside  # not saturated: the comparison has teeth
    assert max_err(out1, ref1) < 2e-3

    parent = ref1[1:].copy()
    ref2 = np.asarray(jst.stage2(parent, k2, steps=2, view_ids=[5]))
    out2 = pst.stage2(parent, seed=0, steps=2, view_ids=[5], noise_fn=_jax_noise(jst, k2))
    assert out2.shape == (1, 4, 32, 32, 3)
    assert max_err(out2, ref2) < 2e-3


def test_noise_is_keyed_by_view_id_not_batch_position(stages):
    _, pst = stages
    a = pst.per_view_noise(3, 1, [4, 5, 6], (4, 4, 4))
    b = pst.per_view_noise(3, 1, [6, 4], (4, 4, 4))
    assert torch.equal(a[2], b[0]) and torch.equal(a[0], b[1])
    assert not torch.equal(a[0], pst.per_view_noise(3, 2, [4], (4, 4, 4))[0])
    assert not torch.equal(a[0], pst.per_view_noise(4, 1, [4], (4, 4, 4))[0])
