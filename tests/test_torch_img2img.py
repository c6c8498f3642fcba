"""one2345_tpu_torch's DDIM img2img (ddim_encode, stochastic_encode,
ddim_decode) and truncate_schedule against the JAX package's (CPU, f32):
the same numpy inputs and eps_fn, relative L2 <= 1e-5; the sigma noise of
an eta=1 decode replayed from the JAX key; trimmed schedules refused with
JAX's message."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.diffusion import ddim as jax_ddim
from one2345_tpu.diffusion import img2img as jax_img2img
from one2345_tpu_torch.diffusion import ddim, img2img
from one2345_tpu_torch.diffusion.schedule import make_ddim_schedule

REL_TOL = 1e-5
SCHED = make_ddim_schedule(10, eta=0.0)
SCHED_ETA = make_ddim_schedule(10, eta=1.0)
X0 = np.random.default_rng(0).standard_normal((2, 4, 4, 3)).astype(np.float32)


@pytest.fixture(autouse=True)
def _full_matmul_precision():
    with jax.default_matmul_precision("highest"):
        yield


def rel_l2(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_eps(x, t):
    # depends on x and t, so an ordering or timestep slip cannot cancel
    return 0.1 * x + 0.01 * jnp.asarray(t, jnp.float32)


def port_eps(x, t):
    return 0.1 * x + 0.01 * float(np.float32(t))


@pytest.mark.parametrize("t_enc", [1, 4, 10])
def test_ddim_encode_matches_jax(t_enc):
    ref = jax_img2img.ddim_encode(jax_eps, jnp.asarray(X0), SCHED, t_enc)
    ts = []

    def eps(x, t):
        ts.append(t)
        return port_eps(x, t)

    out = img2img.ddim_encode(eps, torch.from_numpy(X0), SCHED, t_enc)
    assert rel_l2(out, ref) <= REL_TOL
    assert ts == list(range(t_enc))  # the loop index, as the original passes it


@pytest.mark.parametrize("t_start", [1, 4, 10])
def test_ddim_decode_matches_jax(t_start):
    ref = jax_img2img.ddim_decode(jax_eps, jnp.asarray(X0), SCHED, t_start)
    out = img2img.ddim_decode(port_eps, torch.from_numpy(X0), SCHED, t_start)
    assert rel_l2(out, ref) <= REL_TOL


def test_ddim_decode_eta_noise_matches_jax():
    """eta=1: the sigma noise of draw d is normal(fold_in(key, d)) in JAX;
    the port takes the same draws through noise_fn."""
    key = jax.random.key(3)
    ref = jax_img2img.ddim_decode(jax_eps, jnp.asarray(X0), SCHED_ETA, 6, key=key)

    def noise_fn(draw, shape):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, draw), shape)))

    out = img2img.ddim_decode(port_eps, torch.from_numpy(X0), SCHED_ETA, 6, noise_fn=noise_fn)
    assert rel_l2(out, ref) <= REL_TOL
    quiet = img2img.ddim_decode(port_eps, torch.from_numpy(X0), SCHED_ETA, 6)
    gen = img2img.ddim_decode(port_eps, torch.from_numpy(X0), SCHED_ETA, 6,
                              generator=torch.Generator().manual_seed(0))
    again = img2img.ddim_decode(port_eps, torch.from_numpy(X0), SCHED_ETA, 6,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(gen, again) and not torch.equal(gen, quiet)


def test_stochastic_encode_matches_jax():
    noise = np.random.default_rng(1).standard_normal(X0.shape).astype(np.float32)
    for t in (0, 3, 9):
        ref = jax_img2img.stochastic_encode(jnp.asarray(X0), t, SCHED, jnp.asarray(noise))
        out = img2img.stochastic_encode(torch.from_numpy(X0), t, SCHED, torch.from_numpy(noise))
        assert rel_l2(out, ref) <= REL_TOL
    t = [2, 7]  # one index per sample
    ref = jax_img2img.stochastic_encode(jnp.asarray(X0), jnp.asarray(t), SCHED, jnp.asarray(noise))
    for tt in (t, torch.tensor(t), np.asarray(t)):
        out = img2img.stochastic_encode(torch.from_numpy(X0), tt, SCHED, torch.from_numpy(noise))
        assert rel_l2(out, ref) <= REL_TOL
    out = img2img.stochastic_encode(torch.from_numpy(X0), torch.tensor(3), SCHED, torch.from_numpy(noise))
    assert rel_l2(out, jax_img2img.stochastic_encode(jnp.asarray(X0), 3, SCHED, jnp.asarray(noise))) <= REL_TOL


@pytest.mark.parametrize("t_start", [1, 4, 10])
def test_truncate_schedule_matches_jax(t_start):
    for sched in (SCHED, ddim.trim_for_sample(SCHED_ETA)):
        if t_start > sched.num_steps:
            continue
        out, ref = ddim.truncate_schedule(sched, t_start), jax_ddim.truncate_schedule(sched, t_start)
        assert out.trimmed == ref.trimmed == sched.trimmed and out.num_steps == t_start
        for a, b in zip(out.arrays, ref.arrays):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for bad in (0, SCHED.num_steps + 1):
        with pytest.raises(ValueError, match="t_start must be in"):
            ddim.truncate_schedule(SCHED, bad)


def test_img2img_refuses_trimmed_schedules():
    trimmed = ddim.trim_for_sample(SCHED)
    x = torch.from_numpy(X0)
    with pytest.raises(ValueError, match="UNTRIMMED") as port_err:
        img2img.ddim_encode(port_eps, x, trimmed, 2)
    with pytest.raises(ValueError) as jax_err:
        jax_img2img.ddim_encode(jax_eps, jnp.asarray(X0), trimmed, 2)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="UNTRIMMED"):
        img2img.stochastic_encode(x, 1, trimmed, x)
    with pytest.raises(ValueError) as port_err:
        img2img.ddim_decode(port_eps, x, trimmed, 2)
    with pytest.raises(ValueError) as jax_err:
        jax_img2img.ddim_decode(jax_eps, jnp.asarray(X0), trimmed, 2)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="t_enc must be in"):
        img2img.ddim_encode(port_eps, x, SCHED, 0)
