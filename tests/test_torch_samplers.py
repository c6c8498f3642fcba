"""one2345_tpu_torch's PLMS and DPM-Solver++(2M) samplers against the JAX
package's (CPU, f32) on one numpy-defined eps_fn, at 5 and 8 steps and at
the schedules the CLI runs (PLMS 75 -> 77 entries, dpmpp 30 / 25 -> 31 /
25 entries): relative L2 <= 1e-5.  Also the UNet evals each sampler takes,
the duplicate terminal node of schedules over 500 steps, and the two-step
identity with DDIM."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.diffusion.dpm_solver import dpmpp_sample as jax_dpmpp
from one2345_tpu.diffusion.plms import plms_sample as jax_plms
from one2345_tpu_torch.diffusion.ddim import ddim_sample
from one2345_tpu_torch.diffusion.dpm_solver import dpmpp_sample
from one2345_tpu_torch.diffusion.plms import plms_sample
from one2345_tpu_torch.diffusion.schedule import make_ddim_schedule

REL_TOL = 1e-5
SHAPE = (2, 4, 4, 3)


@pytest.fixture(autouse=True)
def _full_matmul_precision():
    with jax.default_matmul_precision("highest"):
        yield


def rel_l2(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def eps_pair(seed: int = 0):
    """The same eps_fn for both packages: 0.3 x + 0.1 tanh(x) + c[t], with
    c a numpy table over the 1000 timesteps (and index 0 after the last
    PLMS step)."""
    table = (0.2 * np.random.default_rng(seed).standard_normal((1000,) + SHAPE[1:])).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)

    def jax_eps(x, t):
        return 0.3 * x + 0.1 * jnp.tanh(x) + jt[t]

    def port_eps(x, t):
        return 0.3 * x + 0.1 * torch.tanh(x) + tt[t]

    return jax_eps, port_eps


def x_T(seed: int = 1):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def counted(fn):
    calls = []

    def eps(x, t):
        calls.append(t)
        return fn(x, t)

    return eps, calls


@pytest.mark.parametrize("steps", [5, 8, 75])
def test_plms_matches_jax(steps):
    sched = make_ddim_schedule(steps, eta=0.0)
    jax_eps, port_eps = eps_pair()
    x = x_T()
    ref = jax_plms(jax_eps, jnp.asarray(x), sched)
    eps, calls = counted(port_eps)
    out = plms_sample(eps, torch.from_numpy(x), sched)
    assert rel_l2(out, ref) <= REL_TOL, rel_l2(out, ref)
    # step 0 is a Heun step: one extra eval, at the next timestep
    assert len(calls) == sched.num_steps + 1
    t = [int(v) for v in sched.timesteps]
    assert calls == t[:1] + t[1:2] + t[1:]
    if steps == 75:
        assert sched.num_steps == 77 and len(calls) == 78


@pytest.mark.parametrize("steps", [5, 8, 30, 25])
def test_dpmpp_matches_jax(steps):
    sched = make_ddim_schedule(steps, eta=0.0)
    jax_eps, port_eps = eps_pair()
    x = x_T()
    ref = jax_dpmpp(jax_eps, jnp.asarray(x), sched)
    eps, calls = counted(port_eps)
    out = dpmpp_sample(eps, torch.from_numpy(x), sched)
    assert rel_l2(out, ref) <= REL_TOL
    assert calls == [int(t) for t in sched.timesteps]
    assert {30: 31, 25: 25}.get(steps, sched.num_steps) == len(calls)


def test_plms_zero_eps_telescopes():
    """With eps == 0 every update is x *= sqrt(a_prev / a_t)."""
    sched = make_ddim_schedule(10, eta=0.0)
    out = plms_sample(lambda x, t: torch.zeros_like(x), torch.ones(SHAPE), sched)
    expected = np.sqrt(sched.alphas_prev[-1] / sched.alphas[0])
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-5)


def test_dpmpp_duplicate_terminal_node_matches_jax():
    """Over 500 steps the +1 offset is clipped and the terminal node comes
    twice: h_prev == 0 there, and the step drops to first order."""
    sched = make_ddim_schedule(600, eta=0.0)
    assert sched.timesteps[0] == sched.timesteps[1]
    x = x_T(2)
    ref = jax_dpmpp(lambda x, t: 0.1 * x, jnp.asarray(x), sched)
    out = dpmpp_sample(lambda x, t: 0.1 * x, torch.from_numpy(x), sched)
    assert torch.isfinite(out).all()
    assert rel_l2(out, ref) <= REL_TOL


def test_dpmpp_two_steps_equal_ddim():
    """At S=2 both steps are first order, and a first-order DPM++ step is
    an eta=0 DDIM step: the port's DPM++ against the port's DDIM loop."""
    sched = make_ddim_schedule(2, eta=0.0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    c = torch.from_numpy((0.2 * rng.standard_normal(SHAPE[1:])).astype(np.float32))

    def eps(x, t):
        return 0.3 * x + c

    out = dpmpp_sample(eps, x, sched)
    np.testing.assert_allclose(out.numpy(), ddim_sample(eps, x, sched).numpy(), rtol=1e-4, atol=1e-5)
