"""DDIM img2img: encode, stochastic_encode and decode.

Counterpart of ``one2345_tpu/diffusion/img2img.py``: push a clean latent
to an intermediate noise level (deterministically by DDIM inversion, or in
one q_sample), then decode it back with the conditional model.  The same
``eps_fn(x, t) -> eps`` protocol as the samplers (CFG folded in by the
caller), over an untrimmed ``make_ddim_schedule`` output.

Kept quirk of the original: ``ddim_encode`` gives the model the *loop
index* i as the timestep, not the DDPM timestep ``ddim_timesteps[i]``.
The per-step constants are computed in float32, as the JAX loops compute
them.
"""

from __future__ import annotations

import numpy as np
import torch

from one2345_tpu_torch.diffusion.ddim import ddim_sample, truncate_schedule
from one2345_tpu_torch.diffusion.schedule import DDIMSchedule


def _ascending(sched: DDIMSchedule):
    """The schedule's alphas, previous alphas and sqrt(1 - alphas) in
    t-ascending order (the order the original builds them in)."""
    if sched.trimmed:
        raise ValueError(
            "img2img encode/decode take an UNTRIMMED make_ddim_schedule() "
            "output; this schedule went through trim_for_sample (the "
            "DDIMSampler.sample drop-last quirk, e.g. Zero123Stage._schedule) "
            "and would diverge from the reference encode/decode by one step."
        )
    rev = slice(None, None, -1)
    return tuple(
        np.ascontiguousarray(a[rev], np.float32)
        for a in (sched.alphas, sched.alphas_prev, sched.sqrt_one_minus_alphas)
    )


def ddim_encode(eps_fn, x0: torch.Tensor, sched: DDIMSchedule, t_enc: int) -> torch.Tensor:
    """Deterministic DDIM inversion: walk ``x0`` up the noise schedule for
    ``t_enc`` of its steps; each step moves alphas_prev[i] -> alphas[i] of
    the ascending schedule.

    :param eps_fn: (x, t int) -> eps, CFG folded in; t is the loop index
    :param t_enc: 1..sched.num_steps
    :return: x at DDIM noise level t_enc
    """
    if not (1 <= t_enc <= sched.num_steps):
        raise ValueError(f"t_enc must be in [1, {sched.num_steps}], got {t_enc}")
    asc_alphas, asc_alphas_prev, _ = _ascending(sched)
    one = np.float32(1.0)
    x = x0
    for i in range(t_enc):
        a_next, a = asc_alphas[i], asc_alphas_prev[i]
        e = eps_fn(x, i)
        weight = np.sqrt(a_next) * (np.sqrt(one / a_next - one) - np.sqrt(one / a - one))
        x = float(np.sqrt(a_next / a)) * x + float(weight) * e
    return x


def stochastic_encode(x0: torch.Tensor, t, sched: DDIMSchedule, noise: torch.Tensor) -> torch.Tensor:
    """q_sample at a DDIM step index: sqrt(a_t) x0 + sqrt(1 - a_t) noise.

    :param t: int, or [B] ints (a tensor or a sequence): the index into the
        t-ascending schedule, per sample
    :param noise: the shape of ``x0``
    """
    asc_alphas, _, asc_sqrt_1m = _ascending(sched)
    sqrt_a = np.sqrt(asc_alphas)
    if (t.dim() if isinstance(t, torch.Tensor) else np.ndim(t)) == 0:
        return float(sqrt_a[int(t)]) * x0 + float(asc_sqrt_1m[int(t)]) * noise
    idx = torch.as_tensor(t, dtype=torch.int64).cpu()
    shape = (-1,) + (1,) * (x0.dim() - 1)
    sa = torch.from_numpy(sqrt_a)[idx].reshape(shape).to(x0.device)
    s1m = torch.from_numpy(asc_sqrt_1m)[idx].reshape(shape).to(x0.device)
    return sa * x0 + s1m * noise


def ddim_decode(eps_fn, x_latent: torch.Tensor, sched: DDIMSchedule, t_start: int,
                generator: torch.Generator | None = None, noise_fn=None) -> torch.Tensor:
    """The DDIM sampling loop from noise level ``t_start`` down to 0: the
    port's ``ddim_sample`` over the last ``t_start`` steps of ``sched``.

    :param t_start: 1..sched.num_steps, how many of the schedule's
        ascending steps the latent sits above
    :param generator: draws the sigma noise (on the latent's device)
    :param noise_fn: (draw, shape) -> noise, instead of ``generator``;
        neither -> no noise (exact for eta=0, where the sigmas are 0)
    """
    if sched.trimmed:
        raise ValueError(
            "ddim_decode takes an UNTRIMMED make_ddim_schedule() output "
            "(t_start indexes the full ascending schedule); got a "
            "trim_for_sample'd one."
        )
    if noise_fn is None and generator is not None:
        def noise_fn(draw, shape):
            return torch.randn(shape, generator=generator, device=x_latent.device)

    return ddim_sample(eps_fn, x_latent, truncate_schedule(sched, t_start), noise_fn)
