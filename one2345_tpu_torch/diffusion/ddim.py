"""The DDIM sampling loop.

Counterpart of ``one2345_tpu/diffusion/ddim.py`` (a ``lax.scan`` there, a
Python loop here): per step
    pred_x0 = (x - sqrt(1 - a_t) e) / sqrt(a_t)
    dir_xt  = sqrt(max(1 - a_prev - sigma^2, 0)) e
    x_prev  = sqrt(a_prev) pred_x0 + dir_xt + sigma * noise.
CFG folding lives in the caller's ``eps_fn``.  The per-step constants are
computed in float32, as the JAX loop computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from one2345_tpu_torch.diffusion.schedule import DDIMSchedule


def ddim_sample(eps_fn, x: torch.Tensor, sched: DDIMSchedule, noise_fn=None) -> torch.Tensor:
    """Run the full DDIM loop over ``sched`` (already in sampling order).

    :param eps_fn: (x, t int) -> eps, CFG already folded in
    :param x: [B, ...] initial noise x_T, f32
    :param noise_fn: (draw index, shape) -> noise for the sigma term, where
        draw runs 1..num_steps (0 is the x_T draw); None -> no noise (exact
        for eta=0, where the sigmas are identically 0)
    :return: x_0 estimate after the last step
    """
    f32 = np.float32
    for i in range(sched.num_steps):
        a_t = f32(sched.alphas[i])
        a_prev = f32(sched.alphas_prev[i])
        sigma = f32(sched.sigmas[i])
        e_t = eps_fn(x, int(sched.timesteps[i]))
        pred_x0 = (x - float(sched.sqrt_one_minus_alphas[i]) * e_t) / float(np.sqrt(a_t))
        dir_xt = float(np.sqrt(np.maximum(f32(1.0) - a_prev - sigma * sigma, f32(0.0)))) * e_t
        x = float(np.sqrt(a_prev)) * pred_x0 + dir_xt
        if noise_fn is not None:
            x = x + float(sigma) * noise_fn(i + 1, tuple(x.shape))
    return x


def trim_for_sample(sched: DDIMSchedule) -> DDIMSchedule:
    """Drop the highest-noise step, as the original ``DDIMSampler.sample``
    does (its ``t_start=-1`` slice): S schedule entries run S-1 UNet steps,
    so S=75 -> 77 entries -> 76 steps from t=977."""
    return DDIMSchedule(*(np.asarray(a)[1:] for a in sched.arrays), trimmed=True)


def truncate_schedule(sched: DDIMSchedule, t_start: int) -> DDIMSchedule:
    """The last ``t_start`` sampling steps of ``sched`` (the first
    ``t_start`` ascending steps, flipped: decode's ``timesteps[:t_start]``)."""
    if not (1 <= t_start <= sched.num_steps):
        raise ValueError(f"t_start must be in [1, {sched.num_steps}], got {t_start}")
    sl = slice(sched.num_steps - t_start, None)
    return DDIMSchedule(*(np.asarray(a)[sl] for a in sched.arrays), trimmed=sched.trimmed)
