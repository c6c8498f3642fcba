"""PLMS (pseudo linear multistep) sampler, the alternative to DDIM.

Counterpart of ``one2345_tpu/diffusion/plms.py`` (a ``lax.scan`` with
``lax.cond`` branches there, a Python loop with plain branches here):

- step 0 is a Heun step: eps at the provisional next state (at the next
  timestep, 0 after the last step), averaged with eps at the current one,
  so it takes two UNet evals;
- later steps combine eps with the history of earlier eps (newest first)
  by the 2-, 3- and 4-term Adams-Bashforth weights, the history holding 3;
- the update is the eta=0 DDIM step with the combined eps.

S schedule entries take S + 1 evals.  The per-step constants are computed
in float32, as the JAX loop computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from one2345_tpu_torch.diffusion.schedule import DDIMSchedule


def _x_prev(x, e_t, a_t, a_prev, sqrt_1m_a):
    f32 = np.float32
    pred_x0 = (x - float(sqrt_1m_a) * e_t) / float(np.sqrt(a_t))
    dir_xt = float(np.sqrt(np.maximum(f32(1.0) - a_prev, f32(0.0)))) * e_t
    return float(np.sqrt(a_prev)) * pred_x0 + dir_xt


def plms_sample(eps_fn, x: torch.Tensor, sched: DDIMSchedule) -> torch.Tensor:
    """Run the PLMS loop.

    :param eps_fn: (x, t int) -> predicted noise, CFG already folded in
    :param x: [B, H, W, C] initial noise, f32
    :param sched: DDIM schedule with eta=0 (the sigmas are not read)
    """
    f32 = np.float32
    ts = [int(t) for t in sched.timesteps]
    ts_next = ts[1:] + [0]
    hist = []  # earlier eps, newest first, at most 3
    for i in range(sched.num_steps):
        a_t, a_prev = f32(sched.alphas[i]), f32(sched.alphas_prev[i])
        sqrt_1m_a = f32(sched.sqrt_one_minus_alphas[i])
        e_t = eps_fn(x, ts[i])
        if not hist:
            e_next = eps_fn(_x_prev(x, e_t, a_t, a_prev, sqrt_1m_a), ts_next[i])
            e_prime = (e_t + e_next) / 2.0
        elif len(hist) == 1:
            e_prime = (3.0 * e_t - hist[0]) / 2.0
        elif len(hist) == 2:
            e_prime = (23.0 * e_t - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * hist[0] + 37.0 * hist[1] - 9.0 * hist[2]) / 24.0
        x = _x_prev(x, e_prime, a_t, a_prev, sqrt_1m_a)
        hist = [e_t] + hist[:2]
    return x
