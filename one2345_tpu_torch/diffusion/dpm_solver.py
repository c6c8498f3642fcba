"""DPM-Solver++(2M), a fast deterministic sampler (opt-in speed mode).

Counterpart of ``one2345_tpu/diffusion/dpm_solver.py`` (a ``lax.scan``
there, a Python loop here).  The data-prediction "++" update (arXiv
2211.01095, Algorithm 2) over the nodes of the untrimmed eta=0 DDIM
schedule, with a_i = alpha_cumprod at node i, alpha = sqrt(a), sigma =
sqrt(1 - a) and lambda = log(alpha / sigma) = 0.5 log(a / (1 - a)):

  h_i = lambda_i - lambda_{i-1},  r_i = h_{i-1} / h_i
  D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}
  x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i expm1(-h_i) D_i

The first and the last step are first order (r = 1 and x0_{i-1} = x0_i,
so D = x0), and so is any step where h or h_{i-1} is 0: schedules of more
than 500 steps duplicate the terminal node, where the second-order term
would be inf - inf.  S schedule entries take S UNet evals.  lambda, h and
expm1 are computed in float32, as in the JAX loop.
"""

from __future__ import annotations

import numpy as np
import torch

from one2345_tpu_torch.diffusion.schedule import DDIMSchedule


def _lam(a):
    f32 = np.float32
    return f32(0.5) * np.log(a / (f32(1.0) - a))


def dpmpp_sample(eps_fn, x: torch.Tensor, sched: DDIMSchedule) -> torch.Tensor:
    """Run the DPM-Solver++(2M) loop.

    :param eps_fn: (x, t int) -> predicted noise, CFG already folded in
    :param x: [B, H, W, C] initial noise at ``sched.timesteps[0]``, f32
    :param sched: DDIM schedule with eta=0 (the sigmas are not read)
    """
    f32 = np.float32
    S = sched.num_steps
    prev_x0, prev_lam = None, _lam(f32(sched.alphas[0]))
    for i in range(S):
        a_t, a_next = f32(sched.alphas[i]), f32(sched.alphas_prev[i])
        e_t = eps_fn(x, int(sched.timesteps[i]))
        x0 = (x - float(sched.sqrt_one_minus_alphas[i]) * e_t) / float(np.sqrt(a_t))

        lam_t = _lam(a_t)
        h = _lam(a_next) - lam_t
        h_prev = lam_t - prev_lam
        lower = i == 0 or i == S - 1 or h_prev == 0.0 or h == 0.0
        r = f32(1.0) if lower else h_prev / h
        c = f32(1.0) / (f32(2.0) * r)
        D = float(f32(1.0) + c) * x0 - float(c) * (x0 if lower else prev_x0)

        ratio = np.sqrt(f32(1.0) - a_next) / np.sqrt(f32(1.0) - a_t)
        x = float(ratio) * x - float(np.sqrt(a_next) * np.expm1(-h)) * D
        prev_x0, prev_lam = x0, lam_t
    return x
