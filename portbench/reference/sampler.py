"""Plain reference of one DDIM sampler step with classifier-free guidance,
as the reference's ``DDIMSampler.p_sample_ddim`` takes it (the mathematics
of ``one2345_tpu_torch/diffusion/ddim.py`` and of the CFG fold in
``diffusion/zero123.py``, written again):

    e       = e_uncond + s (e_cond - e_uncond)
    pred_x0 = (x_t - sqrt(1 - a_t) e) / sqrt(a_t)
    sigma   = eta sqrt((1 - a_prev) / (1 - a_t) (1 - a_t / a_prev))
    x_prev  = sqrt(a_prev) pred_x0 + sqrt(1 - a_prev - sigma^2) e + sigma z

with a_t and a_prev the 'linear' schedule's cumulative alphas at the step's
timestep and at the next one.  Computed in float64; under the control
(``precision.use("fp8")``) every operation's result is rounded to
bfloat16, the precision below the float32 the step runs in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import precision


def alphas_cumprod(timesteps: int, linear_start: float, linear_end: float) -> np.ndarray:
    """float64 cumulative alphas of the 'linear' (sqrt-linear squared)
    beta schedule."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_step(x, e_uncond, e_cond, z, t: int, t_next: int, cfg_scale: float, eta: float,
              ac: np.ndarray) -> torch.Tensor:
    """x_prev of one guided DDIM step from timestep ``t`` to ``t_next``."""
    r = precision.round_state
    x, e_uncond, e_cond, z = (v.to(torch.float64) for v in (x, e_uncond, e_cond, z))
    a_t, a_prev = float(ac[int(t)]), float(ac[int(t_next)])
    sigma = eta * math.sqrt((1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev))
    e = r(e_uncond + r(cfg_scale * r(e_cond - e_uncond)))
    pred_x0 = r(r(x - r(math.sqrt(1.0 - a_t) * e)) / math.sqrt(a_t))
    dir_xt = r(math.sqrt(max(1.0 - a_prev - sigma * sigma, 0.0)) * e)
    return r(r(r(math.sqrt(a_prev) * pred_x0) + dir_xt) + r(sigma * z))
