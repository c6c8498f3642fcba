"""Diffusion noise schedules + DDIM sampling parameters.

The numpy construction is the JAX package's ``diffusion/schedule.py``, bit
for bit: the 'linear' (sqrt-linear-squared) beta schedule, 'uniform' DDIM
timesteps with the +1 offset, the DDIM sigmas, and the training buffers.
Kept quirk: stride 1000//S over the full range, so S=75 yields 77 entries.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def make_beta_schedule(
    n_timestep: int = 1000, linear_start: float = 0.00085, linear_end: float = 0.0120
) -> np.ndarray:
    return (
        np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
        ** 2
    )


class DDIMSchedule(NamedTuple):
    """Per-step DDIM constants, ordered for *sampling* (t descending)."""

    timesteps: np.ndarray  # [S] int32, descending
    alphas: np.ndarray  # [S] a_t
    alphas_prev: np.ndarray  # [S] a_{t-1}
    sigmas: np.ndarray  # [S]
    sqrt_one_minus_alphas: np.ndarray  # [S]
    # True once trim_for_sample dropped the highest-noise entry
    trimmed: bool = False

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @property
    def arrays(self):
        """The five per-step array fields (excludes the trimmed flag)."""
        return self[:5]


def make_ddim_schedule(
    ddim_num_steps: int,
    num_ddpm_timesteps: int = 1000,
    eta: float = 1.0,
    linear_start: float = 0.00085,
    linear_end: float = 0.0120,
) -> DDIMSchedule:
    betas = make_beta_schedule(num_ddpm_timesteps, linear_start, linear_end)
    alphas_cumprod = np.cumprod(1.0 - betas)

    c = num_ddpm_timesteps // ddim_num_steps
    # +1 offset; clipped — when c divides the range exactly an unclipped +1
    # would index past the schedule
    ddim_timesteps = np.minimum(
        np.asarray(list(range(0, num_ddpm_timesteps, c))) + 1, num_ddpm_timesteps - 1
    )

    alphas = alphas_cumprod[ddim_timesteps]
    alphas_prev = np.asarray(
        [alphas_cumprod[0]] + alphas_cumprod[ddim_timesteps[:-1]].tolist()
    )
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
    )

    rev = slice(None, None, -1)
    return DDIMSchedule(
        timesteps=ddim_timesteps[rev].astype(np.int32),
        alphas=alphas[rev].astype(np.float32),
        alphas_prev=alphas_prev[rev].astype(np.float32),
        sigmas=sigmas[rev].astype(np.float32),
        sqrt_one_minus_alphas=np.sqrt(1.0 - alphas[rev]).astype(np.float32),
    )


def training_schedule(
    n_timestep: int = 1000, linear_start: float = 0.00085, linear_end: float = 0.0120
) -> dict:
    """Buffers used by q_sample / p_losses (ddpm.py:126-178), numpy f32."""
    betas = make_beta_schedule(n_timestep, linear_start, linear_end)
    alphas_cumprod = np.cumprod(1.0 - betas)
    return {
        "betas": betas.astype(np.float32),
        "alphas_cumprod": alphas_cumprod.astype(np.float32),
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod).astype(np.float32),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod).astype(
            np.float32
        ),
    }


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, [B] -> [B, dim] f32, cos before sin."""
    half = dim // 2
    freqs = torch.exp(
        -float(np.log(max_period))
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / half
    )
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
