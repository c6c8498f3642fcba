"""flax's initialisers, for the modules of a stage built from a seed.

A JAX stage built from a seed draws every leaf from its flax initialiser;
torch's layers default to other distributions (kaiming-uniform kernels,
whose variance is about 1 / (3 fan_in), and uniform biases).  ``flax_init_``
redraws a module's leaves as flax draws them:

- ``nn.Linear`` / ``nn.Conv*`` kernels: ``lecun_normal`` (flax's ``Dense``
  and ``Conv`` default), a normal truncated at +-2 sigma and rescaled so that
  the variance is 1 / fan_in, fan_in = in_channels / groups x kernel volume;
  ``he_normal`` (variance 2 / fan_in) for the modules of ``he_normal``;
- biases zero, norm scales one (flax's defaults);
- ``WNDense``: its direction ``v`` [in, out] ``lecun_normal`` over ``in``,
  ``g`` the column norms of ``v``, the bias zero (``nn/layers.py::WNDense``);
- a module flagged ``zero_init`` (the UNet's output convs) all zero.

Other leaves (CLIP's ``normal(0.02)`` embeddings, the identity
CCProjection, the SDF MLP's geometric init, scalar parameters) keep the
values their modules give them; a module of a ``skip`` type is left whole.
Every draw comes from ``generator``, in module order.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from one2345_tpu_torch.nn.layers import WNDense

# standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's correction)
TRUNCATED_STD = 0.87962566103423978
_NORMS = (nn.GroupNorm, nn.LayerNorm)


def truncated_normal_(t: torch.Tensor, variance: float, generator: torch.Generator):
    """Fill ``t`` with a normal truncated at +-2 sigma whose variance is
    ``variance`` (inverse-CDF sampling, as ``jax.random.truncated_normal``)."""
    std = math.sqrt(variance) / TRUNCATED_STD
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        t.uniform_(2.0 * lo - 1.0, 1.0 - 2.0 * lo, generator=generator)
        t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    return t


def flax_init_(module: nn.Module, generator: torch.Generator, he_normal: tuple = (),
               skip: tuple = ()) -> nn.Module:
    """Redraw ``module``'s kernels, biases and norm affines in place as
    flax initialises them (see the module docstring).

    :param he_normal: module types whose linears take ``he_normal``
    :param skip: module types left as they are
    """
    def walk(m: nn.Module, he: bool):
        if isinstance(m, skip):
            return
        he = he or isinstance(m, he_normal)
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            w = m.weight
            if getattr(m, "zero_init", False):
                with torch.no_grad():
                    w.zero_()
            else:
                truncated_normal_(w, (2.0 if he else 1.0) / w[0].numel(), generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, WNDense):
            truncated_normal_(m.v, 1.0 / m.v.shape[0], generator)
            m.reset_norm()
            with torch.no_grad():
                m.bias.zero_()
        elif isinstance(m, _NORMS) and m.weight is not None:
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
        for child in m.children():
            walk(child, he)

    walk(module, False)
    return module
