"""Shared building blocks of the reconstruction networks.

Counterpart of ``one2345_tpu/nn/layers.py`` with the same names.  Modules
work on PyTorch's channels-first layout ([N, C, H, W] or [N, C, X, Y, Z]);
the networks that use them convert at their own boundary.  Submodules are
named after the flax scopes (``Conv_0``, ``BatchNorm_0``) so that
``utils.convert_jax`` maps a JAX parameter tree onto them mechanically.

- ``ConvBnAct``: 2-D conv with symmetric ``k // 2`` padding, batch norm,
  LeakyReLU(0.01) — the reference's InPlaceABN (featurenet.py:11-37).
- ``MaskedBatchNorm``: the same normalisation times an occupancy mask, its
  training statistics over the active voxels only (torchsparse's
  BatchNorm: inactive voxels do not exist in the sparse tensor).

Batch norm has two modes, chosen per call by ``train`` as the flax modules
take it, not by ``nn.Module.train()``: running statistics, or the batch's
statistics with the running ones updated as flax updates them (momentum
0.9, the **biased** batch variance; ``torch.nn.BatchNorm*`` would use the
unbiased one).
- ``WNDense``: weight-normalised dense layer ``w = g * v / ||v||`` computed
  explicitly, with ``v`` stored [in, out] as in the JAX module.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01  # inplace_abn default activation slope


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


class BatchNorm(nn.Module):
    """Batch norm over dim 1 (eps 1e-5).  The statistics are at least f32
    (flax promotes them so); the affine map is applied in the input's
    dtype, as flax applies it in the module dtype.

    ``train=True`` normalises with the batch statistics, var = E[x^2] -
    E[x]^2 clipped at 0 (flax's ``use_fast_variance``), and updates the
    running statistics outside the autograd graph:
    ``ra = 0.9 * ra + (1 - 0.9) * batch``."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _update(self, mean, var):
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var + (1 - m) * var.detach())

    def _normalize(self, x, mean, var):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        mean = mean.to(x.dtype).view(shape)
        return (x - mean) * inv.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)

    def forward(self, x, train: bool = False):
        if not train:
            return self._normalize(x, self.running_mean, self.running_var)
        dims = (0,) + tuple(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=dims)
        var = ((xf * xf).mean(dim=dims) - mean * mean).clamp(min=0.0)
        self._update(mean, var)
        return self._normalize(x, mean, var)


class MaskedBatchNorm(BatchNorm):
    """``BatchNorm`` whose output is zero outside the mask ([N, 1, ...] of
    {0, 1}).  In training its statistics run over the active elements only
    (count clamped at 1; the variance in two passes, as the JAX module
    computes it)."""

    def forward(self, x, mask, train: bool = False):
        if not train:
            return self._normalize(x, self.running_mean, self.running_var) * mask.to(x.dtype)
        dims = (0,) + tuple(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        m = mask.to(xf.dtype)
        count = m.sum().clamp(min=1.0)
        mean = (xf * m).sum(dim=dims) / count
        centred = xf - mean.view((1, -1) + (1,) * (x.dim() - 2))
        var = (m * centred * centred).sum(dim=dims) / count
        self._update(mean, var)
        return self._normalize(x, mean, var) * mask.to(x.dtype)


class ConvBnAct(nn.Module):
    """Conv2d (no bias) + ``BatchNorm`` + LeakyReLU(0.01); the conv runs in
    its weight's dtype."""

    def __init__(self, cin: int, features: int, kernel_size: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1)):
        super().__init__()
        # explicit symmetric padding, as the JAX module pads (k//2, k//2)
        self.Conv_0 = nn.Conv2d(
            cin, features, tuple(kernel_size), stride=tuple(strides),
            padding=tuple(k // 2 for k in kernel_size), bias=False,
        )
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, train: bool = False):
        return leaky_relu(self.BatchNorm_0(self.Conv_0(x.to(self.Conv_0.weight.dtype)), train))


class WNDense(nn.Module):
    """Weight-normalised dense layer: ``x @ (v * g / ||v||_col) + bias``,
    the norm over the input axis (torch weight_norm's dim=0 on [out, in]).
    ``v`` is [in, out]; ``g`` starts at the column norms of ``v`` so the
    initial weight equals ``v``."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.v = nn.Parameter(torch.randn(in_dim, features) / in_dim**0.5)  # lecun normal
        self.g = nn.Parameter(torch.linalg.vector_norm(self.v.detach(), dim=0))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_norm(self):
        """Set ``g`` to the column norms of ``v`` (after ``v`` is redrawn)."""
        with torch.no_grad():
            self.g.copy_(torch.linalg.vector_norm(self.v, dim=0))

    def forward(self, x):
        w = self.v * (self.g / (torch.linalg.vector_norm(self.v, dim=0) + 1e-12))
        return x.to(w.dtype) @ w + self.bias


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF-style (x, sin 2^k x, cos 2^k x) embedding, input included:
    out_dim = in * (2 * n_freqs + 1), per-frequency [sin, cos] ordering."""
    out = [x]
    for k in range(n_freqs):
        f = 2.0**k
        out.append(torch.sin(f * x))
        out.append(torch.cos(f * x))
    return torch.cat(out, dim=-1)


def resize_bilinear_align_corners(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True of [N, C, H, W] maps."""
    return F.interpolate(img, size=tuple(out_hw), mode="bilinear", align_corners=True)
