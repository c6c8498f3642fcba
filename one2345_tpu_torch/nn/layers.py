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

A conv or linear computes in ``compute_dtype(m)``: its weight's dtype (an
inference stage casts the weights once), or the dtype ``set_compute_dtype``
gave it, over weights that stay f32 and are cast at use, as flax's
``dtype=bfloat16`` with ``param_dtype`` f32 (bf16 training: the gradients
reach the f32 weights through the cast).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01  # inplace_abn default activation slope


def compute_dtype(m: nn.Module) -> torch.dtype:
    """The dtype the conv or linear ``m`` computes in."""
    return getattr(m, "compute_dtype", None) or m.weight.dtype


def _cast_forward(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    dt = m.compute_dtype
    w = m.weight.to(dt)
    b = None if m.bias is None else m.bias.to(dt)
    if isinstance(m, nn.Linear):
        return F.linear(x.to(dt), w, b)
    return m._conv_forward(x.to(dt), w, b)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run every conv and linear of ``module`` in ``dtype`` over its own
    weights, cast at each use (they keep their dtype and take the
    gradients); the norms are left as they are."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            m.compute_dtype = dtype
            m.forward = functools.partial(_cast_forward, m)
    return module


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


class BatchNorm(nn.Module):
    """Batch norm over dim 1 (eps 1e-5).  The statistics are at least f32
    (flax's ``force_float32_reductions``), and so is the affine map, whose
    result is rounded once to the input's dtype, as flax's ``_normalize``
    (a half-precision input comes out in half precision).

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
        inv = (torch.rsqrt(var + self.eps) * self.weight).view(shape)
        y = (x - mean.view(shape)) * inv + self.bias.view(shape)
        return y.to(x.dtype)

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
    computes it).  Its affine map runs in the input's dtype, as the JAX
    module applies it."""

    def _normalize(self, x, mean, var):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        mean = mean.to(x.dtype).view(shape)
        return (x - mean) * inv.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)

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
    its compute dtype."""

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
        return leaky_relu(self.BatchNorm_0(self.Conv_0(x.to(compute_dtype(self.Conv_0))), train))


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
    """Bilinear resize with align_corners=True of [N, C, H, W] maps, in at
    least f32: the JAX function's f32 interpolation weights promote a
    half-precision map."""
    img = img.to(torch.promote_types(img.dtype, torch.float32))
    return F.interpolate(img, size=tuple(out_hw), mode="bilinear", align_corners=True)
