"""Shared building blocks of the reconstruction networks.

Counterpart of ``one2345_tpu/nn/layers.py`` with the same names.  Modules
work on PyTorch's channels-first layout ([N, C, H, W] or [N, C, X, Y, Z]);
the networks that use them convert at their own boundary.  Submodules are
named after the flax scopes (``Conv_0``, ``BatchNorm_0``) so that
``utils.convert_jax`` maps a JAX parameter tree onto them mechanically.

- ``ConvBnAct``: 2-D conv with symmetric ``k // 2`` padding, batch norm from its running statistics, LeakyReLU(0.01) — the
  reference's InPlaceABN (featurenet.py:11-37) at inference.
- ``MaskedBatchNorm``: the same normalisation times an occupancy mask
  (torchsparse's BatchNorm over active voxels, at inference).
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
    """Batch norm over dim 1 from running statistics (eps 1e-5).  The
    statistics stay f32; the affine map is applied in the input's dtype,
    as flax applies it in the module dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        mean = self.running_mean.to(x.dtype).view(shape)
        return (x - mean) * inv.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)


class MaskedBatchNorm(BatchNorm):
    """``BatchNorm`` whose output is zero outside the mask ([N, 1, ...] of
    {0, 1}): inactive voxels do not exist in the reference's sparse tensor.
    Statistics over active voxels only matter in training, which is not
    ported."""

    def forward(self, x, mask):
        return super().forward(x) * mask.to(x.dtype)


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

    def forward(self, x):
        return leaky_relu(self.BatchNorm_0(self.Conv_0(x.to(self.Conv_0.weight.dtype))))


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
