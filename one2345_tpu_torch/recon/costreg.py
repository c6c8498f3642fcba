"""Cost-volume regularization U-Net: dense conv3d with occupancy masks.

Counterpart of ``one2345_tpu/recon/costreg.py`` (reference: the torchsparse
SparseCostRegNet, tsparse/modules.py:259-304).  The masks reproduce the
sparse convs' semantics:
- submanifold conv (k3, s1): inactive inputs are zeroed before the conv and
  inactive outputs after it;
- strided conv (k3, s2): a coarse site is active iff any of its 2^3 fine
  sites is (``_mask_down``);
- transposed conv (k3, s2): zero insertion (``_upsample2x_zero``) followed
  by a k3 conv, as in the JAX module, so its weights map with no flip;
  output sites are the cached fine-level active set.

The volume is [X, Y, Z, C] and the mask [X, Y, Z, 1] at the module's
boundary; inside, [1, C, X, Y, Z] in the channels_last_3d memory format
(the boundary's own memory order), which cuDNN's 3-D convs take directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from one2345_tpu_torch.nn.layers import MaskedBatchNorm, compute_dtype


def _mask_down(mask: torch.Tensor) -> torch.Tensor:
    """Max-pool k2 s2 of a [N, 1, X, Y, Z] occupancy."""
    return F.max_pool3d(mask, 2)


def _upsample2x_zero(x: torch.Tensor) -> torch.Tensor:
    """Insert zeros: out[..., 2i, 2j, 2k] = x[..., i, j, k] -> [N, C, 2X, 2Y, 2Z]."""
    N, C, X, Y, Z = x.shape
    out = torch.empty((N, C, 2 * X, 2 * Y, 2 * Z), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last_3d).zero_()
    out[:, :, ::2, ::2, ::2] = x
    return out


class _MConvBnRelu(nn.Module):
    """Masked conv3d (k3, no bias) + masked BN + ReLU; optional stride 2."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv3d(cin, features, 3, stride=stride, padding=1, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)

    def forward(self, x, mask_in, mask_out, train: bool = False):
        x = x * mask_in.to(x.dtype)
        x = self.Conv_0(x.to(compute_dtype(self.Conv_0)))
        return torch.relu(self.MaskedBatchNorm_0(x, mask_out, train))


class _MDeconvBnRelu(_MConvBnRelu):
    """Masked transposed conv3d (k3, s2) + masked BN + ReLU, as zero
    insertion followed by a k3 conv."""

    def forward(self, x, mask_in, mask_out, train: bool = False):
        x = _upsample2x_zero(x * mask_in.to(x.dtype))
        x = self.Conv_0(x.to(compute_dtype(self.Conv_0)))
        return torch.relu(self.MaskedBatchNorm_0(x, mask_out, train))


class CostRegNet(nn.Module):
    """Dense-masked SparseCostRegNet: encoder 16-16/32-32/64-64 with
    stride-2 downsamples, decoder with additive skips."""

    def __init__(self, d_in: int = 32, d_out: int = 16):
        super().__init__()
        enc = [(d_in, d_out, 1), (d_out, 16, 2), (16, 16, 1), (16, 32, 2), (32, 32, 1),
               (32, 64, 2), (64, 64, 1)]
        for i, (cin, cout, s) in enumerate(enc):
            setattr(self, f"_MConvBnRelu_{i}", _MConvBnRelu(cin, cout, s))
        for i, (cin, cout) in enumerate([(64, 32), (32, 16), (16, d_out)]):
            setattr(self, f"_MDeconvBnRelu_{i}", _MDeconvBnRelu(cin, cout))
        self.to(memory_format=torch.channels_last_3d)

    def forward(self, volume: torch.Tensor, mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """volume [X, Y, Z, C_in], mask [X, Y, Z, 1] -> [X, Y, Z, d_out],
        zero at inactive voxels; ``train`` normalises with the statistics of
        each level's active voxels."""
        x = volume.permute(3, 0, 1, 2)[None]
        m0 = mask.permute(3, 0, 1, 2)[None].to(torch.float32)
        m1 = _mask_down(m0)
        m2 = _mask_down(m1)
        m3 = _mask_down(m2)

        t = train
        conv0 = self._MConvBnRelu_0(x, m0, m0, t)
        conv1 = self._MConvBnRelu_1(conv0, m0, m1, t)
        conv2 = self._MConvBnRelu_2(conv1, m1, m1, t)
        conv3 = self._MConvBnRelu_3(conv2, m1, m2, t)
        conv4 = self._MConvBnRelu_4(conv3, m2, m2, t)
        conv5 = self._MConvBnRelu_5(conv4, m2, m3, t)
        conv6 = self._MConvBnRelu_6(conv5, m3, m3, t)

        x = conv4 + self._MDeconvBnRelu_0(conv6, m3, m2, t)
        x = conv2 + self._MDeconvBnRelu_1(x, m2, m1, t)
        x = conv0 + self._MDeconvBnRelu_2(x, m1, m0, t)
        return (x * m0.to(x.dtype))[0].permute(1, 2, 3, 0)
