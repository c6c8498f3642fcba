"""2-D pyramid feature extractor (FPN) of the cost volume.

Counterpart of ``one2345_tpu/recon/featurenet.py`` (reference:
reconstruction/models/featurenet.py:43-91 and the 3-scale fusion at
trainer_generic.py:1104-1125).  Submodules carry the flax scope names
(``ConvBnAct_0`` .. ``ConvBnAct_7``, ``toplayer``, ``lat1``, ``lat0``,
``smooth1``, ``smooth0``).  ``FeatureNet`` works on [B, C, H, W];
``PyramidFeatureFusion`` takes and returns channels-last maps, as the JAX
module does.  ``train`` selects the batch norms' batch statistics, as the
JAX ``__call__(..., train)``.
"""

from __future__ import annotations

import torch
from torch import nn

from one2345_tpu_torch.nn.layers import ConvBnAct, compute_dtype, resize_bilinear_align_corners


def _conv(m: nn.Conv2d, x):
    return m(x.to(compute_dtype(m)))


class FeatureNet(nn.Module):
    """3-level FPN: [B, 3, H, W] -> [feat2 (32ch, H/4), feat1 (16ch, H/2),
    feat0 (8ch, H)]."""

    def __init__(self):
        super().__init__()
        plan = [  # (cin, cout, kernel, stride) of ConvBnAct_0 .. ConvBnAct_7
            (3, 8, 3, 1), (8, 8, 3, 1),
            (8, 16, 5, 2), (16, 16, 3, 1), (16, 16, 3, 1),
            (16, 32, 5, 2), (32, 32, 3, 1), (32, 32, 3, 1),
        ]
        for i, (cin, cout, k, s) in enumerate(plan):
            setattr(self, f"ConvBnAct_{i}", ConvBnAct(cin, cout, (k, k), (s, s)))
        self.toplayer = nn.Conv2d(32, 32, 1)
        self.lat1 = nn.Conv2d(16, 32, 1)
        self.lat0 = nn.Conv2d(8, 32, 1)
        self.smooth1 = nn.Conv2d(32, 16, 3, padding=1)
        self.smooth0 = nn.Conv2d(32, 8, 3, padding=1)

    def forward(self, x, train: bool = False):
        conv0 = self.ConvBnAct_1(self.ConvBnAct_0(x, train), train)
        conv1 = self.ConvBnAct_4(self.ConvBnAct_3(self.ConvBnAct_2(conv0, train), train), train)
        conv2 = self.ConvBnAct_7(self.ConvBnAct_6(self.ConvBnAct_5(conv1, train), train), train)

        feat2 = _conv(self.toplayer, conv2)
        lat1 = _conv(self.lat1, conv1)
        lat0 = _conv(self.lat0, conv0)
        feat1 = resize_bilinear_align_corners(feat2, lat1.shape[2:]) + lat1
        feat0 = resize_bilinear_align_corners(feat1, lat0.shape[2:]) + lat0
        return [feat2, _conv(self.smooth1, feat1), _conv(self.smooth0, feat0)]


class PyramidFeatureFusion(nn.Module):
    """FeatureNet + full-resolution fusion to 56 channels
    (trainer_generic.py:1116-1123: [up4(feat2), up2(feat1), feat0])."""

    def __init__(self):
        super().__init__()
        self.fpn = FeatureNet()

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[V, H, W, 3] -> [V, H, W, 56], at least f32 (the upsampled levels
        interpolate in f32, as the JAX module's promote); ``train``
        normalises with batch statistics over the V views."""
        feats = self.fpn(images.permute(0, 3, 1, 2), train)
        H, W = images.shape[1], images.shape[2]
        f2 = resize_bilinear_align_corners(feats[0], (H, W))
        f1 = resize_bilinear_align_corners(feats[1], (H, W))
        return torch.cat([f2, f1, feats[2]], dim=1).permute(0, 2, 3, 1)
