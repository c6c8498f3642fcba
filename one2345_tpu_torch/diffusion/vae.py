"""SD AutoencoderKL (first-stage VAE): ``Encoder``, ``Decoder``, and the
posterior's ``moments_mode`` and ``moments_sample``.

Counterpart of ``one2345_tpu/diffusion/vae.py`` with the same submodule
names.  Public layouts are NHWC (images [B, 256, 256, 3], latents
[B, 32, 32, 4]); NCHW inside.  GroupNorm eps is 1e-6 here (1e-5 in the
UNet).  The bottleneck attention is single-head plain PyTorch: it runs once
per sampler call, outside the denoising loop.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from one2345_tpu_torch.diffusion.unet import GroupNorm32


def _norm(channels: int) -> GroupNorm32:
    return GroupNorm32(channels, eps=1e-6)


class VAEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full attention over the bottleneck's pixels."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (m(h).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(C)
        o = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)  # [B, HW, C]
        return x + self.proj_out(o.transpose(1, 2).reshape(B, C, H, W))


class Encoder(nn.Module):
    def __init__(
        self,
        base_channels: int = 128,
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_res_blocks: int = 2,
        z_channels: int = 4,
        in_channels: int = 3,
    ):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, base_channels, 3, padding=1)
        self._plan = []
        ch = base_channels
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                name = f"down_{level}_block_{i}"
                setattr(self, name, VAEResBlock(ch, base_channels * mult))
                ch = base_channels * mult
                self._plan.append((name, False))
            if level != len(channel_mult) - 1:
                name = f"down_{level}_downsample"
                setattr(self, name, nn.Conv2d(ch, ch, 3, stride=2))
                self._plan.append((name, True))
        self.mid_block_1 = VAEResBlock(ch, ch)
        self.mid_attn = AttnBlock(ch)
        self.mid_block_2 = VAEResBlock(ch, ch)
        self.norm_out = _norm(ch)
        self.conv_out = nn.Conv2d(ch, 2 * z_channels, 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * z_channels, 1)

    def forward(self, x):
        """[B, H, W, 3] in [-1, 1] -> moments [B, H/8, W/8, 2*z] f32."""
        h = self.conv_in(x.permute(0, 3, 1, 2).to(self.conv_in.weight.dtype))
        for name, downsample in self._plan:
            if downsample:
                h = F.pad(h, (0, 1, 0, 1))  # SD's asymmetric (0, 1) padding
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        h = self.conv_out(F.silu(self.norm_out(h)))
        h = self.quant_conv(h)
        return h.float().permute(0, 2, 3, 1)


class Decoder(nn.Module):
    def __init__(
        self,
        base_channels: int = 128,
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_res_blocks: int = 2,
        out_channels: int = 3,
        z_channels: int = 4,
    ):
        super().__init__()
        ch = base_channels * channel_mult[-1]
        self.post_quant_conv = nn.Conv2d(z_channels, z_channels, 1)
        self.conv_in = nn.Conv2d(z_channels, ch, 3, padding=1)
        self.mid_block_1 = VAEResBlock(ch, ch)
        self.mid_attn = AttnBlock(ch)
        self.mid_block_2 = VAEResBlock(ch, ch)
        self._plan = []
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                name = f"up_{level}_block_{i}"
                setattr(self, name, VAEResBlock(ch, base_channels * mult))
                ch = base_channels * mult
                self._plan.append((name, False))
            if level != 0:
                name = f"up_{level}_conv"
                setattr(self, name, nn.Conv2d(ch, ch, 3, padding=1))
                self._plan.append((name, True))
        self.norm_out = _norm(ch)
        self.conv_out = nn.Conv2d(ch, out_channels, 3, padding=1)

    def forward(self, z):
        """[B, h, w, z] latent -> [B, 8h, 8w, 3] f32 in about [-1, 1]."""
        h = self.post_quant_conv(z.permute(0, 3, 1, 2).to(self.conv_in.weight.dtype))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(self.conv_in(h))))
        for name, upsample in self._plan:
            if upsample:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = getattr(self, name)(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.float().permute(0, 2, 3, 1)


def moments_mode(moments: torch.Tensor) -> torch.Tensor:
    """DiagonalGaussianDistribution.mode() = mean (first half of moments)."""
    return moments.chunk(2, dim=-1)[0]


def moments_sample(moments: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample() with the standard normal draw
    ``noise`` (shape of the mean) given by the caller; logvar clipped to
    [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    return mean + torch.exp(0.5 * logvar) * noise
