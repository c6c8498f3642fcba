"""Frozen CLIP ViT-L/14 image tower -> 768-d conditioning token.

Counterpart of ``one2345_tpu/diffusion/clip.py`` with the same submodule and
parameter names: bicubic antialiased resize to 224 with renormalization from
[-1, 1] inputs to CLIP statistics, the ViT-L/14 visual encoder, and the
projected CLS token.  Its attention is plain PyTorch: the tower runs once
per sampler call, outside the denoising loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from one2345_tpu_torch.diffusion.unet import LayerNorm32

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_for_clip(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> [B, size, size, 3] CLIP-normalized, f32.

    Bicubic with antialias (Keys a=-0.5, the kernel of jax.image.resize
    'cubic'); without antialias a downscale would not match."""
    x = F.interpolate(
        images.float().permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
        antialias=True, align_corners=False,
    ).permute(0, 2, 3, 1)
    x = (x + 1.0) / 2.0
    mean = torch.as_tensor(CLIP_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        B, T, C = x.shape
        dh = C // self.heads
        q, k, v = (
            m(x).view(B, T, self.heads, dh).transpose(1, 2)
            for m in (self.q_proj, self.k_proj, self.v_proj)
        )
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
        o = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)  # [B, H, T, dh]
        return self.out_proj(o.transpose(1, 2).reshape(B, T, C))


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm32(width)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = LayerNorm32(width)
        self.fc = nn.Linear(width, width * 4)
        self.proj = nn.Linear(width * 4, width)

    def forward(self, x):
        dt = x.dtype
        x = x + self.attn(self.ln_1(x).to(dt))
        h = self.fc(self.ln_2(x).to(dt))
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + self.proj(h)


class CLIPVisionTower(nn.Module):
    def __init__(
        self,
        image_size: int = 224,
        patch_size: int = 14,
        width: int = 1024,
        layers: int = 24,
        heads: int = 16,
        embed_dim: int = 768,
    ):
        super().__init__()
        n = (image_size // patch_size) ** 2
        self.layers = layers
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(width) * 0.02)
        self.positional_embedding = nn.Parameter(torch.randn(n + 1, width) * 0.02)
        self.ln_pre = LayerNorm32(width)
        for i in range(layers):
            setattr(self, f"resblock_{i}", CLIPBlock(width, heads))
        self.ln_post = LayerNorm32(width)
        self.proj = nn.Parameter(torch.randn(width, embed_dim) * 0.02)

    def forward(self, images):
        """[B, size, size, 3] CLIP-normalized -> [B, embed_dim] f32."""
        dt = self.patch_embed.weight.dtype
        x = self.patch_embed(images.permute(0, 3, 1, 2).to(dt))
        x = x.flatten(2).transpose(1, 2)  # [B, n, width]
        B = x.shape[0]
        cls = self.class_embedding.to(dt).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x).to(dt)
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x)
        x = self.ln_post(x[:, 0])
        return (x.to(dt) @ self.proj.to(dt)).float()
