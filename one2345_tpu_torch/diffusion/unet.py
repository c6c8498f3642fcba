"""Zero123-XL denoiser UNet (Stable-Diffusion-1.x architecture, 8 in-ch).

Counterpart of ``one2345_tpu/diffusion/unet.py``: the same blocks under the
same names (``in_0_0_res.in_conv``, ``in_0_0_attn.block0.attn1.to_q``, ...),
so ``utils/convert_jax.py`` maps the flax parameter tree mechanically.

- The public ``UNetModel.forward`` keeps the JAX layout (NHWC latents);
  inside, activations are NCHW.
- Compute dtype is the dtype of the conv / linear weights (bf16 on the card,
  f32 for CPU parity; see ``cast_compute``).  Norms keep f32 parameters and
  compute in f32; the output is f32.
- Multi-token self-attention runs ``ops.flash_attention`` (the CUDA
  kernels on the card, forward and backward, which take bf16 only: an f32
  UNet runs on the CPU, or on the card under bf16 autocast); the one-token
  cross-attention is the exact broadcast of V.
- ``remat=True`` recomputes each ResBlock and SpatialTransformer in the
  backward pass (``torch.utils.checkpoint``), as ``UNetModel.remat`` of the
  JAX package does with ``nn.remat``: the same gradients for less
  activation memory.
- ``quant=True`` builds the W8A8 int8 UNet (``diffusion/quantize.py``): the
  layers the JAX package routes through ``q.conv`` / ``q.dense`` become
  ``QConv2d`` / ``QLinear`` unless ``SKIP_QUANT`` names them, which leaves
  the int8 convs of the ResBlocks, the transformers' 1x1 projections and
  the down / up convs.  Inference only; its state comes from
  ``quantize_unet_state``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from one2345_tpu_torch.diffusion import quantize as q
from one2345_tpu_torch.diffusion.schedule import timestep_embedding
from one2345_tpu_torch.ops.flash_attention import flash_attention


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with gcd(32, C) groups (so tiny configs stay valid),
    computed in f32, returned in the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(math.gcd(32, channels), channels, eps=eps)

    def forward(self, x):
        return F.group_norm(
            x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in f32 with an f32 result (eps 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        )


def cast_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the conv / linear weights of ``module`` to the compute dtype;
    norms and free parameters (CLIP embeddings, projections) stay f32, as
    the JAX modules keep f32 params and cast at use.  The int8 layers keep
    their weights and f32 scales and output the compute dtype."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
        elif isinstance(m, (q.QConv2d, q.QLinear)):
            m.dtype = dtype
    return module


class ResBlock(nn.Module):
    """norm -> silu -> conv, + time embedding, norm -> silu -> conv, skip."""

    def __init__(self, cin: int, cout: int, emb_dim: int, quant: bool = False):
        super().__init__()
        self.in_norm = GroupNorm32(cin)
        self.in_conv = q.conv(quant, "in_conv", cin, cout, 3, padding=1)
        self.emb_proj = q.dense(quant, "emb_proj", emb_dim, cout)
        self.out_norm = GroupNorm32(cout)
        self.out_conv = q.conv(quant, "out_conv", cout, cout, 3, padding=1)
        self.skip = q.conv(quant, "skip", cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention over tokens [B, T, C]; self-attention when
    ``context`` is None, cross-attention otherwise."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 quant: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = q.dense(quant, "to_q", query_dim, inner, bias=False)
        self.to_k = q.dense(quant, "to_k", context_dim, inner, bias=False)
        self.to_v = q.dense(quant, "to_v", context_dim, inner, bias=False)
        self.to_out = q.dense(quant, "to_out", inner, query_dim)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        B, T, _ = x.shape
        S = ctx.shape[1]
        v = self.to_v(ctx)
        if S == 1:
            # one context token: softmax over a single key is identically 1,
            # so every query's output is that token's V (exact); the output
            # projection is applied once and broadcast over the T queries
            return self.to_out(v).expand(B, T, -1)
        shape = (B, -1, self.heads, self.dim_head)
        q = self.to_q(x).view(shape)
        k = self.to_k(ctx).view(shape)
        o, _ = flash_attention(q, k, v.view(shape))
        return self.to_out(o.reshape(B, T, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int, quant: bool = False):
        super().__init__()
        self.proj = q.dense(quant, "proj", dim, dim_out * 2)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        # flax's nn.gelu is the tanh approximation
        return a * F.gelu(g, approximate="tanh")


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, context_dim: int, heads: int, quant: bool = False):
        super().__init__()
        dh = dim // heads
        self.norm1 = LayerNorm32(dim)
        self.attn1 = Attention(dim, dim, heads, dh, quant)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = Attention(dim, context_dim, heads, dh, quant)
        self.norm3 = LayerNorm32(dim)
        self.ff_geglu = GEGLU(dim, dim * 4, quant)
        self.ff_out = q.dense(quant, "ff_out", dim * 4, dim)

    def forward(self, x, context):
        dt = x.dtype
        x = x + self.attn1(self.norm1(x).to(dt))
        x = x + self.attn2(self.norm2(x).to(dt), context)
        h = self.ff_out(self.ff_geglu(self.norm3(x).to(dt)))
        return x + h


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj -> transformer blocks -> zero 1x1 proj, residual."""

    def __init__(self, channels: int, context_dim: int, heads: int, depth: int,
                 quant: bool = False):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.proj_in = q.conv(quant, "proj_in", channels, channels, 1)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", BasicTransformerBlock(channels, context_dim, heads, quant))
        self.proj_out = q.conv(quant, "proj_out", channels, channels, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)  # [B, HW, C]
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h, context)
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, channels: int, quant: bool = False):
        super().__init__()
        # symmetric (1, 1) padding, stride 2
        self.op = q.conv(quant, "op", channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, quant: bool = False):
        super().__init__()
        self.conv = q.conv(quant, "conv", channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNetModel(nn.Module):
    def __init__(
        self,
        in_channels: int = 8,
        out_channels: int = 4,
        model_channels: int = 320,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        transformer_depth: int = 1,
        context_dim: int = 768,
        remat: bool = False,
        quant: bool = False,
    ):
        super().__init__()
        mc = model_channels
        self.remat = remat
        emb_dim = mc * 4
        self.model_channels = mc
        self.time_embed_0 = q.dense(quant, "time_embed_0", mc, emb_dim)
        self.time_embed_2 = q.dense(quant, "time_embed_2", emb_dim, emb_dim)
        self.conv_in = q.conv(quant, "conv_in", in_channels, mc, 3, padding=1)

        def attn(ch):
            return SpatialTransformer(ch, context_dim, num_heads, transformer_depth, quant)

        # (kind, name) in execution order; kind in res/attn/down/up/push/pop
        self._plan = []
        chans = [mc]  # channels of the skip stack
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                setattr(self, f"in_{level}_{i}_res", ResBlock(ch, mc * mult, emb_dim, quant))
                ch = mc * mult
                self._plan.append(("res", f"in_{level}_{i}_res"))
                if ds in attention_resolutions:
                    setattr(self, f"in_{level}_{i}_attn", attn(ch))
                    self._plan.append(("attn", f"in_{level}_{i}_attn"))
                self._plan.append(("push", None))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                setattr(self, f"down_{level}", Downsample(ch, quant))
                self._plan += [("mod", f"down_{level}"), ("push", None)]
                chans.append(ch)
                ds *= 2
        self.mid_res1 = ResBlock(ch, ch, emb_dim, quant)
        self.mid_attn = attn(ch)
        self.mid_res2 = ResBlock(ch, ch, emb_dim, quant)
        self._plan += [("res", "mid_res1"), ("attn", "mid_attn"), ("res", "mid_res2")]
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                skip = chans.pop()
                setattr(self, f"out_{level}_{i}_res",
                        ResBlock(ch + skip, mc * mult, emb_dim, quant))
                ch = mc * mult
                self._plan += [("pop", None), ("res", f"out_{level}_{i}_res")]
                if ds in attention_resolutions:
                    setattr(self, f"out_{level}_{i}_attn", attn(ch))
                    self._plan.append(("attn", f"out_{level}_{i}_attn"))
            if level != 0:
                setattr(self, f"up_{level}", Upsample(ch, quant))
                self._plan.append(("mod", f"up_{level}"))
                ds //= 2
        self.out_norm = GroupNorm32(mc)
        self.conv_out = q.conv(quant, "conv_out", mc, out_channels, 3, padding=1)

        # zero-initialised outputs, as in the JAX module (int8 layers come
        # from a quantized f32 state)
        outs = [m.out_conv for m in self.modules() if isinstance(m, ResBlock)]
        outs += [m.proj_out for m in self.modules() if isinstance(m, SpatialTransformer)]
        for m in outs + [self.conv_out]:
            if isinstance(m, nn.Conv2d):
                nn.init.zeros_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x, timesteps, context):
        """
        :param x: [B, H, W, in_channels] noisy latent ++ concat conditioning
        :param timesteps: [B] int
        :param context: [B, T_ctx, context_dim] cross-attention tokens
        :return: [B, H, W, out_channels] predicted noise, f32
        """
        dt = self.conv_in.weight.dtype
        t_emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_0(t_emb.to(dt))
        emb = self.time_embed_2(F.silu(emb))
        context = context.to(dt)

        h = self.conv_in(x.permute(0, 3, 1, 2).to(dt))
        hs = [h]
        remat = self.remat and torch.is_grad_enabled()
        for kind, name in self._plan:
            if kind in ("res", "attn"):
                block = getattr(self, name)
                cond = emb if kind == "res" else context
                if remat:
                    h = checkpoint(block, h, cond, use_reentrant=False)
                else:
                    h = block(h, cond)
            elif kind == "mod":
                h = getattr(self, name)(h)
            elif kind == "push":
                hs.append(h)
            else:  # pop
                h = torch.cat([h, hs.pop()], dim=1)
        h = self.conv_out(F.silu(self.out_norm(h)))
        return h.float().permute(0, 2, 3, 1)
