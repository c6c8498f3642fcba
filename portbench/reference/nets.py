"""Plain reference of the diffusion stage's networks: the Zero123-XL UNet,
the VAE encoder and decoder, the CLIP ViT-L/14 image tower and the
CCProjection, in float32 with plain attention.

Frozen copies of ``one2345_tpu_torch/diffusion/{unet,vae,clip,zero123}.py``
with the same submodule and parameter names (so a state dict of the
program's modules loads here and ``weights.seeded_state_dict`` draws the
same tensors for both), minus everything that is not the mathematics:
no flash-attention kernel (softmax(q k^T / sqrt(d)) v in f32), no int8
layers, no compute-dtype casts, no remat.

Every conv and linear (and the attention's products) reads its operands
through ``precision.round_``, which is the identity unless a caller
selects the fp8 control (``precision.use("fp8")``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import precision


class Conv2d(nn.Conv2d):
    def forward(self, x):
        w = precision.round_(self.weight)
        return self._conv_forward(precision.round_(x), w, self.bias)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(precision.round_(x), precision.round_(self.weight), self.bias)


def attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v over [B, T, H, D], in f32."""
    D = q.shape[-1]
    q, k, v = (precision.round_(x).transpose(1, 2) for x in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    p = precision.round_(torch.softmax(s, dim=-1))
    return torch.matmul(p, v).transpose(1, 2)


class GroupNorm32(nn.GroupNorm):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(math.gcd(32, channels), channels, eps=eps)


def timestep_embedding(t, dim: int, max_period: int = 10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ------------------------------------------------------------------ UNet
class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm32(cin)
        self.in_conv = Conv2d(cin, cout, 3, padding=1)
        self.emb_proj = Linear(emb_dim, cout)
        self.out_norm = GroupNorm32(cout)
        self.out_conv = Conv2d(cout, cout, 3, padding=1)
        self.skip = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = Linear(inner, query_dim)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        B, T, _ = x.shape
        shape = (B, -1, self.heads, self.dim_head)
        q = self.to_q(x).view(shape)
        k = self.to_k(ctx).view(shape)
        v = self.to_v(ctx).view(shape)
        return self.to_out(attention(q, k, v).reshape(B, T, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, dim_out * 2)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g, approximate="tanh")


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        dh = dim // heads
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, dim, heads, dh)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads, dh)
        self.norm3 = nn.LayerNorm(dim)
        self.ff_geglu = GEGLU(dim, dim * 4)
        self.ff_out = Linear(dim * 4, dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, context_dim: int, heads: int, depth: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.proj_in = Conv2d(channels, channels, 1)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", BasicTransformerBlock(channels, context_dim, heads))
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h, context)
        return x + self.proj_out(h.transpose(1, 2).reshape(B, C, H, W))


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet(nn.Module):
    """SD-1.x UNet with Zero123's 8 input channels; NHWC in and out."""

    def __init__(self, in_channels=8, out_channels=4, model_channels=320, num_res_blocks=2,
                 attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4), num_heads=8,
                 transformer_depth=1, context_dim=768, **_):
        super().__init__()
        mc = model_channels
        emb_dim = mc * 4
        self.model_channels = mc
        self.time_embed_0 = Linear(mc, emb_dim)
        self.time_embed_2 = Linear(emb_dim, emb_dim)
        self.conv_in = Conv2d(in_channels, mc, 3, padding=1)

        def attn(ch):
            return SpatialTransformer(ch, context_dim, num_heads, transformer_depth)

        self._plan = []
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                setattr(self, f"in_{level}_{i}_res", ResBlock(ch, mc * mult, emb_dim))
                ch = mc * mult
                self._plan.append(("res", f"in_{level}_{i}_res"))
                if ds in attention_resolutions:
                    setattr(self, f"in_{level}_{i}_attn", attn(ch))
                    self._plan.append(("attn", f"in_{level}_{i}_attn"))
                self._plan.append(("push", None))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                setattr(self, f"down_{level}", Downsample(ch))
                self._plan += [("mod", f"down_{level}"), ("push", None)]
                chans.append(ch)
                ds *= 2
        self.mid_res1 = ResBlock(ch, ch, emb_dim)
        self.mid_attn = attn(ch)
        self.mid_res2 = ResBlock(ch, ch, emb_dim)
        self._plan += [("res", "mid_res1"), ("attn", "mid_attn"), ("res", "mid_res2")]
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                skip = chans.pop()
                setattr(self, f"out_{level}_{i}_res", ResBlock(ch + skip, mc * mult, emb_dim))
                ch = mc * mult
                self._plan += [("pop", None), ("res", f"out_{level}_{i}_res")]
                if ds in attention_resolutions:
                    setattr(self, f"out_{level}_{i}_attn", attn(ch))
                    self._plan.append(("attn", f"out_{level}_{i}_attn"))
            if level != 0:
                setattr(self, f"up_{level}", Upsample(ch))
                self._plan.append(("mod", f"up_{level}"))
                ds //= 2
        self.out_norm = GroupNorm32(mc)
        self.conv_out = Conv2d(mc, out_channels, 3, padding=1)

    def forward(self, x, timesteps, context):
        emb = self.time_embed_0(timestep_embedding(timesteps, self.model_channels))
        emb = self.time_embed_2(F.silu(emb))
        h = self.conv_in(x.permute(0, 3, 1, 2))
        hs = [h]
        for kind, name in self._plan:
            if kind == "res":
                h = getattr(self, name)(h, emb)
            elif kind == "attn":
                h = getattr(self, name)(h, context)
            elif kind == "mod":
                h = getattr(self, name)(h)
            elif kind == "push":
                hs.append(h)
            else:
                h = torch.cat([h, hs.pop()], dim=1)
        h = self.conv_out(F.silu(self.out_norm(h)))
        return h.permute(0, 2, 3, 1)


# ------------------------------------------------------------------- VAE
def _vae_norm(channels: int) -> GroupNorm32:
    return GroupNorm32(channels, eps=1e-6)


class VAEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _vae_norm(cin)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _vae_norm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.norm = _vae_norm(channels)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (m(h).flatten(2).transpose(1, 2)[:, :, None] for m in (self.q, self.k, self.v))
        o = attention(q, k, v)[:, :, 0]
        return x + self.proj_out(o.transpose(1, 2).reshape(B, C, H, W))


class Encoder(nn.Module):
    def __init__(self, base_channels=128, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                 z_channels=4, in_channels=3):
        super().__init__()
        self.conv_in = Conv2d(in_channels, base_channels, 3, padding=1)
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
                setattr(self, name, Conv2d(ch, ch, 3, stride=2))
                self._plan.append((name, True))
        self.mid_block_1 = VAEResBlock(ch, ch)
        self.mid_attn = AttnBlock(ch)
        self.mid_block_2 = VAEResBlock(ch, ch)
        self.norm_out = _vae_norm(ch)
        self.conv_out = Conv2d(ch, 2 * z_channels, 3, padding=1)
        self.quant_conv = Conv2d(2 * z_channels, 2 * z_channels, 1)

    def forward(self, x):
        """[B, H, W, 3] in [-1, 1] -> moments [B, H/8, W/8, 2 z]."""
        h = self.conv_in(x.permute(0, 3, 1, 2))
        for name, downsample in self._plan:
            if downsample:
                h = F.pad(h, (0, 1, 0, 1))
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        h = self.quant_conv(self.conv_out(F.silu(self.norm_out(h))))
        return h.permute(0, 2, 3, 1)


class Decoder(nn.Module):
    def __init__(self, base_channels=128, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                 out_channels=3, z_channels=4):
        super().__init__()
        ch = base_channels * channel_mult[-1]
        self.post_quant_conv = Conv2d(z_channels, z_channels, 1)
        self.conv_in = Conv2d(z_channels, ch, 3, padding=1)
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
                setattr(self, name, Conv2d(ch, ch, 3, padding=1))
                self._plan.append((name, True))
        self.norm_out = _vae_norm(ch)
        self.conv_out = Conv2d(ch, out_channels, 3, padding=1)

    def forward(self, z):
        """[B, h, w, z] latent -> [B, 8h, 8w, 3]."""
        h = self.post_quant_conv(z.permute(0, 3, 1, 2))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(self.conv_in(h))))
        for name, upsample in self._plan:
            if upsample:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = getattr(self, name)(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ CLIP
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_for_clip(images, size: int = 224):
    """[B, H, W, 3] in [-1, 1] -> [B, size, size, 3] CLIP-normalised
    (bicubic with antialias)."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                      antialias=True, align_corners=False).permute(0, 2, 3, 1)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(width, width)
        self.k_proj = Linear(width, width)
        self.v_proj = Linear(width, width)
        self.out_proj = Linear(width, width)

    def forward(self, x):
        B, T, C = x.shape
        shape = (B, T, self.heads, C // self.heads)
        q, k, v = (m(x).view(shape) for m in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attention(q, k, v).reshape(B, T, C))


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.fc = Linear(width, width * 4)
        self.proj = Linear(width * 4, width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        h = self.fc(self.ln_2(x))
        return x + self.proj(h * torch.sigmoid(1.702 * h))


class CLIPVisionTower(nn.Module):
    def __init__(self, image_size=224, patch_size=14, width=1024, layers=24, heads=16,
                 embed_dim=768, **_):
        super().__init__()
        n = (image_size // patch_size) ** 2
        self.layers = layers
        self.patch_embed = Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        for i in range(layers):
            setattr(self, f"resblock_{i}", CLIPBlock(width, heads))
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, images):
        """[B, size, size, 3] CLIP-normalised -> [B, embed_dim]."""
        x = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x)
        return precision.round_(self.ln_post(x[:, 0])) @ precision.round_(self.proj)


class CCProjection(nn.Module):
    """Linear(772 -> 768) as x @ kernel + bias."""

    def __init__(self, in_dim: int = 772, out_dim: int = 768):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return x @ self.kernel + self.bias


def build(kind: str, widths: dict, device="meta") -> nn.Module:
    """A reference module of the config's widths: 'unet', 'encoder',
    'decoder', 'clip' or 'cc_projection' (``widths``: the config's
    'diffusion' entry)."""
    vae = widths["vae"]
    vae_kw = dict(base_channels=vae["base_channels"], channel_mult=tuple(vae["channel_mult"]),
                  num_res_blocks=vae["num_res_blocks"], z_channels=vae["z_channels"])
    with torch.device(device):
        if kind == "unet":
            u = dict(widths["unet"])
            u["attention_resolutions"] = tuple(u["attention_resolutions"])
            u["channel_mult"] = tuple(u["channel_mult"])
            return UNet(**u)
        if kind == "encoder":
            return Encoder(in_channels=vae["in_channels"], **vae_kw)
        if kind == "decoder":
            return Decoder(out_channels=vae["out_channels"], **vae_kw)
        if kind == "clip":
            return CLIPVisionTower(**widths["clip"])
        if kind == "cc_projection":
            return CCProjection(widths["clip"]["embed_dim"] + 4, widths["unet"]["context_dim"])
    raise ValueError(f"unknown module {kind!r}")
