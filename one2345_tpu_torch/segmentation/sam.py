"""Segment Anything (ViT-H): box-prompted foreground segmentation.

Counterpart of ``one2345_tpu/segmentation/sam.py`` (reference: the
``segment-anything`` package as utils/sam_utils.py:9-37 uses it: the ViT-H
image encoder at 1024^2, a box prompt, multimask output, alpha = the third
mask), with the same module and parameter names, so that
``utils.convert_jax.sam_from_jax`` maps the JAX parameters mechanically.

Numerics kept from the JAX modules:
- attention as ``jax.nn.dot_product_attention`` computes it: f32 logits
  (bf16 q and k multiply exactly into f32), the decomposed relative-position
  bias computed and summed in the compute dtype
  (``bias_h[..., :, None] + bias_w[..., None, :]``, reshaped
  [B, n, H, W, Hk, Wk] -> [B, n, HW, HW]) and added in f32, an f32 softmax,
  the probabilities cast to the value dtype for P.V.  Plain matmul +
  softmax, as the port's VAE and CLIP compute attention: K1 takes no bias;
- windowed blocks pad the token grid with zeros after ``norm1`` (64 -> 70
  at full size, 25 windows of 14^2); the padded tokens take part in the
  attention, unmasked;
- ``norm1``, ``norm2`` and ``LayerNorm2d`` use eps 1e-6 (flax's default);
  ``LayerNorm2d`` takes the mean in the input dtype, the variance in f32;
  the mask decoder's norms use 1e-5; GELU is exact; the neck convs have
  no bias;
- ``upscale_conv1/2`` are flax ``ConvTranspose`` layers, which apply their
  kernel without flipping it: as ``nn.ConvTranspose2d`` the weight is the
  flax kernel [kh, kw, I, O] moved to [I, O, kh, kw] with both spatial axes
  reversed (``convert_jax.sam_from_jax``).

``SamStage`` keeps the JAX stage's interface: ``set_image`` (memoised by
the sha1 of the image), ``predict_box``, ``seed_bbox``, ``segment_bbox``.
The image is resized as ``cv2.resize`` INTER_LINEAR resizes uint8 and the
mask logits as it resizes float32 (``utils.resample``), on the stage's
device.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from one2345_tpu_torch.core.config import SamConfig
from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.diffusion.unet import LayerNorm32
from one2345_tpu_torch.utils.image import bbox_from_mask
from one2345_tpu_torch.utils.resample import cv2_resize_linear

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def rel_pos_bias(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """[q, k, head_dim] decomposed relative-position embeddings (SAM
    get_rel_pos at the trained size: no interpolation)."""
    dev = rel_pos.device
    coords = (torch.arange(q_size, device=dev)[:, None]
              - torch.arange(k_size, device=dev)[None, :] + (k_size - 1))
    return rel_pos[coords]


def attention(q, k, v, bias=None, scale: float | None = None):
    """softmax(q k^T * scale + bias) v as ``jax.nn.dot_product_attention``
    computes it: q, k, v [B, T, n, d]; f32 logits and softmax, the
    probabilities in v's dtype.  Returns [B, T, n, d] in v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, n, T, d]
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits.add_(bias)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p, vt).transpose(1, 2)


class SamAttention(nn.Module):
    def __init__(self, dim: int, heads: int, input_size: int):
        super().__init__()
        self.heads = heads
        dh = dim // heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, dh))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, dh))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        """x: [B, H, W, C] token grid (possibly window batches)."""
        B, H, W, C = x.shape
        n, dh = self.heads, C // self.heads
        q, k, v = self.qkv(x).reshape(B, H * W, 3, n, dh).unbind(2)
        dt = q.dtype
        Rh = rel_pos_bias(self.rel_pos_h, H, H).to(dt)  # [H, H, dh]
        Rw = rel_pos_bias(self.rel_pos_w, W, W).to(dt)  # [W, W, dh]
        qg = q.reshape(B, H, W, n, dh)
        bias_h = torch.einsum("bhwnd,hkd->bnhwk", qg, Rh)  # [B, n, H, W, Hk]
        bias_w = torch.einsum("bhwnd,wkd->bnhwk", qg, Rw)  # [B, n, H, W, Wk]
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(B, n, H * W, H * W)
        o = attention(q, k, v, bias=bias, scale=1.0 / math.sqrt(dh))
        return self.proj(o.reshape(B, H, W, C))


class SamBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, grid: int):
        super().__init__()
        self.window = window  # 0 = global
        self.norm1 = LayerNorm32(dim, eps=1e-6)
        self.attn = SamAttention(dim, heads, window if window > 0 else grid)
        self.norm2 = LayerNorm32(dim, eps=1e-6)
        self.mlp_lin1 = nn.Linear(dim, dim * 4)
        self.mlp_lin2 = nn.Linear(dim * 4, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        dt = x.dtype
        h = self.norm1(x).to(dt)
        if self.window > 0:
            w = self.window
            pad = (w - H % w) % w
            hp = F.pad(h, (0, 0, 0, pad, 0, pad))
            Hp = H + pad
            nw = Hp // w
            hp = hp.reshape(B, nw, w, nw, w, C).transpose(2, 3).reshape(B * nw * nw, w, w, C)
            hp = self.attn(hp)
            hp = hp.reshape(B, nw, nw, w, w, C).transpose(2, 3)
            h = hp.reshape(B, Hp, Hp, C)[:, :H, :W]
        else:
            h = self.attn(h)
        x = x + h
        h = self.norm2(x).to(dt)
        h = self.mlp_lin2(F.gelu(self.mlp_lin1(h)))
        return x + h


class LayerNorm2d(nn.Module):
    """Channel-wise LayerNorm over the last axis of [B, H, W, C] (SAM's
    LayerNorm2d): the mean in the input dtype, the variance in f32, eps
    1e-6; the f32 affine promotes the result to f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.float().mean(dim=-1, keepdim=True).to(x.dtype)
        var = x.float().var(dim=-1, keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + 1e-6).to(x.dtype)
        return y * self.weight + self.bias


def _nchw(conv, x):
    """A Conv2d / ConvTranspose2d applied to [B, H, W, C] -> [B, H', W', C']
    in the conv's dtype."""
    return conv(x.permute(0, 3, 1, 2).to(conv.weight.dtype)).permute(0, 2, 3, 1)


class SamImageEncoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        c = cfg
        self.depth = c.encoder_depth
        grid = c.image_size // c.patch_size
        self.patch_embed = nn.Conv2d(3, c.encoder_dim, c.patch_size, stride=c.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, c.encoder_dim))
        for i in range(c.encoder_depth):
            win = 0 if i in c.global_attn_indexes else c.window_size
            setattr(self, f"block_{i}", SamBlock(c.encoder_dim, c.encoder_heads, win, grid))
        self.neck_conv1 = nn.Conv2d(c.encoder_dim, c.prompt_embed_dim, 1, bias=False)
        self.neck_ln1 = LayerNorm2d(c.prompt_embed_dim)
        self.neck_conv2 = nn.Conv2d(c.prompt_embed_dim, c.prompt_embed_dim, 3, padding=1,
                                    bias=False)
        self.neck_ln2 = LayerNorm2d(c.prompt_embed_dim)

    def forward(self, x):
        """[B, 1024, 1024, 3] normalised -> [B, 64, 64, 256] f32 embedding."""
        h = _nchw(self.patch_embed, x)
        h = h + self.pos_embed.to(h.dtype)
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            # profiler ranges: the global blocks' share of an encode
            with torch.profiler.record_function(
                    "sam_block_window" if block.window else "sam_block_global"):
                h = block(h)
        h = self.neck_ln1(_nchw(self.neck_conv1, h))
        h = self.neck_ln2(_nchw(self.neck_conv2, h))
        return h.float()


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, layers: int):
        super().__init__()
        self.layers = layers
        sizes = [dim] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            setattr(self, f"lin{i}", nn.Linear(sizes[i], sizes[i + 1]))

    def forward(self, x):
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"lin{i}")(x))
        return getattr(self, f"lin{self.layers - 1}")(x)


class TwoWayAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        self.heads = heads
        inner = dim // downsample
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        qh = self.q_proj(q).reshape(B, Tq, self.heads, -1)
        kh = self.k_proj(k).reshape(B, Tk, self.heads, -1)
        vh = self.v_proj(v).reshape(B, Tk, self.heads, -1)
        return self.out_proj(attention(qh, kh, vh).reshape(B, Tq, -1))


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, heads: int, skip_first_pe: bool = False):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = TwoWayAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn_t2i = TwoWayAttention(dim, heads, 2)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_lin1 = nn.Linear(dim, 2048)
        self.mlp_lin2 = nn.Linear(2048, dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn_i2t = TwoWayAttention(dim, heads, 2)
        self.norm4 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            q = self.self_attn(queries, queries, queries)
        else:
            qq = queries + query_pe
            q = self.self_attn(qq, qq, queries)
        queries = self.norm1(queries + q)
        qq = queries + query_pe
        kk = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_t2i(qq, kk, keys))
        queries = self.norm3(queries + self.mlp_lin2(F.relu(self.mlp_lin1(queries))))
        qq = queries + query_pe
        keys = self.norm4(keys + self.cross_attn_i2t(kk, qq, queries))
        return queries, keys


class SamMaskDecoder(nn.Module):
    """TwoWayTransformer (depth 2) + upscaling + hypernetwork mask heads."""

    def __init__(self, dim: int = 256, heads: int = 8, num_mask_tokens: int = 4):
        super().__init__()
        self.dim, self.num_mask_tokens = dim, num_mask_tokens
        self.iou_token = nn.Parameter(torch.randn(1, dim))
        self.mask_tokens = nn.Parameter(torch.randn(num_mask_tokens, dim))
        self.layer0 = TwoWayBlock(dim, heads, True)
        self.layer1 = TwoWayBlock(dim, heads, False)
        self.final_attn = TwoWayAttention(dim, heads, 2)
        self.norm_final = nn.LayerNorm(dim, eps=1e-5)
        self.upscale_conv1 = nn.ConvTranspose2d(dim, dim // 4, 2, stride=2)
        self.upscale_ln = LayerNorm2d(dim // 4)
        self.upscale_conv2 = nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2)
        for i in range(num_mask_tokens):
            setattr(self, f"hyper_{i}", MLP(dim, dim, dim // 8, 3))
        self.iou_head = MLP(dim, dim, num_mask_tokens, 3)

    def forward(self, image_embed, image_pe, sparse_prompt):
        """image_embed, image_pe [B, g, g, C]; sparse_prompt [B, P, C] ->
        (masks [B, M, 4g, 4g], iou [B, M])."""
        B = image_embed.shape[0]
        tokens = torch.cat([self.iou_token, self.mask_tokens])[None].expand(B, -1, -1)
        tokens = torch.cat([tokens, sparse_prompt], dim=1)
        src = image_embed.reshape(B, -1, self.dim)
        pe = image_pe.reshape(B, -1, self.dim)
        q, k = self.layer0(tokens, src, tokens, pe)
        q, k = self.layer1(q, k, tokens, pe)
        a = self.final_attn(q + tokens, k + pe, k)
        q = self.norm_final(q + a)
        iou_out = q[:, 0]
        mask_out = q[:, 1: 1 + self.num_mask_tokens]
        grid = int(round(k.shape[1] ** 0.5))
        h = _nchw(self.upscale_conv1, k.reshape(B, grid, grid, self.dim))
        h = F.gelu(self.upscale_ln(h))
        h = F.gelu(_nchw(self.upscale_conv2, h))  # [B, 4g, 4g, C / 8]
        hyper = torch.stack([getattr(self, f"hyper_{i}")(mask_out[:, i])
                             for i in range(self.num_mask_tokens)], dim=1)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper, h)
        return masks, self.iou_head(iou_out)


def position_encoding_grid(pe_gaussian: torch.Tensor, size: int) -> torch.Tensor:
    """[size, size, C] random-Fourier position encoding grid
    (SAM PositionEmbeddingRandom.forward)."""
    coords = (torch.arange(size, dtype=torch.float32, device=pe_gaussian.device) + 0.5) / size
    gy, gx = torch.meshgrid(coords, coords, indexing="ij")
    xy = torch.stack([gx, gy], dim=-1) * 2.0 - 1.0
    proj = 2 * math.pi * (xy @ pe_gaussian)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def encode_point(pe_gaussian: torch.Tensor, pts: torch.Tensor, size: float) -> torch.Tensor:
    """Points [..., 2] in pixel coordinates -> [..., C] Fourier features."""
    xy = (pts + 0.5) / size * 2.0 - 1.0
    proj = 2 * math.pi * (xy @ pe_gaussian)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class SamPrompt(nn.Module):
    """The prompt encoder's free leaves (the JAX stage's 'extra')."""

    def __init__(self, dim: int):
        super().__init__()
        self.pe_gaussian = nn.Parameter(torch.randn(2, dim // 2))
        # box corner embeddings (point_embeddings[2], [3] in SAM)
        self.box_embed = nn.Parameter(torch.randn(2, dim) * 0.02)


class SamModules(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.encoder = SamImageEncoder(cfg)
        self.decoder = SamMaskDecoder(dim=cfg.prompt_embed_dim)
        self.extra = SamPrompt(cfg.prompt_embed_dim)


class SamStage:
    """set_image + box prompts, as SamPredictor is used in
    utils/sam_utils.py:19-37 (mask = the third multimask output).

    :param params: a state dict of ``SamModules`` (``utils.convert_jax.
        sam_from_jax`` makes one from the JAX ``SamStage.params``), loaded
        with ``strict=True``; None -> modules initialised from ``seed``
        (the relative-position tables and the position embedding drawn
        N(0, 0.02^2), so that a seeded stage exercises them)
    :param device: None -> 'cuda' (raises without CUDA)
    """

    def __init__(self, config: SamConfig | None = None, params=None, seed: int = 0,
                 device=None):
        self.config = cfg = config or SamConfig()
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda), self.device:
            torch.manual_seed(seed)
            self.modules = SamModules(cfg)
            for name, p in self.modules.encoder.named_parameters():
                if "rel_pos" in name or name == "pos_embed":
                    nn.init.normal_(p, std=0.02)
        if params is not None:
            self.modules.load_state_dict(params, strict=True)
        self.modules.requires_grad_(False).eval()
        # the encoder's convs and dense layers in the stage dtype; norms,
        # tables and the mask decoder stay f32 (the JAX decoder is f32)
        for m in self.modules.encoder.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(self.dtype)
        self._memo = None

    @property
    def encoder(self):
        return self.modules.encoder

    @property
    def decoder(self):
        return self.modules.decoder

    # --- SamPredictor-style cached interface (set_image once, many prompts)
    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> dict:
        """Encode a [H, W, 3] uint8 image once; returns the cache prompts
        are decoded against.  The last encoding is memoised by content, so
        init_bbox -> preprocess on the same thumbnail encodes once.

        On the card the memo carries an event recorded after the encode on
        the encoding thread's stream; a thread that takes the memo makes its
        own current stream wait for that event (and marks the embedding as
        used there), so a request on another stream never reads an
        embedding that is still being written."""
        image = np.ascontiguousarray(image)
        key = (hashlib.sha1(image).hexdigest(), image.shape)
        memo = self._memo  # one read: another thread may store its own image meanwhile
        if memo is not None and memo[0] == key:
            _, cache, ready = memo
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                cache["embedding"].record_stream(stream)
            return cache
        H, W = image.shape[:2]
        size = self.config.image_size
        scale = size / max(H, W)
        nh, nw = int(H * scale + 0.5), int(W * scale + 0.5)
        padded = torch.zeros((size, size, 3), dtype=torch.uint8, device=self.device)
        padded[:nh, :nw] = cv2_resize_linear(image, (nw, nh), device=self.device)
        emb = self._encode(padded, nh, nw)
        cache = {"embedding": emb, "scale": scale, "hw": (H, W), "nhw": (nh, nw)}
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._memo = (key, cache, ready)
        return cache

    @torch.inference_mode()
    def _encode(self, image_u8: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
        size = self.config.image_size
        dev = self.device
        x = (image_u8.float() - torch.as_tensor(SAM_PIXEL_MEAN, device=dev)) / torch.as_tensor(
            SAM_PIXEL_STD, device=dev)
        # SAM pads with zeros after normalising: mask the pad region
        rows = torch.arange(size, device=dev)[:, None, None]
        cols = torch.arange(size, device=dev)[None, :, None]
        x = x * ((rows < nh) & (cols < nw))
        return self.encoder(x[None])

    @torch.inference_mode()
    def _decode(self, embedding: torch.Tensor, box: torch.Tensor):
        c = self.config
        extra = self.modules.extra
        grid = c.image_size // c.patch_size
        image_pe = position_encoding_grid(extra.pe_gaussian, grid)[None]
        sparse = encode_point(extra.pe_gaussian, box.reshape(2, 2), float(c.image_size))
        sparse = sparse + extra.box_embed
        return self.decoder(embedding, image_pe, sparse[None])

    def seed_bbox(self, cache: dict, margin: float = 0.05):
        """Bbox of the dominant object, predicted by SAM from a near-full-
        frame box prompt (the rembg/u2net replacement, utils/utils.py:10-19).

        :return: (x0, y0, x1, y1), or None when the mask is degenerate
            (below 1e-3 or above 0.9 of the frame) and the caller should
            fall back to ``utils.image.estimate_bbox``
        """
        H, W = cache["hw"]
        box = (margin * W, margin * H, (1.0 - margin) * W, (1.0 - margin) * H)
        mask = self.predict_box(cache, box)
        frac = float(mask.mean())
        if frac < 1e-3 or frac > 0.9:
            return None
        return bbox_from_mask(mask)

    def predict_box(self, cache: dict, bbox) -> np.ndarray:
        """[H, W] bool mask from a box prompt against a cached encoding: the
        last mask's f32 logits resized to the 1024 frame, cropped to the
        image, resized to (W, H) (INTER_LINEAR, no antialias), > 0."""
        H, W = cache["hw"]
        nh, nw = cache["nhw"]
        size = self.config.image_size
        box = torch.as_tensor(np.asarray(bbox, np.float32) * cache["scale"], device=self.device)
        masks, _ = self._decode(cache["embedding"], box)
        m = cv2_resize_linear(masks[0, -1].float(), (size, size), device=self.device)[:nh, :nw]
        return (cv2_resize_linear(m, (W, H), device=self.device) > 0.0).cpu().numpy()

    def segment_bbox(self, image: np.ndarray, bbox) -> np.ndarray:
        """[H, W, 3] uint8 image, (x0, y0, x1, y1) box -> [H, W] bool mask."""
        return self.predict_box(self.set_image(image), bbox)
