"""LoFTR detector-free feature matcher (indoor_ds config), fixed-size slates.

Counterpart of ``one2345_tpu/elevation/loftr.py`` (reference: the vendored
LoFTR under elevation_estimate/loftr/): a ResNet-FPN 8_2 backbone, the sine
position encoding, 4 x (self, cross) linear-attention coarse transformer,
dual-softmax coarse matching with mutual nearest neighbours, and 5x5-window
fine refinement by the heatmap's expected coordinate.

As in the JAX package, matching returns a fixed ``max_matches`` slate with a
validity mask (the reference's variable-length boolean indexing becomes a
top-K over the row maxima), so every shape is static.  Modules work in
PyTorch's layout ([N, C, H, W] in the backbone, [B, L, C] tokens after it)
and are named after the flax scopes, so ``utils.convert_jax.loftr_from_jax``
maps the JAX variables onto them mechanically.

Dtypes follow the JAX modules' promotions: convs, batch norms and dense
layers compute in the matcher's dtype (bf16 under ``PipelineConfig``); the
FPN's upsampling, the position-encoded coarse tokens and the coarse
transformer's residual stream are f32 (f32 operands promote there); layer
norms run in f32; the matching heads (dual softmax, fine heatmap) always run
in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.nn.layers import BatchNorm, leaky_relu, resize_bilinear_align_corners


class MatchResult(NamedTuple):
    kpts0: torch.Tensor  # [..., K, 2] pixel coords in image0 (480x480 frame)
    kpts1: torch.Tensor  # [..., K, 2]
    conf: torch.Tensor  # [..., K]
    valid: torch.Tensor  # [..., K] bool


class Conv2d(nn.Conv2d):
    """Conv2d without bias that computes in its weight's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=False)

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Dense(nn.Linear):
    """Linear layer that computes in its weight's dtype (flax ``Dense`` with
    ``dtype``)."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, padding=1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = BatchNorm(planes)
        self.stride = stride
        if stride != 1:
            # flax's default 'SAME' padding of a 1x1 stride-2 conv is none
            self.down_conv = Conv2d(cin, planes, 1, stride)
            self.down_bn = BatchNorm(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.stride != 1:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class ResNetFPN_8_2(nn.Module):
    """1/8 coarse (256 ch) + 1/2 fine (128 ch) features
    (loftr/backbone/resnet_fpn.py:44-120)."""

    def __init__(self, initial_dim: int = 128, block_dims=(128, 196, 256)):
        super().__init__()
        b0, b1, b2 = block_dims
        self.conv1 = Conv2d(1, initial_dim, 7, 2, padding=3)
        self.bn1 = BatchNorm(initial_dim)
        self.layer1_0 = BasicBlock(initial_dim, b0, 1)
        self.layer1_1 = BasicBlock(b0, b0, 1)
        self.layer2_0 = BasicBlock(b0, b1, 2)
        self.layer2_1 = BasicBlock(b1, b1, 1)
        self.layer3_0 = BasicBlock(b1, b2, 2)
        self.layer3_1 = BasicBlock(b2, b2, 1)
        self.layer3_outconv = Conv2d(b2, b2, 1)
        self.layer2_outconv = Conv2d(b1, b2, 1)
        self.layer2_outconv2_0 = Conv2d(b2, b2, 3, padding=1)
        self.layer2_outconv2_bn = BatchNorm(b2)
        self.layer2_outconv2_1 = Conv2d(b2, b1, 3, padding=1)
        self.layer1_outconv = Conv2d(b0, b1, 1)
        self.layer1_outconv2_0 = Conv2d(b1, b1, 3, padding=1)
        self.layer1_outconv2_bn = BatchNorm(b1)
        self.layer1_outconv2_1 = Conv2d(b1, b0, 3, padding=1)

    def forward(self, x):
        """[N, 1, H, W] -> (coarse [N, 256, H/8, W/8], fine [N, 128, H/2, W/2])."""
        x0 = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1_1(self.layer1_0(x0))
        x2 = self.layer2_1(self.layer2_0(x1))
        x3 = self.layer3_1(self.layer3_0(x2))

        x3_out = self.layer3_outconv(x3)
        # the upsampled map is f32 and so is the sum, as in the JAX module
        # (its gather resize promotes a bf16 map); the next conv casts back
        up3 = resize_bilinear_align_corners(x3_out.float(), x2.shape[2:])
        x2_out = self.layer2_outconv(x2) + up3
        x2_out = leaky_relu(self.layer2_outconv2_bn(self.layer2_outconv2_0(x2_out)))
        x2_out = self.layer2_outconv2_1(x2_out)

        up2 = resize_bilinear_align_corners(x2_out.float(), x1.shape[2:])
        x1_out = self.layer1_outconv(x1) + up2
        x1_out = leaky_relu(self.layer1_outconv2_bn(self.layer1_outconv2_0(x1_out)))
        x1_out = self.layer1_outconv2_1(x1_out)
        return x3_out, x1_out


def sine_position_encoding(h: int, w: int, d_model: int) -> np.ndarray:
    """2D sine encoding [h, w, d_model] (utils/position_encoding.py with
    temp_bug_fix=True, positions starting at 1)."""
    pe = np.zeros((d_model, h, w), np.float32)
    y_pos = np.cumsum(np.ones((h, w)), axis=0)
    x_pos = np.cumsum(np.ones((h, w)), axis=1)
    div = np.exp(np.arange(0, d_model // 2, 2) * (-np.log(10000.0) / (d_model // 2)))
    div = div[:, None, None]
    pe[0::4] = np.sin(x_pos[None] * div)
    pe[1::4] = np.cos(x_pos[None] * div)
    pe[2::4] = np.sin(y_pos[None] * div)
    pe[3::4] = np.cos(y_pos[None] * div)
    return np.moveaxis(pe, 0, -1)


def linear_attention(q, k, v, eps: float = 1e-6):
    """elu+1 feature-map linear attention (loftr_module/linear_attention.py:
    14-48) on [N, L, H, D] q and [N, S, H, D] k, v; the ``v / S`` and the
    final ``* S`` kept as written."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    S = v.shape[1]
    v = v / S
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv->nlhv", Q, KV) * Z[..., None] * S


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = Dense(d_model, d_model, bias=False)
        self.k_proj = Dense(d_model, d_model, bias=False)
        self.v_proj = Dense(d_model, d_model, bias=False)
        self.merge = Dense(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp0 = Dense(2 * d_model, 2 * d_model, bias=False)
        self.mlp2 = Dense(2 * d_model, d_model, bias=False)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, source):
        B, L, C = x.shape
        H = self.nhead
        q = self.q_proj(x).view(B, L, H, C // H)
        k = self.k_proj(source).view(B, -1, H, C // H)
        v = self.v_proj(source).view(B, -1, H, C // H)
        msg = self.merge(linear_attention(q, k, v).reshape(B, L, C))
        dt = msg.dtype
        msg = self.norm1(msg.float()).to(dt)
        h = F.relu(self.mlp0(torch.cat([x, msg], dim=-1)))
        h = self.norm2(self.mlp2(h).float()).to(dt)
        return x + h


class LocalFeatureTransformer(nn.Module):
    """``n_pairs`` (self, cross) layer pairs, each layer shared by both
    feature sets."""

    def __init__(self, d_model: int, nhead: int, n_pairs: int):
        super().__init__()
        self.n_pairs = n_pairs
        for i in range(n_pairs):
            setattr(self, f"self_{i}", LoFTREncoderLayer(d_model, nhead))
            setattr(self, f"cross_{i}", LoFTREncoderLayer(d_model, nhead))

    def forward(self, feat0, feat1):
        for i in range(self.n_pairs):
            self_layer = getattr(self, f"self_{i}")
            cross_layer = getattr(self, f"cross_{i}")
            feat0 = self_layer(feat0, feat0)
            feat1 = self_layer(feat1, feat1)
            # sequential cross updates (transformer.py:95-97): feat1 attends
            # to the feat0 already updated in this iteration
            feat0 = cross_layer(feat0, feat1)
            feat1 = cross_layer(feat1, feat0)
        return feat0, feat1


class LoFTRModules(nn.Module):
    """All LoFTR submodules under one state dict (the flax ``LoFTRModules``
    tree): ``backbone``, ``coarse_tf``, ``fine_tf``, ``down_proj`` and
    ``merge_feat``."""

    def __init__(self, d_coarse: int = 256, d_fine: int = 128, nhead: int = 8, window: int = 5):
        super().__init__()
        self.d_coarse, self.d_fine, self.window = d_coarse, d_fine, window
        self.backbone = ResNetFPN_8_2()
        self.coarse_tf = LocalFeatureTransformer(d_coarse, nhead, 4)
        self.fine_tf = LocalFeatureTransformer(d_fine, nhead, 1)
        self.down_proj = Dense(d_coarse, d_fine)
        self.merge_feat = Dense(2 * d_fine, d_fine)

    def fuse_fine(self, fine_win, coarse_feat):
        """Concat coarse context into fine windows (fine_preprocess.py:50-58):
        [M, W*W, d_fine] windows, [M, d_coarse] coarse features."""
        c = self.down_proj(coarse_feat)
        c = c[:, None, :].expand(*fine_win.shape[:2], self.d_fine)
        return self.merge_feat(torch.cat([fine_win, c], dim=-1))


class LoFTRMatcher:
    """The matcher's modules on their device, and the fixed-K matching.

    :param params: a state dict of ``LoFTRModules`` (``utils.convert_jax.
        loftr_from_jax`` makes one from the JAX variables), loaded with
        ``strict=True``; None -> modules initialised from ``seed``
    :param dtype: compute dtype of the convs, batch norms and dense layers,
        'float32' or 'bfloat16' (``ElevationConfig.dtype``); the matching
        heads run f32
    :param device: None -> 'cuda' (raises without CUDA)
    """

    def __init__(self, params=None, image_size: int = 480, max_matches: int = 1024,
                 threshold: float = 0.2, border: int = 2, seed: int = 0,
                 dtype: str = "float32", device=None):
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.image_size = image_size
        self.max_matches = max_matches
        self.threshold = threshold
        self.border = border
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda), self.device:
            torch.manual_seed(seed)
            self.modules = LoFTRModules()
        if params is not None:
            self.modules.load_state_dict(params, strict=True)
        self.modules.requires_grad_(False).eval()
        # convs and dense layers in the compute dtype; batch-norm statistics
        # and layer norms stay f32
        for m in self.modules.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(self.dtype)

    # ------------------------------------------------------------- pieces
    @torch.no_grad()
    def extract(self, images: torch.Tensor):
        """[N, H, W] grayscale in [0, 1] -> (coarse [N, H/8, W/8, 256],
        fine [N, H/2, W/2, 128]) in the compute dtype."""
        coarse, fine = self.modules.backbone(images[:, None].to(self.device, torch.float32))
        return coarse.permute(0, 2, 3, 1), fine.permute(0, 2, 3, 1)

    @torch.no_grad()
    def coarse_confidence(self, coarse0: torch.Tensor, coarse1: torch.Tensor):
        """Position-encoded coarse transformer and dual-softmax confidence of
        [P, hc, wc, C] feature pairs -> (c0, c1 [P, L, C], conf [P, L, L] f32)."""
        P, hc, wc, d_c = coarse0.shape
        pe = torch.from_numpy(sine_position_encoding(hc, wc, d_c)).to(coarse0.device)
        c0 = (coarse0 + pe).reshape(P, hc * wc, d_c)
        c1 = (coarse1 + pe).reshape(P, hc * wc, d_c)
        c0, c1 = self.modules.coarse_tf(c0, c1)
        # always f32: the mutual-NN max comparisons and the threshold need
        # more than bf16's 8-bit mantissa
        n0 = c0.float() / d_c**0.5
        n1 = c1.float() / d_c**0.5
        sim = (n0 @ n1.transpose(1, 2)) / 0.1
        conf = torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)
        return c0, c1, conf

    @torch.no_grad()
    def match_features(self, coarse, fine, i0, i1) -> MatchResult:
        """Match the pairs (coarse[i0[p]], coarse[i1[p]]) of one batch of
        backbone features -> a MatchResult with a leading pair axis.

        Mirrors LoFTR.forward (loftr.py:29-76) with dual-softmax coarse
        matching (coarse_matching.py:109-180) and s2d fine matching
        (fine_matching.py:15-74)."""
        dev = coarse.device
        i0 = torch.as_tensor(i0, device=dev)
        i1 = torch.as_tensor(i1, device=dev)
        P = i0.shape[0]
        _, hc, wc, _ = coarse.shape
        hf = fine.shape[1]
        c0, c1, conf = self.coarse_confidence(coarse[i0], coarse[i1])

        # threshold + mutual nearest + border removal
        L = hc * wc
        maxrow = conf == conf.amax(dim=2, keepdim=True)
        maxcol = conf == conf.amax(dim=1, keepdim=True)
        ok = (conf > self.threshold) & maxrow & maxcol
        ii = torch.arange(L, device=dev)
        iy, ix = ii // wc, ii % wc
        b = self.border
        inb = (iy >= b) & (iy < hc - b) & (ix >= b) & (ix < wc - b)
        ok = ok & inb[:, None] & inb[None, :]
        scores = torch.where(ok, conf, torch.zeros((), device=dev))

        # mutual-NN leaves at most one valid entry per row, so the slate is a
        # top-K over the row maxima (the same selection as a sort of the
        # dense matrix, up to exact ties)
        K = self.max_matches
        row_val = scores.amax(dim=2)
        row_arg = scores.argmax(dim=2)  # the first maximum, as jnp.argmax
        topv, i_ids = torch.topk(row_val, K, dim=1)
        j_ids = torch.gather(row_arg, 1, i_ids)
        valid = topv > 0.0

        scale_c = self.image_size // hc  # 8
        k0 = torch.stack([(i_ids % wc) * scale_c, (i_ids // wc) * scale_c], dim=-1)
        k1 = torch.stack([(j_ids % wc) * scale_c, (j_ids // wc) * scale_c], dim=-1)

        # fine refinement: 5x5 windows of the padded 1/2 map, centred on the
        # coarse cells' fine pixels
        Wn = self.modules.window
        stride = hf // hc  # 4
        pad = Wn // 2
        fpad = F.pad(fine, (0, 0, pad, pad, pad, pad))  # [N, hf + 4, wf + 4, C]
        dy = torch.arange(Wn, device=dev)

        def windows(img_ids, ids):
            rows = ((ids // wc) * stride)[..., None, None] + dy[:, None]
            cols = ((ids % wc) * stride)[..., None, None] + dy[None, :]
            w = fpad[img_ids[:, None, None, None], rows, cols]  # [P, K, Wn, Wn, C]
            return w.reshape(P * K, Wn * Wn, -1)

        pidx = torch.arange(P, device=dev)[:, None]
        win0 = self.modules.fuse_fine(windows(i0, i_ids), c0[pidx, i_ids].reshape(P * K, -1))
        win1 = self.modules.fuse_fine(windows(i1, j_ids), c1[pidx, j_ids].reshape(P * K, -1))
        win0, win1 = self.modules.fine_tf(win0, win1)

        d_f = win0.shape[-1]
        center = win0[:, (Wn * Wn) // 2, :].float()
        simf = torch.einsum("mc,mrc->mr", center, win1.float()) / d_f**0.5
        heat = torch.softmax(simf, dim=-1).reshape(-1, Wn, Wn)
        lin = torch.linspace(-1.0, 1.0, Wn, device=dev)
        gy, gx = torch.meshgrid(lin, lin, indexing="ij")
        ex = (heat * gx).sum(dim=(1, 2))
        ey = (heat * gy).sum(dim=(1, 2))
        scale_f = self.image_size // hf  # 2
        k1f = k1 + (torch.stack([ex, ey], dim=-1) * (Wn // 2) * scale_f).reshape(P, K, 2)
        return MatchResult(
            kpts0=k0.to(torch.float32), kpts1=k1f.to(torch.float32), conf=topv, valid=valid,
        )

    # ------------------------------------------------------------ matching
    def match_pairs(self, imgs0, imgs1) -> MatchResult:
        """[P, H, W] x [P, H, W] grayscale in [0, 1] -> MatchResult with a
        leading pair axis (the backbone on all 2P images in one batch, the
        transformers at batch P)."""
        imgs = torch.cat([torch.as_tensor(imgs0), torch.as_tensor(imgs1)])
        P = len(imgs) // 2
        return self.match_views(imgs, [(p, P + p) for p in range(P)])

    def match_pair(self, img0, img1) -> MatchResult:
        """[H, W] x [H, W] grayscale in [0, 1] -> fixed-K matches."""
        res = self.match_pairs(torch.as_tensor(img0)[None], torch.as_tensor(img1)[None])
        return MatchResult(*(x[0] for x in res))

    def match_views(self, images, pairs) -> MatchResult:
        """[V, H, W] grayscale views and (i, j) index pairs -> MatchResult
        with a leading pair axis.  The backbone runs once per view, not once
        per pair member: batch norm at inference normalises each sample on
        its own, so a view's features do not depend on its batch."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        coarse, fine = self.extract(images)
        return self.match_features(coarse, fine, [i for i, _ in pairs], [j for _, j in pairs])
