"""Cost-volume conditioned SDF network (generalizable SparseNeuS).

Counterpart of ``one2345_tpu/recon/sdf_network.py`` (reference:
reconstruction/models/sparse_sdf_network.py, ``SparseSdfNetwork``
:139-540 and ``LatentSDFLayer`` :35-136), dense and fixed-shape:
- the frustum-culled sparse voxel list is a dense lattice with an
  occupancy mask;
- the per-view feature fetch accumulates sum, sum of squares and count in
  a loop over views, in f32, instead of building the [N_vox, V, C] tensor;
  its backward recomputes each view's projection and gather
  (``_ViewCost``), so no per-view residual is kept: at 192^3 x 32 views the
  gather indices and weights alone would take tens of GB;
- the sparse U-Net is the dense masked ``CostRegNet``;
- normals are ``torch.autograd.grad`` of the SDF at the points, with
  ``create_graph=True`` for the eikonal loss (the JAX package's three
  forward-mode JVPs are a TPU workaround).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from one2345_tpu_torch.geometry.projection import project_points
from one2345_tpu_torch.geometry.sampling import trilinear_sample
from one2345_tpu_torch.nn.layers import ConvBnAct, WNDense, positional_encoding
from one2345_tpu_torch.recon.costreg import CostRegNet


def _upsample_parents(x: torch.Tensor) -> torch.Tensor:
    """[X, Y, Z, C] -> [2X, 2Y, 2Z, C]: each parent voxel repeated over its
    2^3 children (sparse_sdf_network.py upsample:198-219)."""
    return x.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)


def softplus100(x):
    """Softplus with beta=100 (sparse_sdf_network.py:106-107)."""
    return F.softplus(100.0 * x) / 100.0


class LatentSDFLayer(nn.Module):
    """SDF MLP conditioned on a per-point latent code.

    4 layers (3 weight-normalised linears), hidden 128, positional encoding
    multires 6 (3 -> 39), the latent concatenated to the input of every
    layer after the first, softplus(beta=100), always f32.  Output
    [..., hidden]: channel 0 is the sdf, the rest are features.

    Geometric (IDR) initialisation, drawn from the global generator
    (sparse_sdf_network.py:76-98): lin0 reads only xyz, N(0, 2/out); the
    middle layers N(0, 2/out); the last N(sqrt(pi/in), 1e-4^2) with bias
    -``bias``; latent columns (and the last bias's latent-width tail)
    zero, so the initial field is a sphere of radius about ``bias``.
    """

    def __init__(self, d_hidden: int = 128, n_layers: int = 4, multires: int = 6,
                 d_latent: int = 16, bias: float = 0.5):
        super().__init__()
        self.multires = multires
        h = d_hidden
        d_in = 3 * (2 * multires + 1)
        with torch.no_grad():
            self.lin0 = WNDense(d_in, h)
            self.lin0.v.zero_()
            self.lin0.v[:3].normal_(0.0, math.sqrt(2) / math.sqrt(h))
            for l in range(1, n_layers - 2):
                lin = WNDense(h + d_latent, h)
                lin.v.normal_(0.0, math.sqrt(2) / math.sqrt(h))
                lin.v[-d_latent:] = 0.0
                setattr(self, f"lin{l}", lin)
            last = WNDense(h + d_latent, h)
            last.v.normal_(math.sqrt(math.pi) / math.sqrt(h + d_latent), 1e-4)
            last.v[-d_latent:] = 0.0
            last.bias.fill_(-bias)
            last.bias[-d_latent:] = 0.0
            setattr(self, f"lin{n_layers - 2}", last)
            for m in self.modules():
                if isinstance(m, WNDense):
                    m.reset_norm()
        self.n_layers = n_layers

    def forward(self, pts, latent):
        """pts [..., 3] in the normalized volume space, latent [..., d_latent]."""
        latent = latent.to(torch.promote_types(latent.dtype, torch.float32))
        x = softplus100(self.lin0(positional_encoding(pts, self.multires)))
        for l in range(1, self.n_layers - 2):
            x = softplus100(getattr(self, f"lin{l}")(torch.cat([x, latent], dim=-1)))
        return getattr(self, f"lin{self.n_layers - 2}")(torch.cat([x, latent], dim=-1))


class SingleVarianceNetwork(nn.Module):
    """Learnable scalar s; inv_variance = exp(10 s) (models/fields.py:179-185)."""

    def __init__(self, init_val: float = 0.2):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(init_val, dtype=torch.float32))

    def forward(self):
        return torch.exp(10.0 * self.variance)


def _view_cost_terms(feats, projs, pts, size_hw):
    """Yield, per view v: (the corner taps' flat indices into feats[v],
    their weights times in-bounds flags [N, 1] in the features' dtype, and
    the in-frustum mask [N])."""
    V, fH, fW, _ = feats.shape
    sH, sW = size_hw
    for v in range(V):
        x, y, z = project_points(pts, projs[v])
        gx = 2.0 * x / (sW - 1) - 1.0
        gy = 2.0 * y / (sH - 1) - 1.0
        mask = (gx.abs() <= 1.0) & (gy.abs() <= 1.0) & (z > 0)
        px = (gx + 1.0) * 0.5 * (fW - 1)
        py = (gy + 1.0) * 0.5 * (fH - 1)
        x0, y0 = torch.floor(px), torch.floor(py)
        tx, ty = px - x0, py - y0
        taps = []
        for dx, dy, w in ((0, 0, (1 - tx) * (1 - ty)), (1, 0, tx * (1 - ty)),
                          (0, 1, (1 - tx) * ty), (1, 1, tx * ty)):
            ix, iy = x0 + dx, y0 + dy
            ok = (ix >= 0) & (ix <= fW - 1) & (iy >= 0) & (iy <= fH - 1)
            lin = iy.clamp(0, fH - 1).long() * fW + ix.clamp(0, fW - 1).long()
            taps.append((lin, (w.to(feats.dtype) * ok.to(feats.dtype))[:, None]))
        yield taps, mask


def _acc_dtype(feats):
    """The accumulation dtype: at least f32."""
    return torch.promote_types(feats.dtype, torch.float32)


def _gather_view(flat, taps):
    """The bilinear fetch of one view from its flat [H * W, C] map, in the
    accumulation dtype."""
    out = 0.0
    for lin, w in taps:
        out = out + flat[lin] * w
    return out.to(_acc_dtype(flat))


class _ViewCost(torch.autograd.Function):
    """(sum, sum of squares, count) over views of the bilinear fetch of
    every view's map at every voxel's projection, f32.  Nothing per view is
    saved: the backward recomputes each view's projection and gather and
    scatters d/df = g_sum + 2 g_sq f into the view's map (``index_add_``).
    The tap order and dtype are ``bilinear_sample``'s, so the forward
    equals the plain per-view fetch."""

    @staticmethod
    def forward(ctx, feats, projs, pts, size_hw):
        V, fH, fW, C = feats.shape
        N = pts.shape[0]
        vol_sum = torch.zeros(N, C, dtype=_acc_dtype(feats), device=feats.device)
        vol_sq = torch.zeros_like(vol_sum)
        counts = torch.zeros(N, dtype=vol_sum.dtype, device=feats.device)
        for v, (taps, mask) in enumerate(_view_cost_terms(feats, projs, pts, size_hw)):
            f = _gather_view(feats[v].reshape(fH * fW, C), taps)
            vol_sum += f
            vol_sq += f * f
            counts += mask.to(counts.dtype)
        ctx.save_for_backward(feats, projs, pts)
        ctx.size_hw = size_hw
        ctx.mark_non_differentiable(counts)
        return vol_sum, vol_sq, counts

    @staticmethod
    def backward(ctx, g_sum, g_sq, _):
        feats, projs, pts = ctx.saved_tensors
        V, fH, fW, C = feats.shape
        grad = torch.zeros((V, fH * fW, C), dtype=g_sum.dtype, device=feats.device)
        for v, (taps, _) in enumerate(_view_cost_terms(feats, projs, pts, ctx.size_hw)):
            f = _gather_view(feats[v].reshape(fH * fW, C), taps)
            g = g_sum + 2.0 * g_sq * f
            for lin, w in taps:
                grad[v].index_add_(0, lin, g * w.to(g.dtype))
        return grad.reshape(feats.shape).to(feats.dtype), None, None, None


class SdfVolumeNetwork(nn.Module):
    """Feature compression + cost volume + regularization + SDF MLP.

    ``build_volume`` makes the conditional feature volume from the views'
    fused pyramid features; ``sdf`` evaluates (sdf, features) at points.
    The conv path (``compress``, ``costreg``) runs in its weights' dtype;
    the SDF MLP stays f32 (its zero crossing is the surface).  A lod1
    network (``d_pre`` > 0) also takes the previous lod's pruned occupancy
    and features at half its lattice.
    """

    def __init__(self, vol_dims=(96, 96, 96), voxel_size: float = 2.0 / 95.0,
                 origin=(-1.0, -1.0, -1.0), ch_in: int = 56, d_compress: int = 16,
                 regnet_d_out: int = 16, hidden_dim: int = 128, num_sdf_layers: int = 4,
                 multires: int = 6, d_pre: int = 0):
        super().__init__()
        self.vol_dims = tuple(vol_dims)
        self.voxel_size = voxel_size
        self.origin = tuple(origin)
        self.compress = ConvBnAct(ch_in, d_compress, (3, 3))
        self.costreg = CostRegNet(d_in=2 * d_compress + d_pre, d_out=regnet_d_out)
        self.sdf_layer = LatentSDFLayer(
            d_hidden=hidden_dim, n_layers=num_sdf_layers, multires=multires,
            d_latent=regnet_d_out,
        )

    def voxel_world_coords(self, device=None, dtype=torch.float32) -> torch.Tensor:
        """[X, Y, Z, 3] world coordinates of the voxel centers."""
        axes = [torch.arange(n, dtype=dtype, device=device) for n in self.vol_dims]
        coords = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        origin = torch.tensor(self.origin, dtype=dtype, device=device)
        return coords * self.voxel_size + origin

    def build_volume(self, feature_maps: torch.Tensor, projs: torch.Tensor,
                     size_hw=(256, 256), train: bool = False, pre_mask=None,
                     pre_feats=None) -> dict:
        """Conditional volume from fused pyramid features
        (get_conditional_volume, sparse_sdf_network.py:286-400).

        :param feature_maps: [V, H, W, 56]
        :param projs: [V, 4, 4] K @ w2c in the normalized space
        :param size_hw: the (H, W) the projections are calibrated for
        :param train: batch norms on batch statistics (running ones updated)
        :param pre_mask: lod1 only, [X/2, Y/2, Z/2, 1] pruned occupancy of
            the previous lod; each parent covers its 2^3 children
        :param pre_feats: lod1 only, [X/2, Y/2, Z/2, C_prev] parent features
            concatenated into the cost
        :return: 'volume' [X, Y, Z, regnet_d_out] in the conv dtype, 'mask'
            [X, Y, Z, 1] f32 (voxels inside >= 2 view frusta, and under a
            kept parent)
        """
        feats = self.compress(feature_maps.permute(0, 3, 1, 2), train).permute(0, 2, 3, 1)
        feats = feats.contiguous()
        # f32 sums (at least) whatever the feature dtype: the variance below
        # is E[x^2] - E[x]^2, which cancels badly in half-precision sums
        acc = _acc_dtype(feats)
        pts = self.voxel_world_coords(feats.device, acc).reshape(-1, 3)
        vol_sum, vol_sq, counts = _ViewCost.apply(feats, projs.to(acc), pts, tuple(size_hw))

        valid = counts >= 2.0  # minimum_visible_views culling (:330-334)
        if pre_mask is not None:
            valid = valid & (_upsample_parents(pre_mask).reshape(-1) > 0)
        inv = (1.0 / (counts + 1e-5))[:, None]
        mean = vol_sum * inv
        var = vol_sq * inv - mean * mean
        cost = torch.cat([var, mean], dim=-1)
        if pre_feats is not None:
            upf = _upsample_parents(pre_feats)
            cost = torch.cat([cost, upf.reshape(cost.shape[0], -1).to(cost.dtype)], dim=-1)
        cost = cost * valid[:, None].to(cost.dtype)
        X, Y, Z = self.vol_dims
        mask = valid.reshape(X, Y, Z, 1).to(torch.float32)
        out = self.costreg(cost.reshape(X, Y, Z, -1), mask, train)
        return {"volume": out, "mask": mask}

    def sdf(self, pts: torch.Tensor, volume: torch.Tensor):
        """(sdf [..., 1], features [..., hidden - 1]) at normalized pts."""
        out = self.sdf_layer(pts, trilinear_sample(volume, pts))
        return out[..., :1], out[..., 1:]

    def sdf_from_latent(self, pts: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        """The SDF MLP on latents fetched elsewhere (the field grid's
        separable resize)."""
        return self.sdf_layer(pts, latent)

    def sdf_and_gradient(self, pts: torch.Tensor, volume: torch.Tensor,
                         create_graph: bool = False):
        """(sdf, features, d sdf / d pts) with the gradient from
        ``torch.autograd.grad`` of the summed sdf (the points are
        independent, so it is the per-point gradient).  ``create_graph``
        keeps all three differentiable in the volume and the MLP's
        parameters (training: the eikonal loss differentiates the gradient,
        through the gather-based ``trilinear_sample``); otherwise no graph
        outlives the call (mesh colors, validation)."""
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            sdf, feat = self.sdf(p, volume)
            (grad,) = torch.autograd.grad(sdf.sum(), p, create_graph=create_graph)
        if create_graph:
            return sdf, feat, grad
        return sdf.detach(), feat.detach(), grad
