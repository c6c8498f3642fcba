"""Plain reference of the reconstruction stage's field: 32 posed views ->
-sdf on the R^3 lattice of [-1, 1]^3, in float32.

Frozen copies, forward and inference only, of
``one2345_tpu_torch/recon/{featurenet,costreg,sdf_network,pipeline}.py``,
``nn/layers.py`` and the camera rig of ``geometry/cameras.py``, with the
same submodule and parameter names: the pyramid features, the compressed
features' per-view bilinear fetch at every voxel (mean and variance over
the views that see it), the masked 3-D U-Net over the cost, and the SDF
MLP over the trilinear resize of the volume to the lattice.  Batch norms
use their running statistics.  Every conv and linear reads its operands
through ``precision.round_``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import precision

FOCAL = 280.0
NEAR_FAR = (0.5, 1.8)
CAMERA_RADIUS = 1.2
BLENDER2OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])


# ---------------------------------------------------------------- cameras
def _look_at(polar, azimuth, radius=CAMERA_RADIUS):
    n = polar.shape[0]
    centers = np.stack([radius * np.sin(azimuth) * np.sin(polar),
                        -radius * np.cos(azimuth) * np.sin(polar),
                        radius * np.cos(polar)], axis=-1)

    def unit(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    forward = unit(centers)
    up = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (n, 3))
    right = np.cross(up, forward)
    right = unit(np.where(np.linalg.norm(right, axis=-1, keepdims=True) < 0.1,
                          np.array([0.0, 1.0, 0.0]), right))
    up = unit(np.cross(forward, right))
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    poses[:, :3, 3] = centers
    return poses


def source_projections(polar_deg: float) -> np.ndarray:
    """[32, 4, 4] K @ w2c of the 32 stage-2 views in the normalised space,
    for the input's polar angle (the rig of the reference's get_poses and
    the scene normalisation of One2345_eval_new_data.py, as
    ``build_recon_cameras`` assembles them)."""
    mid = float(polar_deg)
    second = mid + 30.0 if mid <= 75 else mid - 30.0
    polar = [mid] * 4 + [second] * 4 + [mid - 10, mid + 10, mid, mid] * 4 \
        + [second - 10, second + 10, second, second] * 4
    overlook = [30.0 + 90.0 * k for k in range(4)]
    eyelevel = [60.0 + 90.0 * k for k in range(4)]
    delta = [0.0, 0.0, -10.0, 10.0]
    azim = overlook + eyelevel + [t + s for t in overlook for s in delta] \
        + [t + s for t in eyelevel for s in delta]
    c2ws = _look_at(np.radians(polar), np.radians(azim)) @ BLENDER2OPENCV
    w2cs_all = np.linalg.inv(c2ws)
    trans = np.linalg.inv(w2cs_all[0])
    sel = [0] + list(range(8, 40))
    w2cs = np.stack([w2cs_all[i] @ trans for i in sel])
    K = np.array([[FOCAL, 0.0, 128.0], [0.0, FOCAL, 128.0], [0.0, 0.0, 1.0]])
    # the union of the 33 view frusta's corners sets the unit cube
    xs = np.array([0, 0, 256, 256, 0, 0, 256, 256], np.float64)
    ys = np.array([0, 256, 0, 256, 0, 256, 0, 256], np.float64)
    zs = np.array([NEAR_FAR[0]] * 4 + [NEAR_FAR[1]] * 4)
    cam_pts = np.stack([(xs - 128.0) * zs / FOCAL, (ys - 128.0) * zs / FOCAL, zs,
                        np.ones(8)], axis=-1)
    pts = np.concatenate([(np.linalg.inv(w) @ cam_pts.T).T[:, :3] for w in w2cs])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center, r = (lo + hi) / 2.0, float((hi - lo).max() / 2.0) * 1.1
    out = []
    for w in w2cs[1:]:
        R = w[:3, :3]
        c_new = (np.linalg.inv(w)[:3, 3] - center) / r
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ c_new
        aff = np.eye(4)
        aff[:3, :4] = K @ w2c[:3, :4]
        out.append(aff)
    return np.stack(out).astype(np.float32)


# ----------------------------------------------------------------- layers
class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(precision.round_(x), precision.round_(self.weight), self.bias)


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(precision.round_(x), precision.round_(self.weight), self.bias)


class BatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = (torch.rsqrt(self.running_var + self.eps) * self.weight).view(shape)
        return (x - self.running_mean.view(shape)) * inv + self.bias.view(shape)


class ConvBnAct(nn.Module):
    def __init__(self, cin, features, kernel_size=(3, 3), strides=(1, 1)):
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, tuple(kernel_size), stride=tuple(strides),
                             padding=tuple(k // 2 for k in kernel_size), bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), 0.01)


def _resize(img, hw):
    return F.interpolate(img, size=tuple(hw), mode="bilinear", align_corners=True)


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        plan = [(3, 8, 3, 1), (8, 8, 3, 1), (8, 16, 5, 2), (16, 16, 3, 1), (16, 16, 3, 1),
                (16, 32, 5, 2), (32, 32, 3, 1), (32, 32, 3, 1)]
        for i, (cin, cout, k, s) in enumerate(plan):
            setattr(self, f"ConvBnAct_{i}", ConvBnAct(cin, cout, (k, k), (s, s)))
        self.toplayer = Conv2d(32, 32, 1)
        self.lat1 = Conv2d(16, 32, 1)
        self.lat0 = Conv2d(8, 32, 1)
        self.smooth1 = Conv2d(32, 16, 3, padding=1)
        self.smooth0 = Conv2d(32, 8, 3, padding=1)

    def forward(self, x):
        c = [getattr(self, f"ConvBnAct_{i}") for i in range(8)]
        conv0 = c[1](c[0](x))
        conv1 = c[4](c[3](c[2](conv0)))
        conv2 = c[7](c[6](c[5](conv1)))
        feat2 = self.toplayer(conv2)
        lat1, lat0 = self.lat1(conv1), self.lat0(conv0)
        feat1 = _resize(feat2, lat1.shape[2:]) + lat1
        feat0 = _resize(feat1, lat0.shape[2:]) + lat0
        return [feat2, self.smooth1(feat1), self.smooth0(feat0)]


class PyramidFeatureFusion(nn.Module):
    def __init__(self):
        super().__init__()
        self.fpn = FeatureNet()

    def forward(self, images):
        """[V, H, W, 3] in [0, 1] -> [V, H, W, 56]."""
        feats = self.fpn(images.permute(0, 3, 1, 2))
        H, W = images.shape[1], images.shape[2]
        return torch.cat([_resize(feats[0], (H, W)), _resize(feats[1], (H, W)), feats[2]],
                         dim=1).permute(0, 2, 3, 1)


class MConvBnRelu(nn.Module):
    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.Conv_0 = Conv3d(cin, features, 3, stride=stride, padding=1, bias=False)
        self.MaskedBatchNorm_0 = BatchNorm(features)
        self.deconv = False

    def forward(self, x, mask_in, mask_out):
        x = x * mask_in
        if self.deconv:  # zero insertion, then the k3 conv
            N, C, X, Y, Z = x.shape
            up = x.new_zeros((N, C, 2 * X, 2 * Y, 2 * Z))
            up[:, :, ::2, ::2, ::2] = x
            x = up
        return torch.relu(self.MaskedBatchNorm_0(self.Conv_0(x)) * mask_out)


class CostRegNet(nn.Module):
    def __init__(self, d_in=32, d_out=16):
        super().__init__()
        enc = [(d_in, d_out, 1), (d_out, 16, 2), (16, 16, 1), (16, 32, 2), (32, 32, 1),
               (32, 64, 2), (64, 64, 1)]
        for i, (cin, cout, s) in enumerate(enc):
            setattr(self, f"_MConvBnRelu_{i}", MConvBnRelu(cin, cout, s))
        for i, (cin, cout) in enumerate([(64, 32), (32, 16), (16, d_out)]):
            m = MConvBnRelu(cin, cout)
            m.deconv = True
            setattr(self, f"_MDeconvBnRelu_{i}", m)

    def forward(self, volume, mask):
        x = volume.permute(3, 0, 1, 2)[None]
        m0 = mask.permute(3, 0, 1, 2)[None]
        m1 = F.max_pool3d(m0, 2)
        m2 = F.max_pool3d(m1, 2)
        m3 = F.max_pool3d(m2, 2)
        e = [getattr(self, f"_MConvBnRelu_{i}") for i in range(7)]
        d = [getattr(self, f"_MDeconvBnRelu_{i}") for i in range(3)]
        conv0 = e[0](x, m0, m0)
        conv2 = e[2](e[1](conv0, m0, m1), m1, m1)
        conv4 = e[4](e[3](conv2, m1, m2), m2, m2)
        conv6 = e[6](e[5](conv4, m2, m3), m3, m3)
        x = conv4 + d[0](conv6, m3, m2)
        x = conv2 + d[1](x, m2, m1)
        x = conv0 + d[2](x, m1, m0)
        return (x * m0)[0].permute(1, 2, 3, 0)


class WNDense(nn.Module):
    def __init__(self, in_dim, features):
        super().__init__()
        self.v = nn.Parameter(torch.zeros(in_dim, features))
        self.g = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        w = self.v * (self.g / (torch.linalg.vector_norm(self.v, dim=0) + 1e-12))
        return precision.round_(x) @ precision.round_(w) + self.bias


def positional_encoding(x, n_freqs):
    out = [x]
    for k in range(n_freqs):
        out += [torch.sin(2.0**k * x), torch.cos(2.0**k * x)]
    return torch.cat(out, dim=-1)


def softplus100(x):
    return F.softplus(100.0 * x) / 100.0


class LatentSDFLayer(nn.Module):
    def __init__(self, d_hidden=128, n_layers=4, multires=6, d_latent=16):
        super().__init__()
        self.multires, self.n_layers = multires, n_layers
        self.lin0 = WNDense(3 * (2 * multires + 1), d_hidden)
        for l in range(1, n_layers - 1):
            setattr(self, f"lin{l}", WNDense(d_hidden + d_latent, d_hidden))

    def forward(self, pts, latent):
        x = softplus100(self.lin0(positional_encoding(pts, self.multires)))
        for l in range(1, self.n_layers - 2):
            x = softplus100(getattr(self, f"lin{l}")(torch.cat([x, latent], dim=-1)))
        return getattr(self, f"lin{self.n_layers - 2}")(torch.cat([x, latent], dim=-1))


class SdfVolumeNetwork(nn.Module):
    def __init__(self, vol_dims=(96, 96, 96), voxel_size=2.0 / 95.0, origin=(-1.0, -1.0, -1.0),
                 ch_in=56, d_compress=16, regnet_d_out=16, hidden_dim=128, num_sdf_layers=4,
                 multires=6):
        super().__init__()
        self.vol_dims, self.voxel_size, self.origin = tuple(vol_dims), voxel_size, origin
        self.compress = ConvBnAct(ch_in, d_compress, (3, 3))
        self.costreg = CostRegNet(d_in=2 * d_compress, d_out=regnet_d_out)
        self.sdf_layer = LatentSDFLayer(hidden_dim, num_sdf_layers, multires, regnet_d_out)

    def build_volume(self, feature_maps, projs, size_hw=(256, 256)):
        """Fused features [V, H, W, 56] + [V, 4, 4] projections -> (volume
        [X, Y, Z, 16], mask [X, Y, Z, 1])."""
        feats = self.compress(feature_maps.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        V, fH, fW, C = feats.shape
        axes = [torch.arange(n, dtype=torch.float32, device=feats.device) for n in self.vol_dims]
        pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
        pts = pts * self.voxel_size + torch.tensor(self.origin, device=feats.device)
        vol_sum = torch.zeros(pts.shape[0], C, device=feats.device)
        vol_sq = torch.zeros_like(vol_sum)
        counts = torch.zeros(pts.shape[0], device=feats.device)
        sH, sW = size_hw
        for v in range(V):
            P = projs[v]
            x = P[0, 0] * pts[:, 0] + P[0, 1] * pts[:, 1] + P[0, 2] * pts[:, 2] + P[0, 3]
            y = P[1, 0] * pts[:, 0] + P[1, 1] * pts[:, 1] + P[1, 2] * pts[:, 2] + P[1, 3]
            z = P[2, 0] * pts[:, 0] + P[2, 1] * pts[:, 1] + P[2, 2] * pts[:, 2] + P[2, 3]
            z_safe = torch.where(z >= 0, z.clamp(min=1e-6), z)
            gx = 2.0 * (x / z_safe) / (sW - 1) - 1.0
            gy = 2.0 * (y / z_safe) / (sH - 1) - 1.0
            counts += ((gx.abs() <= 1.0) & (gy.abs() <= 1.0) & (z > 0)).float()
            px, py = (gx + 1.0) * 0.5 * (fW - 1), (gy + 1.0) * 0.5 * (fH - 1)
            x0, y0 = torch.floor(px), torch.floor(py)
            tx, ty = px - x0, py - y0
            flat = feats[v].reshape(fH * fW, C)
            f = 0.0
            for dx, dy, w in ((0, 0, (1 - tx) * (1 - ty)), (1, 0, tx * (1 - ty)),
                              (0, 1, (1 - tx) * ty), (1, 1, tx * ty)):
                ix, iy = x0 + dx, y0 + dy
                ok = (ix >= 0) & (ix <= fW - 1) & (iy >= 0) & (iy <= fH - 1)
                lin = iy.clamp(0, fH - 1).long() * fW + ix.clamp(0, fW - 1).long()
                f = f + flat[lin] * (w * ok.float())[:, None]
            vol_sum += f
            vol_sq += f * f
        valid = counts >= 2.0
        inv = (1.0 / (counts + 1e-5))[:, None]
        mean = vol_sum * inv
        cost = torch.cat([vol_sq * inv - mean * mean, mean], dim=-1) * valid[:, None].float()
        X, Y, Z = self.vol_dims
        mask = valid.reshape(X, Y, Z, 1).float()
        return self.costreg(cost.reshape(X, Y, Z, -1), mask), mask


def interp_matrix(R: int, X: int):
    """[R, X] linear interpolation from X samples of [-1, 1] (corners
    aligned) to R, and the R lattice coordinates (built on the CPU)."""
    lin = torch.linspace(-1.0, 1.0, R, dtype=torch.float32)
    pos = (lin + 1.0) * 0.5 * (X - 1)
    i0 = torch.floor(pos).clamp(0, X - 1).long()
    i1 = (i0 + 1).clamp(max=X - 1)
    t = (pos - i0.to(torch.float32))[:, None]
    eye = torch.eye(X, dtype=torch.float32)
    return eye[i0] * (1.0 - t) + eye[i1] * t, lin


def field(sdf_net: SdfVolumeNetwork, volume, R: int, chunk: int = 64**3):
    """-sdf on the R^3 lattice: the volume's trilinear resize (three
    separable interpolation matmuls), then the SDF MLP over slabs."""
    X, C = volume.shape[0], volume.shape[-1]
    Wm, lin = interp_matrix(R, X)
    Wm, lin = Wm.to(volume.device), lin.to(volume.device)
    vol = torch.einsum("xa,aYZC->xYZC", Wm, volume)
    vol = torch.einsum("yb,XbZC->XyZC", Wm, vol)
    slab = max(1, chunk // (R * R))
    yy, zz = torch.meshgrid(lin, lin, indexing="ij")
    u = torch.empty((R, R, R), device=volume.device)
    for x0 in range(0, R, slab):
        xs = lin[x0:x0 + slab]
        S = xs.shape[0]
        latent = torch.einsum("zc,SYcC->SYzC", Wm, vol[x0:x0 + slab]).reshape(-1, C)
        pts = torch.stack([xs[:, None, None].expand(S, R, R), yy.expand(S, R, R),
                           zz.expand(S, R, R)], dim=-1).reshape(-1, 3)
        u[x0:x0 + slab] = -sdf_net.sdf_layer(pts, latent)[:, 0].reshape(S, R, R)
    return u


def build(recon: dict, device="meta") -> dict:
    """{'fusion', 'sdf'}: the reference modules of the config's 'recon'
    widths."""
    with torch.device(device):
        return {
            "fusion": PyramidFeatureFusion(),
            "sdf": SdfVolumeNetwork(
                vol_dims=tuple(recon["vol_dims"]), voxel_size=recon["voxel_size"],
                origin=tuple(recon["partial_vol_origin"]), ch_in=recon["ch_in"],
                d_compress=recon["d_pyramid_feature_compress"],
                regnet_d_out=recon["regnet_d_out"], hidden_dim=recon["hidden_dim"],
                num_sdf_layers=recon["num_sdf_layers"], multires=recon["multires"]),
        }


@torch.no_grad()
def reference_field(modules: dict, images, polar_deg: float, R: int, image_hw=(256, 256)):
    """The -sdf lattice [R, R, R] of 32 views [32, H, W, 3] in [0, 1]."""
    projs = torch.as_tensor(source_projections(polar_deg), device=images.device)
    feats = modules["fusion"](images)
    volume, _ = modules["sdf"].build_volume(feats, projs, image_hw)
    return field(modules["sdf"], volume, R)
