"""IBRNet-style view-blending rendering network.

Counterpart of ``one2345_tpu/recon/rendering_network.py`` (reference:
reconstruction/models/rendering_network.py:26-129): per-sample features of
every source view are blended by a masked softmax, with anti-alias pooling
weights from the ray-direction dot products.  The linears run in their
compute dtype (the stage's), the pooling weights in f32, as the JAX module
promotes them.  Kaiming-normal init, as the reference's ``weights_init``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from one2345_tpu_torch.nn.layers import compute_dtype


def _linear(cin: int, cout: int) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    nn.init.kaiming_normal_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class GeneralRenderingNetwork(nn.Module):
    def __init__(self, in_geometry_feat_ch: int = 16, in_rendering_feat_ch: int = 56,
                 anti_alias_pooling: bool = True):
        super().__init__()
        F_ = in_rendering_feat_ch + 3
        self.ray_dir_fc0 = _linear(4, 16)
        self.ray_dir_fc1 = _linear(16, F_)
        self.base_fc0 = _linear(in_geometry_feat_ch + 3 * F_, 64)
        self.base_fc1 = _linear(64, 32)
        self.vis_fc0 = _linear(32, 32)
        self.vis_fc1 = _linear(32, 33)
        self.vis_fc2_0 = _linear(32, 32)
        self.vis_fc2_1 = _linear(32, 1)
        self.rgb_fc0 = _linear(32 + 1 + 4, 16)
        self.rgb_fc1 = _linear(16, 8)
        self.rgb_fc2 = _linear(8, 1)
        self.anti_alias_pooling = anti_alias_pooling
        if anti_alias_pooling:
            self.s = nn.Parameter(torch.tensor(0.2))

    @staticmethod
    def _fc(lin: nn.Linear, x):
        return lin(x.to(compute_dtype(lin)))

    def forward(self, geometry_feat, rgb_feat, ray_diff, mask):
        """
        :param geometry_feat: [n_rays, n_samples, G]
        :param rgb_feat: [n_views, n_rays, n_samples, 3 + F] (colors ++ feats)
        :param ray_diff: [n_views, n_rays, n_samples, 4] (dir diff, dot)
        :param mask: [n_views, n_rays, n_samples] validity
        :return: (rgb [n_rays, n_samples, 3], valid_mask [n_rays, 1] bool)
        """
        fc = self._fc
        dt = compute_dtype(self.base_fc0)
        # -> [n_rays, n_samples, n_views, *]
        rgb_feat = torch.movedim(rgb_feat, 0, 2)
        ray_diff = torch.movedim(ray_diff, 0, 2)
        mask = torch.movedim(mask[..., None].to(dt), 0, 2)
        num_views = rgb_feat.shape[2]
        geo = geometry_feat[:, :, None, :].expand(-1, -1, num_views, -1)

        d = F.elu(fc(self.ray_dir_fc0, ray_diff))
        d = F.elu(fc(self.ray_dir_fc1, d))
        rgb_in = rgb_feat[..., :3]
        rgb_feat = rgb_feat + d

        if self.anti_alias_pooling:
            exp_dot = torch.exp(self.s.abs() * (ray_diff[..., 3:] - 1.0))
            weight = (exp_dot - exp_dot.amin(dim=2, keepdim=True)) * mask
        else:
            weight = mask
        weight = weight / (weight.sum(dim=2, keepdim=True) + 1e-8)

        mean = (rgb_feat * weight).sum(dim=2, keepdim=True)
        var = (weight * (rgb_feat - mean) ** 2).sum(dim=2, keepdim=True)
        globalfeat = torch.cat([mean, var], dim=-1).expand(-1, -1, num_views, -1)

        # the concatenations promote to the widest dtype, as jnp.concatenate
        x = torch.cat([geo, globalfeat, rgb_feat], dim=-1)
        x = F.elu(fc(self.base_fc0, x))
        x = F.elu(fc(self.base_fc1, x))

        x_vis = F.elu(fc(self.vis_fc0, x * weight))
        x_vis = F.elu(fc(self.vis_fc1, x_vis))
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        v2 = F.elu(fc(self.vis_fc2_0, x * vis))
        vis = torch.sigmoid(fc(self.vis_fc2_1, v2)) * mask

        x = torch.cat([x, vis, ray_diff], dim=-1)
        x = F.elu(fc(self.rgb_fc0, x))
        x = F.elu(fc(self.rgb_fc1, x))
        x = fc(self.rgb_fc2, x)
        x = x.masked_fill(mask == 0, -1e9)
        blend = torch.softmax(x, dim=2)
        rgb_out = (rgb_in * blend).sum(dim=2)

        # a point is valid if seen by >= 2 views, a ray if > 8 points are
        views_per_point = mask[..., 0].sum(dim=2)
        point_ok = (views_per_point >= 2).to(dt)
        valid_mask = point_ok.sum(dim=1, keepdim=True) > 8
        return rgb_out, valid_mask
