"""Per-shape finetuning of the reconstruction (the reference's ``-ft`` mode).

Counterpart of ``one2345_tpu/recon/finetune.py`` (reference:
FinetuneOctreeSdfNetwork, sparse_sdf_network.py:548-781;
BlendingRenderingNetwork, :784-907; PatchProjector,
models/patch_projector.py):

- the conditional volume itself is the optimised parameter, a dense
  tensor times the occupancy mask (gradients reach only the masked voxels,
  as in the reference's sparse parameterisation), with a TV regulariser;
- the SDF MLP warm-starts from a **copy** of the stage's ``sdf_layer``: the
  stage's own weights are not touched;
- a fresh ``BlendingRenderingNetwork`` predicts per-view blending logits
  (d_out 50, the most source images) over the colours the points project
  to in every view (``pixel_warp``); ``patch_warp`` warps reference-view
  patches into the views by the points' tangent-plane homographies.

``FinetuneTrainer.train_step`` renders a batch of rays with the stage's
variance and the fitted colour (``render_rays(fitted_color_fn=...)``) and
takes one Adam step (optax.adam's betas 0.9 / 0.999, eps 1e-8, no clip).
The render draws nothing (no stratified jitter, no normal-query mix), so
the step is deterministic; the JAX step's key reaches no draw either.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from one2345_tpu_torch.geometry.projection import sample_features_from_maps
from one2345_tpu_torch.geometry.sampling import bilinear_sample
from one2345_tpu_torch.nn.layers import WNDense, positional_encoding
from one2345_tpu_torch.recon.renderer import RenderParams, render_rays


class BlendingRenderingNetwork(nn.Module):
    """IDR-style MLP over (position, view-direction embedding, normal,
    geometry feature) -> per-view blending logits; the colour is the
    masked softmax blend of the views' colours, renormalised (+1e-8)."""

    def __init__(self, d_feature: int = 127, d_hidden: int = 128, n_layers: int = 3,
                 d_out: int = 50, multires_view: int = 4):
        super().__init__()
        self.n_layers = n_layers
        self.multires_view = multires_view
        dims = [3 + 3 * (2 * multires_view + 1) + 3 + d_feature] + [d_hidden] * n_layers + [d_out]
        for i in range(n_layers + 1):
            setattr(self, f"lin{i}", WNDense(dims[i], dims[i + 1]))

    def forward(self, position, normals, view_dirs, feature_vectors, pixel_colors, pixel_mask,
                patch_colors=None, patch_mask=None):
        """
        :param position, normals, view_dirs: [N, 3]
        :param feature_vectors: [N, d_feature]
        :param pixel_colors: [N, V, 3]; :param pixel_mask: [N, V]
        :param patch_colors: [N, V, P, 3]; :param patch_mask: [N, V, P]
        :return: (pixel_color [N, 3], pixel_ok [N, 1] bool, patch_color
            [N, P, 3] or None, patch_ok [N, 1] or None)
        """
        v_emb = positional_encoding(view_dirs, self.multires_view)
        x = torch.cat([position, v_emb, normals, feature_vectors], dim=-1)
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"lin{i}")(x))
        x = getattr(self, f"lin{self.n_layers}")(x)

        V = pixel_colors.shape[1]
        soft = torch.softmax(x[:, :V], dim=1)
        w = soft * pixel_mask
        w = w / (w.sum(dim=1, keepdim=True) + 1e-8)
        pixel_color = (pixel_colors * w[:, :, None]).sum(dim=1)
        pixel_ok = pixel_mask.sum(dim=1, keepdim=True) > 0

        patch_color = patch_ok = None
        if patch_colors is not None:
            P = patch_colors.shape[2]
            pm = (patch_mask.sum(dim=-1) > P - 1).to(soft.dtype)  # the whole patch visible
            wp = soft * pm
            wp = wp / (wp.sum(dim=1, keepdim=True) + 1e-8)
            patch_color = (patch_colors * wp[:, :, None, None]).sum(dim=1)
            patch_ok = pm.sum(dim=1, keepdim=True) > 0
        return pixel_color, pixel_ok, patch_color, patch_ok


def build_patch_offsets(h: int) -> np.ndarray:
    """[(2h+1)^2, 2] (dx, dy) pixel offsets, row-major over dy
    (models/rays.py build_patch_offset)."""
    r = np.arange(-h, h + 1)
    gy, gx = np.meshgrid(r, r, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1).astype(np.float32)


def patch_warp(pts, uv, normals, src_images, ref_K, src_Ks, ref_c2w, src_c2ws,
               h_patch_size: int = 3, plane_dist_thresh: float = 0.001):
    """Warp reference-view patches into the source views by each point's
    tangent-plane homography (PatchProjector.patch_warp,
    patch_projector.py:45-208); all views at once.

    H = K_src (R_rel + t_rel n^T / d) K_ref^-1 per point and view; a
    homography is kept where the plane is off the reference camera, off
    the source camera and in front of it (|d1| and |d1 - d2| above
    ``plane_dist_thresh``, d2 / d < 1), else the fronto-parallel K_src R_rel
    K_ref^-1 takes its place.  Taps off the image read zero.

    :param pts: [N, 3] surface points (world); :param uv: [N, 2] their
        reference-view pixel coordinates; :param normals: [N, 3] world normals
    :param src_images: [V, H, W, 3]; :param ref_K: [3, 3] (or 4x4);
        :param src_Ks: [V, 3, 3]; :param ref_c2w: [4, 4]; :param src_c2ws:
        [V, 4, 4]
    :return: (patch_colors [N, V, P, 3], patch_mask [N, V, P] bool)
    """
    N = pts.shape[0]
    Himg, Wimg = src_images.shape[1], src_images.shape[2]
    offsets = torch.as_tensor(build_patch_offsets(h_patch_size), dtype=pts.dtype,
                              device=pts.device)
    P = offsets.shape[0]

    inv_ref_K = torch.linalg.inv(ref_K[:3, :3])
    inv_ref_pose = torch.linalg.inv(ref_c2w)
    R_ref = inv_ref_pose[:3, :3]
    t_ref = inv_ref_pose[:3, 3:]
    rot_normals = (R_ref @ normals.T).T  # [N, 3]
    pts_ref = (R_ref @ pts.T + t_ref).T
    d1 = (rot_normals * pts_ref).sum(dim=-1)  # [N]
    sign = torch.where(d1 >= 0, 1.0, -1.0).to(d1.dtype)
    d = d1.abs().clamp(min=1e-8) * sign

    rel = torch.linalg.inv(src_c2ws) @ ref_c2w  # [V, 4, 4]
    R_rel = rel[:, :3, :3]
    t_rel = rel[:, :3, 3:]  # [V, 3, 1]
    cam_off = (-R_rel.transpose(1, 2) @ t_rel)[:, :, 0]  # source centres in the ref frame
    d2 = (rot_normals[None] * cam_off[:, None, :]).sum(dim=-1)  # [V, N]
    valid = ((d1.abs() > plane_dist_thresh)[None]
             & ((d1[None] - d2).abs() > plane_dist_thresh)
             & ((d2 / d[None]) < 1.0))
    K = src_Ks[:, :3, :3]
    outer = t_rel[:, None] * rot_normals[None, :, None, :] / d[None, :, None, None]  # [V, N, 3, 3]
    H = K[:, None] @ (R_rel[:, None] + outer) @ inv_ref_K
    fronto = K @ R_rel @ inv_ref_K  # [V, 3, 3]
    H = torch.where(valid[..., None, None], H, fronto[:, None])

    pix = uv[:, None, :] + offsets[None]  # [N, P, 2]
    ph = torch.cat([pix, torch.ones((N, P, 1), dtype=pix.dtype, device=pix.device)], dim=-1)
    warped = torch.einsum("vnij,npj->vnpi", H, ph)  # [V, N, P, 3]
    w = warped[..., 2:]
    w_uv = warped[..., :2] / w.abs().clamp(min=1e-8) * torch.sign(w)
    in_img = ((w_uv[..., 0] >= 0) & (w_uv[..., 0] <= Wimg - 1)
              & (w_uv[..., 1] >= 0) & (w_uv[..., 1] <= Himg - 1) & (warped[..., 2] > 0))
    colors = bilinear_sample(src_images, w_uv[..., 0], w_uv[..., 1])  # [V, N, P, 3]
    mask = in_img & valid[..., None]
    return colors.transpose(0, 1), mask.transpose(0, 1)


def pixel_warp(pts, images, w2cs, intrinsics, size_hw):
    """Every view's colour at the projections of ``pts`` [N, 3]
    (PatchProjector.pixel_warp): ([N, V, 3], [N, V] bool)."""
    colors, mask = sample_features_from_maps(pts, images, w2cs, intrinsics, size_hw)
    return colors.transpose(0, 1), mask.transpose(0, 1)


def tv_regularizer(volume: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked total variation of an [X, Y, Z, C] volume
    (sparse_sdf_network.py:658-678): sqrt of the channel mean of the
    squared forward differences (+1e-6), where a voxel and its three
    forward neighbours are all in the mask."""
    dx = (volume[1:] - volume[:-1]) ** 2
    dy = (volume[:, 1:] - volume[:, :-1]) ** 2
    dz = (volume[:, :, 1:] - volume[:, :, :-1]) ** 2
    tv = dx[:, :-1, :-1] + dy[:-1, :, :-1] + dz[:-1, :-1, :]
    m = mask[:-1, :-1, :-1] * mask[1:, :-1, :-1] * mask[:-1, 1:, :-1] * mask[:-1, :-1, 1:]
    tv = torch.sqrt(tv.mean(dim=-1, keepdim=True) + 1e-6) * m
    return tv.mean()


class FinetuneTrainer:
    """Optimise (volume, SDF MLP, blending net) on one shape: colour L1 +
    ``igr_weight`` eikonal + ``sparse_weight`` mean exp(-decay |sdf|) +
    ``tv_weight`` TV of the masked volume.

    :param stage: ``recon.pipeline.ReconStage`` (its ``sdf_layer`` is
        copied, its variance net read; neither is changed)
    :param seed: seed of the blending net's initialisation
    :param dtype: of the trained tensors and the scene (float64 gives a
        reference run; the stage's modules must then be float64 too)
    """

    def __init__(self, stage, lr: float = 5e-4, tv_weight: float = 1e-4,
                 igr_weight: float = 0.1, sparse_weight: float = 0.02, seed: int = 0,
                 dtype=torch.float32):
        self.stage = stage
        self.device = stage.device
        self.lr = lr
        self.tv_weight = tv_weight
        self.igr_weight = igr_weight
        self.sparse_weight = sparse_weight
        self.seed = seed
        self.dtype = dtype
        self.step = 0

    def init_state(self, volume, mask_volume, blend_params=None) -> None:
        """Start from the conditional ``volume`` [X, Y, Z, C] (times
        ``mask_volume`` [X, Y, Z, 1]), a copy of the stage's SDF MLP, and a
        blending net seeded from ``seed`` or loaded from ``blend_params``
        (a state dict, ``utils.convert_jax.finetune_from_jax``)."""
        dev, dt = self.device, self.dtype
        mask = torch.as_tensor(mask_volume).to(dev, dt)
        self.volume = nn.Parameter((torch.as_tensor(volume).to(dev, dt) * mask).detach().clone())
        # a copy of the stage's network, of which only the SDF MLP trains
        self.sdf_net = copy.deepcopy(self.stage.sdf_net).to(dt)
        self.sdf_layer = self.sdf_net.sdf_layer.requires_grad_(True)
        hidden = self.stage.config.hidden_dim
        cuda = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda), dev:
            torch.manual_seed(self.seed)
            self.blend_net = BlendingRenderingNetwork(d_feature=hidden - 1, d_hidden=hidden)
        self.blend_net.to(dt)
        if blend_params is not None:
            self.blend_net.load_state_dict(blend_params, strict=True)
        self._params = ([self.volume] + list(self.sdf_layer.parameters())
                        + list(self.blend_net.parameters()))
        self.optimizer = torch.optim.Adam(self._params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    # ---------------------------------------------------------------- step
    def loss_fn(self, mask_volume, scene: dict):
        """The loss of one batch of rays and its metrics {'loss', 'color',
        'eikonal', 'tv'}, differentiable in the trained tensors.

        :param scene: {'rays_o', 'rays_v', 'rays_color' [N, 3], 'near_far'
            [2], 'images' [V, H, W, 3], 'w2cs' [V, 4, 4], 'intrinsics'
            [V, 3, 3]} (arrays or tensors)
        """
        cfg = self.stage.config
        dev, dt = self.device, self.dtype
        sc = {k: torch.as_tensor(v).to(dev, dt) for k, v in scene.items()}
        mask = torch.as_tensor(mask_volume).to(dev, dt)
        volume = self.volume * mask
        imgs = sc["images"]

        def color_fn(pts, dirs, feat, grads):
            # eps inside the sqrt: masked samples carry exactly-zero
            # gradients, and d||x||/dx at 0 is NaN
            norm = torch.sqrt((grads**2).sum(dim=-1, keepdim=True) + 1e-12)
            normals = grads / (norm + 1e-6)
            pix_c, pix_m = pixel_warp(pts, imgs, sc["w2cs"], sc["intrinsics"],
                                      (imgs.shape[1], imgs.shape[2]))
            return self.blend_net(pts, normals, dirs, feat, pix_c, pix_m.to(pix_c.dtype))[0]

        out = render_rays(
            lambda p: self.sdf_net.sdf(p, volume),
            lambda p: self.sdf_net.sdf_and_gradient(p, volume, create_graph=True),
            None,
            self.stage.variance_net(),
            sc["rays_o"], sc["rays_v"], sc["near_far"][0], sc["near_far"][1],
            volume, mask,
            imgs[..., :1],  # unread on the fitted path
            imgs, sc["w2cs"], sc["intrinsics"], (imgs.shape[1], imgs.shape[2]),
            sc["rays_o"][0],
            RenderParams(n_samples=cfg.n_samples, n_importance=cfg.n_importance,
                         background_rgb=1.0 if cfg.use_white_bkgd else None),
            fitted_color_fn=color_fn,
        )
        cl = (out["color_fine"] - sc["rays_color"]).abs().mean()
        eik = out["gradient_error_fine"]
        sparse = torch.exp(-cfg.sdf_decay_param * out["sdf"].abs()).mean()
        tv = tv_regularizer(volume, mask)
        loss = cl + self.igr_weight * eik + self.sparse_weight * sparse + self.tv_weight * tv
        return loss, {"loss": loss, "color": cl, "eikonal": eik, "tv": tv}

    def train_step(self, mask_volume, scene: dict) -> dict:
        """Forward, backward and one Adam step; the step count advances.
        Returns the metrics as detached tensors on the device (no host
        sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(mask_volume, scene)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}
