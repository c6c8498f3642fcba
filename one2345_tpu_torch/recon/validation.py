"""Full-image validation renders (val_step).

Counterpart of ``one2345_tpu/recon/validation.py`` (reference:
GenericTrainer.val_step, trainer_generic.py:359-622): the reference view
of a scene rendered in chunks of rays at lod0 or lod1, its color, depth
and normal images, their PSNR against the reference image and a
side-by-side panel.
"""

from __future__ import annotations

import numpy as np
import torch

from one2345_tpu_torch.geometry.rays import rays_from_camera
from one2345_tpu_torch.recon.renderer import RenderParams, render_rays


class Validator:
    """Chunked full-image renders of a ``ReconStage`` (on its device)."""

    def __init__(self, stage, n_rays_chunk: int = 1024):
        self.stage = stage
        self.chunk = n_rays_chunk

    @torch.no_grad()
    def _render_chunk(self, rays_o, rays_d, near, far, volume, mask_volume, feats, colors, w2cs,
                      intrinsics, query_cam_center, lod: int = 0) -> dict:
        st = self.stage
        cfg = st.config
        _, sdf_net, render_net, variance_net = st.lod_modules(lod)
        out = render_rays(
            lambda p: sdf_net.sdf(p, volume),
            lambda p: sdf_net.sdf_and_gradient(p, volume),
            render_net, variance_net(), rays_o, rays_d, near, far, volume, mask_volume,
            feats, colors, w2cs, intrinsics, tuple(cfg.image_hw), query_cam_center,
            RenderParams(n_samples=cfg.n_samples, n_importance=cfg.n_importance,
                         background_rgb=1.0 if cfg.use_white_bkgd else None),
        )
        normals = out["gradients"] * out["weights"][..., None]
        return {"color": out["color_fine"], "depth": out["depth"][:, 0],
                "normal": normals.sum(dim=1)}

    def render_view(self, images, cameras, view_idx: int = 0, H: int = 256, W: int = 256,
                    lod: int = 0) -> dict:
        """Render one view of a scene -> {'color' [H, W, 3], 'depth' [H, W],
        'normal' [H, W, 3]} numpy arrays.

        :param images: [V_src, H, W, 3] source views (cameras 1..V)
        :param cameras: a ``build_recon_cameras`` pack
        :param lod: 1 renders the fine lod: the lod1 volume under the
            pruned lod0 occupancy, on the lod1 networks (val_step with
            num_lods=2), pruned as the trainer and ``reconstruct`` prune
        """
        st = self.stage
        dev = st.device
        images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        V = images.shape[0]

        def cam(key, sel=slice(1, V + 1)):
            return torch.as_tensor(np.asarray(cameras[key][sel]), dtype=torch.float32,
                                   device=dev)

        feats = st.feature_maps(images)
        vol = st.conditional_volume(feats, cam("affines"))
        volume, mask_volume = vol["volume"], vol["mask"]
        if lod == 1:
            if st.config.lod1_prune_depth_filter:
                pre_mask = st.prune_occupancy_depth_filter(
                    volume, mask_volume, cam("affines"), cam("intrinsics"), cam("c2ws"),
                    cam("near_fars", 1), tuple(st.config.image_hw))
            else:
                pre_mask = st.prune_occupancy(volume, mask_volume)
            feats = st.feature_maps_lod1(images)
            vol = st.conditional_volume_lod1(feats, cam("affines"), pre_mask, volume)
            volume, mask_volume = vol["volume"], vol["mask"]

        c2w = cam("c2ws", view_idx)
        rays_o, rays_d = rays_from_camera(H, W, cam("intrinsics", view_idx), c2w)
        near, far = cam("near_fars", view_idx)
        w2cs, intrinsics = cam("w2cs"), cam("intrinsics")
        outs = {"color": [], "depth": [], "normal": []}
        for i in range(0, H * W, self.chunk):
            out = self._render_chunk(rays_o[i:i + self.chunk], rays_d[i:i + self.chunk], near,
                                     far, volume, mask_volume, feats, images, w2cs, intrinsics,
                                     c2w[:3, 3], lod)
            for k in outs:
                outs[k].append(out[k])
        res = {k: torch.cat(v).to(torch.float32).cpu().numpy() for k, v in outs.items()}
        return {"color": res["color"].reshape(H, W, 3), "depth": res["depth"].reshape(H, W),
                "normal": res["normal"].reshape(H, W, 3)}

    @staticmethod
    def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
        mse = float(np.mean((pred - gt) ** 2))
        return float(20.0 * np.log10(1.0 / np.sqrt(mse + 1e-12)))

    @staticmethod
    def panel(result: dict, gt: np.ndarray | None = None) -> np.ndarray:
        """[H, n * W, 3] side by side: (gt,) color, depth (min-max
        normalised), normal * 0.5 + 0.5 (save_visualization,
        trainer_generic.py:984-1050)."""
        d = result["depth"]
        dmin, dmax = float(d.min()), float(d.max() + 1e-9)
        depth_vis = np.repeat(((d - dmin) / (dmax - dmin))[..., None], 3, -1)
        normal_vis = np.clip(result["normal"] * 0.5 + 0.5, 0, 1)
        panels = [result["color"], depth_vis, normal_vis]
        if gt is not None:
            panels.insert(0, gt)
        return np.concatenate(panels, axis=1)
