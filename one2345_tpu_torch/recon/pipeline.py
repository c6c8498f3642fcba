"""Reconstruction stage, lod0: 32 posed views -> vertex-colored mesh.

Counterpart of ``ReconStage`` of ``one2345_tpu/recon/pipeline.py``
(reference: Runner.export_mesh -> GenericTrainer.export_mesh_step ->
validate_colored_mesh, exp_runner_generic_blender_val.py:553-587,
trainer_generic.py:827-979,1309-1380).  ``reconstruct`` runs:

1. ``feature_maps``: the fused 56-channel pyramid features of every view;
2. ``conditional_volume``: the 96^3 cost volume over the views, regularized
   by the masked 3-D U-Net;
3. ``field_grid``: the -sdf field on an R^3 lattice of [-1, 1]^3 (separable
   interpolation matmuls, then the SDF MLP in chunks), f32, gated by the
   occupancy mask on the card, then copied to the host once;
4. marching tetrahedra on the host (C++);
5. ``color_chunk``: vertex colors from the blending network, with normals
   from the SDF's gradient, in chunks of ``VERT_CHUNK`` vertices.

The coarse-to-fine lod1 path is not ported: ``num_lods > 1`` raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.recon import mesh_extract
from one2345_tpu_torch.recon.featurenet import PyramidFeatureFusion
from one2345_tpu_torch.recon.rendering_network import GeneralRenderingNetwork
from one2345_tpu_torch.recon.renderer import projector_features
from one2345_tpu_torch.recon.sdf_network import SdfVolumeNetwork, SingleVarianceNetwork

VERT_CHUNK = 65536  # vertices per color_chunk call (bounds the autograd graph)
FIELD_CHUNK = 64**3  # lattice points per SDF-MLP call of field_grid
# the field value of voxels outside the occupancy mask, below the threshold:
# the JAX package's int8 field stores them as -127 in units of 1e-3
OUTSIDE = 0.127


def _interp_matrix(R: int, X: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, X] linear-interpolation matrix from X samples of [-1, 1] (align
    corners) to R, and the R lattice coordinates; built on the CPU, so the
    card and the CPU use the same numbers."""
    lin = torch.linspace(-1.0, 1.0, R, dtype=torch.float32)
    pos = (lin + 1.0) * 0.5 * (X - 1)
    i0 = torch.floor(pos).clamp(0, X - 1).long()
    i1 = (i0 + 1).clamp(max=X - 1)
    t = (pos - i0.to(torch.float32))[:, None]
    eye = torch.eye(X, dtype=torch.float32)
    return eye[i0] * (1.0 - t) + eye[i1] * t, lin


class ReconStage:
    """The reconstruction networks and the lod0 mesh export.

    :param params: state dicts keyed 'fusion', 'sdf', 'render', 'variance'
        (``utils.convert_jax.recon_from_jax`` makes them from the JAX
        ``ReconStage.params``), loaded with ``strict=True``; None -> modules
        initialised from ``seed``, the SDF MLP geometrically (a sphere)
    :param device: None -> 'cuda' (raises without CUDA)
    """

    def __init__(self, config: ReconConfig | None = None, params=None, seed: int = 0,
                 device=None):
        self.config = cfg = config or ReconConfig()
        if cfg.num_lods > 1:
            raise NotImplementedError(
                f"ReconConfig.num_lods={cfg.num_lods}: only lod0 is ported (num_lods=1)"
            )
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        # built on their device, from their own seed, leaving the global
        # generators as they were
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda), self.device:
            torch.manual_seed(seed)
            self.fusion = PyramidFeatureFusion()
            self.sdf_net = SdfVolumeNetwork(
                vol_dims=cfg.vol_dims,
                voxel_size=cfg.voxel_size,
                origin=cfg.partial_vol_origin,
                ch_in=cfg.ch_in,
                d_compress=cfg.d_pyramid_feature_compress,
                regnet_d_out=cfg.regnet_d_out,
                hidden_dim=cfg.hidden_dim,
                num_sdf_layers=cfg.num_sdf_layers,
                multires=cfg.multires,
            )
            self.render_net = GeneralRenderingNetwork(
                in_geometry_feat_ch=cfg.in_geometry_feat_ch,
                in_rendering_feat_ch=cfg.in_rendering_feat_ch,
                anti_alias_pooling=cfg.anti_alias_pooling,
            )
            self.variance_net = SingleVarianceNetwork(init_val=cfg.variance_init_val)
        for name, module in self.modules().items():
            if params is not None:
                module.load_state_dict(params[name], strict=True)
            module.requires_grad_(False).eval()
        # the conv feature path and the blending net in the stage dtype; the
        # norms' statistics and the SDF MLP stay f32
        for module in (self.fusion, self.sdf_net.compress, self.sdf_net.costreg,
                       self.render_net):
            for m in module.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear)):
                    m.to(self.dtype)

    def modules(self) -> dict:
        """{'fusion', 'sdf', 'render', 'variance'} -> module (the keys of
        ``params``)."""
        return {
            "fusion": self.fusion,
            "sdf": self.sdf_net,
            "render": self.render_net,
            "variance": self.variance_net,
        }

    # ------------------------------------------------------------- stages
    @torch.no_grad()
    def feature_maps(self, images: torch.Tensor) -> torch.Tensor:
        """[V, H, W, 3] -> [V, H, W, 56] fused pyramid features (stage dtype)."""
        return self.fusion(images)

    @torch.no_grad()
    def conditional_volume(self, feature_maps: torch.Tensor, projs: torch.Tensor) -> dict:
        """Fused features + [V, 4, 4] projections -> {'volume' [X, Y, Z, 16],
        'mask' [X, Y, Z, 1]}."""
        return self.sdf_net.build_volume(feature_maps, projs, tuple(self.config.image_hw))

    @torch.no_grad()
    def field_grid(self, volume: torch.Tensor, resolution: int) -> torch.Tensor:
        """-sdf on the R^3 lattice of [-1, 1]^3 (extract_fields,
        sparse_neus_renderer.py:881-905), f32.

        Trilinear sampling on a regular lattice is separable: three [R, X]
        interpolation matmuls resize the latent volume, the same numbers as
        pointwise ``trilinear_sample``; the SDF MLP then runs over slabs of
        about ``FIELD_CHUNK`` points, so no activation spans the lattice."""
        X, C, R = volume.shape[0], volume.shape[-1], resolution
        Wm, lin = _interp_matrix(R, X)
        Wm, lin = Wm.to(volume.device), lin.to(volume.device)
        vol = volume.to(torch.float32)
        vol = torch.einsum("xa,aYZC->xYZC", Wm, vol)  # [R, Y, Z, C]
        vol = torch.einsum("yb,XbZC->XyZC", Wm, vol)  # [R, R, Z, C]
        slab = max(1, FIELD_CHUNK // (R * R))
        yy, zz = torch.meshgrid(lin, lin, indexing="ij")
        u = torch.empty((R, R, R), dtype=torch.float32, device=volume.device)
        for x0 in range(0, R, slab):
            xs = lin[x0:x0 + slab]
            S = xs.shape[0]
            latent = torch.einsum("zc,SYcC->SYzC", Wm, vol[x0:x0 + slab])  # [S, R, R, C]
            pts = torch.stack(
                [xs[:, None, None].expand(S, R, R), yy.expand(S, R, R), zz.expand(S, R, R)],
                dim=-1,
            ).reshape(-1, 3)
            out = self.sdf_net.sdf_from_latent(pts, latent.reshape(-1, C))
            u[x0:x0 + slab] = (-out[:, 0]).reshape(S, R, R)
        return u

    @torch.no_grad()
    def gate_field(self, u: torch.Tensor, mask_volume: torch.Tensor) -> torch.Tensor:
        """The field with voxels outside the occupancy mask set below the
        threshold (extract_geometry's empty-mask culling,
        sparse_neus_renderer.py:923-930).  A lattice point takes the mask of
        voxel trunc(i * X / R), that index computed in f32 as the JAX
        package computes it."""
        R = u.shape[0]
        occ = mask_volume[..., 0] > 0
        idx = (torch.arange(R, dtype=torch.float32) * (occ.shape[0] / R)).long()
        idx = idx.to(occ.device)
        occ_up = occ[idx][:, idx][:, :, idx]
        return torch.where(occ_up, u, self.config.mesh_threshold - OUTSIDE)

    @torch.no_grad()
    def color_chunk(self, verts, volume, mask_volume, feature_maps, color_maps, w2cs,
                    intrinsics) -> torch.Tensor:
        """[N, 3] normalized vertices -> [N, 3] colors, from the
        view-independent projector + blending net (projector.py:231-425 +
        validate_colored_mesh).  The maps are sampled in the stage dtype."""
        _, _, grads = self.sdf_net.sdf_and_gradient(verts, volume)
        normals = grads / (torch.linalg.vector_norm(grads, dim=-1, keepdim=True) + 1e-6)
        geo_feat, rgb_feat, ray_diff, mask = projector_features(
            verts[None], volume, mask_volume,
            feature_maps.to(self.dtype), color_maps.to(self.dtype),
            w2cs, intrinsics, tuple(self.config.image_hw), normals,
        )
        colors, _ = self.render_net(geo_feat, rgb_feat, ray_diff, mask)
        return colors[0]

    # --------------------------------------------------------------- driver
    def reconstruct(self, images, cameras: dict, resolution: int | None = None,
                    out_path: str | None = None, timer=None) -> dict:
        """32 posed RGB views -> vertex-colored mesh.

        :param images: [V, 256, 256, 3] in [0, 1] (white-composited), a
            tensor or an array
        :param cameras: the pack of ``geometry.cameras.build_recon_cameras``:
            index 0 is the reference view (not an input image), 1..V the
            source views
        :param timer: a ``core.profiling.Timer``; each step is one of its
            spans (synchronised), 'feature_maps', 'conditional_volume',
            'field_grid', 'field_to_host', 'marching_tets', 'colors'
        :return: dict(vertices [N, 3] world space, faces [M, 3] int32,
            colors [N, 3] in [0, 1]), numpy arrays
        """
        cfg = self.config
        resolution = resolution or cfg.mesh_resolution
        dev = self.device
        images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        V = images.shape[0]
        if cameras["w2cs"].shape[0] != V + 1:
            raise ValueError(
                f"{V} images need {V + 1} cameras (reference + sources), "
                f"got {cameras['w2cs'].shape[0]}"
            )

        def span(name):
            return timer.span(name) if timer is not None else contextlib.nullcontext()

        def cam(key):
            return torch.as_tensor(np.asarray(cameras[key][1:V + 1]), dtype=torch.float32,
                                   device=dev)

        with span("feature_maps"):
            feats = self.feature_maps(images)
        with span("conditional_volume"):
            out = self.conditional_volume(feats, cam("affines"))
            volume, mask_volume = out["volume"], out["mask"]
        with span("field_grid"):
            u = self.gate_field(self.field_grid(volume, resolution), mask_volume)
        with span("field_to_host"):
            u = u.cpu().numpy()
        with span("marching_tets"):
            verts_grid, faces = mesh_extract.marching_tetrahedra(u, cfg.mesh_threshold)
            verts_n = mesh_extract.grid_to_world(verts_grid, (-1, -1, -1), (1, 1, 1), resolution)
        with span("colors"):
            colors = np.zeros((len(verts_n), 3), np.float32)
            if len(verts_n):
                verts = torch.from_numpy(verts_n).to(dev)
                w2cs, intrinsics = cam("w2cs"), cam("intrinsics")
                colors = torch.cat([
                    self.color_chunk(verts[i:i + VERT_CHUNK], volume, mask_volume, feats,
                                     images, w2cs, intrinsics)
                    for i in range(0, len(verts), VERT_CHUNK)
                ]).to(torch.float32).cpu().numpy()
        colors = np.clip(colors, 0.0, 1.0)
        verts_world = mesh_extract.apply_mesh_transforms(
            verts_n, cameras.get("scale_mat"), cameras.get("trans_mat")
        )
        result = {"vertices": verts_world, "faces": faces, "colors": colors}
        if out_path:
            mesh_extract.save_ply(out_path, verts_world, faces, (colors * 255).astype(np.uint8))
            result["path"] = out_path
        return result
