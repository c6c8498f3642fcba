"""Reconstruction stage: 32 posed views -> vertex-colored mesh.

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

With ``num_lods=2`` (coarse-to-fine, export_mesh_step's lod1 path,
trainer_generic.py:903-934) steps 3-5 run on the fine lod: the lod0 field
is pruned to its near-surface voxels (``prune_occupancy``, or
``prune_occupancy_depth_filter``), the lod1 networks build a 192^3 volume
under the kept parents with the lod0 volume as extra cost channels, and
the mesh and its colors come from the lod1 SDF and blending net.  The
lod1 networks are separate modules with the lod0 architecture
(``fusion_lod1``, ``sdf_lod1``, ``render_lod1``, ``variance_lod1``); as in
the JAX stage, ``params`` without ``fusion_lod1`` / ``render_lod1`` /
``variance_lod1`` (a converted lod0 checkpoint) lets the lod0 module serve
lod1.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.geometry.projection import project_points
from one2345_tpu_torch.geometry.sampling import bilinear_sample
from one2345_tpu_torch.nn.init import flax_init_
from one2345_tpu_torch.nn.layers import set_compute_dtype
from one2345_tpu_torch.recon import mesh_extract
from one2345_tpu_torch.recon.fast_renderer import extract_depth_maps
from one2345_tpu_torch.recon.featurenet import PyramidFeatureFusion
from one2345_tpu_torch.recon.rendering_network import GeneralRenderingNetwork
from one2345_tpu_torch.recon.renderer import projector_features
from one2345_tpu_torch.recon.sdf_network import (
    LatentSDFLayer,
    SdfVolumeNetwork,
    SingleVarianceNetwork,
)

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


def _dilate7(occ: torch.Tensor) -> torch.Tensor:
    """Max over the 7^3 neighbourhood of an [X, Y, Z] {0, 1} grid (JAX's
    ``reduce_window(max, 7^3, SAME)``)."""
    return F.max_pool3d(occ[None, None], 7, stride=1, padding=3)[0, 0]


class ReconStage:
    """The reconstruction networks and the mesh export.

    :param params: state dicts keyed 'fusion', 'sdf', 'render', 'variance'
        and, with ``num_lods=2``, 'sdf_lod1' (and optionally 'fusion_lod1',
        'render_lod1', 'variance_lod1'); ``utils.convert_jax.recon_from_jax``
        makes them from the JAX ``ReconStage.params``; loaded with
        ``strict=True``.  None -> modules initialised from ``seed`` with
        flax's initialisers (``nn.init.flax_init_``), each SDF MLP
        geometrically (a sphere)
    :param device: None -> 'cuda' (raises without CUDA)
    :param f32_weights: with a bf16 config, keep every weight f32 and run
        the bf16 layers on their casts at use (training: flax's
        ``dtype=bfloat16`` over ``param_dtype`` f32); False casts those
        weights to bf16 once (inference)
    """

    def __init__(self, config: ReconConfig | None = None, params=None, seed: int = 0,
                 device=None, f32_weights: bool = False):
        self.config = cfg = config or ReconConfig()
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

        def sdf_net(lod):
            dims, voxel, comp, pre = (
                (cfg.vol_dims, cfg.voxel_size, cfg.d_pyramid_feature_compress, 0) if lod == 0
                else (cfg.lod1_vol_dims, cfg.lod1_voxel_size, cfg.lod1_d_compress,
                      cfg.regnet_d_out)
            )
            return SdfVolumeNetwork(
                vol_dims=dims, voxel_size=voxel, origin=cfg.partial_vol_origin, ch_in=cfg.ch_in,
                d_compress=comp, regnet_d_out=cfg.regnet_d_out, hidden_dim=cfg.hidden_dim,
                num_sdf_layers=cfg.num_sdf_layers, multires=cfg.multires, d_pre=pre,
            )

        def render_net():
            return GeneralRenderingNetwork(
                in_geometry_feat_ch=cfg.in_geometry_feat_ch,
                in_rendering_feat_ch=cfg.in_rendering_feat_ch,
                anti_alias_pooling=cfg.anti_alias_pooling,
            )

        # built on their device, from their own seed, leaving the global
        # generators as they were
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda), self.device:
            torch.manual_seed(seed)
            self.fusion = PyramidFeatureFusion()
            self.sdf_net = sdf_net(0)
            self.render_net = render_net()
            self.variance_net = SingleVarianceNetwork(init_val=cfg.variance_init_val)
            self.sdf_net_lod1 = self.fusion_lod1 = self.render_lod1 = self.variance_lod1 = None
            if cfg.num_lods > 1:
                self.sdf_net_lod1 = sdf_net(1)
                if params is None or "fusion_lod1" in params:
                    self.fusion_lod1 = PyramidFeatureFusion()
                if params is None or "render_lod1" in params:
                    self.render_lod1 = render_net()
                if params is None or "variance_lod1" in params:
                    self.variance_lod1 = SingleVarianceNetwork(init_val=cfg.variance_init_val)
        if params is None and self.device.type != "meta":
            # flax's initialisers, as the JAX stage built from a seed; the
            # SDF MLPs keep their geometric init, the blending nets take
            # he_normal
            gen = torch.Generator(device=self.device).manual_seed(seed)
            for module in self.modules().values():
                flax_init_(module, gen, he_normal=(GeneralRenderingNetwork,),
                           skip=(LatentSDFLayer, SingleVarianceNetwork))
        for name, module in self.modules().items():
            if params is not None:
                module.load_state_dict(params[name], strict=True)
            module.requires_grad_(False).eval()
        # the conv feature paths and the blending nets in the stage dtype;
        # the norms' statistics and the SDF MLPs stay f32.  With
        # ``f32_weights`` the weights stay f32 and are cast at each use
        self.f32_weights = f32_weights
        for name, module in self.modules().items():
            if name.startswith("variance"):
                continue
            parts = (module.compress, module.costreg) if name.startswith("sdf") else (module,)
            for part in parts:
                if f32_weights and self.dtype != torch.float32:
                    set_compute_dtype(part, self.dtype)
                    continue
                for m in part.modules():
                    if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear)):
                        m.to(self.dtype)

    def modules(self) -> dict:
        """{'fusion', 'sdf', 'render', 'variance'} and the lod1 modules the
        stage holds -> module (the keys of ``params``)."""
        mods = {
            "fusion": self.fusion,
            "sdf": self.sdf_net,
            "render": self.render_net,
            "variance": self.variance_net,
            "fusion_lod1": self.fusion_lod1,
            "sdf_lod1": self.sdf_net_lod1,
            "render_lod1": self.render_lod1,
            "variance_lod1": self.variance_lod1,
        }
        return {k: m for k, m in mods.items() if m is not None}

    def lod_modules(self, lod: int) -> tuple:
        """(fusion, sdf, render, variance) of one lod; at lod1 the lod0
        module serves where the stage holds no lod1 one."""
        if lod == 0:
            return self.fusion, self.sdf_net, self.render_net, self.variance_net
        if self.sdf_net_lod1 is None:
            raise ValueError("lod 1 needs a stage built with ReconConfig(num_lods=2)")
        return (self.fusion_lod1 or self.fusion, self.sdf_net_lod1,
                self.render_lod1 or self.render_net, self.variance_lod1 or self.variance_net)

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
    def feature_maps_lod1(self, images: torch.Tensor) -> torch.Tensor:
        """The lod1 pyramid features (obtain_pyramid_feature_maps lod=1,
        trainer_generic.py:1104-1125)."""
        return self.lod_modules(1)[0](images)

    @torch.no_grad()
    def conditional_volume_lod1(self, feature_maps, projs, pre_mask, pre_feats) -> dict:
        """The 192^3 volume under the pruned lod0 occupancy ``pre_mask``
        [96^3, 1], with the lod0 volume ``pre_feats`` as extra cost
        channels (get_conditional_volume, lod > 0)."""
        return self.lod_modules(1)[1].build_volume(
            feature_maps, projs, tuple(self.config.image_hw), False, pre_mask, pre_feats
        )

    def _pruning_field(self, volume_lod0: torch.Tensor) -> torch.Tensor:
        """The lod0 -sdf on the lod0 lattice, rounded to f16: the JAX stage
        prunes on its f16 ``field_grid``."""
        u = self.field_grid(volume_lod0, self.config.vol_dims[0])
        return u.to(torch.float16).to(torch.float32)

    @torch.no_grad()
    def prune_occupancy(self, volume_lod0: torch.Tensor, mask_lod0: torch.Tensor) -> torch.Tensor:
        """Near-surface voxels of the coarse lod (get_valid_sparse_coords_by_sdf,
        sparse_neus_renderer.py:822-879): |sdf| < ``lod1_prune_threshold``,
        dilated over 7^3, and inside the lod0 mask -> [X, Y, Z, 1] bool."""
        u = self._pruning_field(volume_lod0)
        occ = (u.abs() < self.config.lod1_prune_threshold).to(torch.float32)
        return (_dilate7(occ) > 0)[..., None] & (mask_lod0 > 0)

    @torch.no_grad()
    def lod0_depth_maps(self, u: torch.Tensor, intrinsics, c2ws, near_far, size_hw=(256, 256)):
        """[V, H/4, W/4] depth maps (0 where no surface was hit) sphere-traced
        through the lod0 field ``u`` (-sdf on the lod0 lattice) from near *
        1.5 to far (trainer_generic.py:443-449): intrinsics_l_4x."""
        H, W = size_hw
        K = intrinsics[:, :3, :3].clone()
        K[:, :2, :] *= 0.25
        near, far = near_far[0], near_far[1]
        depth, hit = extract_depth_maps((-u)[..., None], K, c2ws, H // 4, W // 4, near * 1.5,
                                        far)
        return depth * hit

    @torch.no_grad()
    def prune_occupancy_depth_filter(self, volume_lod0, mask_lod0, affines, intrinsics, c2ws,
                                     near_far, size_hw=(256, 256)) -> torch.Tensor:
        """Depth-filtered near-surface pruning (prune_depth_filter,
        filter_pts_by_depthmaps, sparse_neus_renderer.py:687-743): an |sdf|
        < tau voxel is kept only if some source view sees it within
        ``lod1_depth_plane_nums`` lod0 voxels of that view's sphere-traced
        depth, which drops the SDF's back-side shell; then dilated and
        masked as ``prune_occupancy``.

        :param affines: [V, 4, 4] K @ w2c; :param intrinsics: [V, 3, 3] or
            [V, 4, 4]; :param c2ws: [V, 4, 4]; :param near_far: [2]
        """
        cfg = self.config
        u = self._pruning_field(volume_lod0)
        occ_sdf = u.abs() < cfg.lod1_prune_threshold
        depth = self.lod0_depth_maps(u, intrinsics, c2ws, near_far, size_hw)[..., None]
        H, W = size_hw
        h, w = H // 4, W // 4
        near, far = near_far[0], near_far[1]
        pts = self.sdf_net.voxel_world_coords(u.device).reshape(-1, 3)
        band = cfg.lod1_depth_plane_nums * cfg.voxel_size
        ok = torch.zeros(pts.shape[0], dtype=torch.bool, device=u.device)
        for dmap, proj, c2w in zip(depth, affines, c2ws):
            x, y, z = project_points(pts, proj)
            gx = 2.0 * x / (W - 1) - 1.0
            gy = 2.0 * y / (H - 1) - 1.0
            inside = (gx.abs() <= 1.0) & (gy.abs() <= 1.0) & (z > 0)
            # corner to corner, (w - 1) / (W - 1): the reference renders at
            # a quarter of the size, F.interpolates to full size with
            # align_corners=True and grid_samples with align_corners=True
            # (trainer_generic.py:447-449 + filter_pts_by_depthmaps)
            px = (gx + 1.0) * 0.5 * (w - 1)
            py = (gy + 1.0) * 0.5 * (h - 1)
            d = bilinear_sample(dmap, px, py)[:, 0]
            dist = torch.linalg.vector_norm(pts - c2w[:3, 3], dim=-1)
            lo = torch.minimum(torch.maximum(d - band, near), far)
            hi = torch.minimum(torch.maximum(d + band, near), far)
            ok |= inside & (d > 0.5 * near) & (dist > lo) & (dist < hi)
        occ = (occ_sdf & ok.reshape(occ_sdf.shape)).to(torch.float32)
        return (_dilate7(occ) > 0)[..., None] & (mask_lod0 > 0)

    @torch.no_grad()
    def field_grid(self, volume: torch.Tensor, resolution: int, lod: int = 0) -> torch.Tensor:
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
            out = self.lod_modules(lod)[1].sdf_from_latent(pts, latent.reshape(-1, C))
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
                    intrinsics, lod: int = 0) -> torch.Tensor:
        """[N, 3] normalized vertices -> [N, 3] colors, from the
        view-independent projector + blending net (projector.py:231-425 +
        validate_colored_mesh) of the lod.  The maps are sampled in the
        stage dtype."""
        _, sdf_net, render_net, _ = self.lod_modules(lod)
        _, _, grads = sdf_net.sdf_and_gradient(verts, volume)
        normals = grads / (torch.linalg.vector_norm(grads, dim=-1, keepdim=True) + 1e-6)
        geo_feat, rgb_feat, ray_diff, mask = projector_features(
            verts[None], volume, mask_volume,
            feature_maps.to(self.dtype), color_maps.to(self.dtype),
            w2cs, intrinsics, tuple(self.config.image_hw), normals,
        )
        colors, _ = render_net(geo_feat, rgb_feat, ray_diff, mask)
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
            ('prune', 'feature_maps_lod1', 'conditional_volume_lod1' with
            ``num_lods=2``,) 'field_grid', 'field_to_host', 'marching_tets',
            'colors'
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
        lod = 0
        if cfg.num_lods > 1:
            with span("prune"):
                if cfg.lod1_prune_depth_filter:
                    pre_mask = self.prune_occupancy_depth_filter(
                        volume, mask_volume, cam("affines"), cam("intrinsics"), cam("c2ws"),
                        torch.as_tensor(cameras["near_fars"][1], dtype=torch.float32,
                                        device=dev),
                        tuple(cfg.image_hw),
                    )
                else:
                    pre_mask = self.prune_occupancy(volume, mask_volume)
            with span("feature_maps_lod1"):
                feats = self.feature_maps_lod1(images)
            with span("conditional_volume_lod1"):
                out = self.conditional_volume_lod1(feats, cam("affines"), pre_mask, volume)
                volume, mask_volume = out["volume"], out["mask"]
            lod = 1
        with span("field_grid"):
            u = self.gate_field(self.field_grid(volume, resolution, lod), mask_volume)
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
                                     images, w2cs, intrinsics, lod)
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
