"""Dataclass configs of the pipeline and its stages.

A copy of the diffusion dataclasses, ``ReconConfig``, ``SamConfig``,
``ElevationConfig`` and ``PipelineConfig`` of ``one2345_tpu/core/config.py``
(the port imports nothing of the JAX package).  Field names and defaults are
the same, so a config serialized by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


class _ConfigBase:
    def to_json(self) -> str:
        return json.dumps(_to_jsonable(self), indent=2)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def from_dict(cls, d: dict):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
            ft = fields[k].type
            if dataclasses.is_dataclass(ft) and isinstance(v, dict):
                v = ft.from_dict(v)
            kwargs[k] = v
        return cls(**kwargs)


@dataclass(frozen=True)
class UNetConfig(_ConfigBase):
    """Zero123-XL denoiser UNet (configs/sd-objaverse-finetune-c_concat-256.yaml
    of the original release: SD-1.x UNet with 8 input channels)."""

    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    dtype: str = "bfloat16"
    # 'none' or 'int8': the W8A8 int8 UNet, conv-only (diffusion/quantize.py);
    # inference only, its state derived from the f32 one
    quant: str = "none"


@dataclass(frozen=True)
class VAEConfig(_ConfigBase):
    """SD AutoencoderKL."""

    embed_dim: int = 4
    z_channels: int = 4
    base_channels: int = 128
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_channels: int = 3
    scale_factor: float = 0.18215
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class CLIPVisionConfig(_ConfigBase):
    """OpenAI CLIP ViT-L/14 image tower."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    embed_dim: int = 768
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class DiffusionConfig(_ConfigBase):
    """Latent-diffusion schedule + sampling defaults (75 stage-1 / 50
    stage-2 DDIM steps, CFG scale 3)."""

    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    ddim_steps_stage1: int = 75
    ddim_steps_stage2: int = 50
    ddim_eta: float = 1.0
    # 'ddim' (the original's), 'plms' or 'dpmpp' (DPM-Solver++(2M), a fast
    # mode: the CLI runs it at 30 / 25 steps); plms and dpmpp run at eta 0
    sampler: str = "ddim"
    cfg_scale: float = 3.0
    image_size: int = 256
    latent_size: int = 32
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    clip: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)


@dataclass(frozen=True)
class ReconConfig(_ConfigBase):
    """Generalizable SparseNeuS reconstruction.

    Defaults reproduce reconstruction/confs/one2345_lod0_val_demo.conf
    (lod0 inference config: 96^3 volume, voxel 2/95, 56-ch fused pyramid
    features compressed to 16, regnet 16-out, 64+64 samples, white bkgd).
    """

    # inputs
    image_hw: Sequence[int] = (256, 256)
    # volume
    vol_dims: Sequence[int] = (96, 96, 96)
    voxel_size: float = 2.0 / 95.0
    partial_vol_origin: Sequence[float] = (-1.0, -1.0, -1.0)
    # coarse-to-fine (conf sdf_network_lod1: 192^3, voxel 2/191, compress 8)
    num_lods: int = 1
    lod1_vol_dims: Sequence[int] = (192, 192, 192)
    lod1_voxel_size: float = 2.0 / 191.0
    lod1_d_compress: int = 8
    lod1_prune_threshold: float = 0.02
    # depth-map-filtered pruning (trainer_generic prune_depth_filter:131;
    # depth maps traced at size/4, band = d_plane_nums * voxel_size,
    # get_valid_sparse_coords_by_sdf_depthfilter call at :467-473)
    lod1_prune_depth_filter: bool = False
    lod1_depth_plane_nums: int = 12
    # feature nets
    ch_in: int = 56
    d_pyramid_feature_compress: int = 16
    regnet_d_out: int = 16
    hidden_dim: int = 128
    num_sdf_layers: int = 4
    multires: int = 6
    # rendering network
    in_geometry_feat_ch: int = 16
    in_rendering_feat_ch: int = 56
    anti_alias_pooling: bool = True
    # renderer
    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 0
    perturb: float = 1.0
    alpha_type: str = "div"
    variance_init_val: float = 0.2
    use_white_bkgd: bool = True
    # training-regime extension (0.0 = reference semantics): fraction of
    # training rays that query the blending net with the surface normal —
    # the direction the mesh-coloring pass uses (renderer.RenderParams.
    # normal_query_prob has the full rationale)
    normal_query_prob: float = 0.0
    # losses / training (one2345_lod0_val_demo.conf:35-56)
    learning_rate: float = 2e-4
    end_iter: int = 200_000
    n_rays: int = 512
    anneal_start: int = 0
    anneal_end: int = 25_000
    # lod1 training (one2345_lod_train.conf:50-51,62; trainer_generic.py
    # train_step:269-319).  NOTE the reference's get_weight quirk
    # (trainer_generic.py:1131-1134): for lod==1 the weight ramp runs from
    # anneal_end_lod1 to 2*anneal_end_lod1 (its start is the END value).
    anneal_start_lod1: int = 0
    anneal_end_lod1: int = 15_000
    # if_fix_lod0_networks: freeze lod0 (stop-gradient, no lod0 loss) and
    # train only the lod1 branch (trainer_generic.py:191-215,243-245)
    fix_lod0_networks: bool = False
    sdf_igr_weight: float = 0.1
    sdf_sparse_weight: float = 0.02
    sdf_decay_param: float = 100.0
    fg_bg_weight: float = 0.01
    # the reference hard-codes "iter_step > 50000" before the mask loss
    # kicks in (trainer_generic.py cal_losses_sdf) — sized for its 200k-iter
    # schedule.  Short-schedule runs (overfit benchmarks) scale it down.
    fg_bg_gate_iter: int = 50_000
    bg_ratio: float = 0.3
    # mesh extraction
    mesh_resolution: int = 256
    mesh_threshold: float = 0.0
    # the JAX package's packed-sign field fetch; the port keeps the f32
    # field and copies it to the host once, so it does not read this flag
    sparse_field_fetch: bool = True
    # compute dtype of the conv feature path (FPN fusion + compress +
    # cost-volume U-Net + blending net).  The SDF MLP always runs f32
    # (SdfVolumeNetwork.mlp_dtype) and the cost-volume accumulation is
    # f32 regardless.  Defaults f32 so every library construction keeps
    # reference numerics; the inference pipeline opts into bf16.
    dtype: str = "float32"


@dataclass(frozen=True)
class SamConfig(_ConfigBase):
    """SAM ViT-H (utils/sam_utils.py:9-16; weights sam_vit_h_4b8939.pth):
    ``segmentation.sam.SamStage``."""

    image_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280
    encoder_depth: int = 32
    encoder_heads: int = 16
    global_attn_indexes: Sequence[int] = (7, 15, 23, 31)
    window_size: int = 14
    prompt_embed_dim: int = 256
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class ElevationConfig(_ConfigBase):
    """LoFTR elevation estimation (elevation_estimate/utils/elev_est_api.py).

    As in the JAX package, the matcher and the solver read only ``focal``,
    ``image_size``, ``default_elevation`` and ``dtype``: the match size
    (480), the sweep grids ([30, 150) by 10, then ``e1 - 10 + arange(20)``)
    and the 0.2 match threshold are fixed in ``elevation/``.  The other
    fields are kept so that configs load in both packages."""

    match_size: int = 480
    focal: float = 280.0
    image_size: int = 256
    coarse_min: int = 30
    coarse_max: int = 150
    coarse_step: int = 10
    fine_span: int = 15
    match_threshold: float = 0.2
    default_elevation: float = 90.0  # fallback (run.py:32-36)
    # backbone/transformer compute dtype; the matching heads (dual-softmax
    # confidences, fine expected-coordinate heatmap) always run f32.  Bare
    # ElevationConfig stays f32; PipelineConfig opts inference into bf16.
    dtype: str = "float32"


@dataclass(frozen=True)
class PipelineConfig(_ConfigBase):
    """End-to-end image->mesh orchestration (run.py:99-119 semantics)."""

    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    # inference runs the recon conv path in bf16; bare ReconConfig() is f32
    recon: ReconConfig = field(
        default_factory=lambda: ReconConfig(dtype="bfloat16")
    )
    sam: SamConfig = field(default_factory=SamConfig)
    # inference runs the LoFTR backbone/transformer in bf16; bare
    # ElevationConfig() is f32
    elevation: ElevationConfig = field(
        default_factory=lambda: ElevationConfig(dtype="bfloat16")
    )
    half_precision: bool = True
    output_format: str = ".ply"
    mesh_resolution: int = 256
    seed: int = 0
