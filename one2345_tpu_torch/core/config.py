"""Dataclass configs of the diffusion stage.

A copy of the diffusion dataclasses of ``one2345_tpu/core/config.py`` (the
port imports nothing of the JAX package).  Field names and defaults are the
same, so a config serialized by either package loads in the other.
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
    # 'none' only: the int8 fast mode of the JAX package is not ported yet
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
    # 'ddim' only: the plms / dpmpp samplers are not ported yet
    sampler: str = "ddim"
    cfg_scale: float = 3.0
    image_size: int = 256
    latent_size: int = 32
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    clip: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
