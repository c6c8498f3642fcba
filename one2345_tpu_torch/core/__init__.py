from one2345_tpu_torch.core.config import (
    CLIPVisionConfig,
    DiffusionConfig,
    ElevationConfig,
    PipelineConfig,
    ReconConfig,
    SamConfig,
    UNetConfig,
    VAEConfig,
)
from one2345_tpu_torch.core.profiling import Timer, trace_annotation

__all__ = [
    "CLIPVisionConfig",
    "DiffusionConfig",
    "ElevationConfig",
    "PipelineConfig",
    "ReconConfig",
    "SamConfig",
    "UNetConfig",
    "VAEConfig",
    "Timer",
    "trace_annotation",
]
