from one2345_tpu_torch.core.config import (
    CLIPVisionConfig,
    DiffusionConfig,
    ReconConfig,
    UNetConfig,
    VAEConfig,
)
from one2345_tpu_torch.core.profiling import Timer

__all__ = [
    "CLIPVisionConfig",
    "DiffusionConfig",
    "ReconConfig",
    "UNetConfig",
    "VAEConfig",
    "Timer",
]
