from one2345_tpu_torch.core.config import (
    CLIPVisionConfig,
    DiffusionConfig,
    UNetConfig,
    VAEConfig,
)
from one2345_tpu_torch.core.profiling import Timer

__all__ = [
    "CLIPVisionConfig",
    "DiffusionConfig",
    "UNetConfig",
    "VAEConfig",
    "Timer",
]
