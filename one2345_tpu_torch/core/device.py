"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` -> the card; raises when CUDA is absent (pass 'cpu' to run
    the plain path on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: one2345_tpu_torch runs on the card by "
                "default; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)
