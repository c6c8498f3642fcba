"""Where the port's entry points run."""

from __future__ import annotations

import os

import torch


def resolve_device(device) -> torch.device:
    """``None`` -> the card: ``cuda:LOCAL_RANK`` under ``torchrun`` (one card
    per rank), else ``cuda``; raises when CUDA is absent (pass 'cpu' to run
    the plain path on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: one2345_tpu_torch runs on the card by "
                "default; pass device='cpu' to run on the CPU"
            )
        local = os.environ.get("LOCAL_RANK")
        device = f"cuda:{int(local)}" if local is not None else "cuda"
    return torch.device(device)
