"""The reference's arithmetic: float32 with TF32 off, or the fp8 control.

``round_(x)`` is what every conv, linear and attention product of the
reference applies to its operands.  In ``"f32"`` (the reference) it is the
identity.  In ``"fp8"`` (the control: the reference put in the program's
place one precision below the configuration's bfloat16) it rounds ``x`` to
float8 e4m3 with one scale per tensor (its largest magnitude mapped to
448, the format's largest finite value) and back, so the products see fp8
operands and accumulate in f32; the backward passes gradients straight
through the rounding.  ``round_state(x)`` is what the reference's
float32 state arithmetic (the sampler's step) applies to each result: the
identity in ``"f32"``, and in ``"fp8"`` a rounding to bfloat16, the
precision below float32.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("f32", "fp8")
E4M3_MAX = 448.0
_mode = ["f32"]


@contextlib.contextmanager
def use(mode: str):
    """Run the reference's products in ``mode`` inside the block."""
    if mode not in MODES:
        raise ValueError(f"precision mode {mode!r}: one of {MODES}")
    saved = _mode[0]
    _mode[0] = mode
    try:
        yield
    finally:
        _mode[0] = saved


def round_(x: torch.Tensor) -> torch.Tensor:
    if _mode[0] == "f32":
        return x
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    # the rounded value forward, the gradient of the identity backward
    return x + (q - x.detach())


def round_state(x: torch.Tensor) -> torch.Tensor:
    if _mode[0] == "f32":
        return x
    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def strict_f32():
    """float32 matmuls and cuDNN convs without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
