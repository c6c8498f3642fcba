"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

``flash_attention(q, k, v)`` computes softmax(q k^T / sqrt(D)) v and the
per-row logsumexp, on [B, T, H, D] tensors (the JAX package's layout):

- on CUDA tensors it launches ``csrc/flash_attention_fwd.cu`` (built by
  ``_build`` at first use) or raises; it never falls back;
- on CPU tensors it runs ``attention_reference``, the plain PyTorch version
  (f32 matmul -> softmax -> matmul), which is also what the kernel is held
  against on the card.

The kernel replaces the Pallas TPU kernel ``_flash_fwd_kernel`` of
``one2345_tpu/ops/flash_attention.py``; the source's header gives its bound
on an H100 and its design.  The backward kernels of that file (training
only) are not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

_PADDED_WIDTHS = (48, 80, 160)  # template instances of the kernel
_MAX_GRID_Y = 65535


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain attention in f32.

    :param q: [B, T, H, D]; :param k/v: [B, S, H, D]
    :return: (o [B, T, H, D] in q's dtype, lse [B, H, T] f32)
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (x.to(torch.float32).transpose(1, 2) for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B, H, T, S]
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), vf)
    return o.transpose(1, 2).to(q.dtype), lse


def kernel_width(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Check that the kernel takes these tensors; return its padded width.

    Raises ValueError on anything the kernel does not take: another dtype
    than bf16, mismatched shapes, D odd or above 160, a non-unit stride
    along D, odd strides or pointers (the kernel moves bf16 pairs)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, T, H, D], got {tuple(x.shape)}")
        if x.stride(-1) != 1 or any(s % 2 for s in x.stride()[:3]):
            raise ValueError(f"flash_attention: {name} strides {x.stride()} unsupported")
    B, T, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    if T < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")
    if D % 2 or D > _PADDED_WIDTHS[-1]:
        raise ValueError(f"flash_attention: head dim {D} must be even and <= 160")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B*H = {B * H} above {_MAX_GRID_Y}")
    return next(w for w in _PADDED_WIDTHS if w >= D)


def _launch(q, k, v):
    from one2345_tpu_torch.ops import _build

    dp = kernel_width(q, k, v)
    for x in (q, k, v):
        if x.device != q.device or x.data_ptr() % 4:
            raise ValueError("flash_attention: q/k/v must share a device and be 4-byte aligned")
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    )
    B, T, H, D = q.shape
    S = k.shape[1]
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, o) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, T, S, D, dp, strides, 1.0 / math.sqrt(D), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with cudaError_t {err}")
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q k^T / sqrt(D)) v and its logsumexp.

    :param q: [B, T, H, D]; :param k/v: [B, S, H, D]
    :return: (o [B, T, H, D] in q's dtype, lse [B, H, T] f32)

    CPU tensors run ``attention_reference``; CUDA tensors launch the kernel
    (bf16, D even and <= 160) and count the launch in
    ``flash_attention.launch_count``.  Anything else raises.
    """
    devices = {x.device.type for x in (q, k, v)}
    if devices == {"cpu"}:
        return attention_reference(q, k, v)
    if devices != {"cuda"}:
        raise ValueError(f"flash_attention: q/k/v on {sorted(devices)}; need all cpu or all cuda")
    out = _launch(q, k, v)
    flash_attention.launch_count += 1
    return out


flash_attention.launch_count = 0
