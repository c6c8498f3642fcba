"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

``flash_attention(q, k, v)`` computes softmax(q k^T / sqrt(D)) v and the
per-row logsumexp, on [B, T, H, D] tensors (the JAX package's layout).  It
is a ``torch.autograd.Function``, differentiable in q, k and v (not in the
logsumexp), as the JAX function is through its ``custom_vjp``:

- on CUDA tensors the forward launches ``csrc/flash_attention_fwd.cu`` and
  the backward ``csrc/flash_attention_bwd.cu`` (a dQ kernel and a dK/dV
  kernel; both built by ``_build`` at first use), or raises; it never falls
  back;
- on CPU tensors the forward runs ``attention_reference`` and the backward
  ``attention_backward_reference``, the plain PyTorch versions, which are
  also what the kernels are held against on the card.

The kernels replace the Pallas TPU kernels ``_flash_fwd_kernel``,
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` of
``one2345_tpu/ops/flash_attention.py``; each source's header gives its
bound on an H100 and its design.  ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv`` wrap one backward kernel each;
``flash_attention_backward`` computes Dsum = rowsum(dO o O) and calls both.
Launches are counted on the ``flash_attention`` function: ``launch_count``
(forward), ``dq_launch_count`` and ``dkv_launch_count`` (backward).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

_PADDED_WIDTHS = (48, 80, 160)  # template instances of the kernels
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


def softmax_grad_rowsum(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Dsum = rowsum(dO o O) in f32, laid out as the logsumexp: [B, H, T]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _fa2_terms(q, k, v, do, lse, dsum):
    """f32 [B, H, L, D] views of q, k and dO, and P and dS [B, H, T, S] of
    the FlashAttention-2 backward: P recomputed from ``lse``,
    dS = P o (dO V^T - Dsum)."""
    qf, kf, vf, dof = (x.to(torch.float32).transpose(1, 2) for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    p = torch.exp(s - lse.to(torch.float32)[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - dsum.to(torch.float32)[..., None])
    return qf, kf, dof, p, ds


def dq_reference(q, k, v, do, lse, dsum):
    """The dq kernel's plain version: dQ = dS K / sqrt(D), in q's dtype."""
    _, kf, _, _, ds = _fa2_terms(q, k, v, do, lse, dsum)
    dq = torch.matmul(ds, kf) / math.sqrt(q.shape[-1])
    return dq.transpose(1, 2).to(q.dtype)


def dkv_reference(q, k, v, do, lse, dsum):
    """The dkv kernel's plain version: (dK = dS^T Q / sqrt(D), dV = P^T dO)."""
    qf, _, dof, p, ds = _fa2_terms(q, k, v, do, lse, dsum)
    dk = torch.matmul(ds.transpose(-1, -2), qf) / math.sqrt(q.shape[-1])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def attention_backward_reference(q, k, v, o, lse, do):
    """Plain FlashAttention-2 backward in f32: P recomputed from ``lse``,
    Dsum = rowsum(dO o O), dP = dO V^T, dS = P o (dP - Dsum);
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), dV = P^T dO.

    :param q/o/do: [B, T, H, D]; :param k/v: [B, S, H, D]; :param lse: [B, H, T]
    :return: (dq, dk, dv) in the dtypes of q, k and v
    """
    dsum = softmax_grad_rowsum(o, do)
    return (dq_reference(q, k, v, do, lse, dsum), *dkv_reference(q, k, v, do, lse, dsum))


def _strides_ok(x: torch.Tensor) -> bool:
    """Unit stride along D, even strides elsewhere: the kernels move bf16 pairs."""
    return x.stride(-1) == 1 and not any(s % 2 for s in x.stride()[:3])


def kernel_width(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do=None) -> int:
    """Check that the kernels take these tensors (and the output gradient
    ``do`` of the backward, shaped as q); return their padded width.

    Raises ValueError on anything the kernels do not take: another dtype
    than bf16, mismatched shapes, D odd or above 160, a non-unit stride
    along D, odd strides or pointers (the kernels move bf16 pairs)."""
    named = (("q", q), ("k", k), ("v", v)) + ((("dO", do),) if do is not None else ())
    for name, x in named:
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, T, H, D], got {tuple(x.shape)}")
        if not _strides_ok(x):
            raise ValueError(f"flash_attention: {name} strides {x.stride()} unsupported")
    B, T, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    if do is not None and do.shape != q.shape:
        raise ValueError(f"flash_attention: dO {tuple(do.shape)} must match q {tuple(q.shape)}")
    if T < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")
    if D % 2 or D > _PADDED_WIDTHS[-1]:
        raise ValueError(f"flash_attention: head dim {D} must be even and <= 160")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B*H = {B * H} above {_MAX_GRID_Y}")
    return next(w for w in _PADDED_WIDTHS if w >= D)


def copy_bytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do=None) -> int:
    """Width of the kernels' copies from device to shared memory: 16 bytes
    when D is a multiple of 8 and every row of q, k, v (and, for the
    backward, dO) starts on a 16-byte boundary (strides multiples of 8
    elements, 16-byte aligned pointers), as the UNet's views do; else 4
    bytes (bf16 pairs)."""
    tensors = (q, k, v) if do is None else (q, k, v, do)
    if q.shape[-1] % 8 == 0 and all(
        x.data_ptr() % 16 == 0 and not any(s % 8 for s in x.stride()[:3]) for x in tensors
    ):
        return 16
    return 4


def _check_pointers(*tensors):
    for x in tensors:
        if x.device != tensors[0].device or x.data_ptr() % 4:
            raise ValueError("flash_attention: tensors must share a device and be 4-byte aligned")


@functools.cache
def _bind(name: str, symbol: str, n_pointers: int):
    """The C entry point ``symbol`` of kernel library ``name``, bound once:
    ``n_pointers`` pointers, then seven ints (B, H, T, S, D, the padded
    width, the copy width), the strides, the scale and the stream."""
    from one2345_tpu_torch.ops import _build

    fn = getattr(_build.load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    )
    return fn


def _strides(*tensors):
    """(batch, token, head) element strides of each tensor, as one C array."""
    values = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


@contextlib.contextmanager
def _on_device(device: torch.device):
    """With ``device`` current: its current CUDA stream, as an int."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def _check(err: int, symbol: str):
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with cudaError_t {err}")


def _launch_fwd(q, k, v):
    dp = kernel_width(q, k, v)
    _check_pointers(q, k, v)
    fn = _bind("flash_attention_fwd", "flash_attention_fwd_bf16", 5)
    B, T, H, D = q.shape
    S = k.shape[1]
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with _on_device(q.device) as stream:
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, T, S, D, dp, copy_bytes(q, k, v), _strides(q, k, v, o), 1.0 / math.sqrt(D),
            stream,
        )
    _check(err, "flash_attention_fwd")
    flash_attention.launch_count += 1
    return o, lse


def _launch_bwd(symbol, q, k, v, do, lse, dsum, outputs):
    dp = kernel_width(q, k, v, do)
    B, T, H, D = q.shape
    for name, x in (("lse", lse), ("dsum", dsum)):
        if x.dtype != torch.float32 or x.shape != (B, H, T) or not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous f32 [B, H, T]")
    _check_pointers(q, k, v, do, lse, dsum, *outputs)
    fn = _bind("flash_attention_bwd", symbol, 6 + len(outputs))
    with _on_device(q.device) as stream:
        err = fn(
            *(x.data_ptr() for x in (q, k, v, do, lse, dsum, *outputs)),
            B, H, T, k.shape[1], D, dp, copy_bytes(q, k, v, do),
            _strides(q, k, v, do, *outputs), 1.0 / math.sqrt(D), stream,
        )
    _check(err, symbol)


def flash_attention_bwd_dq(q, k, v, do, lse, dsum):
    """dQ of the attention backward: the dq kernel on CUDA tensors (bf16,
    counted in ``flash_attention.dq_launch_count``), its plain version on
    CPU tensors.

    :param q/do: [B, T, H, D]; :param k/v: [B, S, H, D]
    :param lse: the forward's logsumexp; :param dsum: ``softmax_grad_rowsum``
    """
    if _device_type(q, k, v, do, lse, dsum) == "cpu":
        return dq_reference(q, k, v, do, lse, dsum)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_attention_bwd_dq_bf16", q, k, v, do, lse, dsum, (dq,))
    flash_attention.dq_launch_count += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, dsum):
    """(dK, dV) of the attention backward: the dkv kernel on CUDA tensors
    (bf16, counted in ``flash_attention.dkv_launch_count``), its plain
    version on CPU tensors.  Arguments as ``flash_attention_bwd_dq``."""
    if _device_type(q, k, v, do, lse, dsum) == "cpu":
        return dkv_reference(q, k, v, do, lse, dsum)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_attention_bwd_dkv_bf16", q, k, v, do, lse, dsum, (dk, dv))
    flash_attention.dkv_launch_count += 1
    return dk, dv


def _device_type(*tensors) -> str:
    devices = {x.device.type for x in tensors}
    if devices == {"cpu"} or devices == {"cuda"}:
        return devices.pop()
    raise ValueError(f"flash_attention: tensors on {sorted(devices)}; need all cpu or all cuda")


def flash_attention_backward(q, k, v, o, lse, do):
    """(dq, dk, dv) of softmax(q k^T / sqrt(D)) v for the output gradient
    ``do``, given the forward's ``o`` and ``lse``: Dsum by one reduction,
    then the dq and the dkv kernel (CUDA) or their plain versions (CPU)."""
    _device_type(q, k, v, o, lse, do)
    if not _strides_ok(do):  # autograd hands dO over with the caller's strides
        do = do.contiguous()
    dsum = softmax_grad_rowsum(o, do)
    return (
        flash_attention_bwd_dq(q, k, v, do, lse, dsum),
        *flash_attention_bwd_dkv(q, k, v, do, lse, dsum),
    )


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            o, lse = attention_reference(q, k, v)
        else:
            o, lse = _launch_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        return flash_attention_backward(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q k^T / sqrt(D)) v and its logsumexp, differentiable in q, k
    and v.

    :param q: [B, T, H, D]; :param k/v: [B, S, H, D]
    :return: (o [B, T, H, D] in q's dtype, lse [B, H, T] f32, not differentiable)

    CPU tensors run the plain versions; CUDA tensors launch the kernels
    (bf16, D even and <= 160) and count the forward launch in
    ``flash_attention.launch_count`` and the backward ones in
    ``flash_attention.dq_launch_count`` and ``dkv_launch_count``.  Anything
    else raises.
    """
    _device_type(q, k, v)
    return _FlashAttention.apply(q, k, v)


flash_attention.launch_count = 0
flash_attention.dq_launch_count = 0
flash_attention.dkv_launch_count = 0
