"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

``flash_attention(q, k, v)`` computes softmax(q k^T / sqrt(D)) v and the
per-row logsumexp, on [B, T, H, D] tensors (the JAX package's layout).  It
is a ``torch.autograd.Function``, differentiable in q, k and v (not in the
logsumexp), as the JAX function is through its ``custom_vjp``:

- on CUDA tensors the forward launches ``csrc/flash_attention_fwd.cu`` and
  the backward ``csrc/flash_attention_bwd.cu`` (a dQ kernel, which also
  computes Dsum = rowsum(dO o O), and a dK/dV kernel; both built by
  ``_build`` at first use), or raises; it never falls back.  Every kernel
  reads its bf16 inputs through TMA tensor maps: an input a map cannot
  describe (``tma_ready``) is first staged into an aligned copy
  (``stage_for_tma``), and the call is counted in
  ``flash_attention.staged_count`` (forward) or ``bwd_staged_count``
  (backward);
- on CPU tensors the forward runs ``attention_reference`` and the backward
  ``attention_backward_reference``, the plain PyTorch versions, which are
  also what the kernels are held against on the card.

The kernels replace the Pallas TPU kernels ``_flash_fwd_kernel``,
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` of
``one2345_tpu/ops/flash_attention.py``; each source's header gives its
bound on an H100 and its design.  ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv`` wrap one backward kernel each;
``flash_attention_backward`` calls both.  Launches are counted on the
``flash_attention`` function: ``launch_count`` (forward),
``dq_launch_count`` and ``dkv_launch_count`` (backward), ``staged_count``
and ``bwd_staged_count`` (calls whose inputs were staged first).  Each
increment holds one lock, so the counts are exact when several threads
launch (``One2345Pipeline.run_many``); they are read and reset as plain
attributes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading

import torch

_PADDED_WIDTHS = (48, 80, 160)  # template instances of the kernels
_COUNT_LOCK = threading.Lock()


def _count(name: str, n: int = 1):
    """Add ``n`` to the counter ``flash_attention.<name>``, atomically."""
    with _COUNT_LOCK:
        setattr(flash_attention, name, getattr(flash_attention, name) + int(n))


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


def dq_reference(q, k, v, do, lse, o):
    """The dq kernel's plain version: (dQ = dS K / sqrt(D) in q's dtype,
    Dsum = ``softmax_grad_rowsum(o, do)``)."""
    dsum = softmax_grad_rowsum(o, do)
    _, kf, _, _, ds = _fa2_terms(q, k, v, do, lse, dsum)
    dq = torch.matmul(ds, kf) / math.sqrt(q.shape[-1])
    return dq.transpose(1, 2).to(q.dtype), dsum


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
    dq, dsum = dq_reference(q, k, v, do, lse, o)
    return (dq, *dkv_reference(q, k, v, do, lse, dsum))


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
    return next(w for w in _PADDED_WIDTHS if w >= D)


def tma_ready(x: torch.Tensor) -> bool:
    """Whether the kernels' TMA tensor maps can describe ``x`` as it is: D a
    multiple of 8, unit stride along D, a 16-byte aligned base and (batch,
    token, head) strides that are positive multiples of 8 elements.  The UNet's q, k
    and v views, the forward's o and the output gradient of the train step
    are; anything else is staged first."""
    return x.shape[-1] % 8 == 0 and x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        s > 0 and s % 8 == 0 for s in x.stride()[:3]
    )


def stage_for_tma(x: torch.Tensor) -> torch.Tensor:
    """A copy of the [B, L, H, D] tensor ``x`` that ``tma_ready`` takes: a
    view of the first D columns of a fresh [B, L, H, D rounded up to 8]
    buffer (the rest of each row is never read)."""
    B, L, H, D = x.shape
    padded = torch.empty((B, L, H, -(-D // 8) * 8), dtype=x.dtype, device=x.device)
    out = padded[..., :D]
    out.copy_(x)
    return out


def stage_unready(*tensors) -> tuple[tuple[torch.Tensor, ...], bool]:
    """The tensors with every one that ``tma_ready`` refuses replaced by its
    staged copy, and whether any was."""
    ready = [tma_ready(x) for x in tensors]
    staged = tuple(x if ok else stage_for_tma(x) for x, ok in zip(tensors, ready))
    return staged, not all(ready)


def _check_pointers(*tensors):
    for x in tensors:
        if x.device != tensors[0].device or x.data_ptr() % 4:
            raise ValueError("flash_attention: tensors must share a device and be 4-byte aligned")


@functools.cache
def _bind(name: str, symbol: str, n_pointers: int, n_ints: int = 6):
    """The C entry point ``symbol`` of kernel library ``name``, bound once:
    ``n_pointers`` pointers, then ``n_ints`` ints (B, H, T, S, D and the
    padded width), the strides, the scale and the stream."""
    from one2345_tpu_torch.ops import _build

    fn = getattr(_build.load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
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
    (q, k, v), staged = stage_unready(q, k, v)
    _count("staged_count", staged)
    fn = _bind("flash_attention_fwd", "flash_attention_fwd_bf16", 5, 6)
    B, T, H, D = q.shape
    S = k.shape[1]
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with _on_device(q.device) as stream:
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, T, S, D, dp, _strides(q, k, v, o), 1.0 / math.sqrt(D), stream,
        )
    _check(err, "flash_attention_fwd")
    _count("launch_count")
    return o, lse


def _launch_bwd_kernel(symbol, dp, tensors, outputs):
    """Launch backward entry point ``symbol`` at padded width ``dp`` on
    ``tensors``: q, k, v, then O and dO (dq) or dO (dkv), then lse, then
    Dsum (dkv), the bf16 ones ``tma_ready``; raises on an O, dO, lse or Dsum
    the kernel does not take."""
    q, k = tensors[:2]
    B, T, H, D = q.shape
    for x in tensors[3:]:
        if x.dim() == 4:
            if x.shape != q.shape or x.dtype != q.dtype:
                raise ValueError("flash_attention: O and dO must be bf16 shaped as q")
        elif x.dtype != torch.float32 or x.shape != (B, H, T) or not x.is_contiguous():
            raise ValueError("flash_attention: lse and Dsum must be contiguous f32 [B, H, T]")
    _check_pointers(*tensors, *outputs)
    fn = _bind("flash_attention_bwd", symbol, len(tensors) + len(outputs))
    grids = [x for x in (*tensors, *outputs) if x.dim() == 4]
    with _on_device(q.device) as stream:
        err = fn(
            *(x.data_ptr() for x in (*tensors, *outputs)), B, H, T, k.shape[1], D, dp,
            _strides(*grids), 1.0 / math.sqrt(D), stream,
        )
    _check(err, symbol)


def _launch_dq(q, k, v, do, lse, o):
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dsum = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    _launch_bwd_kernel("flash_attention_bwd_dq_bf16", kernel_width(q, k, v, do),
                       (q, k, v, o, do, lse), (dq, dsum))
    _count("dq_launch_count")
    return dq, dsum


def _launch_dkv(q, k, v, do, lse, dsum):
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd_kernel("flash_attention_bwd_dkv_bf16", kernel_width(q, k, v, do),
                       (q, k, v, do, lse, dsum), (dk, dv))
    _count("dkv_launch_count")
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do):
    """Stage what a tensor map cannot take (counted once in
    ``bwd_staged_count``), then launch dq, which returns dQ and Dsum, and
    dkv on that Dsum: (dq, dk, dv)."""
    (q, k, v, o, do), staged = stage_unready(q, k, v, o, do)
    _count("bwd_staged_count", staged)
    dq, dsum = _launch_dq(q, k, v, do, lse, o)
    return (dq, *_launch_dkv(q, k, v, do, lse, dsum))


def flash_attention_bwd_dq(q, k, v, do, lse, o):
    """(dQ, Dsum) of the attention backward: the dq kernel on CUDA tensors
    (bf16, counted in ``flash_attention.dq_launch_count``; staged inputs in
    ``bwd_staged_count``), its plain version on CPU tensors.

    :param q/do/o: [B, T, H, D]; :param k/v: [B, S, H, D]
    :param lse: the forward's logsumexp; :param o: the forward's output
    :return: (dq [B, T, H, D], Dsum = rowsum(dO o O) f32 [B, H, T])
    """
    if _device_type(q, k, v, do, lse, o) == "cpu":
        return dq_reference(q, k, v, do, lse, o)
    (q, k, v, do, o), staged = stage_unready(q, k, v, do, o)
    _count("bwd_staged_count", staged)
    return _launch_dq(q, k, v, do, lse, o)


def flash_attention_bwd_dkv(q, k, v, do, lse, dsum):
    """(dK, dV) of the attention backward: the dkv kernel on CUDA tensors
    (bf16, counted in ``flash_attention.dkv_launch_count``; staged inputs in
    ``bwd_staged_count``), its plain version on CPU tensors.  Arguments as
    ``flash_attention_bwd_dq``, with Dsum (as it returns) in place of o."""
    if _device_type(q, k, v, do, lse, dsum) == "cpu":
        return dkv_reference(q, k, v, do, lse, dsum)
    (q, k, v, do), staged = stage_unready(q, k, v, do)
    _count("bwd_staged_count", staged)
    return _launch_dkv(q, k, v, do, lse, dsum)


def _device_type(*tensors) -> str:
    devices = {x.device.type for x in tensors}
    if devices == {"cpu"} or devices == {"cuda"}:
        return devices.pop()
    raise ValueError(f"flash_attention: tensors on {sorted(devices)}; need all cpu or all cuda")


def flash_attention_backward(q, k, v, o, lse, do):
    """(dq, dk, dv) of softmax(q k^T / sqrt(D)) v for the output gradient
    ``do``, given the forward's ``o`` and ``lse``: the dq kernel (which
    computes Dsum) then the dkv kernel on CUDA tensors, with no other pass
    between them but a counted staging copy where one is needed; their
    plain versions on CPU tensors."""
    if _device_type(q, k, v, o, lse, do) == "cpu":
        return attention_backward_reference(q, k, v, o, lse, do)
    return _launch_bwd(q, k, v, o, lse, do)


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
    ``flash_attention.launch_count`` (and in ``staged_count`` when q, k or
    v had to be staged for the forward's tensor maps) and the backward ones
    in ``flash_attention.dq_launch_count`` and ``dkv_launch_count`` (and in
    ``bwd_staged_count`` when the backward staged its inputs).
    Anything else raises.
    """
    _device_type(q, k, v)
    return _FlashAttention.apply(q, k, v)


flash_attention.launch_count = 0
flash_attention.staged_count = 0
flash_attention.dq_launch_count = 0
flash_attention.dkv_launch_count = 0
flash_attention.bwd_staged_count = 0
