"""W8A8 int8 layers for the UNet (the opt-in ``UNetConfig.quant="int8"``).

Counterpart of ``one2345_tpu/diffusion/quantize.py``:

- ``QConv2d`` / ``QLinear`` hold an int8 weight (``weight_q``, torch's
  OIHW / (out, in) layout), an f32 scale per output channel
  (``weight_scale``) and an f32 bias.  Each call quantizes its input
  dynamically per tensor (absmax / 127 over the whole batch, the CFG pair
  included), takes the int8 x int8 -> int32 product, and dequantizes in the
  epilogue: ``acc.f32 * (x_scale * w_scale) + bias``, cast to the compute
  dtype.  The activation scale stays a device tensor (no host sync).
- ``quantize_unet_state``: f32 UNet state dict -> the state dict of
  ``UNetModel(quant=True)``, once per process (the f32 state stays the
  source for training and conversion).  Idempotent.
- ``SKIP_QUANT``: the layers that stay in the compute dtype, by leaf name,
  as in the JAX package: the time / embedding MLPs and the first and last
  convs, and every dense layer of the transformers.  So the shipped mode
  is conv-only: ResBlock ``in_conv`` / ``out_conv`` / ``skip``,
  ``proj_in`` / ``proj_out``, ``Downsample.op`` and ``Upsample.conv``.

The int8 product: the JAX package leaves it to XLA (an integer
``conv_general_dilated``), not to a Pallas kernel.  On the card it is
``torch._int_mm`` (cuBLASLt, int8 tensor cores) over an im2col of the
quantized NHWC activation for the 3x3 convs (a zero pad and 9 strided
slices: the zero pad is the quantized zero) and over the activation itself
for the 1x1 convs.  Its plain version, which the CPU takes, is exact:
every partial sum of int8 products is an integer below 127^2 * K <= 2^29,
so a float64 product returns it exactly.  A CUDA tensor takes the int8
route or raises.  ``QConv2d`` marks its three steps for the profiler
(``int8_quantize``: the activation's codes and im2col; ``int8_gemm``;
``int8_dequantize``: the epilogue), so a trace gives each its device time.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

# leaf module names whose weights stay in the compute dtype: the time and
# embedding MLPs and the first and last convs (a small share of the FLOPs,
# and conv_out writes eps directly), and every transformer / projection
# dense layer
_SKIP_SENSITIVE = ("time_embed_0", "time_embed_2", "emb_proj", "conv_in", "conv_out")
_SKIP_DENSE = ("to_q", "to_k", "to_v", "to_out", "proj", "ff_out")
SKIP_QUANT = _SKIP_SENSITIVE + _SKIP_DENSE
# scales are absmax * float32(1/127): XLA compiles the JAX package's
# ``absmax / 127.0`` to this product (one ulp apart in ~1 of 6 scales), and
# the JAX package always runs it compiled (the UNet's apply and the jitted
# ``quantize_unet_params``)
_INV_127 = float(np.float32(1.0) / np.float32(127.0))
_COUNT_LOCK = threading.Lock()  # guards int8_matmul.launch_count


def quantize_activation(x: torch.Tensor):
    """Dynamic symmetric per-tensor quantization -> (int8 x, f32 scale, a
    0-dim tensor on x's device).  Rounds half to even, as ``jnp.round``."""
    s = torch.clamp(x.abs().amax().float(), min=1e-8) * _INV_127
    xq = torch.div(x.float(), s).round_().clamp_(-127, 127).to(torch.int8)
    return xq, s


def quantize_kernel(w: torch.Tensor):
    """Per-output-channel symmetric absmax -> (int8 weight, f32 scale[out]).
    The output channel is axis 0 (conv OIHW, linear (out, in))."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=tuple(range(1, wf.dim()))), min=1e-8) * _INV_127
    wq = torch.div(wf, s.view(-1, *[1] * (wf.dim() - 1))).round_().clamp_(-127, 127)
    return wq.to(torch.int8), s


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of ``int8_matmul``: a [M, K] int8 times b [N, K]
    int8, transposed -> [M, N] int32, exact (integer partial sums below
    2^53 are exact in float64, in any order)."""
    return torch.matmul(a.double(), b.double().t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b[N, K]ᵀ -> [M, N] int32 with int32 accumulation.

    On the card: ``torch._int_mm`` (the row-major a against the
    column-major view of b), which needs K and N multiples of 8 and M > 16
    (fewer rows are padded with zero rows).  On the CPU: the plain version.
    Counts its launches in ``int8_matmul.launch_count``."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return int8_matmul_reference(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"int8_matmul runs on CUDA or the CPU, not {a.device}")
    M, K = a.shape
    N = b.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"int8_matmul on the card needs K and N multiples of 8, got K={K} N={N}")
    a = a.contiguous()
    if M <= 16:
        a = torch.cat([a, a.new_zeros(32 - M, K)])
    out = torch._int_mm(a, b.contiguous().t())
    _count_launch()
    return out[:M]


int8_matmul.launch_count = 0


def _count_launch():
    """One more ``int8_matmul.launch_count``, exact when several threads
    launch (``One2345Pipeline.run_many``)."""
    with _COUNT_LOCK:
        int8_matmul.launch_count += 1


def im2col_nhwc(xq: torch.Tensor, k: int, stride: int, padding: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, Ho, Wo, k*k*C], columns ordered (kh, kw, c),
    zero-padded by ``padding`` on each side (int8 safe: no ``unfold``)."""
    B, H, W, C = xq.shape
    Ho = (H + 2 * padding - k) // stride + 1
    Wo = (W + 2 * padding - k) // stride + 1
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    if k == 1:
        return xq[:, : stride * (Ho - 1) + 1 : stride, : stride * (Wo - 1) + 1 : stride].contiguous()
    return torch.cat(
        [
            xq[:, i : i + stride * (Ho - 1) + 1 : stride, j : j + stride * (Wo - 1) + 1 : stride]
            for i in range(k) for j in range(k)
        ],
        dim=-1,
    )


def dequantize(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
               dtype: torch.dtype) -> torch.Tensor:
    """acc.f32 * scale (+ bias) -> dtype, over the last axis."""
    y = torch.mul(acc, scale)  # int32 * f32 computes in f32
    if bias is not None:
        y.add_(bias)
    return y.to(dtype)


class QConv2d(nn.Module):
    """int8 conv over NCHW input: int8 weight, per-channel scale, f32 bias,
    dynamic per-tensor activation scale.  ``dtype`` is the output's (the
    UNet's compute dtype, set by ``unet.cast_compute``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.dtype = torch.float32
        k = kernel_size
        self.register_buffer("weight_q", torch.zeros(out_channels, in_channels, k, k, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_channels))
        self.register_buffer("bias", torch.zeros(out_channels))
        # weight_q as the GEMM's [out, kh * kw * in] operand, kept beside it
        self.register_buffer("weight_mat", torch.empty(0, dtype=torch.int8), persistent=False)
        self.register_load_state_dict_post_hook(lambda module, _: module.refresh())
        self.refresh()

    def refresh(self):
        """Rebuild the GEMM operand from ``weight_q`` (after a load)."""
        self.weight_mat = self.weight_q.permute(0, 2, 3, 1).reshape(self.out_channels, -1).contiguous()

    @classmethod
    def from_float(cls, conv: nn.Conv2d) -> "QConv2d":
        """The quantized twin of a square, symmetric-padded ``nn.Conv2d``."""
        q = cls(conv.in_channels, conv.out_channels, conv.kernel_size[0], conv.stride[0],
                conv.padding[0]).to(conv.weight.device)
        wq, ws = quantize_kernel(conv.weight.detach())
        bias = conv.bias.detach() if conv.bias is not None else torch.zeros_like(ws)
        q.load_state_dict({"weight_q": wq, "weight_scale": ws, "bias": bias.float()})
        return q

    def accumulate(self, x: torch.Tensor):
        """(int32 accumulator [B, Ho, Wo, out], activation scale) of x."""
        with record_function("int8_quantize"):
            xq, xs = quantize_activation(x)
            cols = im2col_nhwc(xq.permute(0, 2, 3, 1), self.kernel_size, self.stride, self.padding)
        B, Ho, Wo, K = cols.shape
        with record_function("int8_gemm"):
            acc = int8_matmul(cols.view(-1, K), self.weight_mat)
        return acc.view(B, Ho, Wo, self.out_channels), xs

    def forward(self, x):
        acc, xs = self.accumulate(x)
        with record_function("int8_dequantize"):
            y = dequantize(acc, xs * self.weight_scale, self.bias, self.dtype)
        return y.permute(0, 3, 1, 2)


class QLinear(nn.Module):
    """int8 linear over the last axis; see ``QConv2d``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = torch.float32
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def forward(self, x):
        xq, xs = quantize_activation(x)
        acc = int8_matmul(xq.reshape(-1, self.in_features), self.weight_q)
        y = dequantize(acc, xs * self.weight_scale, self.bias, self.dtype)
        return y.view(*x.shape[:-1], self.out_features)


def conv(quant: bool, name: str, in_channels: int, out_channels: int, kernel_size: int,
         stride: int = 1, padding: int = 0) -> nn.Module:
    """``nn.Conv2d``, or ``QConv2d`` where ``quant`` is set and ``name`` is
    not in ``SKIP_QUANT``."""
    if quant and name not in SKIP_QUANT:
        return QConv2d(in_channels, out_channels, kernel_size, stride, padding)
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=padding)


def dense(quant: bool, name: str, in_features: int, out_features: int,
          bias: bool = True) -> nn.Module:
    """``nn.Linear``, or ``QLinear`` as ``conv`` chooses."""
    if quant and name not in SKIP_QUANT:
        return QLinear(in_features, out_features, bias)
    return nn.Linear(in_features, out_features, bias=bias)


def is_quantized(state: dict) -> bool:
    return any(k.endswith(".weight_q") for k in state)


def quantize_unet_state(state: dict, skip_names=SKIP_QUANT) -> dict:
    """f32 UNet state dict -> the state dict of ``UNetModel(quant=True)``.

    Every conv / linear ``weight`` (2-D and up: norm weights are 1-D) of a
    module whose leaf name is not in ``skip_names`` becomes ``weight_q``
    (int8) + ``weight_scale`` (f32 [out]); biases, norms and the skipped
    weights pass through.  A state that is already quantized passes
    through unchanged."""
    if is_quantized(state):
        return dict(state)
    out = {}
    for name, t in state.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "weight" and t.dim() >= 2 and module.rsplit(".", 1)[-1] not in skip_names:
            out[f"{module}.weight_q"], out[f"{module}.weight_scale"] = quantize_kernel(t)
        else:
            out[name] = t
    return out
