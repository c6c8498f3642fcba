"""The image resizes of PIL and OpenCV that preprocessing relies on, in torch.

The JAX package resizes on the host with PIL (``Image.thumbnail`` and
``Image.resize`` with LANCZOS or BICUBIC) and OpenCV (``cv2.resize``
INTER_LINEAR); the port has neither library, so this module reproduces
their arithmetic on a torch device:

- ``pil_resize``: PIL's two-pass 8-bit convolution resampler
  (``Resample.c``): per output pixel the filter taps of the input span,
  normalised, converted to 22-bit fixed point (rounded half away from
  zero), the horizontal pass first, each pass rounded to uint8
  (``(sum + 2^21) >> 22``, clipped).  The sums are exact integers, so the
  products run as float64 matmuls (exact below 2^53) and give the same
  bytes on the CPU and the card.  RGBA is resampled premultiplied
  (``RGBA -> RGBa -> RGBA``, PIL's ``Convert.c`` formulas);
- ``pil_reduce``: ``Image.reduce``'s box average (``Reduce.c``), which
  ``Image.thumbnail`` runs first when a side shrinks by ``2 * reducing_gap``
  or more (RGB only: PIL drops ``reducing_gap`` on the RGBa path);
- ``thumbnail_size``: ``Image.thumbnail``'s aspect rounding;
- ``cv2_resize_linear``: ``cv2.resize`` INTER_LINEAR with half-pixel
  centres and no antialias: 11-bit fixed point for uint8 (the horizontal
  pass in int32, the vertical one as ``((b0 * (S0 >> 4)) >> 16 + (b1 *
  (S1 >> 4)) >> 16 + 2) >> 2``), plain two-tap arithmetic for float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRECISION_BITS = 22  # PIL Resample.c: 32 - 8 - 2
RESIZE_COEF_BITS = 11  # OpenCV INTER_RESIZE_COEF_BITS


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


def pil_coefficients(in_size: int, in0: float, in1: float, out_size: int,
                     method: str) -> np.ndarray:
    """[out_size, in_size] int64 fixed-point taps of one pass (PIL's
    ``precompute_coeffs`` + ``normalize_coeffs_8bpc``); the box ``in0, in1``
    is in input pixels (float32, as PIL parses it)."""
    fn, support = FILTERS[method]
    in0, in1 = float(np.float32(in0)), float(np.float32(in1))
    scale = float(np.float32(in1) - np.float32(in0)) / out_size
    filterscale = max(scale, 1.0)
    support *= filterscale
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = in0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)
        for x, wx in enumerate(w):
            k = wx / ww if ww != 0.0 else wx
            out[xx, xmin + x] = int(-0.5 + k * (1 << PRECISION_BITS)) if k < 0 else int(
                0.5 + k * (1 << PRECISION_BITS))
    return out


def _pil_pass(x: torch.Tensor, coef: np.ndarray, axis: int) -> torch.Tensor:
    """One rounded pass along ``axis`` (0 rows, 1 columns) of [H, W, C]
    float64 integer values."""
    k = torch.as_tensor(coef, dtype=torch.float64, device=x.device)
    y = torch.einsum("hwc,ow->hoc" if axis == 1 else "hwc,oh->owc", x, k)
    y = torch.floor((y + float(1 << (PRECISION_BITS - 1))) / float(1 << PRECISION_BITS))
    return y.clamp_(0.0, 255.0)


def premultiply(x: torch.Tensor) -> torch.Tensor:
    """RGBA -> RGBa (PIL): c * a / 255 as ``((t >> 8) + t) >> 8``, t = c a + 128."""
    x = x.to(torch.int64)
    t = x[..., :3] * x[..., 3:] + 128
    return torch.cat([((t >> 8) + t) >> 8, x[..., 3:]], dim=-1)


def unpremultiply(x: torch.Tensor) -> torch.Tensor:
    """RGBa -> RGBA (PIL): min(255, 255 c // a) where 0 < a < 255."""
    x = x.to(torch.int64)
    a = x[..., 3:]
    rgb = torch.clamp(255 * x[..., :3] // a.clamp(min=1), max=255)
    rgb = torch.where((a == 0) | (a == 255), x[..., :3], rgb)
    return torch.cat([rgb, a], dim=-1)


def pil_resize(image, size: tuple[int, int], method: str = "lanczos",
               box: tuple[float, float, float, float] | None = None, *, device) -> np.ndarray:
    """``Image.fromarray(image).resize(size, method, box)`` of an 8-bit
    [H, W, C] array (C = 3 RGB, 4 RGBA, premultiplied as PIL does) ->
    [h, w, C] uint8, computed on ``device``; ``size`` is (w, h) as PIL
    takes it."""
    x = torch.as_tensor(np.ascontiguousarray(image), device=device)
    H, W, C = x.shape
    w, h = size
    box = (0.0, 0.0, float(W), float(H)) if box is None else tuple(map(float, box))
    if (w, h) == (W, H) and box == (0.0, 0.0, float(W), float(H)):
        return np.asarray(image, np.uint8).copy()
    rgba = C == 4
    y = (premultiply(x) if rgba else x).to(torch.float64)
    if w != W or box[0] or box[2] != w:
        y = _pil_pass(y, pil_coefficients(W, box[0], box[2], w, method), axis=1)
    if h != H or box[1] or box[3] != h:
        y = _pil_pass(y, pil_coefficients(H, box[1], box[3], h, method), axis=0)
    y = y.to(torch.int64)
    if rgba:
        y = unpremultiply(y)
    return y.to(torch.uint8).cpu().numpy()


def _reduce_multiplier(n: int) -> int:
    """PIL Reduce.c ``division_UINT32(n, 8)``: 2^32 / (256 n) in float32."""
    return int(np.float32(2.0 ** 32) / np.float32(256 * n))


def pil_reduce(image, factor: tuple[int, int], *, device) -> np.ndarray:
    """``Image.reduce((fx, fy))`` of a [H, W, C] uint8 array on ``device``:
    the mean of each fx x fy box (partial boxes at the right and bottom
    edges average what they hold), ``((sum + n // 2) * mult(n)) >> 24``."""
    fx, fy = factor
    x = torch.as_tensor(np.ascontiguousarray(image), device=device).to(torch.int64)
    H, W, C = x.shape
    oh, ow = -(-H // fy), -(-W // fx)
    x = torch.nn.functional.pad(x, (0, 0, 0, ow * fx - W, 0, oh * fy - H))
    sums = x.reshape(oh, fy, ow, fx, C).sum(dim=(1, 3))
    ny = torch.full((oh,), fy, dtype=torch.int64, device=x.device)
    nx = torch.full((ow,), fx, dtype=torch.int64, device=x.device)
    ny[-1], nx[-1] = H - (oh - 1) * fy, W - (ow - 1) * fx
    n = ny[:, None] * nx[None, :]
    table = torch.as_tensor([0] + [_reduce_multiplier(i) for i in range(1, fx * fy + 1)],
                            dtype=torch.int64, device=x.device)
    out = ((sums + (n // 2)[..., None]) * table[n][..., None]) >> 24
    return out.to(torch.uint8).cpu().numpy()


def thumbnail_size(width: int, height: int, size: int) -> tuple[int, int] | None:
    """``Image.thumbnail([size, size])``'s output (w, h), or None when the
    image already fits."""
    x = y = size
    if x >= width and y >= height:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def _cv2_taps(in_size: int, out_size: int, clamp_weights: bool, fixed_point: bool):
    """(i0, i1, w0, w1) of one INTER_LINEAR pass: source indices (clamped)
    and float32 weights; ``clamp_weights`` zeroes the fraction at the
    edges, as OpenCV does for columns (rows keep it and clamp indices).
    The uint8 path rounds the source coordinate to float32 before taking
    its fraction, the float32 path takes the fraction in double."""
    scale = 1.0 / (out_size / in_size)
    f = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    if fixed_point:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(f.dtype)).astype(np.float32)
    if clamp_weights:
        lo, hi = s < 0, s >= in_size - 1
        f[lo | hi] = 0.0
        s[lo], s[hi] = 0, in_size - 1
    i0 = np.clip(s, 0, in_size - 1)
    i1 = np.clip(s + 1, 0, in_size - 1)
    return i0, i1, (np.float32(1.0) - f).astype(np.float32), f


def cv2_resize_linear(image, size: tuple[int, int], *, device) -> torch.Tensor:
    """``cv2.resize(image, size, interpolation=cv2.INTER_LINEAR)`` of a
    [H, W] or [H, W, C] array or tensor (uint8 or float32); ``size`` is
    (w, h).  Returns a tensor of the input's dtype on ``device``."""
    x = torch.as_tensor(image, device=device)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    H, W, _ = x.shape
    w, h = size
    dev = x.device
    fixed = x.dtype == torch.uint8
    xi0, xi1, a0, a1 = _cv2_taps(W, w, clamp_weights=True, fixed_point=fixed)
    yi0, yi1, b0, b1 = _cv2_taps(H, h, clamp_weights=False, fixed_point=fixed)

    def idx(a):
        return torch.as_tensor(a, device=dev)

    if fixed:
        scale = 1 << RESIZE_COEF_BITS

        def fix(c):  # saturate_cast<short>(c * 2048): round half to even
            return idx(np.rint(c * np.float32(scale)).astype(np.int64))

        s = x.to(torch.int64)
        hx = s[:, idx(xi0)] * fix(a0)[None, :, None] + s[:, idx(xi1)] * fix(a1)[None, :, None]
        s0, s1 = hx[idx(yi0)] >> 4, hx[idx(yi1)] >> 4
        B0, B1 = fix(b0)[:, None, None], fix(b1)[:, None, None]
        out = (((B0 * s0) >> 16) + ((B1 * s1) >> 16) + 2) >> 2
        out = out.clamp(0, 255).to(torch.uint8)
    elif x.dtype == torch.float32:
        hx = x[:, idx(xi0)] * idx(a0)[None, :, None] + x[:, idx(xi1)] * idx(a1)[None, :, None]
        out = hx[idx(yi0)] * idx(b0)[:, None, None] + hx[idx(yi1)] * idx(b1)[:, None, None]
    else:
        raise TypeError(f"cv2_resize_linear takes uint8 or float32, got {x.dtype}")
    return out[..., 0] if squeeze else out
