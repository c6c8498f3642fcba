"""one2345_tpu_torch.ops.flash_attention against the JAX flash attention.

On the CPU the wrapper runs its plain versions, ``attention_reference`` and
``attention_backward_reference``; they are held against the Pallas kernels
(interpret mode, forward and ``jax.grad``), XLA's attention and torch
autograd.  The CUDA kernels themselves are compared with the same plain
versions on the card (tests/test_torch_cuda.py, which imports no JAX, and
chip_smoke.py).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.ops import flash_attention as jax_fa
from one2345_tpu_torch.core import compile_cache
from one2345_tpu_torch.core.config import DiffusionConfig
from one2345_tpu_torch.diffusion import unet as unet_mod
from one2345_tpu_torch.ops import _build
from one2345_tpu_torch.ops import flash_attention as fa
from tests.torch_port_helpers import max_err


def _qkv(B, T, S, H, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v


@pytest.fixture
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    )


@pytest.mark.parametrize("T,S,D", [(256, 256, 40), (256, 256, 80)])
def test_reference_matches_pallas_kernel(T, S, D, interpret_pallas):
    q, k, v = _qkv(2, T, S, 3, D, seed=D)
    out_jax = jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_kv=128
    )
    out, lse = fa.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    assert lse.shape == (2, 3, T) and lse.dtype == torch.float32
    # the Pallas dots run at MXU precision (bf16 inputs) even in interpret
    # mode: the bound of tests/test_flash_attention.py
    assert max_err(out, out_jax) < 8e-3


@pytest.mark.parametrize("T,S", [(64, 64), (16, 16), (64, 16)])
def test_reference_matches_xla_ragged(T, S):
    """UNet level 2 / middle shapes (d=160, below any 64-row tile) and a
    ragged T != S, against XLA attention and logsumexp at full precision."""
    q, k, v = _qkv(2, T, S, 8, 160, seed=T + S)
    with jax.default_matmul_precision("highest"):
        o_jax = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        s = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(160.0)
        lse_jax = jax.nn.logsumexp(s, axis=-1)
    out, lse = fa.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    assert max_err(out, o_jax) < 1e-5
    assert max_err(lse, lse_jax) < 1e-5


def test_wrapper_on_cpu_runs_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 64, 2, 40, seed=3))
    before = fa.flash_attention.launch_count
    out, lse = fa.flash_attention(q, k, v)
    ref_out, ref_lse = fa.attention_reference(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert fa.flash_attention.launch_count == before


@pytest.mark.parametrize(
    "D,width", [(40, 48), (48, 48), (64, 80), (80, 80), (96, 160), (160, 160)]
)
def test_kernel_width_pads_to_the_next_instance(D, width):
    q = torch.zeros(2, 16, 8, D, dtype=torch.bfloat16)
    assert fa.kernel_width(q, q, q) == width


@pytest.mark.parametrize(
    "case",
    ["float32", "odd_d", "wide_d", "shape_mismatch", "strided_d", "do_shape", "do_float32"],
)
def test_kernel_width_rejects_what_the_kernel_does_not_take(case):
    bf = torch.bfloat16
    q = k = v = torch.zeros(2, 16, 8, 40, dtype=bf)
    do = None
    if case == "float32":
        q = q.float()
    elif case == "odd_d":
        q = k = v = torch.zeros(2, 16, 8, 41, dtype=bf)
    elif case == "wide_d":
        q = k = v = torch.zeros(2, 16, 8, 162, dtype=bf)
    elif case == "shape_mismatch":
        k = torch.zeros(2, 16, 4, 40, dtype=bf)
    elif case == "strided_d":
        q = torch.zeros(2, 16, 8, 80, dtype=bf)[..., ::2]
    elif case == "do_shape":  # the backward's output gradient must be shaped as q
        do = torch.zeros(2, 16, 8, 48, dtype=bf)
    elif case == "do_float32":
        do = torch.zeros(2, 16, 8, 40)
    with pytest.raises(ValueError):
        fa.kernel_width(q, k, v, do)


def _unet_attention_levels():
    """(channels, tokens) of every multi-token self-attention of the
    full-width UNet, from DiffusionConfig(): the levels whose downsampling
    factor is in attention_resolutions, then the middle block."""
    cfg = DiffusionConfig()
    u = cfg.unet
    levels = []
    for i, mult in enumerate(u.channel_mult):
        if 2**i in u.attention_resolutions:
            levels.append((u.model_channels * mult, (cfg.latent_size // 2**i) ** 2))
    ds = 2 ** (len(u.channel_mult) - 1)
    levels.append((u.model_channels * u.channel_mult[-1], (cfg.latent_size // ds) ** 2))
    return levels


@pytest.mark.parametrize("channels,tokens", _unet_attention_levels())
def test_copy_bytes_is_16_for_the_unet_views(channels, tokens, monkeypatch):
    """The q, k and v views that the UNet's self-attention hands the kernel
    (bf16 Linear outputs viewed as [B, T, H, D]) take the 16-byte copies."""
    heads = DiffusionConfig().unet.num_heads
    seen = []

    def record(q, k, v):
        seen.append((fa.kernel_width(q, k, v), fa.copy_bytes(q, k, v), q.shape))
        return fa.attention_reference(q, k, v)

    monkeypatch.setattr(unet_mod, "flash_attention", record)
    attn = unet_mod.Attention(channels, channels, heads, channels // heads).to(torch.bfloat16)
    with torch.inference_mode():
        attn(torch.zeros(2, tokens, channels, dtype=torch.bfloat16))
    D = channels // heads
    assert seen == [(next(w for w in (48, 80, 160) if w >= D), 16, (2, tokens, heads, D))]


@pytest.mark.parametrize("case", ["d42", "d2", "stride44", "offset4"])
def test_copy_bytes_is_4_where_rows_are_not_16_byte_aligned(case):
    bf = torch.bfloat16
    if case == "d42":  # D even but not a multiple of 8
        q = torch.zeros(3, 77, 4, 42, dtype=bf)
    elif case == "d2":
        q = torch.zeros(1, 1, 2, 2, dtype=bf)
    elif case == "stride44":  # D = 40 inside rows of 44 elements
        q = torch.zeros(2, 16, 4, 44, dtype=bf)[..., :40]
    else:  # D = 40 starting 4 bytes into each row of 48
        q = torch.zeros(2, 16, 4, 48, dtype=bf)[..., 2:42]
    assert fa.kernel_width(q, q, q) in (48, 80, 160)
    assert fa.copy_bytes(q, q, q) == 4


@pytest.mark.parametrize("channels,tokens", _unet_attention_levels())
def test_copy_bytes_is_16_for_the_train_step_views(channels, tokens, monkeypatch):
    """Under training, the backward gets the UNet's q, k and v views and the
    output gradient autograd hands over; the dq and dkv kernels take all
    four with 16-byte copies."""
    heads = DiffusionConfig().unet.num_heads
    seen = []
    dq_plain = fa.flash_attention_bwd_dq

    def record(q, k, v, do, lse, dsum):
        seen.append((fa.kernel_width(q, k, v, do), fa.copy_bytes(q, k, v, do), do.shape))
        return dq_plain(q, k, v, do, lse, dsum)

    monkeypatch.setattr(fa, "flash_attention_bwd_dq", record)
    attn = unet_mod.Attention(channels, channels, heads, channels // heads).to(torch.bfloat16)
    x = torch.zeros(2, tokens, channels, dtype=torch.bfloat16, requires_grad=True)
    attn(x).float().square().sum().backward()
    D = channels // heads
    assert seen == [(next(w for w in (48, 80, 160) if w >= D), 16, (2, tokens, heads, D))]


@pytest.mark.parametrize("case", ["contiguous_do", "unaligned_do"])
def test_copy_bytes_takes_the_output_gradient(case):
    """16 bytes for aligned q, k, v and a contiguous dO; 4 when only dO's
    rows are not 16-byte aligned (D = 40 starting 4 bytes into rows of 48)."""
    bf = torch.bfloat16
    q = torch.zeros(2, 64, 8, 40, dtype=bf)
    if case == "contiguous_do":
        do = torch.zeros_like(q)
    else:
        do = torch.zeros(2, 64, 8, 48, dtype=bf)[..., 2:42]
    assert fa.copy_bytes(q, q, q) == 16
    assert fa.kernel_width(q, q, q, do) == 48
    assert fa.copy_bytes(q, q, q, do) == (16 if case == "contiguous_do" else 4)


@pytest.mark.parametrize("D,width", [(40, 16), (42, 4)])
def test_backward_launch_passes_the_copy_width_and_binds_once(D, width, monkeypatch):
    """_launch_bwd hands each backward entry point B, H, T, S, D, the padded
    width and the copy width (16 or 4 bytes, from copy_bytes over q, k, v
    and dO), and binds each entry point once (monkeypatched library and
    stream: no card needed)."""
    calls, loads = [], []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    def load(name):
        loads.append(name)
        return types.SimpleNamespace(**{s: entry(s) for s in ("dq_sym", "dkv_sym")})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(fa, "_on_device", lambda device: contextlib.nullcontext(0))
    bf = torch.bfloat16
    q, do = torch.zeros(3, 77, 4, D, dtype=bf), torch.zeros(3, 77, 4, D, dtype=bf)
    k, v = torch.zeros(3, 200, 4, D, dtype=bf), torch.zeros(3, 200, 4, D, dtype=bf)
    lse, dsum = torch.zeros(3, 4, 77), torch.zeros(3, 4, 77)
    fa._bind.cache_clear()
    try:
        for _ in range(2):
            fa._launch_bwd("dq_sym", q, k, v, do, lse, dsum, (torch.empty_like(q),))
            fa._launch_bwd("dkv_sym", q, k, v, do, lse, dsum, (torch.empty_like(k), torch.empty_like(v)))
        bound = [fa._bind("flash_attention_bwd", s, n) for s, n in (("dq_sym", 7), ("dkv_sym", 8))]
    finally:
        fa._bind.cache_clear()
    assert loads == ["flash_attention_bwd"] * 2  # once per entry point
    assert [len(fn.argtypes) for fn in bound] == [7 + 7 + 3, 8 + 7 + 3]
    assert [name for name, _ in calls] == ["dq_sym", "dkv_sym"] * 2
    for name, args in calls:
        n_pointers = 7 if name == "dq_sym" else 8
        assert args[n_pointers:n_pointers + 7] == (3, 4, 77, 200, D, 48, width)


def test_library_path_changes_with_every_shared_header(tmp_path, monkeypatch):
    """A build is named by its source and every csrc/*.cuh, so an edited
    shared header is never served from a stale build."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "a.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    (tmp_path / "b.cuh").write_text("// new header\n")
    third = _build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    fourth = _build.library_path("k")
    assert len({first, second, third, fourth}) == 4
    assert all(p.parent == compile_cache.build_dir() and p.name.startswith("libk-")
               for p in (first, fourth))


def test_entry_points_are_bound_once(monkeypatch):
    """_bind looks a C entry point up and sets its types on the first call
    only; later launches reuse the bound function."""
    loads = []

    def load(name):
        loads.append(name)
        return types.SimpleNamespace(sym=types.SimpleNamespace())

    monkeypatch.setattr(_build, "load", load)
    fa._bind.cache_clear()
    try:
        first = fa._bind("lib", "sym", 5)
        again = fa._bind("lib", "sym", 5)
    finally:
        fa._bind.cache_clear()
    assert again is first and loads == ["lib"]
    assert len(first.argtypes) == 5 + 7 + 3


def test_wrapper_refuses_mixed_devices():
    q = torch.zeros(1, 16, 2, 40)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.to("meta"), q)


def _autograd_grads(q, k, v, w):
    """(dq, dk, dv) of sum(attention_reference(q, k, v)[0] * w) by autograd."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, _ = fa.attention_reference(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize(
    "T,S,D", [(64, 64, 40), (256, 256, 80), (64, 64, 160), (16, 16, 160), (64, 16, 160)]
)
def test_backward_reference_matches_autograd(T, S, D):
    """The plain FA2 backward (P from lse, Dsum, dP, dS) against autograd
    through the plain forward, at UNet widths and ragged T, S below any
    64-row tile; both f32: only summation order differs."""
    q, k, v = _qkv(2, T, S, 4, D, seed=T + S + D)
    w = np.random.default_rng(D).standard_normal((2, T, 4, D)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.attention_reference(tq, tk, tv)
    grads = fa.attention_backward_reference(tq, tk, tv, out, lse, torch.from_numpy(w))
    for got, ref in zip(grads, _autograd_grads(q, k, v, w)):
        assert got.dtype == torch.float32
        assert max_err(got, ref) < 1e-5 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize(
    "T,S,D", [(256, 256, 40), (320, 256, 64), (200, 256, 40), (256, 256, 42), (77, 200, 42)]
)
def test_backward_matches_pallas_grad(T, S, D, interpret_pallas):
    """The port's gradient (the autograd Function on the CPU: plain forward
    and backward) against jax.grad through the JAX flash attention, whose
    custom_vjp runs the Pallas backward kernels in interpret mode: the
    shapes and bound of tests/test_flash_attention.py (Pallas dots run at
    MXU precision, bf16 inputs, even in interpret mode), a ragged T != S
    (queries padded to the block), D = 42, and T = 77, S = 200, where the
    JAX function takes XLA's attention (S not a multiple of its block)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, L, 2, D)).astype(np.float32) for L in (T, S, S))
    w = rng.normal(size=(1, T, 2, D)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_fa.flash_attention(q, k, v, block_q=128, block_kv=128) * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, _ = fa.flash_attention(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, r in zip(leaves, ref):
        assert max_err(leaf.grad, r) < 5e-3 * max(float(jnp.max(jnp.abs(r))), 1.0)


def test_function_carries_gradients_to_q_k_and_v():
    """The forward is an autograd Function: its output has a grad_fn and
    backward() reaches q, k and v (the fault this guards against: a kernel
    output with no graph, so every projection before the attention gets no
    gradient).  The logsumexp is not differentiable.  On the CPU nothing is
    launched."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(2, 64, 64, 2, 40, seed=9))
    counts = _counts()
    out, lse = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None and not lse.requires_grad
    out.square().sum().backward()
    for x in (q, k, v):
        assert x.grad is not None and torch.isfinite(x.grad).all()
        assert float(x.grad.abs().max()) > 0
    assert _counts() == counts


def test_backward_refuses_mixed_devices():
    q = torch.zeros(1, 16, 2, 40)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, q, q, q, lse, q.to("meta"))


def _counts():
    f = fa.flash_attention
    return f.launch_count, f.dq_launch_count, f.dkv_launch_count
