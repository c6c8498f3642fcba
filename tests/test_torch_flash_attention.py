"""one2345_tpu_torch.ops.flash_attention against the JAX flash attention.

On the CPU the wrapper runs its plain versions, ``attention_reference`` and
``attention_backward_reference``; they are held against the Pallas kernels
(interpret mode, forward and ``jax.grad``), XLA's attention and torch
autograd.  The CUDA kernels themselves are compared with the same plain
versions on the card (the ``cuda`` tests below, and chip_smoke.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.ops import flash_attention as jax_fa
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
    ["float32", "odd_d", "wide_d", "shape_mismatch", "strided_d"],
)
def test_kernel_width_rejects_what_the_kernel_does_not_take(case):
    bf = torch.bfloat16
    q = k = v = torch.zeros(2, 16, 8, 40, dtype=bf)
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
    with pytest.raises(ValueError):
        fa.kernel_width(q, k, v)


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
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith("libk-") for p in (first, fourth))


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
        first = fa._bind("lib", "sym", 5, n_ints=7)
        again = fa._bind("lib", "sym", 5, n_ints=7)
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


@pytest.mark.parametrize("T,S,D", [(256, 256, 40), (320, 256, 64)])
def test_backward_matches_pallas_grad(T, S, D, interpret_pallas):
    """The port's gradient (the autograd Function on the CPU: plain forward
    and backward) against jax.grad through the JAX flash attention, whose
    custom_vjp runs the Pallas backward kernels in interpret mode: the
    shapes and bound of tests/test_flash_attention.py (Pallas dots run at
    MXU precision, bf16 inputs, even in interpret mode)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,S,H,D,width",
    [
        (8, 1024, 1024, 8, 40, 16), (56, 1024, 1024, 8, 40, 16), (56, 256, 256, 8, 80, 16),
        (56, 64, 64, 8, 160, 16), (56, 16, 16, 8, 160, 16),
        # ragged T and S (not multiples of the tiles); D not a multiple of 8
        (2, 1000, 1000, 8, 40, 16), (3, 77, 200, 4, 42, 4),
    ],
)
def test_kernel_matches_plain_version_on_card(B, T, S, H, D, width, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(B * T + S + D)
    q = torch.randn(B, T, H, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    k, v = (
        torch.randn(B, S, H, D, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(2)
    )
    assert fa.copy_bytes(q, k, v) == width
    before = fa.flash_attention.launch_count
    out, lse = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.attention_reference(q.float(), k.float(), v.float())
    assert fa.flash_attention.launch_count == before + 1
    # bf16 output and bf16 P in the P.V product: ~1e-2 absolute
    assert max_err(out.float(), ref_out) < 2e-2
    assert max_err(lse, ref_lse) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("T,D", [(1024, 40), (256, 80), (64, 160), (16, 160)])
def test_backward_kernels_match_plain_version_on_card(T, D, cuda_device):
    """K2 (dq and dkv kernels) at the train step's shapes (B=8, 8 heads)
    against the plain backward in f32 from the same bf16 inputs and the
    forward kernel's o and lse; errors relative to max |ref| (bf16 P and dS
    in the products, bf16 outputs: 6.2e-3 at most on an H100)."""
    gen = torch.Generator(device=cuda_device).manual_seed(T + D)
    q, k, v, do = (
        torch.randn(8, T, 8, D, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(4)
    )
    o, lse = fa.flash_attention(q, k, v)
    counts = _counts()
    grads = fa.flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    refs = fa.attention_backward_reference(q.float(), k.float(), v.float(), o, lse, do)
    assert _counts() == (counts[0], counts[1] + 1, counts[2] + 1)
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.bfloat16
        assert max_err(got.float(), ref) < 1.5e-2 * float(ref.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
