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


def _unaligned(case):
    """q of the four inputs whose rows a 16-byte copy cannot take."""
    bf = torch.bfloat16
    if case == "d42":  # D even but not a multiple of 8
        return torch.zeros(3, 77, 4, 42, dtype=bf)
    if case == "d2":
        return torch.zeros(1, 1, 2, 2, dtype=bf)
    if case == "stride44":  # D = 40 inside rows of 44 elements
        return torch.zeros(2, 16, 4, 44, dtype=bf)[..., :40]
    return torch.zeros(2, 16, 4, 48, dtype=bf)[..., 2:42]  # 4 bytes into rows of 48


@pytest.mark.parametrize("case", ["d42", "d2", "stride44", "offset4"])
def test_forward_stages_what_a_tensor_map_cannot_describe(case):
    """The forward's tensor maps need D % 8 == 0, a 16-byte aligned base and
    strides of 16 bytes: none of these inputs has all three, though the
    kernels take each of them (bf16 pairs)."""
    q = _unaligned(case)
    assert fa.kernel_width(q, q, q) in (48, 80, 160)
    assert not fa.tma_ready(q)


@pytest.mark.parametrize("channels,tokens", _unet_attention_levels())
def test_forward_stages_none_of_the_unet_views(channels, tokens, monkeypatch):
    """The q, k and v views of the UNet's self-attention at every level go
    to the tensor maps as they are."""
    heads = DiffusionConfig().unet.num_heads
    seen = []

    def record(q, k, v):
        seen.append([fa.tma_ready(x) for x in (q, k, v)])
        return fa.attention_reference(q, k, v)

    monkeypatch.setattr(unet_mod, "flash_attention", record)
    attn = unet_mod.Attention(channels, channels, heads, channels // heads).to(torch.bfloat16)
    with torch.inference_mode():
        attn(torch.zeros(2, tokens, channels, dtype=torch.bfloat16))
    assert seen == [[True, True, True]]


@pytest.mark.parametrize("case", ["d42", "d2", "stride44", "offset4"])
def test_staged_copy_equals_its_input_and_suits_a_tensor_map(case):
    """stage_for_tma gives the input's values in a view whose base is 16-byte
    aligned and whose strides are multiples of 8 elements (rows padded to
    D rounded up to 8)."""
    q = _unaligned(case)
    q.copy_(torch.randn(q.shape, generator=torch.Generator().manual_seed(4)).to(q.dtype))
    staged = fa.stage_for_tma(q)
    assert torch.equal(staged, q) and staged.dtype == q.dtype
    assert staged.data_ptr() % 16 == 0
    assert all(st % 8 == 0 and st > 0 for st in staged.stride()[:3]) and staged.stride(-1) == 1
    assert staged.stride(2) == -(-q.shape[-1] // 8) * 8
    assert fa.tma_ready(staged) == (q.shape[-1] % 8 == 0)


@pytest.mark.parametrize("case", ["aligned", "d42", "offset4"])
def test_forward_launch_stages_counts_and_binds_once(case, monkeypatch):
    """_launch_fwd hands the forward entry point five pointers (the staged
    copies where the inputs needed one), then B, H, T, S, D and the padded
    width, the (batch, token, head) strides of q, k, v and o, 1/sqrt(D) and
    the stream; it counts the launch, and a launch with staged inputs once
    in staged_count (monkeypatched library and stream: no card needed)."""
    calls, loads = [], []

    def fn(*args):
        calls.append(args)
        return 0

    def load(name):
        loads.append(name)
        return types.SimpleNamespace(flash_attention_fwd_bf16=fn)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(fa, "_on_device", lambda device: contextlib.nullcontext(0))
    bf = torch.bfloat16
    if case == "aligned":
        q, k = torch.zeros(2, 64, 8, 40, dtype=bf), torch.zeros(2, 96, 8, 40, dtype=bf)
    elif case == "d42":
        q, k = torch.zeros(3, 77, 4, 42, dtype=bf), torch.zeros(3, 200, 4, 42, dtype=bf)
    else:
        q = torch.zeros(2, 64, 8, 48, dtype=bf)[..., 2:42]
        k = torch.zeros(2, 96, 8, 40, dtype=bf)
    v = k.clone()
    f = fa.flash_attention
    launches, staged = f.launch_count, f.staged_count
    fa._bind.cache_clear()
    try:
        for _ in range(2):
            o, lse = fa._launch_fwd(q, k, v)
        bound = fa._bind("flash_attention_fwd", "flash_attention_fwd_bf16", 5, 6)
    finally:
        fa._bind.cache_clear()
    assert loads == ["flash_attention_fwd"] and len(bound.argtypes) == 5 + 6 + 3
    assert f.launch_count == launches + 2
    assert f.staged_count == staged + (0 if case == "aligned" else 2)
    B, T, H, D = q.shape
    assert o.shape == q.shape and lse.shape == (B, H, T) and lse.dtype == torch.float32
    for args in calls:
        assert args[5:11] == (B, H, T, k.shape[1], D, 48)
        pointers = {args[0], args[1], args[2]}
        passed_as_is = {x.data_ptr() for x in (q, k, v) if fa.tma_ready(x)}
        assert len(pointers) == 3 and all(ptr % 16 == 0 for ptr in pointers)
        assert passed_as_is <= pointers
        strides = list(args[11])
        assert len(strides) == 12 and all(st % 8 == 0 for st in strides[:9])
        assert strides[9:] == list(o.stride()[:3])
        assert args[12] == pytest.approx(1.0 / np.sqrt(D)) and args[13] == 0


_BWD_INPUTS = ("q", "k", "v", "o", "do")


@pytest.mark.parametrize("position", _BWD_INPUTS)
@pytest.mark.parametrize("case", ["d42", "d2", "stride44", "offset4"])
def test_backward_stages_what_a_tensor_map_cannot_describe(case, position):
    """stage_unready, as the backward calls it on q, k, v, O and dO, copies
    exactly the inputs a tensor map cannot describe: the one unaligned
    input, or all five where D % 8 != 0; the others go to the kernels as
    they are, and a staged copy holds its input's values."""
    odd = _unaligned(case)
    odd.copy_(torch.randn(odd.shape, generator=torch.Generator().manual_seed(7)).to(odd.dtype))
    inputs = [odd if name == position else torch.zeros(odd.shape, dtype=odd.dtype)
              for name in _BWD_INPUTS]
    out, staged = fa.stage_unready(*inputs)
    expect = [name == position or odd.shape[-1] % 8 != 0 for name in _BWD_INPUTS]
    assert staged
    for x, y, copied in zip(inputs, out, expect):
        assert (y is not x) == copied
        assert torch.equal(y, x) and fa.tma_ready(y) == (x.shape[-1] % 8 == 0 or not copied)


@pytest.mark.parametrize("channels,tokens", _unet_attention_levels())
def test_backward_stages_none_of_the_train_step_views(channels, tokens, monkeypatch):
    """Under training, the backward gets the UNet's q, k and v views, the
    forward's o and the output gradient autograd hands over: all five go to
    the tensor maps as they are, so the train step stages nothing."""
    heads = DiffusionConfig().unet.num_heads
    seen = []
    backward = fa.flash_attention_backward

    def record(q, k, v, o, lse, do):
        seen.append(([fa.tma_ready(x) for x in (q, k, v, o, do)], fa.kernel_width(q, k, v, do)))
        return backward(q, k, v, o, lse, do)

    monkeypatch.setattr(fa, "flash_attention_backward", record)
    attn = unet_mod.Attention(channels, channels, heads, channels // heads).to(torch.bfloat16)
    x = torch.zeros(2, tokens, channels, dtype=torch.bfloat16, requires_grad=True)
    attn(x).float().square().sum().backward()
    D = channels // heads
    assert seen == [([True] * 5, next(w for w in (48, 80, 160) if w >= D))]


@pytest.mark.parametrize("case", ["aligned", "d42", "offset4"])
def test_backward_launch_stages_counts_and_binds_once(case, monkeypatch):
    """_launch_bwd stages what a tensor map cannot take once for both
    kernels (one count in bwd_staged_count per call), hands the dq entry
    point q, k, v, O, dO, lse, dQ and Dsum and the dkv entry point q, k, v,
    dO, lse, that Dsum, dK and dV, then B, H, T, S, D, the padded width,
    the (batch, token, head) strides of the six bf16 tensors, 1/sqrt(D)
    and the stream; it counts both launches and binds each entry point
    once (monkeypatched library and stream: no card needed)."""
    calls, loads = [], []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    symbols = ("flash_attention_bwd_dq_bf16", "flash_attention_bwd_dkv_bf16")

    def load(name):
        loads.append(name)
        return types.SimpleNamespace(**{s: entry(s) for s in symbols})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(fa, "_on_device", lambda device: contextlib.nullcontext(0))
    bf = torch.bfloat16
    if case == "aligned":
        q, k = torch.zeros(2, 64, 8, 40, dtype=bf), torch.zeros(2, 96, 8, 40, dtype=bf)
        do = torch.zeros_like(q)
    elif case == "d42":
        q, k = torch.zeros(3, 77, 4, 42, dtype=bf), torch.zeros(3, 200, 4, 42, dtype=bf)
        do = torch.zeros_like(q)
    else:  # only dO starts 4 bytes into its rows
        q, k = torch.zeros(2, 64, 8, 40, dtype=bf), torch.zeros(2, 96, 8, 40, dtype=bf)
        do = torch.zeros(2, 64, 8, 48, dtype=bf)[..., 2:42]
    v, o = k.clone(), q.clone()
    B, T, H, D = q.shape
    lse = torch.zeros(B, H, T)
    f = fa.flash_attention
    counts = (f.dq_launch_count, f.dkv_launch_count, f.bwd_staged_count)
    fa._bind.cache_clear()
    try:
        for _ in range(2):
            dq, dk, dv = fa._launch_bwd(q, k, v, o, lse, do)
        bound = [fa._bind("flash_attention_bwd", s, 8) for s in symbols]
    finally:
        fa._bind.cache_clear()
    assert loads == ["flash_attention_bwd"] * 2  # once per entry point
    assert [len(fn.argtypes) for fn in bound] == [8 + 6 + 3] * 2
    staged = 0 if case == "aligned" else 2
    assert (f.dq_launch_count, f.dkv_launch_count, f.bwd_staged_count) == (
        counts[0] + 2, counts[1] + 2, counts[2] + staged)
    assert [name for name, _ in calls] == list(symbols) * 2
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    for (_, dq_args), (_, dkv_args) in zip(calls[0::2], calls[1::2]):
        for args, n_inputs in ((dq_args, 5), (dkv_args, 4)):
            assert args[8:14] == (B, H, T, k.shape[1], D, 48)
            assert all(ptr % 16 == 0 for ptr in args[:4]) and args[15:] == (
                pytest.approx(1.0 / np.sqrt(D)), 0)
            strides = list(args[14])
            assert len(strides) == 18 and all(st % 8 == 0 for st in strides[:3 * n_inputs])
        # dq's inputs q, k, v, O, dO; dkv's q, k, v, dO; and the Dsum dq wrote
        assert dq_args[4] % 16 == 0 and dkv_args[:3] == dq_args[:3]
        assert dkv_args[3] == dq_args[4] and dkv_args[4] == dq_args[5] == lse.data_ptr()
        assert dkv_args[5] == dq_args[7]
        passed_as_is = {x.data_ptr() for x in (q, k, v, o, do) if fa.tma_ready(x)}
        assert passed_as_is <= set(dq_args[:5])
        assert (do.data_ptr() in dq_args[:5]) == (case == "aligned")


@pytest.mark.parametrize("T,S,D", [(64, 64, 40), (77, 200, 42)])
def test_dq_reference_returns_the_rowsum_dsum(T, S, D):
    """dq_reference takes O and returns (dQ, Dsum) with Dsum exactly
    softmax_grad_rowsum(O, dO): the Dsum that dkv_reference, and on the
    card the dkv kernel, then takes.  flash_attention_bwd_dq on CPU tensors
    returns the same."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, T, S, 3, D, seed=T + D))
    do = torch.from_numpy(np.random.default_rng(D).standard_normal((2, T, 3, D)).astype(np.float32))
    o, lse = fa.attention_reference(q, k, v)
    dq, dsum = fa.dq_reference(q, k, v, do, lse, o)
    assert dsum.shape == (2, 3, T) and dsum.dtype == torch.float32
    assert torch.equal(dsum, fa.softmax_grad_rowsum(o, do))
    ref_dq = fa.attention_backward_reference(q, k, v, o, lse, do)[0]
    assert torch.equal(dq, ref_dq)
    got = fa.flash_attention_bwd_dq(q, k, v, do, lse, o)
    assert torch.equal(got[0], dq) and torch.equal(got[1], dsum)


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
    assert len(first.argtypes) == 5 + 6 + 3


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
    return f.launch_count, f.dq_launch_count, f.dkv_launch_count, f.bwd_staged_count
