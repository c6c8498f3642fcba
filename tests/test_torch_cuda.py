"""The CUDA kernels of one2345_tpu_torch against their plain PyTorch
versions, on the card.  This module imports no JAX, so that it runs on a
machine with a card and without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX).  Every test takes
the ``cuda_device`` fixture and skips where torch.cuda.is_available() is
false.  chip_smoke.py makes the same checks.
"""

import pytest
import torch

from one2345_tpu_torch.ops import flash_attention as fa


def max_err(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


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
@pytest.mark.parametrize(
    "B,T,S,H,D,width",
    [
        (8, 1024, 1024, 8, 40, 16), (8, 256, 256, 8, 80, 16), (8, 64, 64, 8, 160, 16),
        (8, 16, 16, 8, 160, 16),
        # ragged T and S (not multiples of the tiles); D not a multiple of 8
        (2, 1000, 1000, 8, 40, 16), (3, 77, 200, 4, 42, 4),
    ],
)
def test_backward_kernels_match_plain_version_on_card(B, T, S, H, D, width, cuda_device):
    """K2 (dq and dkv kernels) at the train step's shapes (B=8, 8 heads) and
    at two ragged shapes against the plain backward in f32 from the same
    bf16 inputs and the forward kernel's o and lse; errors relative to max
    |ref| (bf16 P and dS in the products, bf16 outputs: 6.2e-3 at most on
    an H100).  A second launch gives bit-identical outputs (no atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * T + S + D)
    q, do = (
        torch.randn(B, T, H, D, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(2)
    )
    k, v = (
        torch.randn(B, S, H, D, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(2)
    )
    assert fa.copy_bytes(q, k, v, do) == width
    o, lse = fa.flash_attention(q, k, v)
    counts = _counts()
    grads = fa.flash_attention_backward(q, k, v, o, lse, do)
    again = fa.flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    refs = fa.attention_backward_reference(q.float(), k.float(), v.float(), o, lse, do)
    assert _counts() == (counts[0], counts[1] + 2, counts[2] + 2)
    for got, repeat, ref in zip(grads, again, refs):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, repeat)
        assert max_err(got.float(), ref) < 1.5e-2 * float(ref.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
