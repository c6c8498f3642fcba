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
    "B,T,S,H,D,staged,offset",
    [
        (8, 1024, 1024, 8, 40, False, 0), (56, 1024, 1024, 8, 40, False, 0),
        (56, 256, 256, 8, 80, False, 0), (56, 64, 64, 8, 160, False, 0),
        (56, 16, 16, 8, 160, False, 0),
        # ragged T and S (not multiples of the tiles); D not a multiple of 8
        (2, 1000, 1000, 8, 40, False, 0), (3, 77, 200, 4, 42, True, 0),
        # rows that start 4 bytes into rows of D + 8 (staged, D % 8 == 0)
        (2, 130, 300, 4, 40, True, 2),
    ],
)
def test_kernel_matches_plain_version_on_card(B, T, S, H, D, staged, offset, cuda_device):
    """K1 against its plain version in f32 from the same bf16 inputs, O and
    lse.  Inputs that a tensor map cannot describe go through one staged
    copy, counted in staged_count; the others none."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * T + S + D)

    def draw(L):
        x = torch.randn(B, L, H, D + (8 if offset else 0), generator=gen, device=cuda_device)
        return x.to(torch.bfloat16)[..., offset:offset + D]

    q, k, v = draw(T), draw(S), draw(S)
    assert all(fa.tma_ready(x) for x in (q, k, v)) != staged
    before = fa.flash_attention.launch_count
    staged_before = fa.flash_attention.staged_count
    out, lse = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.attention_reference(q.float(), k.float(), v.float())
    assert fa.flash_attention.launch_count == before + 1
    assert fa.flash_attention.staged_count == staged_before + staged
    # bf16 output and bf16 P in the P.V product: ~1e-2 absolute
    assert max_err(out.float(), ref_out) < 2e-2
    assert max_err(lse, ref_lse) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,S,H,D,staged,offset",
    [
        # the train step's shapes (B=8, 8 heads)
        (8, 1024, 1024, 8, 40, False, 0), (8, 256, 256, 8, 80, False, 0),
        (8, 64, 64, 8, 160, False, 0), (8, 16, 16, 8, 160, False, 0),
        # the quality twins' (4 heads, D = 16 / 24, T = 16 / 64)
        (4, 64, 64, 4, 16, False, 0), (16, 16, 16, 4, 24, False, 0),
        # ragged T and S (not multiples of the tiles); D not a multiple of 8
        (2, 1000, 1000, 8, 40, False, 0), (3, 77, 200, 4, 42, True, 0),
        # rows that start 4 bytes into rows of D + 8 (staged, D % 8 == 0)
        (2, 130, 300, 4, 40, True, 2),
    ],
)
def test_backward_kernels_match_plain_version_on_card(B, T, S, H, D, staged, offset, cuda_device):
    """K2 (the dq kernel, which also computes Dsum, and the dkv kernel)
    against the plain backward in f32 from the same bf16 inputs and the
    forward kernel's o and lse: dQ, dK, dV and Dsum, errors relative to max
    |ref| (bf16 P and dS in the products, bf16 outputs).  Inputs a tensor
    map cannot describe go through one staged backward.  A second launch
    gives bit-identical outputs (no atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * T + S + D)

    def draw(L):
        x = torch.randn(B, L, H, D + (8 if offset else 0), generator=gen, device=cuda_device)
        return x.to(torch.bfloat16)[..., offset:offset + D]

    q, do, k, v = draw(T), draw(T), draw(S), draw(S)
    o, lse = fa.flash_attention(q, k, v)
    counts = _counts()
    staged_before = fa.flash_attention.bwd_staged_count
    grads = fa.flash_attention_backward(q, k, v, o, lse, do)
    again = fa.flash_attention_backward(q, k, v, o, lse, do)
    dq, dsum = fa.flash_attention_bwd_dq(q, k, v, do, lse, o)
    torch.cuda.synchronize()
    refs = fa.attention_backward_reference(q.float(), k.float(), v.float(), o, lse, do)
    ref_dsum = fa.softmax_grad_rowsum(o, do)
    assert _counts() == (counts[0], counts[1] + 3, counts[2] + 2)
    assert fa.flash_attention.bwd_staged_count == staged_before + 3 * staged
    assert torch.equal(dq, grads[0])
    for got, repeat, ref in zip(grads, again, refs):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, repeat)
        assert max_err(got.float(), ref) < 1.5e-2 * float(ref.abs().max())
    assert dsum.dtype == torch.float32 and dsum.shape == (B, H, T)
    assert max_err(dsum, ref_dsum) < 1.5e-2 * float(ref_dsum.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiny_sam_stage_matches_cpu(cuda_device):
    """The tiny SAM stage (grid 4, window 3: the padded windowed path and a
    global block), f32 with TF32 off (matmuls and cuDNN), the CPU stage's
    seeded weights on the card:
    the embedding, the mask of a box prompt, and the resizes around them
    (the uint8 INTER_LINEAR resize and the LANCZOS thumbnail bit for bit)."""
    from one2345_tpu_torch.core.config import SamConfig
    from one2345_tpu_torch.segmentation.sam import SamStage
    from one2345_tpu_torch.utils import image, resample

    cfg = SamConfig(image_size=64, patch_size=16, encoder_dim=32, encoder_depth=2,
                    encoder_heads=2, global_attn_indexes=(1,), window_size=3,
                    prompt_embed_dim=32, dtype="float32")
    gen = torch.Generator().manual_seed(5)
    img = torch.randint(0, 256, (48, 60, 3), generator=gen, dtype=torch.uint8).numpy()
    big = torch.randint(0, 256, (700, 900, 4), generator=gen, dtype=torch.uint8).numpy()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = SamStage(cfg, seed=3, device="cpu")
        stages = {"cpu": cpu,
                  cuda_device: SamStage(cfg, params=cpu.modules.state_dict(), device=cuda_device)}
        caches = {d: s.set_image(img) for d, s in stages.items()}
        masks = {d: s.predict_box(caches[d], (5, 6, 50, 40)) for d, s in stages.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ref, out = caches["cpu"]["embedding"], caches[cuda_device]["embedding"].cpu()
    assert float((out - ref).norm() / ref.norm()) < 1e-5
    assert float((masks["cpu"] == masks[cuda_device]).mean()) >= 0.999
    assert torch.equal(resample.cv2_resize_linear(img, (128, 102), device=cuda_device).cpu(),
                       resample.cv2_resize_linear(img, (128, 102), device="cpu"))
    assert (image.thumbnail(big, 512, device=cuda_device)
            == image.thumbnail(big, 512, device="cpu")).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,padding,cin,cout,hw", [
    (3, 1, 1, 640, 640, 32), (1, 1, 0, 640, 320, 32), (3, 2, 1, 320, 320, 32), (3, 1, 1, 2560, 1280, 4),
])
def test_int8_conv_matches_cpu_on_card(k, stride, padding, cin, cout, hw, cuda_device):
    """QConv2d at UNet widths: the card's int8 GEMM (torch._int_mm) against
    the CPU's exact plain version on the same codes: the int32
    accumulations equal, the bf16 outputs within one bf16 rounding."""
    from one2345_tpu_torch.diffusion.quantize import QConv2d, int8_matmul

    gen = torch.Generator().manual_seed(cin + cout + k)
    conv = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=padding)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / (k * k * cin) ** 0.5)
    cpu = QConv2d.from_float(conv)
    card = QConv2d.from_float(conv).to(cuda_device)
    card.dtype = cpu.dtype = torch.bfloat16
    x = torch.randn(8, cin, hw, hw, generator=gen).bfloat16()
    before = int8_matmul.launch_count
    acc, xs = card.accumulate(x.to(cuda_device))
    out = card(x.to(cuda_device))
    torch.cuda.synchronize()
    assert int8_matmul.launch_count == before + 2
    ref_acc, ref_xs = cpu.accumulate(x)
    assert acc.dtype == torch.int32 and torch.equal(acc.cpu(), ref_acc)
    assert torch.equal(xs.cpu(), ref_xs)
    ref = cpu(x).float()
    assert max_err(out.float().cpu(), ref) <= 2 ** -8 * float(ref.abs().max())


def _overlapping_triangles(seed: int, n_faces: int):
    gen = torch.Generator().manual_seed(seed)
    centres = torch.rand(n_faces, 1, 3, generator=gen) * 0.7 - 0.35
    v = (centres + 0.12 * torch.randn(n_faces, 3, 3, generator=gen)).reshape(-1, 3)
    f = torch.arange(3 * n_faces, dtype=torch.int32).reshape(-1, 3)
    return v.numpy(), f.numpy(), torch.rand(3 * n_faces, 3, generator=gen).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("view,shade", [(0, True), (7, False), (19, True)])
def test_rasterizer_on_card_matches_cpu(view, shade, cuda_device):
    """The batched z-buffer on the card against the same code on the CPU:
    both compute the barycentrics and depths with the same float64 ops, so
    the pixels are equal (a pixel may differ only at a depth tie within
    1e-9, which these random faces do not produce)."""
    from one2345_tpu_torch.eval.render_harness import eval_cameras, rasterize

    v, f, c = _overlapping_triangles(view, 400)
    K, w2c = eval_cameras(256)[view]
    rgb, alpha = rasterize(v, f, c, K, w2c, 256, shade, device=cuda_device)
    ref_rgb, ref_alpha = rasterize(v, f, c, K, w2c, 256, shade, device="cpu")
    assert 0.05 < alpha.mean() < 0.95
    assert (alpha == ref_alpha).all()
    assert float(abs(rgb - ref_rgb).max()) == 0.0


@pytest.mark.cuda
def test_nn_dists_on_card_match_cpu(cuda_device):
    from one2345_tpu_torch.eval.metrics import nn_dists

    gen = torch.Generator().manual_seed(3)
    a, b = (torch.randn(n, 3, generator=gen).numpy() for n in (3000, 2000))
    card, cpu = nn_dists(a, b, cuda_device), nn_dists(a, b, "cpu")
    assert float(abs(card - cpu).max()) <= 1e-12 * float(abs(cpu).max())


def _tiny_card_config():
    """The walkthrough's toy pipeline with a bf16 UNet (the flash kernels
    take bf16 only), 3 + 2 DDIM steps."""
    from one2345_tpu_torch.core.config import (CLIPVisionConfig, DiffusionConfig,
                                               PipelineConfig, ReconConfig, UNetConfig,
                                               VAEConfig)

    return PipelineConfig(
        diffusion=DiffusionConfig(
            ddim_steps_stage1=3, ddim_steps_stage2=2, image_size=32, latent_size=4,
            unet=UNetConfig(model_channels=32, channel_mult=(1, 2), attention_resolutions=(1,),
                            num_heads=4, dtype="bfloat16"),
            vae=VAEConfig(base_channels=16, channel_mult=(1, 2, 2, 2), dtype="float32"),
            clip=CLIPVisionConfig(image_size=28, patch_size=14, width=32, layers=2, heads=2,
                                  dtype="float32"),
        ),
        recon=ReconConfig(vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0, mesh_resolution=24),
        mesh_resolution=24,
    )


@pytest.mark.cuda
def test_run_many_on_request_streams_equals_sequential_runs(cuda_device):
    """[a, b, a] at seeds [1, 2, 1], two in flight, each request on a CUDA
    stream of its own: the stage images, elevation and mesh equal
    sequential runs bit for bit, and K1 is counted exactly."""
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    pipe = One2345Pipeline(_tiny_card_config(), use_sam=False, device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    imgs = []
    for _ in range(2):
        img = torch.full((96, 96, 3), 255, dtype=torch.uint8)
        img[24:72, 24:72] = torch.randint(40, 200, (48, 48, 3), generator=gen, dtype=torch.uint8)
        imgs.append(img.numpy())
    imgs, seeds = [imgs[0], imgs[1], imgs[0]], [1, 2, 1]
    pipe.run(imgs[0], seed=0)  # builds the kernels before the pool starts
    fa.flash_attention.launch_count = 0
    seq = [pipe.run(img, seed=s) for img, s in zip(imgs, seeds)]
    torch.cuda.synchronize()
    per_run = fa.flash_attention.launch_count // 3
    fa.flash_attention.launch_count = 0
    par = pipe.run_many(imgs, seeds=seeds, max_in_flight=2)
    torch.cuda.synchronize()
    assert fa.flash_attention.launch_count == 3 * per_run > 0
    for a, b in zip(seq, par):
        assert torch.equal(a.stage1_images, b.stage1_images)
        assert torch.equal(a.stage2_images, b.stage2_images)
        assert a.elevation == b.elevation
        for key in ("vertices", "faces", "colors"):
            x, y = getattr(a, key), getattr(b, key)  # numpy arrays
            assert x.shape == y.shape and (x == y).all(), key


@pytest.mark.cuda
def test_sam_memo_taken_on_another_stream_waits_for_its_encode(cuda_device):
    """Stream A sleeps, then encodes; stream B takes the memo at once and
    decodes a box: B must wait for A's encode (the memo's event), so its
    embedding and mask equal those of an encode on one stream."""
    from one2345_tpu_torch.core.config import SamConfig
    from one2345_tpu_torch.segmentation.sam import SamStage

    cfg = SamConfig(image_size=64, patch_size=16, encoder_dim=32, encoder_depth=2,
                    encoder_heads=2, global_attn_indexes=(1,), window_size=3,
                    prompt_embed_dim=32, dtype="float32")
    stage = SamStage(cfg, seed=3, device=cuda_device)
    gen = torch.Generator().manual_seed(5)
    img = torch.randint(0, 256, (48, 60, 3), generator=gen, dtype=torch.uint8).numpy()
    box = (5, 6, 50, 40)
    ref = stage.set_image(img)
    ref_emb, ref_mask = ref["embedding"].clone(), stage.predict_box(ref, box)
    torch.cuda.synchronize()
    stage._memo = None
    a, b = torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(a):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock before the encode
        stage.set_image(img)
    with torch.cuda.stream(b):
        cache = stage.set_image(img)
        emb = cache["embedding"].clone()
        mask = stage.predict_box(cache, box)
    torch.cuda.synchronize()
    assert torch.equal(emb, ref_emb)
    assert (mask == ref_mask).all()
