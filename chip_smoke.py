#!/usr/bin/env python3
"""Smoke run of the PyTorch port (one2345_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:
1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: every CUDA kernel of the port, compiled by nvcc from the sources
   in the checkout (one process per source, all started together);
3. kernels: each kernel against its plain PyTorch version at every shape
   the main path gives it (bf16 N(0, 1) inputs from a seeded generator),
   with the kernel's, the plain version's and one library call's times
   (CUDA events, after warm-up) and the kernel's bound on this card;
4. unet: one full-width Zero123-XL UNet eval (B=2) on the card (bf16, the
   kernels) against the same UNet on the CPU (f32, plain versions), with
   the same seeded weights and inputs;
5. sampling: the image -> mesh path's four sampling phases at full width
   (stage 1 views 0-3, stage 2 of view 0, stage 1 of the second ring at the
   fallback polar angle of 90 degrees, stage 2 of the other 7 views), with
   seeded non-zero weights.  Run twice; launches are counted on the second.

Then the kernels' JSON line, the nvidia-smi line, and the result line.
Needs one card; writes nothing outside its checkout.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet); a card set below
# 700 W runs slower, so every time is printed beside the power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

O_TOL = 2e-2    # bf16 output, bf16 P in the P.V product
LSE_TOL = 1e-2  # f32 statistics from bf16 scores
UNET_TOL = 5e-2  # relative L2, bf16 UNet against the f32 one
POLAR_DEG = 90.0  # the runner's fallback elevation (ElevationConfig.default_elevation)

# (name, B, T=S, H, D) of every flash-attention call on the main path:
# level 0 at the CFG batch of 4 views (8) and of 28 views (56), then
# levels 1, 2 and the middle block at B=56
ATTENTION_SHAPES = [
    ("level0_b8", 8, 1024, 8, 40),
    ("level0_b56", 56, 1024, 8, 40),
    ("level1_b56", 56, 256, 8, 80),
    ("level2_b56", 56, 64, 8, 160),
    ("mid_b56", 56, 16, 8, 160),
]
HEADLINE_SHAPE = "level0_b56"  # the heaviest call: its numbers go in the JSON line


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def seeded_state_dict(module, seed: int) -> dict:
    """Non-zero f32 weights for ``module`` (built on the meta device):
    N(0, 1/fan_in) kernels, 1 + N(0, 0.1^2) norm scales, N(0, 0.1^2)
    biases, N(0, 0.02^2) CLIP embeddings.  Zero-initialised output convs
    would otherwise make every comparison check nothing."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        x = torch.randn(p.shape, generator=gen)
        if leaf in ("class_embedding", "positional_embedding"):
            x *= 0.02
        elif leaf in ("proj", "kernel"):  # used as x @ w: fan_in is dim 0
            x /= math.sqrt(p.shape[0])
        elif leaf == "weight" and p.dim() >= 2:
            x /= math.sqrt(p[0].numel())
        elif leaf == "weight":
            x = 1.0 + 0.1 * x
        else:
            x *= 0.1
        out[name] = x
    return out


def input_image(size: int = 256):
    """A synthetic object on white: a shaded disc, seeded."""
    import numpy as np

    rng = np.random.default_rng(0)
    img = np.ones((size, size, 3), np.float32)
    yy, xx = np.mgrid[:size, :size] / size
    disc = (yy - 0.5) ** 2 + (xx - 0.5) ** 2 < 0.09
    shade = np.stack([yy, xx, 1.0 - yy], axis=-1) * 0.6 + 0.2
    img[disc] = (shade + 0.05 * rng.standard_normal(shade.shape))[disc].clip(0, 1)
    return img


def phase_device():
    import torch

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi: {res.stderr.strip()}")
    smi = res.stdout.strip().splitlines()[0]
    # fp32 matmuls and cuDNN convs in full f32 (cuDNN defaults to TF32):
    # the plain versions here are references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"phase device: {smi} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} cuda {torch.version.cuda} | tf32 off"
    )
    return smi


def phase_build():
    from one2345_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    for name in libs:
        report = [
            line.strip() for line in _build.build_log(name).splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line
        ]
        for line in report:
            log(f"  ptxas {name}: {line}")
    log(f"phase build: {len(libs)} kernel(s) in {dt:.2f} s: {', '.join(sorted(libs))}")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from one2345_tpu_torch.ops.flash_attention import attention_reference, flash_attention

    rows = {}
    for i, (name, B, T, H, D) in enumerate(ATTENTION_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = (
            torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)
        )
        o, lse = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = attention_reference(q.float(), k.float(), v.float())
        err_o = float((o.float() - ref_o).abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        if not (err_o <= O_TOL and err_lse <= LSE_TOL):
            fail(f"flash_attention {name}: O err {err_o} (<= {O_TOL}), lse err {err_lse} (<= {LSE_TOL})")
        iters = 50 if B * T >= 8192 else 200
        ms = time_ms(lambda: flash_attention(q, k, v), iters)
        plain_ms = time_ms(lambda: attention_reference(q, k, v), max(iters // 5, 10))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        flops = 4.0 * B * H * T * T * D
        nbytes = 4.0 * q.numel() * q.element_size() + lse.numel() * 4
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        rows[name] = dict(
            max_abs_err=err_o, lse_err=err_lse, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        )
        log(
            f"phase kernels: flash_attention {name} B={B} T=S={T} H={H} D={D}: "
            f"O err {err_o:.3e} (<= {O_TOL}) lse err {err_lse:.3e} (<= {LSE_TOL}) | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.4f} ms ({rows[name]['bound_by']}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s"
        )
    return rows


def phase_unet():
    import torch

    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.diffusion.unet import UNetModel, cast_compute
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    u = DiffusionConfig().unet
    kw = dict(
        in_channels=u.in_channels, out_channels=u.out_channels,
        model_channels=u.model_channels, num_res_blocks=u.num_res_blocks,
        attention_resolutions=tuple(u.attention_resolutions),
        channel_mult=tuple(u.channel_mult), num_heads=u.num_heads,
        transformer_depth=u.transformer_depth, context_dim=u.context_dim,
    )
    with torch.device("meta"):
        shapes = UNetModel(**kw)
    weights = seeded_state_dict(shapes, seed=1)
    with torch.device("meta"):
        cpu_unet = UNetModel(**kw)
    cpu_unet.load_state_dict(weights, strict=True, assign=True)
    with torch.device("cuda"):
        gpu_unet = UNetModel(**kw)
    gpu_unet.load_state_dict(weights, strict=True)
    cast_compute(gpu_unet, torch.bfloat16)

    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 32, 32, u.in_channels, generator=gen)
    t = torch.tensor([977, 421])
    ctx = torch.randn(2, 1, u.context_dim, generator=gen)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_unet(x, t, ctx)
    cpu_s = time.perf_counter() - t0
    flash_attention.launch_count = 0
    with torch.inference_mode():
        out = gpu_unet(x.cuda(), t.cuda(), ctx.cuda())
    torch.cuda.synchronize()
    launches = flash_attention.launch_count
    rel = float(torch.linalg.vector_norm(out.cpu() - ref) / torch.linalg.vector_norm(ref))
    if not torch.isfinite(out).all() or rel > UNET_TOL:
        fail(f"full-width UNet on the card vs CPU: relative L2 {rel} (<= {UNET_TOL})")
    if launches != 16:
        fail(f"full-width UNet eval launched flash_attention {launches} times, expected 16")
    log(
        f"phase unet: full-width UNet B=2 card bf16 vs CPU f32: relative L2 {rel:.3e} "
        f"(<= {UNET_TOL}), |ref| rms {float(ref.pow(2).mean().sqrt()):.3e}, "
        f"flash_attention launches {launches}, CPU eval {cpu_s:.1f} s"
    )
    return weights


def run_main_path(stage, image, timer):
    """The runner's four sampling phases (One2345Pipeline.run, with the
    elevation estimate pinned to its fallback)."""
    import torch

    with timer.span("stage1"):
        s1_first = stage.stage1(image, seed=1, indices=[0, 1, 2, 3])
    with timer.span("stage2_view0"):
        s2_v0 = stage.stage2(s1_first[:1], seed=2, view_ids=[0])
    second_ring = [4, 5, 6, 7] if POLAR_DEG <= 75 else [8, 9, 10, 11]
    with timer.span("stage1_ring2"):
        s1_second = stage.stage1(image, seed=3, indices=second_ring)
    stage1_images = torch.cat([s1_first, s1_second])
    with timer.span("stage2_rest"):
        rest = stage.stage2(stage1_images[1:], seed=4, view_ids=list(range(1, 8)))
    return stage1_images, torch.cat([s2_v0, rest])


def phase_sampling(unet_weights, smi):
    import torch

    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.core.profiling import Timer, unet_flops_per_eval
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    cfg = DiffusionConfig()
    t0 = time.perf_counter()
    shapes = Zero123Stage(cfg, device="meta")
    params = {"unet": unet_weights}
    for i, name in enumerate(("encoder", "decoder", "clip", "cc_projection")):
        params[name] = seeded_state_dict(getattr(shapes, name), seed=10 + i)
    stage = Zero123Stage(cfg, params=params, device="cuda")
    del shapes, params
    log(f"phase sampling: stage built with seeded weights in {time.perf_counter() - t0:.1f} s")

    image = input_image(cfg.image_size)
    evals = {"stage1": 76, "stage2_view0": 49, "stage1_ring2": 76, "stage2_rest": 49}
    batch = {"stage1": 8, "stage2_view0": 8, "stage1_ring2": 8, "stage2_rest": 56}
    flops = sum(n * unet_flops_per_eval(batch[k]) for k, n in evals.items())
    expected = 16 * sum(evals.values())
    first = None
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        timer = Timer(device="cuda")
        flash_attention.launch_count = 0
        s1, s2 = run_main_path(stage, image, timer)
        torch.cuda.synchronize()
        launches = flash_attention.launch_count
        if tuple(s1.shape) != (8, 256, 256, 3) or tuple(s2.shape) != (8, 4, 256, 256, 3):
            fail(f"sampling shapes {tuple(s1.shape)} {tuple(s2.shape)}")
        for name, imgs in (("stage1", s1), ("stage2", s2)):
            if not torch.isfinite(imgs).all() or imgs.min() < 0 or imgs.max() > 1:
                fail(f"{name} images not finite in [0, 1]")
        if launches != expected:
            fail(f"flash_attention launched {launches} times on the main path, expected {expected}")
        spans = timer.report()
        total = timer.total()
        inside = float(((s2 > 0.01) & (s2 < 0.99)).float().mean())
        rerun = "" if first is None else f", max |warm - cold| {float((s2 - first).abs().max()):.3e}"
        first = s2
        log(
            f"phase sampling ({run}): "
            + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
            + f", total {total:.3f} s | UNet {flops / 1e12:.1f} TFLOP, "
            f"MFU {flops / total / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s | "
            f"flash_attention launches {launches} (expected {expected}) | "
            f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
            f"stage2 pixels in (0.01, 0.99) {inside:.3f}{rerun} | {smi}"
        )
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "one2345_tpu_torch")):
        print("chip_smoke: one2345_tpu_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    unet_weights = phase_unet()
    launches = phase_sampling(unet_weights, smi)

    head = rows[HEADLINE_SHAPE]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "one2345_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "one2345_tpu/ops/flash_attention.py:36",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
