#!/usr/bin/env python3
"""Smoke run of the PyTorch port (one2345_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:
1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: every CUDA kernel of the port, compiled by nvcc from the sources
   in the checkout (one process per source, all started together), with
   ptxas's registers, shared memory and spills for every instance; any
   spill fails the run;
3. kernels: the forward kernel against its plain PyTorch version at every
   shape the sampling path gives it and at two ragged shapes (16-byte and
   4-byte copies), then the two backward kernels against the plain
   backward at every shape the train step gives them and at the same two
   ragged shapes (bf16 N(0, 1) inputs from a seeded generator), and two
   launches of each at level 0 bit for bit; with the kernels', the plain
   versions' and one library call's times (CUDA events, after warm-up) and
   each kernel's bound on this card;
4. unet: one full-width Zero123-XL UNet eval (B=2) on the card (bf16, the
   kernels) against the same UNet on the CPU (f32, plain versions), with
   the same seeded weights and inputs;
5. grad: the gradients of one full-width level-0 SpatialTransformer (B=2,
   32x32 tokens) on the card (f32 weights, bf16 autocast, forward and
   backward kernels) against the CPU (f32, plain versions);
6. sampling: the image -> mesh path's four sampling phases at full width
   (stage 1 views 0-3, stage 2 of view 0, stage 1 of the second ring at the
   fallback polar angle of 90 degrees, stage 2 of the other 7 views), with
   seeded non-zero weights.  Run twice; launches are counted on the second;
7. train: the Zero123 finetune step at full width (Zero123Trainer, B=8,
   remat, f32 weights, bf16 autocast): one cold step and five warm ones,
   each timed, its launches counted, and the first one's gradients, params
   and EMA checked;
8. device times: each kernel's device time per launch (torch.profiler) at
   the shapes of phase 3, and the device time of SDPA's backward (the
   library yardstick of the backward kernels, with its kernels' names),
   after the timed phases 6 and 7, which a profiled run can slow on the
   host.

Then the kernels' JSON line, the nvidia-smi line, and the result line.
Needs one card; writes nothing outside its checkout.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet); a card set below
# 700 W runs slower, so every time is printed beside the power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# exp2 results per clock per SM on the special-function unit (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0); the card's rate is this x SMs x its maximum SM clock
EXP2_PER_CLOCK_PER_SM = 16

O_TOL = 2e-2    # bf16 output, bf16 P in the P.V product
LSE_TOL = 1e-2  # f32 statistics from bf16 scores
# dQ, dK, dV: max abs error over max |ref| (bf16 P and dS in the products,
# bf16 outputs); 6.2e-3 at most on an H100 80GB HBM3 at 700 W
BWD_TOL = 1.5e-2
UNET_TOL = 5e-2  # relative L2, bf16 UNet against the f32 one
# relative L2 per parameter gradient, bf16 autocast against f32; 9.2e-3 at
# most on an H100 80GB HBM3 at 700 W
GRAD_TOL = 3e-2
POLAR_DEG = 90.0  # the runner's fallback elevation (ElevationConfig.default_elevation)
TRAIN_BATCH = 8
TRAIN_STEPS = 6  # one cold, five warm

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
# (name, B, T, S, H, D, copy width in bytes) of the forward's ragged checks:
# T and S not multiples of the tiles, and D not a multiple of 8
RAGGED_SHAPES = [("ragged_16b", 2, 1000, 1000, 8, 40, 16), ("ragged_4b", 3, 77, 200, 4, 42, 4)]
# (name, T=S, D) of every attention backward of the train step (B=8, H=8)
TRAIN_SHAPES = [("level0", 1024, 40), ("level1", 256, 80), ("level2", 64, 160), ("mid", 16, 160)]
TRAIN_HEADLINE = "level0"
# parameters no loss reads: the one-token cross-attention is the broadcast
# of V, so its query and key projections and its pre-norm get no gradient,
# as in the JAX package (jax.grad gives them zeros)
DEAD = ("attn2.to_q.weight", "attn2.to_k.weight", "norm2.weight", "norm2.bias")


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


def device_time_us(evt) -> float:
    """Device time of a profiler row in microseconds (the attribute's name
    depends on the torch version)."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms_per_launch(fn, kernel: str, iters: int) -> tuple[float, int]:
    """(device ms per launch, recorded launches) of the kernel whose name
    contains ``kernel``: torch.profiler over ``iters`` calls of ``fn``, the
    kernel's device time over its recorded launches.  The profiler can drop
    records (on an H100 it kept 33 of 50 once), so a profiled run that
    recorded fewer than 0.9 * ``iters`` launches is made again, up to three
    runs in all.  Fails if none recorded that many, or if one recorded more
    than one launch per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages() if kernel in r.key and device_time_us(r) > 0]
        launches = sum(r.count for r in rows)
        if launches > iters:
            fail(f"profiler: {launches} launches of {kernel} recorded in {iters} calls")
        if launches >= 0.9 * iters:
            return sum(device_time_us(r) for r in rows) / launches / 1e3, launches
        counts.append(launches)
    fail(f"profiler: {counts} launches of {kernel} recorded in three profiled runs of {iters} calls")


def device_ms_per_call(fn, iters: int) -> tuple[float, list[str]]:
    """(device ms per call, names of the device kernels) of ``fn``: the sum
    of every kernel's and copy's device time in a torch.profiler run of
    ``iters`` calls, over the calls.  A run that recorded fewer than 0.9 of
    the device events of ``iters`` single-call runs is made again, up to
    three runs in all; fails if none did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    per_call = len(run(1))
    counts = []
    for _ in range(3):
        events = run(iters)
        if per_call and len(events) >= 0.9 * per_call * iters:
            total_us = sum(e.device_time_total for e in events)
            return total_us / iters / 1e3, sorted({e.name for e in events})
        counts.append(len(events))
    fail(f"profiler: {counts} device events in three runs of {iters} calls ({per_call} per call)")


def kernel_bound(flops: float, nbytes: float, n_exp: float, exp_rate: float):
    """(ms, bound_by, terms): the least time the card could take for a
    kernel's work, the largest of its tensor-core operations at the bf16
    peak, its bytes (each input read once, each output written once) at the
    HBM rate, and its exp2 evaluations at the exp unit's rate; ``terms``
    holds all three in ms."""
    terms = {
        "operations": flops / PEAK_BF16_FLOPS * 1e3,
        "bytes": nbytes / PEAK_HBM_BYTES * 1e3,
        "exp": n_exp / exp_rate * 1e3,
    }
    by = max(terms, key=terms.get)
    return terms[by], by, terms


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


def input_image(size: int = 256, seed: int = 0):
    """A synthetic object on white: a shaded disc, seeded."""
    import numpy as np

    rng = np.random.default_rng(seed)
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
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi clocks.max.sm: {res.stderr.strip()}")
    sm_mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = EXP2_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6
    # fp32 matmuls and cuDNN convs in full f32 (cuDNN defaults to TF32):
    # the plain versions here are references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"phase device: {smi} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} cuda {torch.version.cuda} | tf32 off | {sms} SMs, "
        f"max SM clock {sm_mhz:.0f} MHz: exp2 {exp_rate / 1e12:.3f}e12/s"
    )
    return smi, exp_rate


def phase_build():
    from one2345_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    spills = []
    for name in libs:
        entry = None
        for line in _build.build_log(name).splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
            if "registers" in line or "spill" in line or found:
                log(f"  ptxas {name}: {line.strip()}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found and (int(found.group(1)) or int(found.group(2))):
                spills.append(f"{entry}: {line.strip()}")
    if spills:
        fail("ptxas spills registers in " + "; ".join(spills))
    log(
        f"phase build: {len(libs)} kernel(s) in {dt:.2f} s, no spills: {', '.join(sorted(libs))}"
    )


def check_forward(name: str, q, k, v):
    """The forward kernel against its plain version on the same bf16
    inputs: (max |O err|, max |lse err|); fails beyond O_TOL or LSE_TOL."""
    import torch

    from one2345_tpu_torch.ops.flash_attention import attention_reference, flash_attention

    o, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = attention_reference(q.float(), k.float(), v.float())
    err_o = float((o.float() - ref_o).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    if not (err_o <= O_TOL and err_lse <= LSE_TOL):
        fail(f"flash_attention {name}: O err {err_o} (<= {O_TOL}), lse err {err_lse} (<= {LSE_TOL})")
    return err_o, err_lse


def forward_inputs(i: int):
    """Seeded bf16 N(0, 1) q, k, v of ATTENTION_SHAPES[i], and its launches per timing."""
    import torch

    _, B, T, H, D = ATTENTION_SHAPES[i]
    gen = torch.Generator(device="cuda").manual_seed(100 + i)
    q, k, v = (
        torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    )
    return q, k, v, 50 if B * T >= 8192 else 200


def backward_case(B: int, T: int, S: int, H: int, D: int, seed: int):
    """Seeded bf16 N(0, 1) q, k, v, dO, the forward kernel's o and lse, and Dsum."""
    import torch

    from one2345_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (
        torch.randn(B, L, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        for L in (T, S, S, T)
    )
    o, lse = fa.flash_attention(q, k, v)
    return q, k, v, do, o, lse, fa.softmax_grad_rowsum(o, do)


def backward_inputs(i: int):
    """backward_case of TRAIN_SHAPES[i] (B=TRAIN_BATCH, H=8), and the launches per timing."""
    _, T, D = TRAIN_SHAPES[i]
    return (*backward_case(TRAIN_BATCH, T, T, 8, D, seed=200 + i), 50 if T >= 1024 else 200)


def check_backward(name: str, q, k, v, do, o, lse, dsum):
    """The dq and dkv kernels against the plain backward on the same inputs:
    (errors over max |ref|, max abs errors) of dQ, dK, dV; fails beyond
    BWD_TOL."""
    import torch

    from one2345_tpu_torch.ops import flash_attention as fa

    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum)
    torch.cuda.synchronize()
    refs = fa.attention_backward_reference(q.float(), k.float(), v.float(), o, lse, do)
    abs_errs = [float((got.float() - ref).abs().max()) for got, ref in zip((dq, dk, dv), refs)]
    errs = [e / float(ref.abs().max()) for e, ref in zip(abs_errs, refs)]
    if not max(errs) <= BWD_TOL:
        fail(f"flash attention backward {name}: dq/dk/dv errors {errs} (<= {BWD_TOL})")
    return errs, abs_errs


def check_repeatable(name: str, q, k, v, do, lse, dsum):
    """Two launches of each backward kernel on the same inputs give
    bit-identical outputs (no atomics); fails otherwise."""
    import torch

    from one2345_tpu_torch.ops import flash_attention as fa

    runs = [
        (fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum),
         *fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum))
        for _ in range(2)
    ]
    torch.cuda.synchronize()
    for label, a, b in zip(("dq", "dk", "dv"), *runs):
        if not torch.equal(a, b):
            fail(f"flash attention backward {name}: two launches differ in {label}")


def phase_kernels(exp_rate: float):
    import torch
    import torch.nn.functional as F

    from one2345_tpu_torch.ops.flash_attention import (
        attention_reference,
        copy_bytes,
        flash_attention,
    )

    rows = {}
    for i, (name, B, T, H, D) in enumerate(ATTENTION_SHAPES):
        q, k, v, iters = forward_inputs(i)
        err_o, err_lse = check_forward(name, q, k, v)
        ms = time_ms(lambda: flash_attention(q, k, v), iters)
        plain_ms = time_ms(lambda: attention_reference(q, k, v), max(iters // 5, 10))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        flops = 4.0 * B * H * T * T * D
        nbytes = 4.0 * q.numel() * q.element_size() + B * H * T * 4  # Q, K, V, O; lse
        bound_ms, bound_by, terms = kernel_bound(flops, nbytes, B * H * T * T, exp_rate)
        rows[name] = dict(
            max_abs_err=err_o, lse_err=err_lse, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms, flops=flops,
        )
        log(
            f"phase kernels: flash_attention {name} B={B} T=S={T} H={H} D={D} "
            f"({copy_bytes(q, k, v)}-byte copies): "
            f"O err {err_o:.3e} (<= {O_TOL}) lse err {err_lse:.3e} (<= {LSE_TOL}) | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        )
    for i, (name, B, T, S, H, D, width) in enumerate(RAGGED_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(150 + i)
        q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (
            torch.randn(B, S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2)
        )
        if copy_bytes(q, k, v) != width:
            fail(f"flash_attention {name}: {copy_bytes(q, k, v)}-byte copies, expected {width}")
        err_o, err_lse = check_forward(name, q, k, v)
        rows[name] = dict(max_abs_err=err_o, lse_err=err_lse)
        log(
            f"phase kernels: flash_attention {name} B={B} T={T} S={S} H={H} D={D} "
            f"({width}-byte copies): O err {err_o:.3e} (<= {O_TOL}) lse err {err_lse:.3e} "
            f"(<= {LSE_TOL})"
        )
    return rows


def phase_kernels_bwd(exp_rate: float):
    """The dq and dkv kernels against the plain backward at the train
    step's shapes and at the ragged shapes, from the forward kernel's o and
    lse."""
    from one2345_tpu_torch.ops import flash_attention as fa

    rows = {}
    B, H = TRAIN_BATCH, 8
    for i, (name, T, D) in enumerate(TRAIN_SHAPES):
        q, k, v, do, o, lse, dsum, iters = backward_inputs(i)
        errs, abs_errs = check_backward(name, q, k, v, do, o, lse, dsum)
        repeat = ""
        if name == TRAIN_HEADLINE:
            check_repeatable(name, q, k, v, do, lse, dsum)
            repeat = " | two launches bit-identical"
        dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum), iters)
        dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum), iters)
        plain_dq_ms = time_ms(lambda: fa.dq_reference(q, k, v, do, lse, dsum), max(iters // 5, 10))
        plain_dkv_ms = time_ms(lambda: fa.dkv_reference(q, k, v, do, lse, dsum), max(iters // 5, 10))
        # yardstick: the backward alone of PyTorch's fused attention (dQ, dK
        # and dV in one call), same inputs and dtype
        sdpa_ms = time_ms(sdpa_backward(q, k, v, do), iters)
        n = q.numel() * q.element_size()  # one [B, T, H, D] bf16 tensor
        stats = 2 * B * H * T * 4  # lse and dsum, f32 [B, H, T]
        row = {}
        for kernel, flops, nbytes, ms, plain_ms, err in (
            ("dq", 6.0 * B * H * T * T * D, 5 * n + stats, dq_ms, plain_dq_ms, abs_errs[0]),
            ("dkv", 8.0 * B * H * T * T * D, 6 * n + stats, dkv_ms, plain_dkv_ms,
             max(abs_errs[1:])),
        ):
            # one exp2 per score in each kernel (P recomputed from lse)
            bound_ms, bound_by, terms = kernel_bound(flops, nbytes, B * H * T * T, exp_rate)
            row[kernel] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms, flops=flops,
            )
        rows[name] = row
        log(
            f"phase kernels: flash_attention backward {name} B={B} T=S={T} H={H} D={D} "
            f"({fa.copy_bytes(q, k, v, do)}-byte copies): "
            f"dq/dk/dv err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} of max |ref| (<= {BWD_TOL}), "
            f"abs {abs_errs[0]:.3e}/{abs_errs[1]:.3e}/{abs_errs[2]:.3e} | "
            f"dq {dq_ms:.4f} ms (bound {row['dq']['bound_ms']:.4f}, {row['dq']['bound_by']}, "
            f"plain {plain_dq_ms:.4f}) | "
            f"dkv {dkv_ms:.4f} ms (bound {row['dkv']['bound_ms']:.4f}, {row['dkv']['bound_by']}, "
            f"plain {plain_dkv_ms:.4f}) | sdpa backward {sdpa_ms:.4f} ms{repeat}"
        )
    for i, (name, B, T, S, H, D, width) in enumerate(RAGGED_SHAPES):
        q, k, v, do, o, lse, dsum = backward_case(B, T, S, H, D, seed=250 + i)
        if fa.copy_bytes(q, k, v, do) != width:
            fail(f"flash attention backward {name}: {fa.copy_bytes(q, k, v, do)}-byte copies, "
                 f"expected {width}")
        errs, abs_errs = check_backward(name, q, k, v, do, o, lse, dsum)
        rows[name] = {"dq": dict(max_abs_err=abs_errs[0]), "dkv": dict(max_abs_err=max(abs_errs[1:]))}
        log(
            f"phase kernels: flash_attention backward {name} B={B} T={T} S={S} H={H} D={D} "
            f"({width}-byte copies): dq/dk/dv err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} of "
            f"max |ref| (<= {BWD_TOL})"
        )
    return rows


def sdpa_backward(q, k, v, do):
    """One call of the backward alone of PyTorch's fused attention on these
    [B, T, H, D] inputs (dQ, dK and dV in one torch.autograd.grad): the
    backward kernels' library yardstick, never called by the port."""
    import torch
    import torch.nn.functional as F

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in leaves))
    grad_out = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)


def phase_device_times(rows: dict, bwd_rows: dict):
    """Every kernel's device time per launch (torch.profiler) at every
    main-path and train-step shape, on the inputs of phase 3.  It runs
    after the timed phases: a profiled run can leave every later
    launch in the process costing more host time, and the B=8 sampling
    phases and the train step are host-bound."""
    from one2345_tpu_torch.ops import flash_attention as fa

    for i, (name, B, T, H, D) in enumerate(ATTENTION_SHAPES):
        q, k, v, iters = forward_inputs(i)
        ms, recorded = device_ms_per_launch(
            lambda: fa.flash_attention(q, k, v), "flash_fwd_kernel", iters
        )
        row = rows[name]
        row["device_ms"] = ms
        log(
            f"phase device times: flash_attention {name} B={B} T=S={T} H={H} D={D}: "
            f"device {ms:.4f} ms/launch ({recorded} of {iters} launches recorded), "
            f"{row['flops'] / ms / 1e9:.1f} TFLOP/s, {row['bound_ms'] / ms:.2f} of the bound"
        )
    for i, (name, T, D) in enumerate(TRAIN_SHAPES):
        q, k, v, do, _, lse, dsum, iters = backward_inputs(i)
        for kernel, fn in (("dq", fa.flash_attention_bwd_dq), ("dkv", fa.flash_attention_bwd_dkv)):
            ms, recorded = device_ms_per_launch(
                lambda: fn(q, k, v, do, lse, dsum), f"flash_bwd_{kernel}_kernel", iters
            )
            row = bwd_rows[name][kernel]
            row["device_ms"] = ms
            log(
                f"phase device times: flash_attention backward {kernel} {name} B={TRAIN_BATCH} "
                f"T=S={T} H=8 D={D}: device {ms:.4f} ms/launch ({recorded} of {iters} launches "
                f"recorded), {row['flops'] / ms / 1e9:.1f} TFLOP/s, "
                f"{row['bound_ms'] / ms:.2f} of the bound"
            )
        sdpa_ms, names = device_ms_per_call(sdpa_backward(q, k, v, do), iters)
        for kernel in ("dq", "dkv"):
            bwd_rows[name][kernel]["library_device_ms"] = sdpa_ms
        log(
            f"phase device times: sdpa backward {name} B={TRAIN_BATCH} T=S={T} H=8 D={D}: "
            f"device {sdpa_ms:.4f} ms/call (event {bwd_rows[name]['dq']['library_ms']:.4f} ms) | "
            f"dq + dkv device {bwd_rows[name]['dq']['device_ms'] + bwd_rows[name]['dkv']['device_ms']:.4f} ms"
            f" | kernels: {'; '.join(names)}"
        )


def phase_unet():
    import torch

    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.diffusion.unet import cast_compute
    from one2345_tpu_torch.diffusion.zero123 import make_unet
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    u = DiffusionConfig().unet
    with torch.device("meta"):
        shapes = make_unet(u)
    weights = seeded_state_dict(shapes, seed=1)
    with torch.device("meta"):
        cpu_unet = make_unet(u)
    cpu_unet.load_state_dict(weights, strict=True, assign=True)
    with torch.device("cuda"):
        gpu_unet = make_unet(u)
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


def phase_grad():
    """Gradients of one full-width level-0 SpatialTransformer: the card (f32
    weights, bf16 autocast, the forward and backward kernels) against the
    CPU (f32, plain versions), same seeded weights and inputs."""
    import torch

    from one2345_tpu_torch.diffusion.unet import SpatialTransformer
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    C, heads, ctx_dim, B, L = 320, 8, 768, 2, 32
    with torch.device("meta"):
        shapes = SpatialTransformer(C, ctx_dim, heads, 1)
    weights = seeded_state_dict(shapes, seed=5)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(B, C, L, L, generator=gen)
    ctx = torch.randn(B, 1, ctx_dim, generator=gen)
    w = torch.randn(B, C, L, L, generator=gen)  # the loss is sum(out * w)
    grads, launches = {}, None
    for device in ("cpu", "cuda"):
        with torch.device("meta"):
            module = SpatialTransformer(C, ctx_dim, heads, 1)
        module = module.to_empty(device=device)
        module.load_state_dict(weights, strict=True)
        f = flash_attention
        f.launch_count = f.dq_launch_count = f.dkv_launch_count = 0
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=device == "cuda"):
            out = module(x.to(device), ctx.to(device))
        (out.float() * w.to(device)).sum().backward()
        if device == "cuda":
            torch.cuda.synchronize()
            launches = (f.launch_count, f.dq_launch_count, f.dkv_launch_count)
        grads[device] = {
            k: None if p.grad is None else p.grad.float().cpu()
            for k, p in module.named_parameters()
        }
    if launches != (1, 1, 1):
        fail(f"SpatialTransformer fwd/dq/dkv launches {launches}, expected (1, 1, 1)")
    rels = {}
    for k, ref in grads["cpu"].items():
        got = grads["cuda"][k]
        if k.endswith(DEAD):
            if ref is not None or got is not None:
                fail(f"SpatialTransformer: {k} should get no gradient")
            continue
        if got is None or not torch.isfinite(got).all():
            fail(f"SpatialTransformer: {k} gradient missing or not finite on the card")
        rels[k] = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    for k in ("block0.attn1.to_q.weight", "block0.attn1.to_k.weight", "block0.attn1.to_v.weight"):
        if not float(grads["cuda"][k].abs().max()) > 0:
            fail(f"SpatialTransformer: {k} gradient is zero on the card")
    worst = max(rels, key=rels.get)
    if rels[worst] > GRAD_TOL:
        fail(f"SpatialTransformer: {worst} gradient relative L2 {rels[worst]} (> {GRAD_TOL})")
    attn1 = max(v for k, v in rels.items() if ".attn1." in k)
    log(
        f"phase grad: full-width level-0 SpatialTransformer B={B} T={L * L} C={C}: "
        f"{len(rels)} parameter gradients, card bf16 autocast vs CPU f32 relative L2 "
        f"worst {rels[worst]:.3e} ({worst}), attn1 worst {attn1:.3e} (<= {GRAD_TOL}); "
        f"{len(grads['cpu']) - len(rels)} unread parameters without gradient on both; "
        f"fwd/dq/dkv launches {launches}"
    )


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


def build_stage(unet_weights):
    """The full-width Zero123 stage on the card with seeded weights, and the
    f32 state dicts it was built from."""
    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage

    t0 = time.perf_counter()
    shapes = Zero123Stage(DiffusionConfig(), device="meta")
    params = {"unet": unet_weights}
    for i, name in enumerate(("encoder", "decoder", "clip", "cc_projection")):
        params[name] = seeded_state_dict(getattr(shapes, name), seed=10 + i)
    stage = Zero123Stage(DiffusionConfig(), params=params, device="cuda")
    log(f"stage built with seeded weights in {time.perf_counter() - t0:.1f} s")
    return stage, params


def phase_sampling(stage, smi):
    import torch

    from one2345_tpu_torch.core.profiling import Timer, unet_flops_per_eval
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    image = input_image(stage.config.image_size)
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


def train_batch(B: int):
    """A synthetic finetune batch on the card: target and conditioning
    images in [-1, 1] and the pose tokens of seeded camera pairs."""
    import numpy as np
    import torch

    from one2345_tpu_torch.training.data import relative_pose_token

    rng = np.random.default_rng(7)

    def camera():
        c2w = np.eye(4)
        d = rng.normal(size=3)
        c2w[:3, 3] = d / np.linalg.norm(d) * rng.uniform(1.5, 2.2)
        return c2w

    batch = {
        "image_target": np.stack([input_image(256, seed=20 + i) for i in range(B)]) * 2 - 1,
        "image_cond": np.stack([input_image(256, seed=40 + i) for i in range(B)]) * 2 - 1,
        "T": np.stack([relative_pose_token(camera(), camera()) for _ in range(B)])[:, None],
    }
    return {k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in batch.items()}


def phase_train(stage, params, smi):
    """Six full-width finetune steps; returns the backward kernels' launches."""
    import torch

    from one2345_tpu_torch.core.profiling import unet_flops_per_eval
    from one2345_tpu_torch.ops.flash_attention import flash_attention as f
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    t0 = time.perf_counter()
    trainer = Zero123Trainer(
        stage, {k: params[k] for k in ("unet", "cc_projection")}, remat=True, device="cuda"
    )
    named = [
        (f"{m}.{k}", p) for m, module in trainer.modules.items()
        for k, p in module.named_parameters()
    ]
    start = [p.detach().clone() for _, p in named]
    n_params = sum(p.numel() for _, p in named)
    batch = train_batch(TRAIN_BATCH)
    log(
        f"phase train: Zero123Trainer at full width, {n_params / 1e6:.1f} M f32 trainable "
        f"parameters in {len(named)} tensors, remat, bf16 autocast, B={TRAIN_BATCH}, "
        f"built in {time.perf_counter() - t0:.1f} s"
    )
    # model FLOPs: UNet forward + backward (3x the forward); the remat
    # recompute, the frozen towers and the optimizer are not counted
    flops = 3 * unet_flops_per_eval(TRAIN_BATCH)
    totals = [0, 0, 0]
    warm = []
    for step in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        f.launch_count = f.dq_launch_count = f.dkv_launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (f.launch_count, f.dq_launch_count, f.dkv_launch_count)
        totals = [a + b for a, b in zip(totals, counts)]
        loss = float(loss)
        if counts != (32, 16, 16):
            fail(f"train step {step + 1}: fwd/dq/dkv launches {counts}, expected (32, 16, 16)")
        if not math.isfinite(loss):
            fail(f"train step {step + 1}: loss {loss}")
        extra = ""
        if step == 0:
            extra = " | " + check_first_step(trainer, named, start)
        else:
            warm.append(dt)
        log(
            f"phase train ({'cold' if step == 0 else 'warm'}) step {step + 1}: {dt:.4f} s, "
            f"loss {loss:.5f}, {TRAIN_BATCH / dt:.2f} samples/s, "
            f"UNet MFU {flops / dt / PEAK_BF16_FLOPS:.4f} ({flops / 1e12:.2f} TFLOP/step), "
            f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"fwd/dq/dkv launches {counts}{extra}"
        )
    mean = sum(warm) / len(warm)
    log(
        f"phase train: {len(warm)} warm steps mean {mean:.4f} s (min {min(warm):.4f}, max "
        f"{max(warm):.4f}), {TRAIN_BATCH / mean:.2f} samples/s, UNet MFU "
        f"{flops / mean / PEAK_BF16_FLOPS:.4f} | {smi}"
    )
    return totals


def check_first_step(trainer, named, start) -> str:
    """After the first step: every read parameter has a finite, non-zero
    gradient, the unread ones an exact zero, and the params and EMA moved."""
    import torch

    dead, bad = 0, []
    for name, p in named:
        g = p.grad
        if name.endswith(DEAD):
            dead += 1
            if g is None or torch.count_nonzero(g) != 0:
                bad.append(name)
        elif g is None or not torch.isfinite(g).all() or not float(g.abs().max()) > 0:
            bad.append(name)
    if bad:
        fail(f"train step 1: gradient missing, zero or not finite for {bad[:8]} ({len(bad)})")
    attn1 = sum(".attn1.to_" in name for name, _ in named)
    ema = [t for d in trainer.ema.values() for t in d.values()]
    total = sum(p.numel() for _, p in named)
    moved = sum(int(torch.count_nonzero(p.detach() != s)) for (_, p), s in zip(named, start))
    ema_moved = sum(int(torch.count_nonzero(e != s)) for e, s in zip(ema, start))
    if not (moved > 0 and ema_moved > 0):
        fail(f"train step 1: params moved {moved}, EMA moved {ema_moved} of {total}")
    return (
        f"{len(named) - dead} gradients finite and non-zero (of them {attn1} attn1 "
        f"projection tensors), {dead} unread parameters with zero gradient; params moved "
        f"{moved / total:.4f}, EMA {ema_moved / total:.4f} of {total} elements"
    )


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

    smi, exp_rate = phase_device()
    phase_build()
    rows = phase_kernels(exp_rate)
    bwd_rows = phase_kernels_bwd(exp_rate)
    unet_weights = phase_unet()
    phase_grad()
    stage, params = build_stage(unet_weights)
    launches = phase_sampling(stage, smi)
    _, dq_launches, dkv_launches = phase_train(stage, params, smi)
    phase_device_times(rows, bwd_rows)

    def json_bound_by(by: str) -> str:
        # the line names two kinds of bound: the exp unit's rate is a peak
        # rate of operations of one type; `bound_terms` gives all three
        # terms in ms, so an exp bound shows as the largest of them
        return "bytes" if by == "bytes" else "operations"

    head = rows[HEADLINE_SHAPE]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "one2345_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "one2345_tpu/ops/flash_attention.py:36",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": head["ms"],
        "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": json_bound_by(head["bound_by"]),
        "bound_terms": head["bound_terms"],
        "library_ms": head["library_ms"],
    }]
    for kernel, line, n in (("dq", 71, dq_launches), ("dkv", 99, dkv_launches)):
        row = bwd_rows[TRAIN_HEADLINE][kernel]
        kernels.append({
            "name": f"flash_attention_bwd_{kernel}",
            "route": "cuda",
            "source": "one2345_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"one2345_tpu/ops/flash_attention.py:{line}",
            "launches": n,
            "max_abs_err": max(r[kernel]["max_abs_err"] for r in bwd_rows.values()),
            "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": json_bound_by(row["bound_by"]),
            "bound_terms": row["bound_terms"],
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
        })
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
