#!/usr/bin/env python3
"""Where one full-width Zero123-XL UNet eval of the PyTorch port spends its
time on the card, at the main path's CFG batches (8 and 56); with
``--train``, where one full-width finetune step spends it.

    python3 examples/torch_profile_unet.py [--batches 8 56] [--iters 10] [--out-dir DIR]
    python3 examples/torch_profile_unet.py --train [--batches 8] [--iters 5]

For each batch: the eval's (or train step's) time by CUDA events and by the
host clock (after warm-up), UNet MFU against 989 TFLOP/s bf16 (a train
step counts 3 UNet evals of model work: forward and backward, not the remat
recompute), and a torch.profiler window of a few evals or steps: device
busy and idle share, the flash-attention kernels' share, and the top
operators by device time.  With ``--out-dir`` the full operator tables go
to DIR/torch_profile_{unet,train}_b<B>.txt.  Weights are seeded and
non-zero (chip_smoke.seeded_state_dict); a train step's batch is
chip_smoke.train_batch.  Needs one card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# kernel families by a substring of the kernel's name, first match wins
FAMILIES = (
    ("flash_attention", ("flash_fwd_kernel",)),
    ("flash_attention backward", ("flash_bwd_",)),
    ("optimizer and EMA (foreach)", ("multi_tensor_apply",)),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convs", ("fprop", "conv", "implicit")),
    ("matmuls", ("gemm", "nvjet", "cutlass")),
    ("norms", ("norm", "Moments", "ComputeFused")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise and copies"


def sort_key(prof) -> str:
    """The profiler table's sort key for device time in this torch version."""
    avg = prof.key_averages()
    return "self_device_time_total" if hasattr(avg[0], "self_device_time_total") else "self_cuda_time_total"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_unet: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import device_time_us as device_time
    from chip_smoke import seeded_state_dict
    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.core.profiling import unet_flops_per_eval
    from one2345_tpu_torch.diffusion.unet import cast_compute
    from one2345_tpu_torch.diffusion.zero123 import make_unet

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 56])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out-dir", default=None, help="directory for the full operator tables")
    ap.add_argument("--train", action="store_true", help="profile the finetune step instead")
    args = ap.parse_args()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    u = DiffusionConfig().unet
    with torch.device("meta"):
        shapes = make_unet(u)
    weights = seeded_state_dict(shapes, seed=args.seed)
    if args.train:
        from chip_smoke import build_stage, train_batch
        from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

        stage, params = build_stage(weights)
        trainer = Zero123Trainer(
            stage, {k: params[k] for k in ("unet", "cc_projection")}, remat=True, device="cuda"
        )
        what, evals = "train", 3  # forward + backward
    else:
        with torch.device("cuda"):
            unet = make_unet(u)
        unet.load_state_dict(weights, strict=True)
        cast_compute(unet.requires_grad_(False).eval(), torch.bfloat16)
        what, evals = "unet", 1
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    for B in args.batches:
        gen = torch.Generator(device="cuda").manual_seed(args.seed + B)
        x = torch.randn(B, 32, 32, u.in_channels, generator=gen, device="cuda")
        t = torch.full((B,), 500, device="cuda")
        ctx = torch.randn(B, 1, u.context_dim, generator=gen, device="cuda")
        batch = train_batch(B) if args.train else None

        def step():
            if args.train:
                trainer.train_step(batch)
                return
            with torch.inference_mode():
                unet(x, t, ctx)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(args.iters):
            step()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.iters
        ev_ms = start.elapsed_time(end) / args.iters
        flops = evals * unet_flops_per_eval(B)

        n_prof = 3
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            for _ in range(n_prof):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - w0) * 1e6
        cuda = torch.autograd.DeviceType.CUDA
        # device kernels only: a user annotation (Optimizer.step#AdamW.step)
        # also carries the device time of the kernels inside it
        rows = [
            r for r in prof.key_averages()
            if r.device_type == cuda and device_time(r) > 0
            and not getattr(r, "is_user_annotation", False)
        ]
        busy_us = sum(device_time(r) for r in rows)
        flash_us = sum(device_time(r) for r in rows if "flash_" in r.key)
        rows.sort(key=device_time, reverse=True)
        fams = {}
        for r in rows:
            fams[family(r.key)] = fams.get(family(r.key), 0.0) + device_time(r)
        launches = sum(r.count for r in rows) / n_prof
        if args.out_dir:
            table = prof.key_averages().table(sort_by=sort_key(prof), row_limit=60)
            with open(os.path.join(args.out_dir, f"torch_profile_{what}_b{B}.txt"), "w") as f:
                f.write(f"{smi}\nB={B}\n{table}\n")
        print(
            f"{what} B={B}: {ev_ms:.3f} ms/{what} (CUDA events), {host_ms:.3f} ms/{what} (host), "
            f"{flops / 1e12:.3f} TFLOP, MFU {flops / (ev_ms * 1e-3) / 989e12:.4f} | profiled "
            f"{n_prof}: device busy {busy_us / wall_us:.3f} of {wall_us / 1e3:.1f} ms, "
            f"flash_attention kernels {flash_us / busy_us:.3f} of busy, {launches:.0f} device "
            f"kernels per {what} | {smi}",
            flush=True,
        )
        print(
            f"  by family (ms/{what}): "
            + ", ".join(f"{k} {v / n_prof / 1e3:.3f}" for k, v in sorted(fams.items(), key=lambda kv: -kv[1])),
            flush=True,
        )
        for r in rows[:12]:
            print(
                f"  {device_time(r) / n_prof / 1e3:8.3f} ms/{what} {r.count // n_prof:5d} calls/{what}  "
                f"{r.key[:110]}",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
