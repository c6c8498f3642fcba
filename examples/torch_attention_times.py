#!/usr/bin/env python3
"""Time the flash-attention forward kernel of a checkout of the PyTorch
port at every main-path shape (chip_smoke.ATTENTION_SHAPES), on the card.

    python3 examples/torch_attention_times.py [--repo DIR]

``--repo`` names the checkout whose ``one2345_tpu_torch`` is timed (default:
this one), so two commits can be compared in one run on one card: unpack
the other into a directory and alternate the two.  For each shape it prints
the wrapper's time by CUDA events, the kernel's device time per launch from
torch.profiler and the wrapper's host time per call (the host clock over
calls that are not waited for) before any profiled run and after all of
them, then one JSON line of these and the card's name and power limit.
Inputs are bf16 N(0, 1) from a seeded generator.  Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This checkout's chip_smoke.py (its shapes and timers), whatever --repo is."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE, help="checkout whose one2345_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_times: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from one2345_tpu_torch.ops.flash_attention import flash_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    def host_ms(fn, iters: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        return ms

    out = {}
    # host-clock timings at every shape before any profiled run, and again
    # after all of them: a profiled run can tax later launches
    for i, (name, *_) in enumerate(cs.ATTENTION_SHAPES):
        q, k, v, iters = cs.forward_inputs(i)
        ms = cs.time_ms(lambda: flash_attention(q, k, v), iters)
        out[name] = {"ms": ms, "host_ms": host_ms(lambda: flash_attention(q, k, v), iters)}
    for i, (name, *_) in enumerate(cs.ATTENTION_SHAPES):
        q, k, v, iters = cs.forward_inputs(i)
        out[name]["device_ms"], _ = cs.device_ms_per_launch(
            lambda: flash_attention(q, k, v), "flash_fwd_kernel", iters
        )
    for i, (name, B, T, H, D) in enumerate(cs.ATTENTION_SHAPES):
        q, k, v, iters = cs.forward_inputs(i)
        row = out[name]
        row["host_ms_after_profiler"] = host_ms(lambda: flash_attention(q, k, v), iters)
        print(
            f"{name} B={B} T=S={T} H={H} D={D}: {row['ms']:.4f} ms (CUDA events), "
            f"{row['device_ms']:.4f} ms device per launch, {row['host_ms']:.4f} ms host per "
            f"call ({row['host_ms_after_profiler']:.4f} after the profiler) | {repo} | {smi}",
            flush=True,
        )
    print(json.dumps({"repo": repo, "device": smi, "flash_attention_fwd": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
