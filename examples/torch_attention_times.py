#!/usr/bin/env python3
"""Time the flash-attention forward kernel of a checkout of the PyTorch
port at every main-path shape (chip_smoke.ATTENTION_SHAPES), or with
``--backward`` its dq and dkv kernels at every train-step shape
(chip_smoke.TRAIN_SHAPES), on the card.

    python3 examples/torch_attention_times.py [--backward] [--repo DIR]

``--repo`` names the checkout whose ``one2345_tpu_torch`` is timed (default:
this one), so two commits can be compared in one run on one card: unpack
the other into a directory and alternate the two.  For each shape and
kernel it prints the wrapper's time by CUDA events, the kernel's device
time per launch from torch.profiler and the wrapper's host time per call
(the host clock over calls that are not waited for) before any profiled
run and after all of them, then one JSON line of these and the card's name
and power limit.  Inputs are bf16 N(0, 1) from a seeded generator
(chip_smoke.forward_inputs, backward_inputs).  Needs one card.
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
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernels (dq, dkv) at the train-step shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_times: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from one2345_tpu_torch.ops import flash_attention as fa

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

    # (label, call, kernel name, launches per timing) of every timed case
    cases = []
    if args.backward:
        for i, (name, T, D) in enumerate(cs.TRAIN_SHAPES):
            q, k, v, do, _, lse, dsum, iters = cs.backward_inputs(i)
            label = f"{name} B={cs.TRAIN_BATCH} T=S={T} H=8 D={D}"
            for kernel, fn in (("dq", fa.flash_attention_bwd_dq), ("dkv", fa.flash_attention_bwd_dkv)):
                call = (lambda fn=fn, x=(q, k, v, do, lse, dsum): fn(*x))
                cases.append((f"{kernel} {label}", call, f"flash_bwd_{kernel}_kernel", iters))
    else:
        for i, (name, B, T, H, D) in enumerate(cs.ATTENTION_SHAPES):
            q, k, v, iters = cs.forward_inputs(i)
            call = (lambda x=(q, k, v): fa.flash_attention(*x))
            cases.append((f"{name} B={B} T=S={T} H={H} D={D}", call, "flash_fwd_kernel", iters))

    out = {}
    # host-clock timings of every case before any profiled run, and again
    # after all of them: a profiled run can tax later launches
    for label, call, _, iters in cases:
        out[label] = {"ms": cs.time_ms(call, iters), "host_ms": host_ms(call, iters)}
    for label, call, kernel, iters in cases:
        out[label]["device_ms"], _ = cs.device_ms_per_launch(call, kernel, iters)
    for label, call, _, iters in cases:
        row = out[label]
        row["host_ms_after_profiler"] = host_ms(call, iters)
        print(
            f"{label}: {row['ms']:.4f} ms (CUDA events), "
            f"{row['device_ms']:.4f} ms device per launch, {row['host_ms']:.4f} ms host per "
            f"call ({row['host_ms_after_profiler']:.4f} after the profiler) | {repo} | {smi}",
            flush=True,
        )
    key = "flash_attention_bwd" if args.backward else "flash_attention_fwd"
    print(json.dumps({"repo": repo, "device": smi, key: out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
