#!/usr/bin/env python3
"""Time the flash-attention forward kernel of a checkout of the PyTorch
port at every main-path shape (chip_smoke.ATTENTION_SHAPES), or with
``--backward`` its whole backward and its dq and dkv kernels at every
train-step shape (chip_smoke.TRAIN_SHAPES), on the card.

    python3 examples/torch_attention_times.py [--backward] [--repo DIR]

``--repo`` names the checkout whose ``one2345_tpu_torch`` is timed (default:
this one), so two commits can be compared in one run on one card: unpack
the other into a directory and alternate the two.  For each shape and
kernel it prints the wrapper's time by CUDA events, the kernel's device
time per launch from torch.profiler and the wrapper's host time per call
(the host clock over calls that are not waited for) before any profiled
run and after all of them, then one JSON line of these and the card's name
and power limit.  Each shape also gets its bound (chip_smoke.kernel_bound,
chip_smoke.backward_bounds) and the same three times of PyTorch's
scaled_dot_product_attention on the same inputs, forward or backward (the
library yardstick).  The whole backward is one call of
``flash_attention_backward`` and SDPA's one ``torch.autograd.grad``: their
device times are per call, over every kernel they run (for a checkout
whose backward computes Dsum in PyTorch before the dq and dkv kernels,
that pass too).  The forward's rows also carry the SHA-256 of O and lse,
so that two checkouts' outputs can be compared bit for bit.  Inputs are
bf16 N(0, 1) from a seeded generator (chip_smoke.forward_inputs,
backward_inputs).  Needs one card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
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
                    help="time the backward (whole, dq, dkv) at the train-step shapes")
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

    # (label, call, kernel name or None for a whole call, launches per
    # timing) of every timed case, and the bounds by label
    cases, bounds, digests = [], {}, {}
    _, exp_rate = cs.phase_device()
    if args.backward:
        # the dq entry point takes O (it computes Dsum) or, in a checkout
        # from before that, Dsum
        takes_o = list(inspect.signature(fa.flash_attention_bwd_dq).parameters)[-1] == "o"
        for i, (name, T, D) in enumerate(cs.TRAIN_SHAPES):
            q, k, v, do, o, lse, dsum, iters = cs.backward_inputs(i)
            label = f"{name} B={cs.TRAIN_BATCH} T=S={T} H=8 D={D}"
            whole = (lambda x=(q, k, v, o, lse, do): fa.flash_attention_backward(*x))
            cases.append((f"backward {label}", whole, None, iters))
            dq = (lambda x=(q, k, v, do, lse, o if takes_o else dsum): fa.flash_attention_bwd_dq(*x))
            cases.append((f"dq {label}", dq, "flash_bwd_dq_kernel", iters))
            dkv = (lambda x=(q, k, v, do, lse, dsum): fa.flash_attention_bwd_dkv(*x))
            cases.append((f"dkv {label}", dkv, "flash_bwd_dkv_kernel", iters))
            cases.append((f"sdpa backward {label}", cs.sdpa_backward(q, k, v, do), None, iters))
            for kernel, (_, _, bound) in cs.backward_bounds(cs.TRAIN_BATCH, T, 8, D,
                                                            exp_rate).items():
                bounds[f"{kernel} {label}"] = bound[:2]
    else:
        import torch.nn.functional as F

        for i, (name, B, T, H, D) in enumerate(cs.ATTENTION_SHAPES):
            q, k, v, iters = cs.forward_inputs(i)
            label = f"{name} B={B} T=S={T} H={H} D={D}"
            call = (lambda x=(q, k, v): fa.flash_attention(*x))
            cases.append((label, call, "flash_fwd_kernel", iters))
            o, lse = call()
            digests[label] = hashlib.sha256(
                o.contiguous().view(torch.int16).cpu().numpy().tobytes()
                + lse.contiguous().cpu().numpy().tobytes()).hexdigest()
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = (lambda x=(qt, kt, vt): F.scaled_dot_product_attention(*x))
            cases.append((f"sdpa {label}", sdpa, None, iters))
            flops = 4.0 * B * H * T * T * D
            nbytes = 4.0 * q.numel() * q.element_size() + B * H * T * 4
            bounds[label] = cs.kernel_bound(flops, nbytes, B * H * T * T, exp_rate)[:2]

    out = {}
    # host-clock timings of every case before any profiled run, and again
    # after all of them: a profiled run can tax later launches
    for label, call, _, iters in cases:
        out[label] = {"ms": cs.time_ms(call, iters), "host_ms": host_ms(call, iters)}
    for label, call, kernel, iters in cases:
        if kernel is None:  # a whole call: every kernel it launches
            out[label]["device_ms"], out[label]["kernels"] = cs.device_ms_per_call(call, iters)
        else:
            out[label]["device_ms"], _ = cs.device_ms_per_launch(call, kernel, iters)
    for label, call, kernel, iters in cases:
        row = out[label]
        row["host_ms_after_profiler"] = host_ms(call, iters)
        if label in digests:
            row["outputs_sha256"] = digests[label]
        bound = ""
        if label in bounds:
            row["bound_ms"], row["bound_by"] = bounds[label]
            bound = (f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                     f"{row['bound_ms'] / row['device_ms']:.2f} of it")
        print(
            f"{label}: {row['ms']:.4f} ms (CUDA events), "
            f"{row['device_ms']:.4f} ms device per {'launch' if kernel else 'call'}"
            f"{bound}, {row['host_ms']:.4f} ms host per "
            f"call ({row['host_ms_after_profiler']:.4f} after the profiler)"
            + (f" | O, lse sha256 {digests[label][:16]}" if label in digests else "")
            + f" | {repo} | {smi}",
            flush=True,
        )
    key = "flash_attention_bwd" if args.backward else "flash_attention_fwd"
    print(json.dumps({"repo": repo, "device": smi, key: out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
