#!/usr/bin/env python3
"""Compare tile shapes of the flash-attention backward kernels
(csrc/flash_attention_bwd.cu) on the card, in one process.

    python3 examples/torch_attention_sweep.py [--rounds 2] [--variants 0 3 5] [--out FILE]

Each variant replaces some of the six instance shapes (dq and dkv at D
padded to 48, 80 and 160) with ``Shape<MT, warps, tile, stages, regs>``: it
is built by nvcc from a file that defines the FLASH_BWD_* macros and
includes the kernel source, into one2345_tpu_torch/_build/sweep/.  Variant
0 is the source as it stands.  For every variant the script prints ptxas's
registers and spills per instance, checks dQ, dK and dV against the plain
backward (chip_smoke.BWD_TOL) at the train step's shapes and the ragged
shapes, then times dq and dkv at every train shape: CUDA-event ms in
``--rounds`` passes over the variants (forward, then reversed order, and
so on), and device ms per launch by torch.profiler.  A variant that spills
or disagrees is reported and not timed.  The last line is one JSON object;
with ``--out`` the full record (shapes, ptxas, errors, every timing) goes
to FILE as JSON.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# instance -> (MT, warps, tile, stages, regs); what a variant leaves out is
# the source's own shape.  Axes: 16 or 32 rows per warp, 4 or 8 warps, 64-
# to 256-row blocks, 2 or 3 ring stages, the fixed pair's A fragments in
# registers or re-read from shared memory.  Variant 1 holds the first
# shapes of the rewritten kernels; 1-10 were the first sweep, 11-16 the
# second, around the shapes the first one chose.
FIRST = {"DQ48": (1, 4, 64, 3, 1), "DKV48": (1, 4, 64, 3, 1), "DQ80": (1, 4, 64, 2, 1),
         "DKV80": (1, 4, 64, 2, 0), "DQ160": (1, 4, 64, 2, 0), "DKV160": (1, 4, 32, 2, 0)}
VARIANTS = [
    {},
    FIRST,
    {"DQ48": (1, 8, 64, 3, 1), "DKV48": (1, 4, 64, 3, 0), "DQ80": (1, 8, 64, 2, 1),
     "DKV80": (1, 4, 64, 2, 1), "DQ160": (1, 4, 32, 2, 0), "DKV160": (1, 4, 16, 2, 0)},
    {"DQ48": (1, 4, 64, 2, 1), "DKV48": (1, 8, 64, 3, 1), "DQ80": (1, 4, 64, 3, 1),
     "DKV80": (1, 8, 64, 2, 0), "DQ160": (1, 4, 16, 2, 0)},
    {"DQ48": (2, 4, 32, 3, 1), "DKV48": (1, 4, 64, 2, 1), "DQ80": (1, 4, 64, 2, 0),
     "DKV80": (1, 4, 64, 3, 0)},
    {"DQ48": (2, 4, 32, 2, 1), "DKV48": (2, 4, 32, 3, 0)},
    {"DQ48": (1, 8, 64, 2, 1), "DKV48": (2, 4, 32, 2, 0)},
    {"DQ48": (1, 4, 64, 3, 0), "DKV48": (1, 8, 64, 2, 1)},
    {"DQ48": (2, 4, 32, 3, 0), "DKV48": (1, 8, 64, 3, 0)},
    {"DQ48": (1, 4, 32, 3, 1), "DKV48": (2, 4, 32, 3, 1)},
    {"DKV48": (2, 8, 32, 3, 0)},
    # the second sweep
    {"DQ48": (2, 4, 32, 3, 1), "DKV48": (2, 4, 32, 2, 1), "DQ80": (2, 4, 32, 2, 0),
     "DKV80": (2, 4, 32, 2, 0), "DKV160": (1, 4, 16, 2, 0)},
    {"DQ48": (2, 4, 32, 2, 0), "DKV48": (2, 4, 32, 3, 0), "DQ80": (1, 8, 64, 2, 0),
     "DKV80": (1, 4, 64, 2, 0), "DQ160": (1, 4, 64, 2, 0)},
    {"DQ48": (2, 8, 32, 2, 1), "DKV48": (2, 4, 32, 2, 0), "DQ80": (2, 4, 32, 2, 1),
     "DKV80": (1, 8, 64, 3, 0)},
    {"DQ48": (2, 4, 32, 3, 1), "DKV48": (2, 4, 32, 3, 1)},
    {"DQ48": (2, 4, 32, 2, 1), "DKV48": (2, 4, 32, 2, 1)},
    FIRST,
]
WIDTH_OF_SHAPE = {"level0": 48, "level1": 80, "level2": 160, "mid": 160}


def shape_text(shape) -> str:
    mt, warps, tile, stages, regs = shape
    return f"Shape<{mt}, {warps}, {tile}, {stages}, {'true' if regs else 'false'}>"


def build(variants):
    """One library per variant, all nvcc processes started together:
    {index: (path or None, {instance: (registers, spill bytes)}, log)}."""
    from one2345_tpu_torch.core import compile_cache
    from one2345_tpu_torch.ops import _build

    out_dir = compile_cache.build_dir() / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = _build.CSRC / "flash_attention_bwd.cu"
    procs = {}
    for i, variant in variants:
        wrapper = out_dir / f"variant{i}.cu"
        lines = [f"#define FLASH_BWD_{name} {shape_text(shape)}" for name, shape in variant.items()]
        wrapper.write_text("\n".join(lines + [f'#include "{source}"', ""]))
        lib = out_dir / f"libvariant{i}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(wrapper)]
        procs[i] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for i, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        usage, entry = {}, None
        for line in log.splitlines():
            found = re.search(r"flash_bwd_(dq|dkv)_kernelILi(\d+)ELi(\d+)E", line)
            if found and "Compiling entry function" in line:
                entry = f"{found.group(1)}{found.group(2)}/{found.group(3)}B"
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found and entry:
                usage.setdefault(entry, [0, 0])[1] = int(found.group(1)) + int(found.group(2))
            found = re.search(r"Used (\d+) registers", line)
            if found and entry:
                usage.setdefault(entry, [0, 0])[0] = int(found.group(1))
        built[i] = (lib if proc.returncode == 0 else None, usage, log)
    return built


def use(lib_path):
    """Route the wrapper's backward launches to the library at ``lib_path``."""
    from one2345_tpu_torch.ops import _build
    from one2345_tpu_torch.ops import flash_attention as fa

    _build._loaded["flash_attention_bwd"] = ctypes.CDLL(str(lib_path))
    fa._bind.cache_clear()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2, help="timing passes over the variants")
    ap.add_argument("--variants", type=int, nargs="*", help="indices into VARIANTS (default: 0 and 11-16)")
    ap.add_argument("--out", default=None, help="file for the full JSON record")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from one2345_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    chosen = args.variants if args.variants else [0, *range(11, len(VARIANTS))]
    variants = [(i, VARIANTS[i]) for i in chosen]
    built = build(variants)

    train = [cs.backward_inputs(i) for i in range(len(cs.TRAIN_SHAPES))]
    ragged = [cs.backward_case(*r[1:6], seed=250 + j) for j, r in enumerate(cs.RAGGED_SHAPES)]
    cases = [(n, x[:7]) for (n, _, _), x in zip(cs.TRAIN_SHAPES, train)]
    cases += [(r[0], x) for r, x in zip(cs.RAGGED_SHAPES, ragged)]
    refs = {
        name: fa.attention_backward_reference(q.float(), k.float(), v.float(), o, lse, do)
        for name, (q, k, v, do, o, lse, _) in cases
    }
    record = {}
    good = []
    for i, variant in variants:
        lib, usage, log = built[i]
        rec = record[i] = {"shapes": {k: list(v) for k, v in variant.items()}, "ptxas": usage}
        spills = {k: v[1] for k, v in usage.items() if v[1]}
        if lib is None or spills:
            rec["error"] = "build failed" if lib is None else f"spills {spills}"
            print(f"variant {i}: {rec['error']}" + ("" if lib else "\n" + log[-2000:]), flush=True)
            continue
        use(lib)
        errs = {}
        for name, (q, k, v, do, o, lse, dsum) in cases:
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum)
            torch.cuda.synchronize()
            errs[name] = [
                float((g.float() - r).abs().max() / r.abs().max())
                for g, r in zip((dq, dk, dv), refs[name])
            ]
        rec["errors"] = errs
        worst = max(max(e) for e in errs.values())
        if not worst <= cs.BWD_TOL:
            rec["error"] = f"error {worst} above {cs.BWD_TOL}"
            print(f"variant {i}: {rec['error']}: {errs}", flush=True)
            continue
        good.append((i, lib))
        print(f"variant {i} {variant or '(source)'}: registers/spill bytes {usage}, "
              f"worst error {worst:.3e}", flush=True)

    for r in range(args.rounds):
        for i, lib in good if r % 2 == 0 else good[::-1]:
            use(lib)
            for (name, _, _), (q, k, v, do, o, lse, dsum, iters) in zip(cs.TRAIN_SHAPES, train):
                for kernel, fn in (("dq", fa.flash_attention_bwd_dq), ("dkv", fa.flash_attention_bwd_dkv)):
                    ms = cs.time_ms(lambda: fn(q, k, v, do, lse, dsum), iters)
                    record[i].setdefault("ms", {}).setdefault(f"{kernel} {name}", []).append(ms)
    for i, lib in good:
        use(lib)
        for (name, _, _), (q, k, v, do, o, lse, dsum, iters) in zip(cs.TRAIN_SHAPES, train):
            for kernel, fn in (("dq", fa.flash_attention_bwd_dq), ("dkv", fa.flash_attention_bwd_dkv)):
                ms, _ = cs.device_ms_per_launch(
                    lambda: fn(q, k, v, do, lse, dsum), f"flash_bwd_{kernel}_kernel", iters
                )
                record[i].setdefault("device_ms", {})[f"{kernel} {name}"] = ms
    for i, _ in good:
        rec = record[i]
        cells = []
        for (name, T, D) in cs.TRAIN_SHAPES:
            for kernel in ("dq", "dkv"):
                key = f"{kernel} {name}"
                inst = f"{kernel.upper()}{WIDTH_OF_SHAPE[name]}"
                shape = rec["shapes"].get(inst, "src")
                events = "/".join(f"{x:.4f}" for x in rec["ms"][key])
                cells.append(f"{key} {shape}: device {rec['device_ms'][key]:.4f} (events {events})")
        print(f"variant {i}: " + " | ".join(cells) + f" | {smi}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "variants": record}, f, indent=1)
    print(json.dumps({"device": smi, "device_ms": {i: record[i].get("device_ms") for i, _ in good}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
