#!/usr/bin/env python3
"""Read what nvcc made of a CUDA kernel of the PyTorch port: ptxas's
resource report and the SASS of each kernel instance, counted by opcode.

    python3 examples/torch_kernel_sass.py [--repo DIR] [--source flash_attention_fwd]
        [--match REGEX] [--out sass.json] [--dump DIR]

``--repo`` names the checkout whose ``one2345_tpu_torch/csrc/<source>.cu`` is
compiled (default: this one), so the kernel of another commit can be read
beside this one's; ``--source flash_attention_bwd`` reads the dq and dkv
kernels (every padded-width instance of each).  The source is compiled to a cubin with the flags of
``ops/_build.py`` (``-gencode arch=compute_90a,code=sm_90a -O3 -Xptxas -v``)
and disassembled by ``cuobjdump -sass``.  For every kernel whose mangled
name matches ``--match`` it prints ptxas's registers, shared memory and
spills, the opcode counts of the whole function, and the basic blocks that
hold tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma), largest
first, each with its counts of tensor-core products, MUFU.EX2 (the exp
unit), FP32 arithmetic (FFMA, FMUL, FADD, FMNMX), bf16 packs (F2FP),
shared-memory fragment loads (LDSM), barriers (BAR), mbarrier operations
(SYNCS), TMA loads (UTMALDG) and warpgroup fences (WARPGROUP), and the
order in which its HMMA/HGMMA (H) and MUFU.EX2 (M) instructions come, as
runs ("H24 M2 H24 M64 ...").  The block of a fully unrolled key tile is
the largest of them.  ``--dump`` keeps the SASS text.  Needs nvcc and
cuobjdump (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# opcode classes reported per block, by the opcode's first field
CLASSES = ("HMMA", "HGMMA", "MUFU.EX2", "FFMA", "FMUL", "FADD", "FMNMX", "F2FP", "LDSM",
           "BAR", "SYNCS", "UTMALDG", "WARPGROUP", "SHFL", "LDS", "STG")


def toolkit_bin(name: str) -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", name)):
            return os.path.join(home, "bin", name)
    found = shutil.which(name)
    if found is None:
        raise SystemExit(f"torch_kernel_sass: {name} not found (set CUDA_HOME)")
    return found


def opcode_class(opcode: str) -> str:
    """MUFU.EX2 keeps its function; every other opcode its first field."""
    if opcode.startswith("MUFU."):
        return ".".join(opcode.split(".")[:2])
    return opcode.split(".")[0]


def parse_sass(text: str) -> dict[str, list[tuple[str | None, str]]]:
    """{function: [(label or None, opcode), ...]} in program order; a label
    entry (opcode '') opens a basic block."""
    functions: dict[str, list] = {}
    current = None
    for line in text.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            current = functions.setdefault(found.group(1), [])
            continue
        if current is None:
            continue
        label = re.match(r"\s*(\.L_\w+):", line)
        if label:
            current.append((label.group(1), ""))
            continue
        instr = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if instr:
            current.append((None, instr.group(1)))
    return functions


def basic_blocks(instrs: list[tuple[str | None, str]]) -> list[list[str]]:
    """The opcodes split into basic blocks: at every label and after every
    branch or exit."""
    blocks, block = [], []
    for label, opcode in instrs:
        if label is not None:
            if block:
                blocks.append(block)
            block = []
            continue
        block.append(opcode)
        if opcode.split(".")[0] in ("BRA", "EXIT", "RET", "BRX", "JMP"):
            blocks.append(block)
            block = []
    if block:
        blocks.append(block)
    return blocks


def runs(block: list[str]) -> str:
    """Run lengths of H (HMMA, HGMMA) and M (MUFU.EX2) in program order."""
    seq = []
    for opcode in block:
        cls = opcode_class(opcode)
        tag = "H" if cls in ("HMMA", "HGMMA") else "M" if cls == "MUFU.EX2" else None
        if tag is None:
            continue
        if seq and seq[-1][0] == tag:
            seq[-1][1] += 1
        else:
            seq.append([tag, 1])
    return " ".join(f"{t}{n}" for t, n in seq)


def counts(opcodes: list[str]) -> dict[str, int]:
    c = Counter(opcode_class(o) for o in opcodes)
    return {k: c[k] for k in CLASSES if c[k]}


def ptxas_report(log: str) -> dict[str, list[str]]:
    """ptxas -v lines by mangled function name."""
    report: dict[str, list[str]] = {}
    entry = None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = found.group(1)
            report[entry] = []
        elif "warning" in line or "Performance" in line:
            report.setdefault("_warnings", []).append(line.strip())
        elif entry and ("registers" in line or "spill" in line or "smem" in line):
            report[entry].append(line.strip())
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE, help="checkout whose csrc/ is compiled")
    ap.add_argument("--source", default="flash_attention_fwd", help="csrc/<source>.cu")
    ap.add_argument("--match", default="", help="regex on the mangled kernel names")
    ap.add_argument("--blocks", type=int, default=3, help="tensor-core blocks shown per kernel")
    ap.add_argument("--out", default=None, help="write the JSON record here")
    ap.add_argument("--dump", default=None, help="directory to keep the SASS text in")
    args = ap.parse_args()

    csrc = os.path.join(os.path.abspath(args.repo), "one2345_tpu_torch", "csrc")
    src = os.path.join(csrc, f"{args.source}.cu")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{args.source}.cubin")
        build = subprocess.run(
            [toolkit_bin("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-cubin", "-Xptxas", "-v", "-I", csrc, "-o", cubin, src],
            capture_output=True, text=True)
        log = build.stdout + build.stderr
        if build.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        sass = subprocess.run([toolkit_bin("cuobjdump"), "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        with open(os.path.join(args.dump, f"{args.source}.sass"), "w") as f:
            f.write(sass)
    report = ptxas_report(log)
    record = {"repo": os.path.abspath(args.repo), "source": src, "warnings": report.get("_warnings", []),
              "kernels": {}}
    for line in record["warnings"]:
        print(f"ptxas: {line}")
    for name, instrs in parse_sass(sass).items():
        if not re.search(args.match, name):
            continue
        opcodes = [o for label, o in instrs if label is None]
        blocks = [b for b in basic_blocks(instrs)
                  if any(opcode_class(o) in ("HMMA", "HGMMA") for o in b)]
        blocks.sort(key=len, reverse=True)
        entry = {
            "ptxas": report.get(name, []),
            "instructions": len(opcodes),
            "counts": counts(opcodes),
            "tensor_blocks": [{"instructions": len(b), "counts": counts(b), "runs": runs(b)}
                              for b in blocks[:args.blocks]],
        }
        record["kernels"][name] = entry
        print(f"== {name}")
        for line in entry["ptxas"]:
            print(f"   ptxas: {line}")
        print(f"   whole function: {entry['instructions']} instructions, {entry['counts']}")
        for i, b in enumerate(entry["tensor_blocks"]):
            print(f"   tensor block {i}: {b['instructions']} instructions, {b['counts']}")
            print(f"     H/M runs: {b['runs']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"source": args.source, "kernels": len(record["kernels"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
