"""Run one cell of the port's benchmark on the card(s) of this machine.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process per run: it sets up (weights drawn on the card from the seed,
the cell's shapes warmed), measures for ``--seconds``, frees the program,
compares what the window produced with the plain reference, and prints
one JSON line as the last line of standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.  The
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the JSON line.  Without a card (or with fewer
cards than the cell asks for) it exits with status 2 and prints no result;
if JAX or the JAX package is loaded once the window has closed, with 3.

The program's build caches (nvcc and g++ libraries, Triton) live in
``portbench/_cache/`` of the checkout, so only the first run of a checkout
compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "_cache"


def pin_caches() -> None:
    """Every build cache of the program at a fixed path in the checkout."""
    os.environ["ONE2345_COMPILE_CACHE"] = str(CACHE / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    pin_caches()
    from portbench import harness

    cell = harness.Cell.load(args.workload, ROOT)
    os.environ.update(cell.env)  # before CUDA starts: the allocator reads it once
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from one2345_tpu_torch.core import compile_cache

    compile_cache.enable(str(CACHE / "build"))
    harness.log(f"python, torch and the port imported at {time.perf_counter() - T_START:.2f} s")
    harness.log(f"device before: {harness.nvidia_smi()}")
    harness.log(f"torch {torch.__version__} cuda {torch.version.cuda} | cell {cell.name} "
                f"seed {args.seed} seconds {args.seconds} trace {args.trace} | env {cell.env}")
    result, checks, _ = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                 T_START)
    harness.log(f"device after: {harness.nvidia_smi()}")
    found = harness.forbidden_loaded()
    if found:
        harness.log(f"JAX or the JAX package is loaded: {', '.join(found)}")
        return 3
    for c in checks:
        print(f"check {c.name}: {c.value:.6g} (limit {c.limit:.6g}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
