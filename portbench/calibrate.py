"""Read the numbers that decide ``correct`` over many seeds in one
process, for the program and for its controls and faults: the readings
the limits in ``portbench/limits/`` are set from.

    python portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--variants program fp8 int8 half_batch] [--seconds 0]

Per seed and variant it makes one run of the cell through ``harness.run``
(set-up, a window of ``--seconds``, 0 for one request or step, the
program freed, the comparison) and prints one JSON line {cell, seed,
variant, correct, numbers, all}; the lines also go to
``chiprun_out/calibrate_<cell>.jsonl``.  Variants:

- ``program``: the program as the cell runs it;
- ``fp8``: the control, the reference one precision below the
  configuration's put in the program's place (fp8 products for the bf16
  networks, bfloat16 for the float32 sampler step), read against the f32
  reference on the same inputs of the ``program`` run;
- ``int8``: the program's own path one precision below bf16, a copy of
  the configuration with ``unet.quant`` set to ``"int8"`` (serving only);
- ``half_batch``: a fault planted in the train step, the loss taken over
  the first half of each batch.

The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def half_batch():
    """The train step's loss over the first half of each batch."""
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    orig = Zero123Trainer.loss_fn

    def loss_fn(self, batch, draws=None):
        h = len(batch["T"]) // 2
        return orig(self, {k: v[:h] for k, v in batch.items()},
                    None if draws is None else {k: v[:h] for k, v in draws.items()})

    Zero123Trainer.loss_fn = loss_fn
    try:
        yield
    finally:
        Zero123Trainer.loss_fn = orig


def control(name, fn, program):
    """The control in the program's place: the reference, one precision
    below the configuration's."""
    from portbench.reference import precision

    with precision.use("fp8"):
        return fn()


def int8_copy(cell):
    """The cell with a copy of its configuration whose UNet runs int8."""
    cell = copy.copy(cell)
    cell.config = copy.deepcopy(cell.config)
    conf = cell.config.get("pipeline", cell.config)
    conf["diffusion"]["unet"]["quant"] = "int8"
    cell.traffic = {k: v for k, v in cell.traffic.items() if k != "quant"}
    return cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["program"])
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, run as bench_run

    bench_run.pin_caches()
    cell = harness.Cell.load(args.workload, ROOT)
    os.environ.update(cell.env)
    import torch

    from one2345_tpu_torch.core import compile_cache

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    compile_cache.enable(str(bench_run.CACHE / "build"))
    harness.log(f"device: {harness.nvidia_smi()} | torch {torch.__version__} | env {cell.env}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / f"calibrate_{cell.name}.jsonl", "a")

    def emit(seed, variant, correct, checks, driver, t0):
        line = {"cell": cell.name, "seed": seed, "variant": variant, "correct": correct,
                "numbers": {c.name: c.value for c in checks},
                "all": getattr(driver, "values", None),
                "worst_leaves": getattr(driver, "worst_leaves", None),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        sink.write(json.dumps(line) + "\n")
        sink.flush()

    for seed in args.seeds:
        for variant in [v for v in args.variants if v != "fp8"]:
            t0 = time.perf_counter()
            planted = half_batch() if variant == "half_batch" else contextlib.nullcontext()
            run_cell = int8_copy(cell) if variant == "int8" else cell
            with planted:
                result, checks, driver = harness.run(run_cell, seed, args.seconds, False,
                                                     "cuda", t0)
            emit(seed, variant, result["correct"], checks, driver, t0)
            if variant == "program" and "fp8" in args.variants:
                t0 = time.perf_counter()
                checks = driver.verify(judge=control)
                emit(seed, "fp8", all(c.ok for c in checks), checks, driver, t0)
            del driver
            gc.collect()
            torch.cuda.empty_cache()
    harness.log(f"calibrate done in {time.perf_counter() - T0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
