"""Sustained serving throughput of the port: ``run_many`` overlapped requests
on the card.

The twin of ``examples/throughput_probe.py`` for ``one2345_tpu_torch``:
meshes per second over N back-to-back requests (after one warm-up run) at
any sampler / steps / quant configuration, on the same 512^2 inputs with
SAM on, one JSON line with the JAX probe's keys:

    python examples/torch_throughput_probe.py [--sampler dpmpp|ddim] \
        [--steps S1 S2] [--quant none|int8] [--n 6] [--in_flight 2] \
        [--seeds 1 2 1] [--warmups 1] [--device cpu] [--tiny]

On the card ``run_many`` runs each request in flight on a CUDA stream of
its own.  Added to the JAX probe's flags: ``--seeds`` (the requests' seeds;
request i takes the input drawn for its seed, so the default 1..n gives
the JAX probe's requests and ``--seeds 1 2 1`` sends one image twice),
``--warmups`` (runs before the clock starts), ``--device`` (the card by
default) and ``--tiny`` (toy model sizes without SAM, as
``examples/torch_walkthrough.py --tiny``).  Added keys: ``seeds``,
``device`` and ``host_cpu_s_per_mesh`` (the process's CPU
seconds over the requests, per mesh: all threads, the CUDA driver's
waits included).

The other probe twins (``torch_stage_probe.py``, ``torch_fast_mode_probe.py``,
``torch_profile_pipeline.py``) take their mode flags and pipeline from the
helpers here.  Each ``main(argv, pipeline=None)`` can be handed a built
``One2345Pipeline``; its config must be the one the flags give.
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np

BASELINE_S = 45.0  # the reference's seconds per mesh, as in the JAX probes


def add_mode_flags(p: argparse.ArgumentParser, sampler: str) -> None:
    """The fast-mode flags of the JAX probes, and the port's --device and --tiny."""
    p.add_argument("--sampler", choices=["ddim", "plms", "dpmpp"], default=sampler)
    p.add_argument("--steps", type=int, nargs=2, default=None, metavar=("S1", "S2"))
    p.add_argument("--quant", choices=["none", "int8"], default="none")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--tiny", action="store_true",
                   help="toy model sizes without SAM: seconds on the CPU")


def probe_config(args):
    """``PipelineConfig()`` (or the walkthrough's tiny one) with the fast
    modes of the flags, and its mode name as the JAX probes print it."""
    from examples.torch_walkthrough import tiny_config
    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.pipeline.cli import apply_fast_modes

    cfg = apply_fast_modes(
        tiny_config() if args.tiny else PipelineConfig(), sampler=args.sampler,
        steps=tuple(args.steps) if args.steps else None, quant=args.quant,
    )
    d = cfg.diffusion
    mode = f"{args.sampler} {d.ddim_steps_stage1}/{d.ddim_steps_stage2}" + (
        f" +{args.quant}" if args.quant != "none" else "")
    return cfg, mode


def probe_pipeline(cfg, device, use_sam: bool, pipeline=None):
    """A new ``One2345Pipeline(cfg, use_sam=use_sam, device=device)``, or
    ``pipeline`` when one is given: its config must be ``cfg`` and its
    ``use_sam`` the probe's (``use_sam=None``: the probe does not segment)."""
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    if pipeline is None:
        return One2345Pipeline(cfg, use_sam=bool(use_sam), device=device)
    if pipeline.config != cfg:
        raise ValueError("the given pipeline's config is not the one the flags give")
    if use_sam is not None and pipeline.use_sam != use_sam:
        raise ValueError(f"the probe needs use_sam={use_sam}, the pipeline has {pipeline.use_sam}")
    return pipeline


def raw_inputs(n: int) -> list:
    """The JAX probes' n synthetic 512^2 RGB inputs: a textured square on
    white, drawn one after the other from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    imgs = []
    for _ in range(n):
        img = np.full((512, 512, 3), 255, np.uint8)
        img[128:384, 128:384] = rng.uniform(40, 200, (256, 256, 3)).astype(np.uint8)
        imgs.append(img)
    return imgs


def mesh_resolution(args) -> int:
    """256 as in the JAX probes; the tiny config's own under --tiny."""
    from examples.torch_walkthrough import tiny_config

    return tiny_config().mesh_resolution if args.tiny else 256


def device_sync(pipe) -> None:
    """Wait for every stream of the pipeline's card (nothing on the CPU)."""
    import torch

    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)


def main(argv=None, pipeline=None):
    """Print the JSON record; return it and the requests' ``PipelineResult``s."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_mode_flags(ap, "ddim")
    ap.add_argument("--n", type=int, default=6, help="requests in the batch")
    ap.add_argument("--in_flight", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="the requests' seeds (default 1..n); each takes its seed's input")
    ap.add_argument("--warmups", type=int, default=1, help="warm-up runs before the clock")
    args = ap.parse_args(argv)

    cfg, mode = probe_config(args)
    pipe = probe_pipeline(cfg, args.device, not args.tiny, pipeline)
    seeds = args.seeds or list(range(1, args.n + 1))
    if min(seeds) < 1:
        raise SystemExit("--seeds: seeds start at 1 (seed s takes the s-th input)")
    inputs = raw_inputs(max(seeds))
    imgs = [inputs[s - 1] for s in seeds]
    res = mesh_resolution(args)

    for _ in range(args.warmups):
        pipe.run(inputs[0], skip_preprocess=False, mesh_resolution=res, seed=0)
    device_sync(pipe)
    t0, cpu0 = time.perf_counter(), time.process_time()
    results = pipe.run_many(
        imgs, seeds=seeds, max_in_flight=args.in_flight, skip_preprocess=False,
        mesh_resolution=res,
    )
    device_sync(pipe)
    dt, cpu = time.perf_counter() - t0, time.process_time() - cpu0
    n = len(imgs)
    record = {
        "mode": mode,
        "requests": n,
        "in_flight": args.in_flight,
        "secs_per_mesh_sustained": round(dt / n, 3),
        "meshes_per_sec": round(n / dt, 4),
        "vs_reference_baseline": round(BASELINE_S / (dt / n), 2),
        "mesh_vertices": [int(len(r.vertices)) for r in results],
        "seeds": seeds,
        "device": str(pipe.device),
        "host_cpu_s_per_mesh": round(cpu / n, 3),
    }
    print(json.dumps(record), flush=True)
    return record, results


if __name__ == "__main__":
    main()
