"""The port's opt-in fast modes measured end to end on the card.

The twin of ``examples/fast_mode_probe.py`` for ``one2345_tpu_torch``: the
fast-mode stack on the JAX probe's synthetic 512^2 input with SAM on,
DPM-Solver++(2M) at 30 / 25 steps by default, optionally with the int8
UNet (``--quant int8``), or int8 alone at the reference's steps
(``--sampler ddim --quant int8``):

    python examples/torch_fast_mode_probe.py [--sampler dpmpp|ddim|plms] \
        [--steps S1 S2] [--quant none|int8] [--warmups 1] [--device cpu] [--tiny]

One warm-up run (``--warmups``; 0 on a pipeline that has run at these
shapes), then three runs at seeds 1-3; one JSON line with the JAX
probe's keys (``mode``, ``secs_image_to_mesh``: the best run,
``all_runs_s``, ``vs_reference_baseline``, ``timings`` and
``mesh_vertices`` of the best run) and the median, ``median_s``.  Added
flags as in ``torch_throughput_probe.py``: ``--warmups``, ``--device``
(the card by default) and ``--tiny``.
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import statistics
import time

from examples.torch_throughput_probe import (BASELINE_S, add_mode_flags, device_sync,
                                             mesh_resolution, probe_config, probe_pipeline,
                                             raw_inputs)


def main(argv=None, pipeline=None):
    """Print the JSON record; return it and the three runs' ``PipelineResult``s
    (seeds 1-3, in order)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_mode_flags(ap, "dpmpp")
    ap.add_argument("--warmups", type=int, default=1, help="untimed runs first")
    args = ap.parse_args(argv)

    cfg, mode = probe_config(args)
    pipe = probe_pipeline(cfg, args.device, not args.tiny, pipeline)
    img = raw_inputs(1)[0]
    res = mesh_resolution(args)

    for _ in range(args.warmups):
        pipe.run(img, skip_preprocess=False, mesh_resolution=res, seed=0)
    runs = []
    for i in range(3):
        device_sync(pipe)
        t0 = time.perf_counter()
        result = pipe.run(img, skip_preprocess=False, mesh_resolution=res, seed=1 + i)
        device_sync(pipe)
        runs.append((time.perf_counter() - t0, result))
    dt, result = min(runs, key=lambda r: r[0])
    record = {
        "mode": mode,
        "secs_image_to_mesh": round(dt, 3),
        "all_runs_s": [round(r[0], 3) for r in runs],
        "vs_reference_baseline": round(BASELINE_S / dt, 2),
        "timings": {k: round(v, 3) for k, v in result.timings.items()},
        "mesh_vertices": int(len(result.vertices)),
        "median_s": round(statistics.median(r[0] for r in runs), 3),
    }
    print(json.dumps(record), flush=True)
    return record, [r[1] for r in runs]


if __name__ == "__main__":
    main()
