"""Per-stage profiler of the port: one warm run of the pipeline traced by
``torch.profiler``, written to a file.

The twin of ``examples/profile_pipeline.py`` for ``one2345_tpu_torch``:

    python examples/torch_profile_pipeline.py [--trace_dir DIR] [--mesh_resolution 256] \
        [--sampler dpmpp] [--steps S1 S2] [--warmups 1] \
        [--device cpu] [--tiny]

One warm-up run (``--warmups``; 0 on a pipeline whose kernels have run
at these shapes), then one run under ``torch.profiler.profile`` with the
CPU and CUDA activities (the CPU's alone on the CPU).  The trace goes to
``<trace_dir>/trace.json`` (by default ``one2345_trace`` in the temporary
directory: ``$TMPDIR``, else the system's), a Chrome trace that Perfetto
(ui.perfetto.dev) or ``chrome://tracing`` opens; the runner's spans (``preprocess``, ``stage1``, ``stage2_view0``,
``elevation``, ``stage2``, ``reconstruct``) are named ranges in it.  Then
the spans table is printed, as the JAX example prints it.  Added flags:
the fast modes of ``torch_throughput_probe.py`` (``--sampler``,
``--steps``, ``--quant``: a DDIM run launches 4000 attention kernels, and
its trace is large), ``--device`` (the card by default) and ``--tiny``.
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os
import tempfile

import numpy as np

from examples.torch_throughput_probe import (add_mode_flags, device_sync, mesh_resolution,
                                             probe_config, probe_pipeline)

TRACE_NAME = "trace.json"


def trace_path(trace_dir=None) -> str:
    """``<trace_dir>/trace.json``, the directory made; by default
    ``one2345_trace`` in the temporary directory, so that two checkouts'
    runs do not share a fixed path."""
    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "one2345_trace")
    os.makedirs(trace_dir, exist_ok=True)
    return os.path.join(trace_dir, TRACE_NAME)


def main(argv=None, pipeline=None):
    """Trace one warm run; return (the trace's path, the run's spans)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace_dir", default=None,
                   help="default: one2345_trace in the temporary directory")
    p.add_argument("--mesh_resolution", type=int, default=None, help="default 256")
    p.add_argument("--warmups", type=int, default=1, help="warm-up runs before the traced one")
    add_mode_flags(p, "ddim")
    args = p.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    cfg, _ = probe_config(args)
    pipe = probe_pipeline(cfg, args.device, None, pipeline)
    res = args.mesh_resolution or mesh_resolution(args)
    size = cfg.diffusion.image_size
    rng = np.random.default_rng(0)
    img = np.ones((size, size, 3), np.float32)
    q = size // 4
    img[q : 3 * q, q : 3 * q] = rng.uniform(0.2, 0.8, (2 * q, 2 * q, 3))

    for _ in range(args.warmups):
        pipe.run(img, skip_preprocess=True, mesh_resolution=res, seed=0)
    device_sync(pipe)
    activities = [ProfilerActivity.CPU]
    if pipe.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = pipe.run(img, skip_preprocess=True, mesh_resolution=res, seed=1)
        device_sync(pipe)
    path = trace_path(args.trace_dir)
    prof.export_chrome_trace(path)
    print(json.dumps({k: round(v, 3) for k, v in result.timings.items()}, indent=2))
    print(f"trace written to {path} (open it in Perfetto or chrome://tracing)", flush=True)
    return path, result.timings


if __name__ == "__main__":
    main()
