"""Per-stage timing probe of the port: each pipeline stage timed on its own
at the production shapes, one JSON line per stage (plus a warm end-to-end
line).

The twin of ``examples/stage_probe.py`` for ``one2345_tpu_torch``; the
companion of ``torch_throughput_probe.py`` when hunting for the next stage
to speed up:

    python examples/torch_stage_probe.py [--mesh_resolution 256] [--repeats 3] [--sam] \
        [--sampler ddim|dpmpp] [--steps S1 S2] [--warmups 1] [--device cpu] [--tiny]

Each stage runs once to warm up (``--warmups``; 0 on a pipeline that has
run at these shapes), then ``repeats`` measured times, each ending with
``torch.cuda.synchronize``, so the numbers are steady-state serving.  Lines: ``preprocess_sam`` (with ``--sam``), ``stage1_ring4``,
``stage2_view0``, ``elevation``, ``stage2_rest``, ``reconstruct`` and
``end_to_end``, with the JAX probe's keys (``stage``, ``best_s``,
``mean_s`` and its extras).  Integer seeds take the place of the JAX
keys.  ``preprocess_sam`` clears SAM's memo before each call, so every
call encodes as its help says (the JAX stage memoises the last image too,
and its probe's repeats time the memoised path).  Added flags: the fast
modes of ``torch_throughput_probe.py`` (``--sampler``, ``--steps``,
``--quant``; the JAX probe times DDIM), ``--warmups``, ``--device`` (the card by default)
and ``--tiny`` (its own mesh resolution unless one is given).
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np

from examples.torch_throughput_probe import (add_mode_flags, device_sync, mesh_resolution,
                                             probe_config, probe_pipeline)


def span(fn, repeats: int, sync, warmups: int = 1):
    """(best, mean) seconds of ``repeats`` calls of ``fn`` after ``warmups``
    calls, each call ended by ``sync``."""
    for _ in range(warmups):
        fn()
    sync()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return min(ts), float(np.mean(ts))


def main(argv=None, pipeline=None):
    """Print one JSON line per stage; return the lines' records."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh_resolution", type=int, default=None, help="default 256")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--warmups", type=int, default=1, help="untimed calls of each stage first")
    p.add_argument("--sam", action="store_true",
                   help="also time SAM ViT-H preprocessing (encode + seed/final decodes at "
                        "1024^2, as in the JAX bench)")
    add_mode_flags(p, "ddim")
    args = p.parse_args(argv)
    res = args.mesh_resolution or mesh_resolution(args)

    import torch

    from one2345_tpu_torch.geometry import cameras as cam

    cfg, _ = probe_config(args)
    pipe = probe_pipeline(cfg, args.device, args.sam, pipeline)
    z = pipe.zero123

    def sync():
        device_sync(pipe)

    rng = np.random.default_rng(0)
    size = cfg.diffusion.image_size
    img = np.ones((size, size, 3), np.float32)
    img[size // 4 : 3 * size // 4, size // 4 : 3 * size // 4] = rng.uniform(
        0.2, 0.8, (size // 2, size // 2, 3)
    )
    img_t = torch.as_tensor(img, device=pipe.device)
    k1, k2, k3 = 1, 2, 3  # the seeds of the three sampling calls (the JAX probe's key splits)
    steps2 = cfg.diffusion.ddim_steps_stage2
    records = []

    def emit(stage, best, mean, **extra):
        rec = {"stage": stage, "best_s": round(best, 4), "mean_s": round(mean, 4), **extra}
        records.append(rec)
        print(json.dumps(rec), flush=True)

    # SAM preprocessing (raw 512^2 -> segmented / recentred 256^2)
    if args.sam:
        raw = np.full((512, 512, 3), 255, np.uint8)
        raw[128:384, 128:384] = rng.uniform(40, 200, (256, 256, 3)).astype(np.uint8)

        def run_pre():
            pipe.sam._memo = None  # each call encodes
            pipe.preprocess(raw, safety_check=False)

        emit("preprocess_sam", *span(run_pre, args.repeats, sync, args.warmups))

    # stage 1 (one 4-view ring)
    s1 = None

    def run_s1():
        nonlocal s1
        s1 = z.stage1(img_t, k1, indices=[0, 1, 2, 3])

    emit("stage1_ring4", *span(run_s1, args.repeats, sync, args.warmups), views=4)

    # stage 2 for one view (4 nearby views)
    s2v0 = None

    def run_s2v0():
        nonlocal s2v0
        s2v0 = z.stage2(s1[:1], k2, steps=steps2, view_ids=[0])

    emit("stage2_view0", *span(run_s2v0, args.repeats, sync, args.warmups), views=4)

    # elevation (LoFTR on the 4 views + the pose sweep; device tensors in, as in run)
    def run_elev():
        pipe.estimate_elevation(s2v0[0])

    emit("elevation", *span(run_elev, args.repeats, sync, args.warmups))

    # stage 2 for the remaining 7 views (28 samples)
    s1_8 = torch.cat([s1, s1])

    def run_s2():
        z.stage2(s1_8[1:], k3, steps=steps2, view_ids=list(range(1, 8)))

    emit("stage2_rest", *span(run_s2, args.repeats, sync, args.warmups), views=28)

    # reconstruction (cost volume + field + marching tets + colours)
    camera_pack = cam.build_recon_cameras(90.0)
    rest = z.stage2(s1_8[1:], k3, steps=2, view_ids=list(range(1, 8)))  # shape donor only
    src = torch.cat([s2v0, rest]).reshape(-1, size, size, 3)

    def run_recon():
        pipe.recon.reconstruct(src, camera_pack, resolution=res)

    emit("reconstruct", *span(run_recon, args.repeats, sync, args.warmups),
         mesh_resolution=res)

    # warm end-to-end
    def run_e2e():
        pipe.run(img, skip_preprocess=True, mesh_resolution=res, seed=1)

    emit("end_to_end", *span(run_e2e, 1, sync, args.warmups))
    return records


if __name__ == "__main__":
    main()
