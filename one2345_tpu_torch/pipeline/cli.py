"""CLI entry point, flag-compatible with the reference's run.py:99-119.

    python -m one2345_tpu_torch.pipeline.cli --img_path input.png \
        --mesh_resolution 256 --output_format .ply

Counterpart of ``one2345_tpu/pipeline/cli.py`` with the same flags.  The
input is read with the port's PNG reader (``utils.png``) and converted to
RGBA; ``--params`` names a ``core.checkpoint`` file (the tree
``One2345Pipeline.save_params`` writes).  The fast modes stack:
``--sampler dpmpp`` (DPM-Solver++(2M), 30 / 25 steps unless ``--steps``
says otherwise), ``--sampler plms``, and ``--quant int8`` (the W8A8 int8
UNet).  The JAX CLI's XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="One-2-3-45 on one NVIDIA card: image -> textured mesh")
    p.add_argument("--img_path", type=str, required=True, help="Path to the input image (PNG)")
    p.add_argument("--gpu_idx", type=int, default=0, help="the card to run on: cuda:<gpu_idx>")
    p.add_argument("--half_precision", action="store_true", help="bf16 compute")
    p.add_argument("--mesh_resolution", type=int, default=256)
    p.add_argument("--output_format", type=str, default=".ply", choices=[".ply", ".obj", ".glb"])
    p.add_argument("--out_dir", type=str, default=None, help="default: ./exp/<name>")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--params", type=str, default=None,
                   help="core.checkpoint file with stage params (One2345Pipeline.save_params)")
    p.add_argument("--no_sam", action="store_true", help="alpha/threshold segmentation instead of SAM")
    # extensions beyond run.py's flag surface
    p.add_argument("--sampler", choices=["ddim", "plms", "dpmpp"], default="ddim",
                   help="dpmpp = DPM-Solver++(2M) fast mode (defaults to --steps 30 25)")
    p.add_argument("--steps", type=int, nargs=2, default=None, metavar=("S1", "S2"),
                   help="override stage-1/stage-2 REQUESTED denoising step counts "
                        "(reference defaults: 75 50, run by DDIM as 76 and 49)")
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="int8 = the W8A8 int8 UNet (conv-only; stacks with --sampler)")
    return p


def apply_fast_modes(cfg, sampler="ddim", steps=None, quant="none"):
    """Overlay the opt-in fast-mode knobs on a PipelineConfig.

    ``steps`` are REQUESTED counts (the schedule of 75 has 77 entries, of
    which DDIM runs 76).  ``steps`` of None keeps the reference's (75, 50)
    for ddim and plms and takes (30, 25) for dpmpp.  An unknown sampler or
    quant mode raises ``ValueError``."""
    if sampler not in ("ddim", "plms", "dpmpp"):
        raise ValueError(f"unknown sampler {sampler!r}: ddim|plms|dpmpp")
    if quant not in ("none", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}: none|int8")
    if steps is None and sampler == "dpmpp":
        steps = (30, 25)
    d = cfg.diffusion.replace(sampler=sampler)
    if steps:
        d = d.replace(ddim_steps_stage1=steps[0], ddim_steps_stage2=steps[1])
    return cfg.replace(diffusion=d.replace(unet=d.unet.replace(quant=quant)))


def build_config(args):
    from one2345_tpu_torch.core.config import PipelineConfig

    cfg = PipelineConfig(half_precision=args.half_precision, seed=args.seed)
    return apply_fast_modes(
        cfg, sampler=args.sampler, steps=tuple(args.steps) if args.steps else None,
        quant=args.quant,
    )


def main(argv=None, params: dict | None = None, device=None):
    """Run the pipeline on ``--img_path`` and write the mesh and the
    artifacts to ``--out_dir``.

    :param params: a parameter tree as ``--params`` would load (it takes
        precedence), e.g. for callers that hold the weights in memory
    :param device: None -> 'cuda:<gpu_idx>' (raises without CUDA)
    """
    args = build_parser().parse_args(argv)

    from one2345_tpu_torch.core.device import resolve_device
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline
    from one2345_tpu_torch.utils.png import read_png, to_rgba

    cfg = build_config(args)
    if params is None and args.params:
        from one2345_tpu_torch.core import checkpoint

        params = checkpoint.restore(args.params)
    shape_id = os.path.splitext(os.path.basename(args.img_path))[0]
    out_dir = args.out_dir or os.path.join("exp", shape_id)

    if device is None:
        import torch

        resolve_device(None)  # raises without CUDA
        torch.cuda.set_device(args.gpu_idx)  # the kernels launch on the current card
        device = f"cuda:{args.gpu_idx}"
    pipeline = One2345Pipeline(cfg, params, use_sam=not args.no_sam, device=device)
    t0 = time.perf_counter()
    image = to_rgba(read_png(args.img_path))
    read_s = time.perf_counter() - t0
    result = pipeline.run(
        image, out_dir=out_dir, mesh_resolution=args.mesh_resolution,
        output_format=args.output_format, seed=args.seed,
    )
    print("Mesh saved to:", result.mesh_path)
    print(json.dumps({"elevation": result.elevation, "read_png": read_s,
                      "timings": result.timings}))
    return result


if __name__ == "__main__":
    main()
