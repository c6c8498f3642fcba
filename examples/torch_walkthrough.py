"""Step-by-step API walkthrough on the port, the example.ipynb equivalent.

The twin of ``examples/walkthrough.py`` for ``one2345_tpu_torch``: every
pipeline stage runs on its own through the library API (instead of the
one call ``One2345Pipeline.run``), and each stage's artifact is written,
as the reference notebook shows them (preprocess -> stage 1 -> elevation
-> stage 2 -> reconstruction):

    python examples/torch_walkthrough.py [--img input.png] [--out exp/walkthrough] \
        [--params params.pt] [--tiny] [--device cpu] [--sampler ddim|plms|dpmpp]

``--tiny`` runs toy model sizes without SAM, as the JAX example's
``--tiny`` does; ``--device`` picks the device (the card by default;
``--tiny --device cpu`` runs on the CPU in seconds; ``--sampler``, not in
the JAX example, picks the CLI's fast mode, e.g. ``dpmpp`` at 30 / 25
steps).  ``--params`` names a ``core.checkpoint`` file of the port
(``utils/convert_cli.py`` or ``One2345Pipeline.save_params`` writes one).  Differences from the JAX
example: noise comes from the runner's integer phase seeds
(``runner.phase_seeds(0)``), so the steps give what ``run(seed=0)`` gives;
PNGs are written by the port's codec (``utils/png.py``); ``--tiny`` also
cuts the reconstruction volume to 16^3 (the JAX example keeps 96^3).
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os
import time

import numpy as np

# the artifacts, in the JAX walkthrough's names
ARTIFACTS = ("1_preprocessed.png", "4_stage1_grid.png", "5_stage2_grid.png", "6_mesh.ply",
             "summary.json")


def tiny_config():
    """Toy model sizes for a run on the CPU in seconds (the JAX example's,
    with a 16^3 reconstruction volume)."""
    from one2345_tpu_torch.core.config import (CLIPVisionConfig, DiffusionConfig,
                                               ElevationConfig, PipelineConfig, ReconConfig,
                                               UNetConfig, VAEConfig)

    return PipelineConfig(
        diffusion=DiffusionConfig(
            ddim_steps_stage1=3, ddim_steps_stage2=2, image_size=32, latent_size=4,
            unet=UNetConfig(model_channels=32, channel_mult=(1, 2), attention_resolutions=(1,),
                            num_heads=4, dtype="float32"),
            vae=VAEConfig(base_channels=16, channel_mult=(1, 2, 2, 2), dtype="float32"),
            clip=CLIPVisionConfig(image_size=28, patch_size=14, width=32, layers=2, heads=2,
                                  dtype="float32"),
        ),
        recon=ReconConfig(vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0, mesh_resolution=24),
        elevation=ElevationConfig(dtype="float32"),
        mesh_resolution=24,
    )


def synthetic_input() -> np.ndarray:
    """A 512^2 RGBA photo stand-in: a textured square on white."""
    rng = np.random.default_rng(0)
    raw = np.full((512, 512, 4), 255, np.uint8)
    raw[128:384, 128:384, :3] = rng.uniform(40, 200, (256, 256, 3)).astype(np.uint8)
    return raw


def to_uint8(images) -> np.ndarray:
    """float images in [0, 1] (a tensor on any device, or an array) ->
    uint8 on the host, truncated."""
    arr = images.float().cpu().numpy() if hasattr(images, "cpu") else np.asarray(images)
    return (arr * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--img", default=None, help="input photo (default: synthetic)")
    p.add_argument("--out", default="exp/walkthrough")
    p.add_argument("--tiny", action="store_true",
                   help="toy model sizes without SAM: seconds, for CI and smoke runs")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--params", default=None, help="core.checkpoint file of the port")
    p.add_argument("--sampler", choices=["ddim", "plms", "dpmpp"], default="ddim")
    args = p.parse_args(argv)

    import torch

    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.geometry import cameras as cam
    from one2345_tpu_torch.pipeline.cli import apply_fast_modes
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline, phase_seeds, select_stage1b_plan
    from one2345_tpu_torch.utils.image import image_grid
    from one2345_tpu_torch.utils.png import read_png, to_rgba, write_png

    os.makedirs(args.out, exist_ok=True)
    t_all = time.perf_counter()

    # ------------------------------------------------------------------ config
    cfg = apply_fast_modes(tiny_config() if args.tiny else PipelineConfig(), sampler=args.sampler)
    mesh_res = cfg.mesh_resolution
    params = None
    if args.params:
        from one2345_tpu_torch.core import checkpoint

        params = checkpoint.restore(args.params)
    pipe = One2345Pipeline(cfg, params, use_sam=not args.tiny, device=args.device)

    # ------------------------------------------------------- 0. input image
    raw = to_rgba(read_png(args.img)) if args.img else synthetic_input()
    print(f"input: {raw.shape[1]}x{raw.shape[0]}")

    # -------------------------------------------------------- 1. preprocess
    # segment the object with SAM, recentre it on white at 256^2 (run.py:11-16)
    size = cfg.diffusion.image_size
    input_img = pipe.preprocess(raw, safety_check=False)
    write_png(os.path.join(args.out, "1_preprocessed.png"), to_uint8(input_img))
    print(f"1. preprocess -> [{size}, {size}, 3] (1_preprocessed.png)")

    # ------------------------------------- 2. stage-1 views (first ring)
    # 4 views at one elevation, 90 degrees of azimuth apart, in one batch
    seeds = phase_seeds(0)
    s1_first = pipe.zero123.stage1(input_img, seeds["stage1"], indices=[0, 1, 2, 3])
    print(f"2. stage-1 first ring -> {tuple(s1_first.shape)}")

    # ----------------------------- 3. nearby views + elevation estimate
    # the 4 views near view 0 feed the LoFTR pose search (run.py:28-36)
    steps2 = cfg.diffusion.ddim_steps_stage2
    s2_v0 = pipe.zero123.stage2(s1_first[:1], seeds["stage2_view0"], steps=steps2, view_ids=[0])
    polar = pipe.estimate_elevation(s2_v0[0])
    print(f"3. elevation estimate: polar={polar:.0f} deg (elevation {90 - polar:.0f})")

    # --------------------------------- 4. stage-1 second elevation ring
    # the ring depends on the estimate (run.py:40-44): the runner's own plan
    _, _, second = select_stage1b_plan(polar, 1)
    s1_second = pipe.zero123.stage1(input_img, seeds["stage1_ring2"], indices=second)
    stage1 = torch.cat([s1_first, s1_second])
    write_png(os.path.join(args.out, "4_stage1_grid.png"), image_grid(to_uint8(stage1), 2, 4))
    print(f"4. stage-1 complete -> {tuple(stage1.shape)} (4_stage1_grid.png)")

    # ------------------------------------------- 5. stage-2 nearby views
    rest = pipe.zero123.stage2(stage1[1:], seeds["stage2"], steps=steps2,
                               view_ids=list(range(1, 8)))
    stage2 = torch.cat([s2_v0, rest])  # [8, 4, ...]
    flat = stage2.reshape(-1, *stage2.shape[2:])
    write_png(os.path.join(args.out, "5_stage2_grid.png"), image_grid(to_uint8(flat), 4, 8))
    print(f"5. stage-2 complete -> {tuple(stage2.shape)} (5_stage2_grid.png)")

    # --------------------------------------------- 6. 3D reconstruction
    mesh = pipe.recon.reconstruct(flat, cam.build_recon_cameras(polar), resolution=mesh_res,
                                  out_path=os.path.join(args.out, "6_mesh.ply"))
    print(f"6. reconstruction -> {len(mesh['vertices'])} vertices (6_mesh.ply)")

    summary = {
        "elevation_deg": 90.0 - polar,
        "mesh_vertices": int(len(mesh["vertices"])),
        "mesh_faces": int(len(mesh["faces"])),
        "total_secs": round(time.perf_counter() - t_all, 2),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"done in {time.perf_counter() - t_all:.1f}s -> {args.out}/")
    return summary


if __name__ == "__main__":
    main()
