"""Generalizable-reconstruction training CLI, one scene per step and card.

Counterpart of ``one2345_tpu/training/train_recon.py`` (reference:
exp_runner_generic_blender_train.py --mode train: Adam 2e-4 at the cosine
rate, global-norm clip 1.0, 200k iterations, 512 rays), with its flags.

    python -m one2345_tpu_torch.training.train_recon --data_root runs/ --max_steps 200000

``--data_root`` holds shape directories as ``One2345Pipeline.run`` writes
them (stage1_8/, stage2_8/, pose.json).  Writes ``metrics.jsonl``,
``step_XXXXXX`` checkpoints (``core/checkpoint.py``: the trainer's
modules, optimizer and step) and, with ``--val_every``, validation panels
``val/step_XXXXXX[_lod1].png`` under ``--exp_dir``.  ``--resume``
continues from the newest checkpoint at its step.  ``--dtype bfloat16``
runs the conv paths and the blending nets in bf16 over f32 weights
(``ReconTrainer``).

Several cards: ``torchrun --nproc_per_node N -m
one2345_tpu_torch.training.train_recon ...`` trains N scenes per step, one
per rank, as the JAX CLI's n_dev scenes (``make_sharded_train_step``);
rank 0 logs, validates and writes the checkpoints, which hold the whole
state and load in a one-card run.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="SparseNeuS generic training")
    p.add_argument("--data_root", type=str, required=True, help="root of shape dirs")
    p.add_argument("--max_steps", type=int, default=200_000)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--n_rays", type=int, default=512)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="conv-path compute dtype (f32 = reference numerics)")
    p.add_argument("--num_lods", type=int, choices=[1, 2], default=1,
                   help="2 = coarse-to-fine training with the separate lod1 networks "
                        "(trainer_generic train_step:269-319)")
    p.add_argument("--fix_lod0", action="store_true",
                   help="freeze the lod0 networks and train only lod1 (if_fix_lod0_networks)")
    p.add_argument("--ckpt_every", type=int, default=5000)  # conf save_freq
    p.add_argument("--log_every", type=int, default=100)  # conf report_freq
    p.add_argument("--val_every", type=int, default=0,
                   help="render a full-image validation panel + PSNR every N steps "
                        "(conf val_freq / GenericTrainer val_step; 0 = off)")
    p.add_argument("--exp_dir", type=str, default="exp/recon_train")
    p.add_argument("--init_params", type=str, default=None,
                   help="a core/checkpoint.py file of ReconStage state dicts")
    p.add_argument("--resume", action="store_true", help="resume from the newest checkpoint")
    return p


def main(argv=None, device=None):
    """Train; ``device`` None -> the card (raises without CUDA).  Under
    ``torchrun`` (or in a process group the caller started) each rank
    trains its own scene of every step.  Returns the trainer."""
    args = build_parser().parse_args(argv)

    from one2345_tpu_torch.core import meshes

    with meshes.process_group(device) as dev:
        return _train(args, dev)


def _train(args, dev):
    import numpy as np
    import torch
    import torch.distributed as dist

    from one2345_tpu_torch.core import checkpoint, meshes
    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.core.logging import MetricsLogger
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.recon.validation import Validator
    from one2345_tpu_torch.training.data import Prefetcher, ReconScenesDataset
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer
    from one2345_tpu_torch.utils.png import write_png

    cfg = ReconConfig(learning_rate=args.learning_rate, end_iter=args.max_steps,
                      n_rays=args.n_rays, dtype=args.dtype, num_lods=args.num_lods,
                      fix_lod0_networks=args.fix_lod0)
    params = checkpoint.restore(args.init_params) if args.init_params else None
    # bf16 computes over f32 weights: the trainer never casts them
    stage = ReconStage(cfg, params, device=dev, f32_weights=True)
    trainer = ReconTrainer(stage, cfg)
    mesh = meshes.create_mesh(("data",)) if dist.is_initialized() else None
    step_fn = trainer.train_step if mesh is None else trainer.make_sharded_train_step(mesh)
    world, rank = meshes.world_size(), meshes.rank()
    main_rank = rank == 0
    start_step = 0
    if args.resume:
        latest = checkpoint.latest_step_dir(args.exp_dir)
        if latest:
            trainer.load_state_dict(checkpoint.restore(latest, map_location=dev))
            start_step = trainer.step
            if main_rank:
                print(f"resumed from {latest} at step {start_step}", flush=True)
    trainer.generator.manual_seed(start_step)

    ds = ReconScenesDataset(args.data_root, n_rays=args.n_rays)

    def scenes():
        # the step's scenes come in turn from one seeded stream, as the JAX
        # CLI's n_dev scenes per step; each rank loads its own only
        while True:
            for r in range(world):
                idx = int(ds.rng.integers(len(ds)))
                seed = int(ds.rng.integers(1 << 31))
                if r == rank:
                    yield ds.sample_scene(idx, torch.Generator().manual_seed(seed))

    batches = Prefetcher(scenes())
    logger = MetricsLogger(args.exp_dir) if main_rank else None
    validator = None
    t0 = time.time()
    try:
        for step_idx in range(start_step, args.max_steps):
            metrics = step_fn(next(batches))
            if (main_rank and args.val_every and step_idx > 0
                    and step_idx % args.val_every == 0):
                # val_step: full-image render of the first scene's
                # reference view at every lod, panel + PSNR
                if validator is None:
                    validator = Validator(stage)
                sc = ds.load_scene(0)
                os.makedirs(f"{args.exp_dir}/val", exist_ok=True)
                for lod in range(args.num_lods):
                    res = validator.render_view(sc["images"][1:], sc["cameras"], lod=lod)
                    val_psnr = Validator.psnr(res["color"], sc["images"][0])
                    panel = Validator.panel(res, sc["images"][0])
                    suffix = "" if lod == 0 else f"_lod{lod}"
                    write_png(f"{args.exp_dir}/val/step_{step_idx:06d}{suffix}.png",
                              (np.clip(panel, 0, 1) * 255).astype(np.uint8))
                    logger.log(step_idx, **{f"val_psnr{suffix}": val_psnr})
                    print(f"val step {step_idx}: psnr{suffix}={val_psnr:.2f}", flush=True)
            if step_idx % args.log_every == 0 and main_rank:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = args.log_every / max(time.time() - t0, 1e-9)
                logger.log(step_idx, **m)
                print(f"step {step_idx} " + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                      flush=True)
                t0 = time.time()
            if step_idx > 0 and step_idx % args.ckpt_every == 0 and main_rank:
                checkpoint.save(f"{args.exp_dir}/step_{step_idx:06d}", trainer.state_dict())
        if main_rank:
            checkpoint.save(f"{args.exp_dir}/step_{args.max_steps:06d}", trainer.state_dict())
        if mesh is not None:
            dist.barrier()  # the files are written before any rank returns
    finally:
        batches.close()
        if logger is not None:
            logger.close()
    return trainer


if __name__ == "__main__":
    main()
