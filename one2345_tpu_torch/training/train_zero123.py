"""Zero123 finetune training CLI on one card (the ``main.py`` the reference
omits).

    python -m one2345_tpu_torch.training.train_zero123 \
        --data_root views_whole_sphere --batch_size 192 --max_steps 100000

Counterpart of ``one2345_tpu/training/train_zero123.py``, with its flags
and defaults: the training contract of
configs/sd-objaverse-finetune-c_concat-256.yaml (AdamW 1e-4, warmup 100,
a checkpoint every 5000 steps, EMA) through ``Zero123Trainer.train_step``.

- ``--data_root``: a directory of ``*.tar`` shards (or a glob of them) is
  read by ``ObjaverseTarShards``, anything else as per-object view folders
  by ``ObjaverseViewsDataset``;
- ``--init_params``: a ``core/checkpoint.py`` file of the stage's state
  dicts ('unet', 'encoder', 'decoder', 'clip', 'cc_projection');
- writes ``metrics.jsonl`` (loss, samples_per_sec), ``step_XXXXXX``
  checkpoints of ``trainer.state_dicts()`` (every ``--ckpt_every`` steps
  and at the end) and EMA sample grids ``samples/step_XXXXXX.png`` under
  ``--exp_dir``.

Several cards: run under ``torchrun --nproc_per_node N``.  The ranks form
a ``(N // model_shards, model_shards)`` mesh (``core/meshes.py``), as the
JAX CLI's: each reads the global batch and trains on its rows, and with
``--model_shards`` > 1 the trainable weights, their AdamW state and the
EMA are sharded over ``model`` (FSDP2).  Rank 0 writes the metrics, the
sample grids and the checkpoints, which hold the whole weights, so a
sharded run's file loads in a one-card run and the reverse.  A world of one
refuses ``--model_shards`` 2 (``create_mesh``'s ``ValueError``).
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Zero123-XL finetune (one card)")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=192)
    p.add_argument("--base_lr", type=float, default=1e-4)
    p.add_argument("--max_steps", type=int, default=100_000)
    p.add_argument("--ckpt_every", type=int, default=5000)  # yaml modelcheckpoint
    p.add_argument("--log_every", type=int, default=50)
    # ImageLogger parity (yaml:96-111): periodic EMA sample grids
    p.add_argument("--sample_every", type=int, default=2000,
                   help="dump EMA sample grids every N steps (0 = off)")
    p.add_argument("--sample_views", type=int, default=4)
    p.add_argument("--sample_steps", type=int, default=25)
    p.add_argument("--exp_dir", type=str, default="exp/zero123_finetune")
    p.add_argument("--init_params", type=str, default=None,
                   help="a core/checkpoint.py file of the Zero123 stage's state dicts")
    p.add_argument("--model_shards", type=int, default=1,
                   help="FSDP-style parameter sharding factor (ranks on the 'model' axis)")
    p.add_argument("--total_views", type=int, default=12)
    return p


def build_config():
    """The stage's config (the JAX CLI's ``DiffusionConfig()``)."""
    from one2345_tpu_torch.core.config import DiffusionConfig

    return DiffusionConfig()


def log_samples(stage, trainer, sample_batch, out_path: str, steps: int, seed: int,
                noise_fn=None, ema=None) -> str:
    """EMA sample grid, the Lightning ImageLogger's role (yaml:96-111):
    rows (conditioning image, sampled view, target), one column per sample.

    DDIM over ``steps`` with the trainer's EMA UNet and CCProjection at
    ``stage.config.cfg_scale``, conditioned on the batch's own pose tokens;
    the stage's and the trainer's weights are left as they were.
    ``noise_fn`` replaces the per-view noise, as in ``sample_views``;
    ``ema`` gives ``trainer.ema_weights()`` when the caller gathered them
    (a sharded trainer gathers on every rank)."""
    from one2345_tpu_torch.utils.image import image_grid
    from one2345_tpu_torch.utils.png import write_png

    ema = trainer.ema_weights() if ema is None else ema
    with stage.swapped_weights(ema):
        samples = stage.sample_tokens(sample_batch["image_cond"], sample_batch["T"], seed,
                                      steps=steps, cfg_scale=stage.config.cfg_scale,
                                      noise_fn=noise_fn)
    samples = samples.float().cpu().numpy()  # [B, H, W, 3] in [0, 1]
    cond01 = (np.asarray(sample_batch["image_cond"]) + 1.0) / 2.0
    target01 = (np.asarray(sample_batch["image_target"]) + 1.0) / 2.0
    B = samples.shape[0]
    grid = image_grid(np.concatenate([cond01, samples, target01]).astype(np.float32), 3, B)
    write_png(out_path, (np.clip(grid, 0, 1) * 255).astype(np.uint8))
    return out_path


def dataset(data_root: str, image_size: int, total_views: int):
    """Tar shards when ``data_root`` holds (or globs) only ``*.tar`` files,
    else per-object view folders."""
    from one2345_tpu_torch.training.data import ObjaverseTarShards, ObjaverseViewsDataset

    tars = (sorted(glob.glob(os.path.join(data_root, "*.tar"))) if os.path.isdir(data_root)
            else sorted(glob.glob(data_root)))
    if tars and all(t.endswith(".tar") for t in tars):
        return ObjaverseTarShards(tars, image_size=image_size)
    return ObjaverseViewsDataset(data_root, total_views=total_views, image_size=image_size)


def main(argv=None, device=None):
    """Train; ``device`` None -> the card (raises without CUDA).  Under
    ``torchrun`` (or in a process group the caller started) the ranks train
    on a ``(world // model_shards, model_shards)`` mesh.  Returns the
    trainer."""
    args = build_parser().parse_args(argv)

    from one2345_tpu_torch.core import compile_cache, meshes

    compile_cache.enable()
    with meshes.process_group(device) as dev:
        return _train(args, dev)


def _train(args, dev):
    from dataclasses import replace

    import torch.distributed as dist

    from one2345_tpu_torch.core import checkpoint, meshes
    from one2345_tpu_torch.core.logging import MetricsLogger
    from one2345_tpu_torch.diffusion.zero123 import MODULES, Zero123Stage
    from one2345_tpu_torch.training.data import Prefetcher
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    mesh = None
    if dist.is_initialized() or args.model_shards != 1:
        # a world of one refuses --model_shards 2 here, as the JAX CLI's mesh
        world = meshes.world_size()
        mesh = meshes.create_mesh(("data", "model"),
                                  (world // args.model_shards, args.model_shards))
    main_rank = meshes.rank() == 0
    cfg = build_config()
    if args.init_params:
        params = checkpoint.restore(args.init_params)
    else:
        # the seeded modules in f32: the stage keeps its own in the compute dtype
        f32 = Zero123Stage(replace(cfg, unet=replace(cfg.unet, dtype="float32")), device=dev)
        params = {name: getattr(f32, name).state_dict() for name in MODULES}
        del f32
    stage = Zero123Stage(cfg, params, device=dev)
    trainer = Zero123Trainer(stage, {k: params[k] for k in ("unet", "cc_projection")},
                             base_lr=args.base_lr, device=dev)
    del params
    step_fn = (trainer.train_step if mesh is None
               else trainer.make_sharded_train_step(mesh, shard_params=args.model_shards > 1))

    # every rank reads the global batch (the same seeded stream) and keeps its rows
    ds = dataset(args.data_root, cfg.image_size, args.total_views)
    batches = Prefetcher(ds.batches(args.batch_size))
    logger = MetricsLogger(args.exp_dir) if main_rank else None
    sample_batch = None
    t0 = time.time()
    try:
        for step_idx in range(args.max_steps):
            batch = next(batches)
            if sample_batch is None and args.sample_every:
                os.makedirs(f"{args.exp_dir}/samples", exist_ok=True)
                sample_batch = {k: v[:args.sample_views] for k, v in batch.items()}
            loss = step_fn(batch)
            if args.sample_every and step_idx > 0 and step_idx % args.sample_every == 0:
                ema = trainer.ema_weights()
                if main_rank:
                    path = log_samples(stage, trainer, sample_batch,
                                       f"{args.exp_dir}/samples/step_{step_idx:06d}.png",
                                       args.sample_steps, step_idx, ema=ema)
                    print(f"sample grid -> {path}", flush=True)
            if step_idx % args.log_every == 0 and main_rank:
                loss = float(loss)
                rate = args.log_every * args.batch_size / max(time.time() - t0, 1e-9)
                logger.log(step_idx, loss=loss, samples_per_sec=rate)
                print(f"step {step_idx} loss {loss:.4f} ({rate:.1f} samples/s)", flush=True)
                t0 = time.time()
            if step_idx > 0 and step_idx % args.ckpt_every == 0:
                _save(f"{args.exp_dir}/step_{step_idx:06d}", trainer, main_rank)
        _save(f"{args.exp_dir}/step_{args.max_steps:06d}", trainer, main_rank)
    finally:
        batches.close()
        if logger is not None:
            logger.close()
    return trainer


def _save(path: str, trainer, main_rank: bool) -> None:
    """The whole trainable weights (gathered on every rank), written by rank 0."""
    from one2345_tpu_torch.core import checkpoint

    state = trainer.state_dicts()
    if main_rank:
        checkpoint.save(path, state)


if __name__ == "__main__":
    main()
