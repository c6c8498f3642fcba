"""Training throughput of the port on one card at production scale.

The twin of ``examples/train_probe.py`` for ``one2345_tpu_torch``: seconds
per ``Zero123Trainer.train_step`` (the full 860M-parameter SD UNet, 256^2
images, remat backward, f32 weights + AdamW + EMA, bf16 compute; its
self-attention runs the flash kernels forward and backward), or with
``--recon`` per ``ReconTrainer.train_step`` at ``ReconConfig()`` (512
rays, 96^3 volume, 64 + 64 samples, 32 source views at 256^2) on the JAX
probe's synthetic 33-view scene.  One JSON line with the JAX probe's keys:

    python examples/torch_train_probe.py [--batch 4] [--iters 8] [--recon] \
        [--device cpu] [--tiny]

Peak memory comes from ``torch.cuda.max_memory_allocated`` (``peak_gib_in_use``)
and the card's total memory (``gib_limit``), in the places of the JAX
probe's ``memory_stats`` keys; on the CPU both are left out, as the JAX
probe leaves them out where a backend has no memory statistics.  Integer
seeds take the place of the JAX keys.  Added flags: ``--device`` (the
card by default) and ``--tiny`` (the walkthrough's toy UNet, or a 16^3
reconstruction volume with 64 rays at 32^2).  ``zero123_steps`` and
``recon_steps`` time the steps of a trainer that a caller has built.
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_record(device) -> dict:
    """{'peak_gib_in_use', 'gib_limit'} on the card, {} on the CPU."""
    import torch

    if device.type != "cuda":
        return {}
    return {
        "peak_gib_in_use": round(torch.cuda.max_memory_allocated(device) / 2**30, 2),
        "gib_limit": round(torch.cuda.get_device_properties(device).total_memory / 2**30, 2),
    }


def recon_config(tiny: bool):
    from one2345_tpu_torch.core.config import ReconConfig

    if tiny:
        return ReconConfig(vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0, image_hw=(32, 32),
                           n_rays=64, n_samples=8, n_importance=8)
    return ReconConfig()


def recon_probe(iters: int = 8, device=None, tiny: bool = False) -> dict:
    """ReconTrainer.train_step at the production contract: the per-step cost
    behind the reference's 200k-iteration schedule."""
    import torch

    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer

    cfg = recon_config(tiny)
    stage = ReconStage(cfg, seed=0, device=device)
    trainer = ReconTrainer(stage, cfg)
    dev = stage.device

    rng = np.random.default_rng(0)
    (H, W), V, N = cfg.image_hw, 33, cfg.n_rays
    o = rng.normal(0, 1, (N, 3))
    v = o / np.linalg.norm(o, axis=-1, keepdims=True)
    scene = {
        "images": rng.uniform(0, 1, (V, H, W, 3)),
        "affines": np.tile(np.eye(4), (V, 1, 1)),
        "w2cs": np.tile(np.eye(4), (V, 1, 1)),
        "intrinsics": np.tile(np.eye(3), (V, 1, 1)),
        "near_far": np.asarray([0.5, 1.8]),
        "rays_o": -1.5 * v,
        "rays_v": v,
        "rays_color": rng.uniform(0, 1, (N, 3)),
        "rays_mask": np.ones((N, 1)),
    }
    scene = {k: torch.as_tensor(x, dtype=torch.float32, device=dev) for k, x in scene.items()}
    return recon_steps(trainer, scene, iters)


def recon_steps(trainer, scene: dict, iters: int = 8) -> dict:
    """Seconds per ``trainer.train_step(scene)`` over ``iters`` steps after
    one drained warm-up step; print and return the JSON record.  Any built
    ``ReconTrainer`` and scene will do (``recon_probe`` makes the JAX
    probe's)."""
    import torch

    cfg, dev = trainer.cfg, trainer.stage.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics = trainer.train_step(scene)
    float(metrics["loss"])  # drain

    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = trainer.train_step(scene)
    final = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / iters
    record = {
        "component": "recon_train_step",
        "n_rays": cfg.n_rays, "vol_dims": list(cfg.vol_dims), "views": len(scene["images"]) - 1,
        "sec_per_step": round(dt, 4),
        "steps_per_sec": round(1.0 / dt, 3),
        "loss_finite": bool(np.isfinite(final)),
        **memory_record(dev),
    }
    print(json.dumps(record), flush=True)
    return record


def zero123_probe(batch: int = 4, iters: int = 8, device=None, tiny: bool = False) -> dict:
    """Zero123Trainer.train_step at ``DiffusionConfig()``, remat, seeded weights."""
    import torch

    from examples.torch_walkthrough import tiny_config
    from one2345_tpu_torch.core.config import DiffusionConfig
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    cfg = tiny_config().diffusion if tiny else DiffusionConfig()
    # the seeded modules in f32 for the trainer; the stage keeps its own in
    # the compute dtype (as train_zero123 seeds them)
    f32 = Zero123Stage(cfg.replace(unet=cfg.unet.replace(dtype="float32")), seed=0,
                       device=device)
    params = {k: getattr(f32, k).state_dict() for k in ("unet", "cc_projection")}
    del f32
    stage = Zero123Stage(cfg, seed=0, device=device)
    trainer = Zero123Trainer(stage, params, remat=True, device=stage.device, seed=0)
    del params

    B, S = batch, cfg.image_size
    rng = np.random.default_rng(0)
    data = {
        "image_target": rng.uniform(-1, 1, (B, S, S, 3)),
        "image_cond": rng.uniform(-1, 1, (B, S, S, 3)),
        "T": rng.uniform(-1, 1, (B, 1, 4)),
    }
    data = {k: torch.as_tensor(x, dtype=torch.float32, device=stage.device)
            for k, x in data.items()}
    return zero123_steps(trainer, data, iters)


def zero123_steps(trainer, data: dict, iters: int = 8) -> dict:
    """Seconds per ``trainer.train_step(data)`` over ``iters`` steps after
    one drained warm-up step; print and return the JSON record.  Any built
    ``Zero123Trainer`` and batch will do (``zero123_probe`` makes the JAX
    probe's)."""
    import torch

    dev = data["image_target"].device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    float(trainer.train_step(data))  # warm-up, drained

    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = trainer.train_step(data)
    final = float(loss)
    dt = (time.perf_counter() - t0) / iters
    B, S = data["image_target"].shape[:2]
    record = {
        "component": "zero123_train_step",
        "batch": int(B),
        "image_size": int(S),
        "sec_per_step": round(dt, 4),
        "steps_per_sec": round(1.0 / dt, 3),
        "images_per_sec": round(B / dt, 2),
        "loss_finite": bool(np.isfinite(final)),
        **memory_record(dev),
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--recon", action="store_true",
                    help="probe the recon trainer instead of zero123")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="toy sizes: seconds on the CPU")
    args = ap.parse_args(argv)
    if args.recon:
        return recon_probe(args.iters, args.device, args.tiny)
    return zero123_probe(args.batch, args.iters, args.device, args.tiny)


if __name__ == "__main__":
    main()
