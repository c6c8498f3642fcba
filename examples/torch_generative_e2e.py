"""Fully GENERATIVE pipeline e2e on the port: trained tiny zero123 -> recon -> mesh.

The twin of ``examples/generative_e2e.py`` for ``one2345_tpu_torch``: a
tiny zero123 TRAINED IN-ENV (``examples/torch_diffusion_quality.py``'s
protocol) drives the port's ``One2345Pipeline.run``: real stage-1 sampling
from the input view, real stage-2 sampling conditioned on the SAMPLED
stage-1 images (not GT), pinned elevation, a trained recon
(``examples/torch_pipeline_wiring.py``'s ``train_recon_on_pack``), and the
final world-frame mesh is scored against the GT box (CD/F-score), with an
untrained-UNet control through the identical path.

Training data mirror the runner's conditioning graph (the delta tables):
  cond = input view            -> targets at the 12 STAGE1 deltas
  cond = stage-1 view i (0..7) -> targets at the 4 STAGE2 deltas
so the model learns both hops of the cascade; at run time the second hop
is conditioned on its own stage-1 samples.

Deliberate divergence from the JAX example: polar <= 75 only.  The
stage-2 pairs are built for the 8 parents of the polar <= 75 branch
(stage-1 views 0..7); above 75 the runner picks views 0-3 and 8-11, so the
pairs the model learned would not be the ones it is asked for (the JAX
example builds them for views 0..7 at any polar).  ``main`` and
``run_benchmark`` refuse a polar above 75.  As in the other twins, the
stage runs in bf16 on the card, draws come from seeded
``torch.Generator``s, and ``--device`` picks the device.

    python examples/torch_generative_e2e.py [--size 64 --diff-steps 8000 \
        --recon-steps 1500] [--device cpu] [--json out.json]
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np
import torch

from examples.torch_pipeline_wiring import (
    OracleZero123,
    render_pack_views,
    score_mesh_vs_world_box,
    train_recon_on_pack,
)

# the highest polar whose stage-2 training pairs match the runner's parents
MAX_POLAR = 75.0


def _check_polar(polar: float):
    if polar > MAX_POLAR:
        raise ValueError(
            f"polar {polar} > {MAX_POLAR}: the stage-2 training pairs are built for the "
            f"parents of the polar <= 75 branch (stage-1 views 0..7); above 75 the runner "
            f"conditions stage 2 on views 0-3 and 8-11, pairs the model never learned")


def build_training_set(polar: float, size: int, device=None):
    """GT rasters + (cond_idx, target_idx, dx, dy) pairs covering the
    runner's two-hop conditioning graph.  Image order: [input view, 12
    stage-1 views, 8x4 stage-2 views], all rendered through the oracle
    geometry the wiring proof validated."""
    from one2345_tpu_torch.diffusion.zero123 import (
        STAGE1_DELTA_X, STAGE1_DELTA_Y, STAGE2_DELTA_X, STAGE2_DELTA_Y,
    )

    oracle = OracleZero123(polar, size, device=device)
    cond0 = oracle._render([0.0], [0.0])  # [1, S, S, 3]
    s1 = oracle.stage1(None, None)  # [12, S, S, 3]
    # GT stage-2 for the 8 parents the polar <= 75 branch selects
    s2 = oracle.stage2(s1[:8], None).reshape(32, size, size, 3)

    images = torch.cat([cond0, s1, s2]).cpu().numpy()  # [45, S, S, 3]
    pairs = []  # (cond_idx, target_idx, dx, dy)
    for i in range(12):
        pairs.append((0, 1 + i, STAGE1_DELTA_X[i], STAGE1_DELTA_Y[i]))
    for p in range(8):
        for j in range(4):
            pairs.append((1 + p, 13 + p * 4 + j, STAGE2_DELTA_X[j], STAGE2_DELTA_Y[j]))
    return images, pairs


def train_tiny_zero123(images01, pairs, size: int, steps: int, batch: int,
                       vae_steps: int, sample_steps: int, cfg_scale: float,
                       seed: int, model_channels: int = 48,
                       lr: float = 4e-4, vae_lr: float = 2e-3,
                       log_every: int = 200, device=None):
    """Pretrained-VAE + the port's trainer on the two-hop pair set; returns
    (trained EMA stage, untrained-control stage, stats)."""
    from examples.torch_diffusion_quality import (
        ema_params, pretrain_vae, seeded_params, stage_dtype, tiny_config, train_steps,
    )
    from one2345_tpu_torch.core.device import resolve_device
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage, pose_tokens
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    dev = resolve_device(device)
    cfg_base = tiny_config(size, sample_steps, cfg_scale, model_channels, stage_dtype(dev))
    params = seeded_params(cfg_base, seed, dev)
    f32 = cfg_base.replace(unet=cfg_base.unet.replace(dtype="float32"))
    images = np.asarray(images01, np.float32) * 2.0 - 1.0

    t0 = time.perf_counter()
    vae_params, vae_psnr, z_std = pretrain_vae(
        Zero123Stage(f32, params=params, device=dev), images, vae_steps, vae_lr, batch, seed,
        log_every=log_every)
    vae_secs = time.perf_counter() - t0
    print(f"vae: recon {vae_psnr:.2f} dB, latent std {z_std:.3f} ({vae_secs:.0f}s)", flush=True)

    cfg = cfg_base.replace(vae=cfg_base.vae.replace(scale_factor=1.0 / max(float(z_std), 1e-3)))
    params.update(vae_params)
    stage = Zero123Stage(cfg, params=params, device=dev)

    # untrained control: a fresh UNet / CCProjection on the SAME pretrained
    # VAE; the identical pipeline path must collapse without the learned prior
    fresh = seeded_params(cfg_base, seed + 1, dev)
    stage_untrained = Zero123Stage(
        cfg, params=dict(params, unet=fresh["unet"], cc_projection=fresh["cc_projection"]),
        device=dev)

    trainer = Zero123Trainer(
        stage, {k: params[k] for k in ("unet", "cc_projection")}, base_lr=lr, remat=False,
        device=dev, seed=seed)
    imgs = torch.as_tensor(images, device=dev)
    cond_dev = imgs[torch.as_tensor([p[0] for p in pairs], device=dev)]
    tgt_dev = imgs[torch.as_tensor([p[1] for p in pairs], device=dev)]
    tokens = torch.as_tensor(pose_tokens([p[2] for p in pairs], [p[3] for p in pairs]),
                             device=dev)

    t0 = time.perf_counter()
    losses = train_steps(trainer, cond_dev, tgt_dev, tokens, steps, batch, seed, log_every)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_secs = time.perf_counter() - t0

    stage_trained = Zero123Stage(cfg, params=ema_params(params, trainer), device=dev)
    stats = {
        "vae_psnr": round(vae_psnr, 2), "latent_std": round(float(z_std), 3),
        "eps_mse_first": round(losses[0], 4), "eps_mse_last": round(losses[-1], 4),
        "vae_secs": round(vae_secs, 1), "diff_train_secs": round(train_secs, 1),
    }
    return stage_trained, stage_untrained, stats


class _ScaledPackRecon:
    """Recon adapter for size != 256: the runner builds the camera pack in
    its native 256^2 frame, the tiny pipeline's images are size^2: the
    K / affine pixel rows are scaled to match."""

    def __init__(self, stage, size: int):
        self.stage = stage
        self.s = size / 256.0

    def reconstruct(self, images, cameras, resolution=None, out_path=None):
        pk = dict(cameras)
        pk["intrinsics"] = np.array(cameras["intrinsics"], np.float64)
        pk["intrinsics"][:, :2] *= self.s
        pk["affines"] = np.array(cameras["affines"], np.float64)
        pk["affines"][:, :2] *= self.s
        return self.stage.reconstruct(images, pk, resolution=resolution, out_path=out_path)


def build_generative_pipeline(polar: float, size: int, zero123_stage,
                              recon_stage, sample_steps: int, device=None):
    """The port's ``One2345Pipeline`` with the trained tiny diffusion stage
    (its ``image_size`` = size) and the trained recon swapped in; elevation
    pinned (the contracts under test are sampling + recon)."""
    from one2345_tpu_torch.core.config import DiffusionConfig, PipelineConfig
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    cfg = PipelineConfig(diffusion=DiffusionConfig(
        image_size=size, ddim_steps_stage1=sample_steps, ddim_steps_stage2=sample_steps))
    pipe = One2345Pipeline(cfg, use_sam=False, device=device)
    pipe._zero123 = zero123_stage
    pipe._recon = recon_stage if size == 256 else _ScaledPackRecon(recon_stage, size)
    pipe.estimate_elevation = lambda views: float(polar)
    return pipe


def run_benchmark(polar: float = 75.0, size: int = 64, batch: int = 16,
                  diff_steps: int = 8000, vae_steps: int = 2500,
                  recon_steps: int = 1500, n_rays: int = 512, vol: int = 48,
                  sample_steps: int = 25, cfg_scale: float = 3.0,
                  seed: int = 0, mesh_resolution: int = 128,
                  model_channels: int = 48, log_every: int = 200,
                  n_samples: int = 48, n_importance: int = 48,
                  with_untrained_control: bool = True,
                  save_npz: str | None = None, device=None) -> dict:
    from one2345_tpu_torch.core.device import resolve_device
    from one2345_tpu_torch.geometry.cameras import build_recon_cameras

    _check_polar(polar)
    dev = resolve_device(device)
    t_all = time.perf_counter()
    out: dict = {"polar": polar, "size": size, "diff_steps": diff_steps,
                 "recon_steps": recon_steps, "sample_steps": sample_steps}

    # ---- phase 1: tiny zero123 trained on the two-hop pair set
    images, pairs = build_training_set(polar, size, device=dev)
    print(f"data: {images.shape[0]} x {size}^2 renders, {len(pairs)} pairs "
          f"({time.perf_counter() - t_all:.1f}s)", flush=True)
    stage_diff, stage_untrained, stats = train_tiny_zero123(
        images, pairs, size, diff_steps, batch, vae_steps, sample_steps,
        cfg_scale, seed, model_channels=model_channels, log_every=log_every, device=dev)
    out.update(stats)

    # ---- phase 2: recon trained on the GT pack views (the stand-in for the
    # generalizable checkpoint); normal_query_prob 0 = reference semantics:
    # this benchmark's headline is geometry through the generative cascade
    pack = build_recon_cameras(polar)
    gt_imgs, gt_alphas = render_pack_views(pack, size, device=dev)
    stage_recon = train_recon_on_pack(
        pack, gt_imgs, gt_alphas, recon_steps, n_rays, vol, seed=seed,
        log_every=max(log_every // 2, 50), n_samples=n_samples,
        n_importance=n_importance, mesh_resolution=mesh_resolution,
        normal_query_prob=0.0, device=dev)

    # ---- phase 3: the full generative runner, trained vs untrained
    input_img = images[0]  # the GT input view (what SAM would hand over)
    runs = [("e2e", stage_diff)]
    if with_untrained_control:
        runs.append(("e2e_untrained", stage_untrained))
    for label, dstage in runs:
        pipe = build_generative_pipeline(polar, size, dstage, stage_recon, sample_steps,
                                         device=dev)
        t0 = time.perf_counter()
        res = pipe.run(input_img, skip_preprocess=True, seed=seed,
                       mesh_resolution=mesh_resolution)
        secs = time.perf_counter() - t0
        src = res.stage2_images.reshape(32, size, size, 3).float().cpu().numpy()
        score = score_mesh_vs_world_box(
            res.vertices, res.faces, colors=res.colors, images=src,
            pack=pack, size=size, device=dev)
        # sample quality along the way: the 32 source rows handed to recon
        # vs GT rasters at the pack poses (the tier-A comparator, now
        # generative), and the 8 stage-1 samples vs their GT renders
        s2_psnr = [_psnr01(src[k], gt_imgs[1 + k]) for k in range(32)]
        s1 = res.stage1_images.float().cpu().numpy()
        s1_psnr = [_psnr01(s1[k], images[1 + k]) for k in range(s1.shape[0])]
        score.update({
            "stage1_psnr_mean": round(float(np.mean(s1_psnr)), 2),
            "stage2_psnr_mean": round(float(np.mean(s2_psnr)), 2),
            "stage2_psnr_min": round(float(np.min(s2_psnr)), 2),
            "run_secs": round(secs, 1),
        })
        out[label] = score
        print(json.dumps({label: score}), flush=True)
        if save_npz:
            np.savez_compressed(
                f"{save_npz}_{label}.npz", vertices=res.vertices,
                faces=res.faces, colors=res.colors, src=src, stage1=s1)

    out["total_secs"] = round(time.perf_counter() - t_all, 1)
    return out


def _psnr01(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-10)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--polar", type=float, default=75.0,
                   help=f"input polar in degrees, at most {MAX_POLAR:g} (the module docstring)")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--diff-steps", type=int, default=8000)
    p.add_argument("--vae-steps", type=int, default=2500)
    p.add_argument("--recon-steps", type=int, default=1500)
    p.add_argument("--rays", type=int, default=512)
    p.add_argument("--vol", type=int, default=48)
    p.add_argument("--sample-steps", type=int, default=25)
    p.add_argument("--json", default=None)
    p.add_argument("--save-npz", default=None,
                   help="prefix for per-run mesh/sample artifact dumps")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)
    try:
        _check_polar(args.polar)
    except ValueError as e:
        p.error(str(e))

    out = run_benchmark(
        polar=args.polar, size=args.size, batch=args.batch,
        diff_steps=args.diff_steps, vae_steps=args.vae_steps,
        recon_steps=args.recon_steps, n_rays=args.rays, vol=args.vol,
        sample_steps=args.sample_steps, save_npz=args.save_npz, device=args.device)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
