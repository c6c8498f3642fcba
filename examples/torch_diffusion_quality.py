"""In-env diffusion quality benchmark on the port: train -> sample held-out poses -> PSNR.

The twin of ``examples/diffusion_quality.py`` for ``one2345_tpu_torch``:

1. rasterize a KNOWN asymmetric coloured object (the recon-quality box)
   from cameras on the zero123 view sphere;
2. pretrain the tiny AutoencoderKL on those views (SD's first stage is
   pretrained separately and frozen) and set scale_factor = 1 / std(z);
3. train the port's ``Zero123Trainer`` (eps-MSE, CCProjection conditioning,
   5%/5%/5% CFG dropout, AdamW warmup, EMA) on (cond view, target view,
   relative pose token) pairs;
4. sample HELD-OUT pose tokens through the port's sampling path
   (``Zero123Stage.sample_views``) and score PSNR / SSIM against the
   rasterized GT, against an untrained UNet on the same VAE, and by a
   cross-pose discrimination matrix (sample(delta_i) must match
   GT(delta_i) better than GT(delta_j)).

The public functions, their arguments and the keys of ``run_benchmark``'s
dict are those of the JAX example.  The differences:

- the VAE pretraining is ``torch.optim.Adam`` with optax's defaults (b1
  0.9, b2 0.999, eps 1e-8 added to sqrt(v_hat), bias correction), the same
  loss (``vae_loss``);
- on the card the tiny stage runs in bf16 (``UNetConfig.dtype='bfloat16'``:
  the trainer runs the UNet under bf16 autocast, sampling runs the stage's
  modules in bf16), because the port's flash kernels take bf16 only and
  an f32 UNet on the card reaches them; on the CPU it stays f32, as the
  JAX example;
- random draws come from ``torch.Generator``s seeded from ``seed``; any of
  them can be given through ``draw_fn(step)``: {'idx': batch indices,
  'z_eps': the VAE posterior's normal draw} in the VAE pretraining and
  {'idx', and ``Zero123Trainer``'s 't', 'noise', 'z_eps', 'u'} in the
  diffusion training;
- ``--png`` writes the grid with ``utils/png.py``; ``--device`` picks the
  device (None -> the card).

    python examples/torch_diffusion_quality.py [--steps 4000] [--res 64] \
        [--fast-variants] [--device cpu] [--json out.json]
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

# -------------------------------------------------------------- data


def render_pose_views(polar_deg, azimuth_deg, res: int, radius: float = 1.6, device=None):
    """White-background rasterized views of the recon-quality GT box from
    spherical look-at cameras (the zero123 view-sphere geometry).  Returns
    [N, res, res, 3] float32 in [0, 1]."""
    from examples.torch_recon_quality import make_gt_box
    from one2345_tpu_torch.eval.render_harness import rasterize
    from one2345_tpu_torch.geometry.cameras import BLENDER2OPENCV, spherical_look_at_poses

    verts, faces, colors = make_gt_box()
    c2ws = spherical_look_at_poses(
        np.radians(np.asarray(polar_deg, np.float64)),
        np.radians(np.asarray(azimuth_deg, np.float64)),
        radius=radius,
    ) @ BLENDER2OPENCV
    w2cs = np.linalg.inv(c2ws)
    f = res * 1.2  # wide enough that the box fills most of the frame
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    imgs = [rasterize(verts, faces, colors, K, w2cs[i].astype(np.float32), res=res,
                      shade=False, device=device)[0]
            for i in range(w2cs.shape[0])]
    return np.stack(imgs).astype(np.float32)


def make_view_plan(cond_polar: float = 75.0, dx_set=(-20.0, 0.0, 20.0),
                   n_azim: int = 12,
                   heldout=((0.0, 45.0), (0.0, 135.0), (0.0, 225.0),
                            (0.0, 315.0), (20.0, 105.0), (-20.0, 285.0))):
    """(cond pose, train deltas, held-out deltas) on the zero123 sphere.

    Deltas are (delta_polar_deg, delta_azimuth_deg) RELATIVE to the cond
    view, what ``pose_tokens`` encodes.  Held-out deltas sit between the
    training azimuth grid lines, so passing them requires interpolating
    the pose conditioning, not replaying a memorized view."""
    train = [
        (dx, dy)
        for dx in dx_set
        for dy in np.linspace(0.0, 360.0, n_azim, endpoint=False)
    ]
    held = [h for h in heldout if h not in train]
    return (cond_polar, 0.0), train, held


# ----------------------------------------------------- VAE pretraining


def _vae_modules(stage):
    """f32 copies of the stage's Encoder / Decoder, trainable."""
    from one2345_tpu_torch.diffusion.vae import Decoder, Encoder

    v = stage.config.vae
    kw = dict(base_channels=v.base_channels, channel_mult=tuple(v.channel_mult),
              num_res_blocks=v.num_res_blocks, z_channels=v.z_channels)
    with torch.device("meta"):
        enc = Encoder(in_channels=v.in_channels, **kw)
        dec = Decoder(out_channels=v.out_channels, **kw)
    out = []
    for module, src in ((enc, stage.encoder), (dec, stage.decoder)):
        module = module.to_empty(device=stage.device)
        module.load_state_dict({k: t.float() for k, t in src.state_dict().items()}, strict=True)
        out.append(module.train().requires_grad_(True))
    return out


def vae_loss(encoder, decoder, x, z_eps, kl_weight: float = 1e-6):
    """The AutoencoderKL objective minus the discriminator: recon MSE +
    kl_weight * KL of the posterior (logvar clipped to [-30, 20]), with the
    posterior's normal draw ``z_eps`` given."""
    from one2345_tpu_torch.diffusion.vae import moments_sample

    moments = encoder(x)
    rec = decoder(moments_sample(moments, z_eps))
    mean, logvar = moments.chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    kl = 0.5 * torch.mean(mean**2 + torch.exp(logvar) - 1.0 - logvar)
    return torch.mean((rec - x) ** 2) + kl_weight * kl


def pretrain_vae(stage, images_pm1, steps: int, lr: float, batch: int,
                 seed: int, kl_weight: float = 1e-6, log_every: int = 200, draw_fn=None):
    """Autoencoder pretraining of the stage's Encoder / Decoder (f32
    copies) on the rig views.  Returns (vae_params {'encoder', 'decoder'}
    state dicts, recon_psnr, latent_std).

    :param draw_fn: optional step -> {'idx' [batch], 'z_eps'}; missing draws
        come from a generator seeded from ``seed``"""
    from one2345_tpu_torch.diffusion.vae import moments_mode

    dev = stage.device
    imgs = torch.as_tensor(np.asarray(images_pm1), dtype=torch.float32, device=dev)
    N = imgs.shape[0]
    enc, dec = _vae_modules(stage)
    params = list(enc.parameters()) + list(dec.parameters())
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    with torch.no_grad():
        z_shape = moments_mode(enc(imgs[:1])).shape[1:]
    for i in range(steps):
        d = draw_fn(i) if draw_fn is not None else {}
        idx = d.get("idx")
        if idx is None:
            idx = torch.randint(0, N, (batch,), generator=gen, device=dev)
        x = imgs[torch.as_tensor(idx, device=dev)]
        z_eps = d.get("z_eps")
        if z_eps is None:
            z_eps = torch.randn((x.shape[0], *z_shape), generator=gen, device=dev)
        loss = vae_loss(enc, dec, x, torch.as_tensor(z_eps, dtype=torch.float32, device=dev),
                        kl_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % log_every == 0 or i == steps - 1:
            l = float(loss.detach())
            print(f"vae step {i:5d}  loss {l:.5f}", flush=True)
            if not np.isfinite(l):
                raise RuntimeError(f"VAE pretraining diverged at step {i}")

    # reconstruction PSNR of the mode latent (the sampling path's decode
    # input) + the latent std for the scale_factor calibration
    with torch.no_grad():
        z = moments_mode(enc(imgs))
        mse = float(torch.mean((dec(z) - imgs) ** 2))
        std = float(torch.std(z, correction=0))
    # images are in [-1, 1] (range 2): the [0, 1] PSNR convention
    psnr = float(-10.0 * np.log10(max(mse / 4.0, 1e-10)))
    params = {"encoder": enc.state_dict(), "decoder": dec.state_dict()}
    return params, psnr, std


# ----------------------------------------------------------- scoring


def psnr01(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-10)))


def ssim01(a: np.ndarray, b: np.ndarray) -> float:
    """Global-statistics SSIM on [0,1] images (single-window variant —
    enough to rank 'structured object' vs 'noise' without scipy)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = float(np.mean((a - mu_a) * (b - mu_b)))
    c1, c2 = 0.01**2, 0.03**2
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                 / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2)))


# ------------------------------------------------------ the tiny stage


def tiny_config(res: int, sample_steps: int, cfg_scale: float, model_channels: int,
                dtype: str, sampler: str = "ddim", scale_factor: float = 0.18215):
    """The examples' tiny-but-real Zero123 config: VAE channel_mult (1, 2, 2)
    (factor-4 downsample: latent res / 4), a two-level UNet attending at
    level 1, a two-layer CLIP tower; ``dtype`` the stage's compute dtype."""
    from one2345_tpu_torch.core.config import (
        CLIPVisionConfig, DiffusionConfig, UNetConfig, VAEConfig,
    )

    return DiffusionConfig(
        ddim_steps_stage1=sample_steps, ddim_steps_stage2=sample_steps,
        image_size=res, latent_size=res // 4, sampler=sampler, cfg_scale=cfg_scale,
        unet=UNetConfig(model_channels=model_channels, channel_mult=(1, 2),
                        attention_resolutions=(2,), num_heads=4, dtype=dtype),
        vae=VAEConfig(base_channels=24, channel_mult=(1, 2, 2), num_res_blocks=1,
                      dtype="float32", scale_factor=scale_factor),
        clip=CLIPVisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                              dtype="float32"),
    )


def stage_dtype(device) -> str:
    """bf16 on the card (the flash kernels take bf16 only), f32 elsewhere."""
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def seeded_params(config, seed: int, device) -> dict:
    """f32 state dicts of a Zero123Stage built from ``seed`` (flax's
    initialisers): the trainable weights stay f32 whatever the compute
    dtype."""
    from one2345_tpu_torch.diffusion.zero123 import MODULES, Zero123Stage

    f32 = config.replace(unet=config.unet.replace(dtype="float32"))
    st = Zero123Stage(f32, seed=seed, device=device)
    return {name: getattr(st, name).state_dict() for name in MODULES}


def ema_params(params: dict, trainer) -> dict:
    """``params`` with the trainer's EMA UNet and CCProjection."""
    out = dict(params)
    for name, module in trainer.modules.items():
        out[name] = {**module.state_dict(), **trainer.ema[name]}
    return out


def train_steps(trainer, cond, targets, tokens, steps: int, batch: int, seed: int,
                log_every: int, draw_fn=None, label: str = "step"):
    """``steps`` Zero123Trainer steps on (cond [P, H, W, 3] or one view,
    target [P, H, W, 3], pose token [P, 1, 4]) pairs, batches drawn
    uniformly with replacement from a generator seeded from
    ``stream_seed(seed, 1)`` (the trainer's own takes ``seed``).  Returns
    the logged losses."""
    from examples.torch_recon_quality import stream_seed

    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1))
    n = targets.shape[0]
    losses = []
    for i in range(steps):
        d = dict(draw_fn(i)) if draw_fn is not None else {}
        idx = d.pop("idx", None)
        if idx is None:
            idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
        idx = torch.as_tensor(idx, device=dev)
        b = {"image_target": targets[idx],
             "image_cond": cond[idx] if cond.dim() == 4 else cond.expand(len(idx), *cond.shape),
             "T": tokens[idx]}
        loss = trainer.train_step(b, d or None)
        if i % log_every == 0 or i == steps - 1:
            l = float(loss)
            losses.append(l)
            print(f"{label} {i:5d}  eps_mse {l:.4f}", flush=True)
            if not np.isfinite(l):
                raise RuntimeError(f"training diverged at step {i}")
    return losses


# --------------------------------------------------------- benchmark


def run_benchmark(
    steps: int = 4000,
    res: int = 64,
    batch: int = 16,
    vae_steps: int = 3000,
    vae_lr: float = 2e-3,
    lr: float = 4e-4,
    sample_steps: int = 25,
    cfg_scale: float = 3.0,
    seed: int = 0,
    model_channels: int = 48,
    n_azim: int = 12,
    log_every: int = 200,
    sampler: str = "ddim",
    out_png: str | None = None,
    eval_variants: tuple = (),
    device=None,
    vae_draw_fn=None,
    draw_fn=None,
) -> dict:
    """:param vae_draw_fn, draw_fn: optional per-step draws of the VAE
        pretraining and of the diffusion training (the module docstring)"""
    from one2345_tpu_torch.core.device import resolve_device
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage, pose_tokens
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    dev = resolve_device(device)
    t_all = time.perf_counter()
    (cond_polar, cond_azim), train_deltas, held_deltas = make_view_plan(n_azim=n_azim)

    # rasterized GT on the view sphere: cond view first, then the train
    # targets, then the held-out targets
    all_deltas = [(0.0, 0.0)] + train_deltas + held_deltas
    polars = [cond_polar + dx for dx, _ in all_deltas]
    azims = [cond_azim + dy for _, dy in all_deltas]
    views01 = render_pose_views(polars, azims, res, device=dev)
    views = views01 * 2.0 - 1.0  # [-1, 1] (the trainer/VAE contract)
    cond01 = views01[0]
    train_targets = views[1 : 1 + len(train_deltas)]
    held_gt01 = views01[1 + len(train_deltas) :]
    print(f"data: {len(all_deltas)} x {res}^2 box renders "
          f"({time.perf_counter() - t_all:.1f}s)", flush=True)

    dtype = stage_dtype(dev)
    cfg_base = tiny_config(res, sample_steps, cfg_scale, model_channels, dtype, sampler)
    params = seeded_params(cfg_base, seed, dev)
    stage = Zero123Stage(cfg_base.replace(unet=cfg_base.unet.replace(dtype="float32")),
                         params=params, device=dev)

    # ---- phase 1: first-stage autoencoder (pretrained + frozen, like SD)
    t0 = time.perf_counter()
    vae_params, vae_psnr, z_std = pretrain_vae(
        stage, views, vae_steps, vae_lr, batch, seed, log_every=log_every, draw_fn=vae_draw_fn)
    vae_secs = time.perf_counter() - t0
    print(f"vae: recon {vae_psnr:.2f} dB, latent std {z_std:.3f} ({vae_secs:.0f}s)", flush=True)

    # scale_factor = 1/std(z): the calibration that produced SD's 0.18215
    scale = 1.0 / max(z_std, 1e-3)
    cfg = cfg_base.replace(vae=cfg_base.vae.replace(scale_factor=scale))
    params.update(vae_params)
    stage = Zero123Stage(cfg, params=params, device=dev)

    # ---- untrained baseline samples FIRST (same pretrained VAE, seeded
    # UNet / CCProjection): the trained model must beat this decisively
    held_T = np.asarray(held_deltas, np.float64)
    cond_batch = np.tile((cond01 * 2.0 - 1.0)[None], (len(held_deltas), 1, 1, 1))

    def sample_held(st, steps_=None, sampler_=None):
        out = st.sample_views(cond_batch, held_T[:, 0], held_T[:, 1], seed + 77,
                              steps=steps_ or sample_steps, cfg_scale=cfg_scale,
                              sampler=sampler_ or sampler)
        return out.float().cpu().numpy()

    t0 = time.perf_counter()
    samples_untrained = sample_held(stage)
    print(f"untrained samples ({time.perf_counter() - t0:.0f}s)", flush=True)

    # ---- phase 2: zero123 training on (cond, target, T) pairs
    trainer = Zero123Trainer(
        stage, {k: params[k] for k in ("unet", "cc_projection")}, base_lr=lr, remat=False,
        device=dev, seed=seed)
    train_T = torch.as_tensor(pose_tokens([d[0] for d in train_deltas],
                                          [d[1] for d in train_deltas]), device=dev)
    targets_dev = torch.as_tensor(train_targets, device=dev)
    cond_dev = torch.as_tensor(cond01 * 2.0 - 1.0, device=dev)
    n_train = len(train_deltas)

    t0 = time.perf_counter()
    losses = train_steps(trainer, cond_dev, targets_dev, train_T, steps, batch, seed,
                         log_every, draw_fn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_secs = time.perf_counter() - t0

    # ---- phase 3: sample held-out pose tokens with the EMA weights (the
    # reference samples EMA, LitEma)
    params_ema = ema_params(params, trainer)
    t0 = time.perf_counter()
    with stage.swapped_weights({k: params_ema[k] for k in trainer.modules}):
        samples = sample_held(stage)
    sample_secs = time.perf_counter() - t0

    # diagnostic: live (non-EMA) weights through the same path: "did not
    # learn" against "EMA lags"
    with stage.swapped_weights(trainer.state_dicts()):
        samples_live = sample_held(stage)

    if out_png is not None:
        from one2345_tpu_torch.utils.image import image_grid
        from one2345_tpu_torch.utils.png import write_png

        rows = np.concatenate([samples, held_gt01, samples_untrained])
        grid = image_grid(rows, rows=3, cols=len(held_deltas))
        write_png(out_png, (np.clip(grid, 0, 1) * 255).astype(np.uint8))

    # ---- scoring
    H = len(held_deltas)
    psnr_tr = [psnr01(samples[i], held_gt01[i]) for i in range(H)]
    psnr_un = [psnr01(samples_untrained[i], held_gt01[i]) for i in range(H)]
    psnr_lv = [psnr01(samples_live[i], held_gt01[i]) for i in range(H)]
    ssim_tr = [ssim01(samples[i], held_gt01[i]) for i in range(H)]

    # cross-pose discrimination: sample(d_i) must be closest to GT(d_i)
    cross = np.array([[psnr01(samples[i], held_gt01[j]) for j in range(H)]
                      for i in range(H)])
    pose_hits = int(np.sum(np.argmax(cross, axis=1) == np.arange(H)))
    off_diag = (cross.sum(axis=1) - np.diag(cross)) / (H - 1)
    pose_margin = float(np.mean(np.diag(cross) - off_diag))

    out = {
        "steps": steps, "res": res, "batch": batch, "n_train": n_train,
        "n_heldout": H, "sample_steps": sample_steps, "sampler": sampler,
        "cfg_scale": cfg_scale,
        "vae_steps": vae_steps, "vae_psnr": round(vae_psnr, 2),
        "latent_std": round(z_std, 3), "scale_factor": round(scale, 3),
        "eps_mse_first": round(losses[0], 4),
        "eps_mse_last": round(losses[-1], 4),
        "psnr_heldout": round(float(np.mean(psnr_tr)), 2),
        "psnr_heldout_min": round(float(np.min(psnr_tr)), 2),
        "psnr_heldout_untrained": round(float(np.mean(psnr_un)), 2),
        "psnr_heldout_live": round(float(np.mean(psnr_lv)), 2),
        "ssim_heldout": round(float(np.mean(ssim_tr)), 4),
        "pose_hits": pose_hits,
        "pose_margin_db": round(pose_margin, 2),
        "vae_secs": round(vae_secs, 1),
        "train_secs": round(train_secs, 1),
        "sec_per_step": round(train_secs / steps, 4),
        "sample_secs": round(sample_secs, 1),
        "total_secs": round(time.perf_counter() - t_all, 1),
    }

    # ---- optional fast-mode quality A/B: the SAME trained EMA weights
    # sampled through each opt-in serving variant (sampler / steps / int8),
    # scored on the identical held-out protocol
    if eval_variants:
        out["variants"] = {}
        for v in eval_variants:
            cfg_v = cfg
            if v.get("quant"):
                cfg_v = cfg.replace(unet=cfg.unet.replace(quant=v["quant"]))
            st_v = Zero123Stage(cfg_v, params=params_ema, device=dev)
            t0 = time.perf_counter()
            s_v = sample_held(st_v, steps_=v.get("sample_steps"), sampler_=v.get("sampler"))
            secs_v = time.perf_counter() - t0
            psnr_v = [psnr01(s_v[i], held_gt01[i]) for i in range(H)]
            cross_v = np.array([[psnr01(s_v[i], held_gt01[j]) for j in range(H)]
                                for i in range(H)])
            off_v = (cross_v.sum(axis=1) - np.diag(cross_v)) / (H - 1)
            res_v = {
                "sampler": v.get("sampler") or sampler,
                "sample_steps": v.get("sample_steps") or sample_steps,
                "quant": v.get("quant", "none"),
                "psnr_heldout": round(float(np.mean(psnr_v)), 2),
                "psnr_heldout_min": round(float(np.min(psnr_v)), 2),
                "ssim_heldout": round(float(np.mean(
                    [ssim01(s_v[i], held_gt01[i]) for i in range(H)])), 4),
                "pose_hits": int(np.sum(np.argmax(cross_v, axis=1) == np.arange(H))),
                "pose_margin_db": round(float(np.mean(np.diag(cross_v) - off_v)), 2),
                "sample_secs": round(secs_v, 1),
            }
            out["variants"][v["label"]] = res_v
            print(json.dumps({v["label"]: res_v}), flush=True)
    return out


def fast_variants(sample_steps: int) -> tuple:
    """The shipped fast stack (cli --sampler dpmpp --quant int8, a ~2.5x
    step cut like 77/50 -> 30/25 at production scale)."""
    fast_steps = max(sample_steps * 2 // 5, 4)
    return (
        {"label": "dpmpp_same_steps", "sampler": "dpmpp"},
        {"label": "dpmpp_fast", "sampler": "dpmpp", "sample_steps": fast_steps},
        {"label": "int8", "quant": "int8"},
        {"label": "int8_dpmpp_fast", "sampler": "dpmpp", "sample_steps": fast_steps,
         "quant": "int8"},
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--vae-steps", type=int, default=3000)
    p.add_argument("--sample-steps", type=int, default=25)
    p.add_argument("--sampler", default="ddim", choices=("ddim", "plms", "dpmpp"))
    p.add_argument("--json", default=None)
    p.add_argument("--png", default=None, help="save samples/GT/untrained grid")
    p.add_argument("--fast-variants", action="store_true",
                   help="also score the opt-in fast serving stack (dpmpp / reduced "
                        "steps / int8) on the same held-out protocol")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    out = run_benchmark(steps=args.steps, res=args.res, batch=args.batch,
                        vae_steps=args.vae_steps, sample_steps=args.sample_steps,
                        sampler=args.sampler, out_png=args.png,
                        eval_variants=fast_variants(args.sample_steps) if args.fast_variants
                        else (), device=args.device)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
