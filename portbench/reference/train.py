"""Plain reference of the Zero123 finetune step: the eps-MSE of the UNet on
the VAE posterior's noised latent, conditioned on the CLIP token and the
pose through the CCProjection, with the 5 / 5 / 5 % conditioning dropout;
AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4; the CCProjection at
10x the learning rate) under the linear warm-up from 1e-6, then the EMA
with its decay warm-up min(decay, (1 + n) / (10 + n)).

The mathematics of ``one2345_tpu_torch/training/zero123_trainer.py``
(itself the reference's ddpm.py p_losses, get_input and LitEma), written
again over the float32 modules of ``reference.nets``: no autocast, no
remat, no flash-attention kernels; the batch runs in blocks of rows whose
gradients add up to the whole batch's mean.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import nets, precision

SCALE_FACTOR = 0.18215


def training_schedule(timesteps: int, linear_start: float, linear_end: float):
    """(sqrt(alphas_cumprod), sqrt(1 - alphas_cumprod)) of the 'linear'
    (sqrt-linear squared) beta schedule, float64 -> float32."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, timesteps, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    return (torch.as_tensor(np.sqrt(ac), dtype=torch.float32),
            torch.as_tensor(np.sqrt(1.0 - ac), dtype=torch.float32))


def warmup_factor(step: int, warmup_steps: int) -> float:
    return 1e-6 + (1.0 - 1e-6) * min(step / warmup_steps, 1.0)


def leaf_norms(named: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in named.items()}


SAMPLE_CAP = 4096  # elements kept per leaf for the comparisons of direction


def sample_indices(shapes: dict, seed: int, device) -> dict:
    """{leaf: flat indices}: every element of a leaf of at most
    ``SAMPLE_CAP`` elements, else ``SAMPLE_CAP`` drawn with replacement
    from (seed, leaf order)."""
    g = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([int(seed), 13]).generate_state(1, np.uint64)[0] >> 1))
    out = {}
    for k, shape in shapes.items():
        n = int(np.prod(shape, dtype=np.int64))
        out[k] = (torch.arange(n, device=device) if n <= SAMPLE_CAP
                  else torch.randint(0, n, (SAMPLE_CAP,), generator=g, device=device))
    return out


def take(named: dict, samples: dict) -> dict:
    """{leaf: float64 values at the leaf's sampled elements}."""
    return {k: v.detach().reshape(-1)[samples[k].to(v.device)].double() for k, v in named.items()}


def block_loss(mods, rows: dict, draws: dict, sched, clip_size: int, denom: float):
    """The summed squared error of a block of rows over ``denom``
    (differentiable in the UNet and the CCProjection)."""
    with torch.no_grad():
        B = rows["image_target"].shape[0]
        moments = mods["encoder"](torch.cat([rows["image_target"], rows["image_cond"]]))
        emb = mods["clip"](nets.preprocess_for_clip(rows["image_cond"], clip_size))[:, None, :]
        mean_t, logvar_t = moments[:B].chunk(2, dim=-1)
        z = (mean_t + torch.exp(0.5 * logvar_t.clamp(-30.0, 20.0)) * draws["z_eps"]) \
            * SCALE_FACTOR
        concat = moments[B:].chunk(2, dim=-1)[0]
    ctx = mods["cc_projection"](torch.cat([emb, rows["T"]], dim=-1))
    u = draws["u"]
    ctx = ctx.masked_fill((u < 0.10)[:, None, None], 0.0)
    concat = concat.masked_fill(((u >= 0.05) & (u < 0.15))[:, None, None, None], 0.0)
    t, noise = draws["t"], draws["noise"]
    sa, s1a = sched
    z_noisy = sa[t][:, None, None, None] * z + s1a[t][:, None, None, None] * noise
    eps = mods["unet"](torch.cat([z_noisy, concat], dim=-1), t, ctx)
    return ((eps - noise) ** 2).sum() / denom


def reference_steps(diffusion: dict, trainer: dict, state: dict, batches, device,
                    block: int = 32, samples: dict | None = None) -> dict:
    """Follow the program's first steps from the same weights and batches,
    in the precision mode of the caller's ``precision.use`` (f32 unless
    the control asks for fp8).

    :param state: f32 state dicts {'unet', 'encoder', 'clip', 'cc_projection'}
    :param batches: list of (batch, draws), one per step
    :param samples: {leaf: flat indices} (``sample_indices``)
    :return: {'loss': [per step], 'grad1': {leaf: ||g||} of the first step,
        'change': {leaf: ||p_n - p_0||}, 'ema': {leaf: ||ema_n - p_0||},
        and with ``samples`` 'grad1_s' and 'change_s': the first gradient
        and the change at the sampled elements}
    """
    mods = {}
    for name in ("unet", "encoder", "clip", "cc_projection"):
        m = nets.build(name, diffusion, device=device)
        m.load_state_dict(state[name], strict=True)
        mods[name] = m
    for name in ("encoder", "clip"):
        mods[name].requires_grad_(False).eval()
    named = {f"unet.{k}": p for k, p in mods["unet"].named_parameters()}
    named.update({f"cc_projection.{k}": p for k, p in mods["cc_projection"].named_parameters()})
    base_lr = trainer["base_lr"]
    opt = torch.optim.AdamW(
        [{"params": list(mods["unet"].parameters()), "lr": base_lr},
         {"params": list(mods["cc_projection"].parameters()),
          "lr": trainer["cc_lr_scale"] * base_lr}],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4, foreach=False)
    scales = [g["lr"] / base_lr for g in opt.param_groups]
    sched = tuple(x.to(device) for x in training_schedule(
        diffusion["timesteps"], diffusion["linear_start"], diffusion["linear_end"]))
    p0 = {k: p.detach().clone() for k, p in named.items()}
    ema = {k: p.detach().clone() for k, p in named.items()}
    L, zc = diffusion["latent_size"], diffusion["vae"]["z_channels"]
    out = {"loss": []}
    with precision.strict_f32():
        for step, (batch, draws) in enumerate(batches):
            B = batch["T"].shape[0]
            denom = float(B * L * L * zc)
            opt.zero_grad(set_to_none=False)
            total = 0.0
            for a in range(0, B, block):
                rows = {k: v[a:a + block] for k, v in batch.items()}
                d = {k: v[a:a + block] for k, v in draws.items()}
                loss = block_loss(mods, rows, d, sched, diffusion["clip"]["image_size"], denom)
                loss.backward()
                total += float(loss.detach().double())
            out["loss"].append(total)
            for p in named.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if step == 0:
                out["grad1"] = leaf_norms({k: p.grad for k, p in named.items()})
                if samples is not None:
                    out["grad1_s"] = take({k: p.grad for k, p in named.items()}, samples)
            f = warmup_factor(step, trainer["warmup_steps"])
            for g, s in zip(opt.param_groups, scales):
                g["lr"] = base_lr * s * f
            opt.step()
            n = step + 1
            decay = min(trainer["ema_decay"], (1.0 + n) / (10.0 + n))
            with torch.no_grad():
                for k, p in named.items():
                    ema[k].mul_(decay).add_(p.detach(), alpha=1.0 - decay)
    out["change"] = leaf_norms({k: named[k] - p0[k] for k in named})
    out["ema"] = leaf_norms({k: ema[k] - p0[k] for k in named})
    if samples is not None:
        out["change_s"] = take({k: named[k] - p0[k] for k in named}, samples)
    return out


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """{leaf: |program norm - reference norm|} over the leaves (those
    ``keep`` names, if given), each over the larger of its reference norm
    and the median leaf's."""
    keys = [k for k in reference if keep is None or k in keep]
    med = float(np.median([reference[k] for k in keys]))
    return {k: abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in keys}


def direction_gaps(program: dict, reference: dict, norms: dict, sizes: dict,
                   keep=None) -> dict:
    """{leaf: ||program - reference|| / max(leaf norm, median leaf norm)}
    from the vectors at the sampled elements (``take``), the difference
    scaled from the sample to the whole leaf; ``norms`` are the reference's
    whole-leaf norms."""
    keys = [k for k in reference if keep is None or k in keep]
    med = float(np.median([norms[k] for k in keys]))
    out = {}
    for k in keys:
        a, b = program[k].to(reference[k].device, torch.float64), reference[k]
        scale = math.sqrt(sizes[k] / b.numel())
        out[k] = scale * float(torch.linalg.vector_norm(a - b)) / max(norms[k], med, 1e-30)
    return out


def compare(program: dict, reference: dict) -> tuple:
    """The train cell's numbers and, for each worst-leaf number, its leaf:
    'loss' (the largest relative gap of a step's loss), 'grad1' (the worst
    leaf's first gradient), 'change' and 'ema' (the worst leaf's change
    after the steps, over the leaves whose reference gradient is at least
    a thousandth of the median leaf's), all by the gap of the norms; and
    where both sides carry sampled vectors, 'grad1_dir' and 'change_dir':
    the worst leaf by the norm of the difference (``direction_gaps``, over
    the same leaves), which sees a change of direction that leaves a norm
    as it was."""
    g = reference["grad1"]
    med = float(np.median(list(g.values())))
    moving = {k for k, v in g.items() if v >= 1e-3 * med}
    gaps = {"grad1": leaf_gaps(program["grad1"], g),
            "change": leaf_gaps(program["change"], reference["change"], moving),
            "ema": leaf_gaps(program["ema"], reference["ema"], moving)}
    if "grad1_s" in program and "grad1_s" in reference:
        sizes = program["sizes"]
        gaps["grad1_dir"] = direction_gaps(program["grad1_s"], reference["grad1_s"], g, sizes)
        gaps["change_dir"] = direction_gaps(program["change_s"], reference["change_s"],
                                            reference["change"], sizes, moving)
    numbers = {k: max(v.values()) for k, v in gaps.items()}
    numbers["loss"] = max(abs(a - b) / abs(b) for a, b in zip(program["loss"], reference["loss"]))
    worst = {k: max(v, key=v.get) for k, v in gaps.items()}
    return numbers, worst
