"""Zero123 finetune steps back to back: ``Zero123Trainer.train_step`` on a
fresh seeded batch each step, drawn on the card.

Traffic parameters (``portbench/traffic/<mix>.json``): ``batch``,
``image_size``, ``checked_steps`` (the set-up's steps that the reference
follows), ``profiled_steps`` (the steps ``--trace 1`` runs under
``torch.profiler`` after the window).

A batch is what an Objaverse view-pair reader hands the trainer:
``image_target`` and ``image_cond`` [B, S, S, 3] in [-1, 1] (a shaded,
textured ellipse on white, each row its own), the pose token ``T`` [B, 1,
4] of a random pair of views on the render sphere (polar difference, sine
and cosine of the azimuth difference, radius difference), and the step's
draws (timesteps, noises, the dropout uniforms), all from (seed, step).

Set-up builds the stage and the trainer, then runs ``checked_steps``
steps through ``train_step``; it keeps each step's loss, the first
gradient's norm per leaf (read back from AdamW's first moment after one
step), and the change per leaf of the parameters and of the EMA after the
last of them; and the first gradient and the change of the parameters at
the elements ``reference/train.py``'s ``sample_indices`` draws from the
seed.  The window then goes on with the same trainer.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import harness, weights, yardstick
from portbench.drivers.closed_loop_mesh import as_tuples, zero123_params
from portbench.reference import train as ref_train

BETA1 = 0.9


def diffusion_config(d: dict):
    from one2345_tpu_torch.core import config as C

    d = dict(d)
    parts = {"unet": C.UNetConfig(**as_tuples(d.pop("unet"))),
             "vae": C.VAEConfig(**as_tuples(d.pop("vae"))),
             "clip": C.CLIPVisionConfig(**as_tuples(d.pop("clip")))}
    return C.DiffusionConfig(**as_tuples(d), **parts)


def make_batch(seed: int, step: int, B: int, size: int, latent: int, z: int, timesteps: int,
               device) -> tuple:
    """(batch, draws) of one step, from (seed, step), on ``device``."""
    g = torch.Generator(device=device).manual_seed(weights.module_seed(seed, f"batch.{step}"))

    def U(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    n = 2 * B
    lin = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) / size
    yy, xx = lin[:, None], lin[None, :]
    c = U((n, 2, 1, 1), 0.35, 0.65)
    a = U((n, 2, 1, 1), 0.15, 0.3)
    th = U((n, 1, 1), 0.0, math.pi)
    dy, dx = yy - c[:, 0], xx - c[:, 1]
    u = (dx * torch.cos(th) + dy * torch.sin(th)) / a[:, 1]
    v = (-dx * torch.sin(th) + dy * torch.cos(th)) / a[:, 0]
    inside = (u * u + v * v < 1.0)[..., None]
    base = U((n, 1, 1, 3), -0.7, 0.6)
    grad = U((n, 2, 1, 1, 3), -0.45, 0.45)
    tex = base + u[..., None] * grad[:, 0] + v[..., None] * grad[:, 1]
    tex = tex + 0.1 * torch.randn((n, size, size, 3), generator=g, device=device)
    imgs = torch.where(inside, tex.clamp(-1.0, 0.96), torch.ones_like(tex))
    polar = U((2, B), 0.2, math.pi - 0.2)
    azim = U((2, B), 0.0, 2.0 * math.pi)
    radius = U((2, B), 1.5, 2.2)
    dphi = azim[0] - azim[1]
    T = torch.stack([polar[0] - polar[1], torch.sin(dphi), torch.cos(dphi),
                     radius[0] - radius[1]], dim=-1)[:, None, :]
    batch = {"image_target": imgs[:B], "image_cond": imgs[B:], "T": T}
    draws = {"t": torch.randint(0, timesteps, (B,), generator=g, device=device),
             "noise": torch.randn((B, latent, latent, z), generator=g, device=device),
             "z_eps": torch.randn((B, latent, latent, z), generator=g, device=device),
             "u": U((B,))}
    return batch, draws


class Driver:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.conf, self.traffic = ctx.cell.config, ctx.cell.traffic
        self.trainer = None
        self.items, self.program = [], {}
        self.launches = {}
        self.worst_leaves = {}

    def batch(self, step: int):
        d, t = self.conf["diffusion"], self.traffic
        return make_batch(self.ctx.seed, step, t["batch"], t["image_size"], d["latent_size"],
                          d["vae"]["z_channels"], d["timesteps"], self.ctx.device)

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def named(self) -> dict:
        return {f"{m}.{k}": p for m, mod in self.trainer.modules.items()
                for k, p in mod.named_parameters()}

    def setup(self):
        from one2345_tpu_torch.diffusion.zero123 import Zero123Stage
        from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

        seed, dev, tr = self.ctx.seed, self.ctx.device, self.conf["trainer"]
        t0 = time.perf_counter()
        params = zero123_params(self.conf["diffusion"], seed, dev)
        self._sync()
        harness.log(f"weights drawn in {time.perf_counter() - t0:.2f} s")
        stage = Zero123Stage(diffusion_config(self.conf["diffusion"]), params=params, device=dev)
        w0 = {"unet": params["unet"], "cc_projection": params["cc_projection"]}
        self.trainer = Zero123Trainer(stage, w0, ema_decay=tr["ema_decay"],
                                      base_lr=tr["base_lr"], remat=tr["remat"], device=dev)
        del params
        harness.log(f"trainer built with seeded weights in {time.perf_counter() - t0:.2f} s")
        p0 = {f"{m}.{k}": w for m, sd in w0.items() for k, w in sd.items()}
        named = self.named()
        opt = self.trainer.optimizer
        self.samples = ref_train.sample_indices({k: p.shape for k, p in named.items()}, seed, dev)
        p0_s = ref_train.take(p0, self.samples)
        self.program["sizes"] = {k: p.numel() for k, p in named.items()}
        losses = []
        for step in range(int(self.traffic["checked_steps"])):
            t0 = time.perf_counter()
            losses.append(self.trainer.train_step(*self.batch(step)))
            if step == 0:
                # AdamW's first moment after one step is (1 - beta1) g
                # (none where the step made no update: a zero gradient)
                g1 = {k: opt.state[p]["exp_avg"] / (1.0 - BETA1) if opt.state.get(p)
                      else torch.zeros_like(p) for k, p in named.items()}
                self.program["grad1"] = ref_train.leaf_norms(g1)
                self.program["grad1_s"] = _cpu(ref_train.take(g1, self.samples))
                del g1
            self._sync()
            harness.log(f"set-up step {step}: {time.perf_counter() - t0:.3f} s")
        self.program["loss"] = [float(x.double()) for x in losses]
        ema = {f"{m}.{k}": v for m, d in self.trainer.ema.items() for k, v in d.items()}
        self.program["change"] = ref_train.leaf_norms({k: p - p0[k] for k, p in named.items()})
        self.program["ema"] = ref_train.leaf_norms({k: ema[k] - p0[k] for k in named})
        now = ref_train.take(named, self.samples)
        self.program["change_s"] = _cpu({k: now[k] - p0_s[k] for k in named})
        self.samples = _cpu(self.samples)
        del w0, p0

    def window(self, seconds: float) -> harness.Window:
        from one2345_tpu_torch.ops.flash_attention import flash_attention as fa

        before = (fa.launch_count, fa.dq_launch_count, fa.dkv_launch_count)
        step0 = int(self.traffic["checked_steps"])
        flops = 3.0 * yardstick.unet_flops_per_eval(
            self.traffic["batch"], self.conf["diffusion"]["unet"],
            self.conf["diffusion"]["latent_size"])
        prof = None
        n = 0
        self._sync()
        t0 = time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            self.trainer.train_step(*self.batch(step0 + n))
            n += 1
        self._sync()
        t2 = time.perf_counter()
        done = n
        self.items.append({"seconds": t2 - t0, "steps": done, "flops": done * flops,
                           "profiled": False})
        if self.ctx.trace:
            # after the window: a profiler session slows the launches that follow it
            k = int(self.traffic["profiled_steps"])
            prof = harness.Profiler()
            with prof:
                for _ in range(k):
                    self.trainer.train_step(*self.batch(step0 + n))
                    n += 1
            self.items.append({"seconds": time.perf_counter() - t2, "steps": k,
                               "flops": k * flops, "profiled": True})
        window_s = t2 - t0
        after = (fa.launch_count, fa.dq_launch_count, fa.dkv_launch_count)
        self.launches = {"steps": n, "k1": after[0] - before[0], "dq": after[1] - before[1],
                         "dkv": after[2] - before[2]}
        harness.log(f"{done} steps in {window_s:.3f} s: {window_s / done:.4f} s/step; "
                    f"launches {self.launches}")
        unet = self.conf["diffusion"]["unet"]
        L = self.conf["diffusion"]["latent_size"]
        attn = [(self.traffic["batch"], T, H, D, int(self.traffic["profiled_steps"]))
                for T, H, D in yardstick.self_attention_shapes(unet, L)]
        return harness.Window(n, 0, window_s, {"train_step_s": window_s / done},
                              {"items": self.items, "attention_backward": attn},
                              prof.trace() if prof is not None else None)

    def release(self):
        self.trainer = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def verify(self, judge=None) -> list:
        """The reference follows the set-up's checked steps from the same
        weights and batches.  ``judge(number, reference_fn, program)``
        gives the readings judged in the program's place (by default the
        program's; ``calibrate.py`` puts the control there)."""
        limits = self.ctx.cell.limits["numbers"]
        dev, seed = self.ctx.device, self.ctx.seed
        n = int(self.traffic["checked_steps"])
        batches = [self.batch(s) for s in range(n)]
        state = zero123_params(self.conf["diffusion"], seed, dev)

        def steps():
            return ref_train.reference_steps(self.conf["diffusion"], self.conf["trainer"], state,
                                             batches, dev, int(self.traffic["reference_block"]),
                                             self.samples)

        t0 = time.perf_counter()
        ref = steps()
        harness.log(f"reference: {n} steps in {time.perf_counter() - t0:.2f} s")
        program = (judge or (lambda name, fn, program: program))("steps", steps, self.program)
        program = dict(program, sizes=self.program["sizes"])
        values, self.worst_leaves = ref_train.compare(program, ref)
        width = len(yardstick.self_attention_shapes(self.conf["diffusion"]["unet"]))
        s = self.launches.get("steps", 0)
        # the train step's self-attentions: a forward in the step and one
        # more under remat, one dq and one dkv backward each
        fwd = 2 if self.conf["trainer"]["remat"] else 1
        if dev.type != "cuda":  # the CPU runs the plain attention, uncounted
            fwd = width = 0
        values["kernel_launches"] = float(
            abs(self.launches.get("k1", -1) - fwd * width * s)
            + abs(self.launches.get("dq", -1) - width * s)
            + abs(self.launches.get("dkv", -1) - width * s))
        self.values = dict(values)
        return [harness.Check(k, float(values.get(k, float("nan"))), float(v))
                for k, v in limits.items()]


def _cpu(d: dict) -> dict:
    return {k: v.cpu() for k, v in d.items()}
