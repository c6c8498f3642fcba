"""Image -> mesh requests in a closed loop: one client sends its next raw
image when the previous mesh is done.

Traffic parameters (``portbench/traffic/<mix>.json``): ``sampler`` and
``steps`` (the request mode, as the CLI's ``--sampler`` / ``--steps``
set it), optionally ``quant`` (as the CLI's ``--quant``; without it the
configuration's ``unet.quant`` holds), ``use_sam``, ``evals`` (UNet evals
per mesh by UNet batch: fixed by the sampler and steps, and the work the
MFU counts), ``warmup_steps`` (the sampler steps of the set-up's one
request: the step count changes no shape), ``checked_requests`` (how many
of the window's meshes the reference checks, drawn from the seed),
``checked_evals`` (UNet evals kept per batch and mesh).

The window is ``One2345Pipeline.run(image, skip_preprocess=False,
seed=...)`` with no ``out_dir``, request after request, each a new raw
512^2 image, until ``--seconds`` have passed; it holds whole requests and
ends with a device sync.  With ``--trace 1`` one more request runs under
``torch.profiler`` after that.

While the window runs, hooks keep for each request what the reference
later recomputes from the same inputs (``Captures``): UNet evals at each
UNet batch and, under DDIM, one guided sampler step at each (drawn from
the seed), the conditioning of the largest sampler call, the VAE decode
of the largest batch, and the reconstruction stage's field with the 32
stage-2 images it came from.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from portbench import harness, images, weights, yardstick
from portbench.reference import nets, precision, recon as ref_recon, sampler as ref_sampler


IMAGES_AHEAD = 16  # raw images drawn in set-up; later requests draw theirs in the window
WARMUP = 2**31  # the request index of the set-up's one request


def as_tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def pipeline_config(conf: dict, traffic: dict):
    """The ``PipelineConfig`` of a configuration file's ``pipeline`` entry
    with the traffic's request mode: its ``sampler`` and ``steps``, and
    its ``quant`` where it gives one (as the CLI's ``--quant``; else the
    configuration's ``unet.quant``)."""
    from one2345_tpu_torch.core import config as C

    p = conf["pipeline"]
    d = dict(p["diffusion"])
    unet = dict(d.pop("unet"))
    unet["quant"] = traffic.get("quant", unet.get("quant", "none"))
    unet = C.UNetConfig(**as_tuples(unet))
    diffusion = C.DiffusionConfig(
        **{**as_tuples(d), "unet": unet, "vae": C.VAEConfig(**as_tuples(d.pop("vae"))),
           "clip": C.CLIPVisionConfig(**as_tuples(d.pop("clip")))})
    s1, s2 = traffic["steps"]
    diffusion = diffusion.replace(sampler=traffic["sampler"], ddim_steps_stage1=s1,
                                  ddim_steps_stage2=s2)
    rest = {k: v for k, v in p.items() if k not in ("diffusion", "recon", "sam", "elevation")}
    return C.PipelineConfig(
        diffusion=diffusion, recon=C.ReconConfig(**as_tuples(p["recon"])),
        sam=C.SamConfig(**as_tuples(p["sam"])), elevation=C.ElevationConfig(**p["elevation"]),
        **rest)


def zero123_params(diffusion: dict, seed: int, device) -> dict:
    """Seeded f32 state dicts of the diffusion stage's modules, keyed as
    ``Zero123Stage`` takes them; the shapes are the reference modules'
    (the same names and order as the program's)."""
    return {name: weights.seeded_state_dict(weights.shapes_of(nets.build(name, diffusion)),
                                            seed, "zero123." + name, device)
            for name in ("unet", "encoder", "decoder", "clip", "cc_projection")}


def recon_params(recon: dict, seed: int, device, extra: dict | None = None) -> dict:
    """Seeded state dicts of the reconstruction modules: ``fusion`` and
    ``sdf`` from the reference modules' shapes (the SDF MLP with its
    geometric init), and the ``extra`` {name: shapes} modules."""
    mods = ref_recon.build(recon)
    out = {name: weights.seeded_state_dict(weights.shapes_of(m), seed, "recon." + name, device)
           for name, m in mods.items()}
    shapes = weights.shapes_of(mods["sdf"])
    out["sdf"].update(weights.sdf_mlp_state(shapes, seed, "recon.sdf", device,
                                            d_latent=recon["regnet_d_out"]))
    for name, s in (extra or {}).items():
        out[name] = weights.seeded_state_dict(s, seed, "recon." + name, device)
    return out


def request_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(i), 7]).generate_state(1)[0])


class Captures:
    """Per-request records of what the reference recomputes (see the
    module docstring), kept by forward hooks on the program's UNet and VAE
    decoder and by wrappers of ``Zero123Stage.encode_conditioning``,
    ``Zero123Stage.per_view_noise`` and ``ReconStage.field_grid``: these
    are the yardstick's ties to the program's internals.

    For each UNet batch ``B`` a request keeps ``per_batch`` of its
    ``evals[B]`` evals, drawn from (seed, request), and, with ``step``, one
    DDIM step: an eval's x_t, timestep and output (one drawn among the
    first ``evals[B] - 1``), the noise its step draws, and x_{t-1} and the
    timestep of the eval that follows (where the drawn eval ends its
    sampler call, the next eval at ``B`` takes its place).  ``begin(i)``
    starts request i."""

    def __init__(self, pipe, seed: int, evals: dict, per_batch: int, step: bool, zc: int):
        self.pipe, self.seed, self.step, self.zc = pipe, seed, step, zc
        self.evals = {int(b): int(n) for b, n in evals.items()}
        self.per_batch = per_batch
        self.records, self.cur = [], None
        self.picks, self.arm, self.count, self.state = {}, {}, {}, {}
        z = pipe.zero123
        self._handles = [z.unet.register_forward_hook(self._unet),
                         z.decoder.register_forward_hook(self._decoder)]
        self._encode, self._noise = z.encode_conditioning, z.per_view_noise
        self._field = pipe.recon.field_grid
        z.encode_conditioning = self._encode_wrap
        z.per_view_noise = self._noise_wrap
        pipe.recon.field_grid = self._field_wrap

    def begin(self, i: int):
        self.cur = {"request": i, "unet": {b: [] for b in self.evals}, "step": {}}
        rng = np.random.default_rng(request_seed(self.seed, i))
        self.picks = {b: set(rng.choice(n, size=min(self.per_batch, n), replace=False).tolist())
                      for b, n in self.evals.items()}
        self.arm = {b: int(rng.integers(n - 1)) if n > 1 else -1 for b, n in self.evals.items()}
        self.count = {b: 0 for b in self.evals}
        self.state = {b: "idle" for b in self.evals}
        self.records.append(self.cur)

    def remove(self):
        for h in self._handles:
            h.remove()
        z = self.pipe.zero123
        z.encode_conditioning, z.per_view_noise = self._encode, self._noise
        self.pipe.recon.field_grid = self._field

    def _unet(self, module, args, output):
        B = int(args[0].shape[0])
        if self.cur is None or B not in self.count:
            return
        n = self.count[B]
        self.count[B] = n + 1
        x, t, ctx = args
        if n in self.picks[B]:
            self.cur["unet"][B].append(tuple(v.detach().clone() for v in (x, t, ctx, output)))
        if not self.step:
            return
        h, st = B // 2, self.state[B]
        if st == "next":
            rec = self.cur["step"][B]
            rec["x_next"] = x[:h, ..., :self.zc].detach().clone()
            rec["t_next"] = t[:1].detach().clone()
            self.state[B] = "done"
        elif st == "rearm" or (st == "idle" and n == self.arm[B]):
            self.cur["step"][B] = {"x": x[:h, ..., :self.zc].detach().clone(),
                                   "t": t[:1].detach().clone(), "eps": output.detach().clone()}
            self.state[B] = "noise"

    def _noise_wrap(self, seed, draw, view_ids, shape):
        z = self._noise(seed, draw, view_ids, shape)
        B = 2 * len(view_ids)
        st = self.state.get(B) if self.cur is not None else None
        if st == "noise":
            self.cur["step"][B]["z"] = z.detach().clone()
            self.state[B] = "next"
        elif st == "next":  # the kept eval ended its sampler call
            self.state[B] = "rearm"
        return z

    def _decoder(self, module, args, output):
        if self.cur is None:
            return
        for b, st in self.state.items():
            if st == "next":  # the kept eval ended its sampler call
                self.state[b] = "rearm"
        prev = self.cur.get("decode")
        if prev is None or args[0].shape[0] >= prev[0].shape[0]:
            self.cur["decode"] = (args[0].detach().clone(), output.detach().clone())

    def _encode_wrap(self, cond, T):
        ctx, concat = self._encode(cond, T)
        prev = self.cur.get("cond") if self.cur is not None else None
        if self.cur is not None and (prev is None or cond.shape[0] >= prev[0].shape[0]):
            self.cur["cond"] = (cond.detach().clone(), T.detach().clone(),
                                ctx.detach().clone(), concat.detach().clone())
        return ctx, concat

    def _field_wrap(self, volume, resolution, lod=0):
        u = self._field(volume, resolution, lod)
        if self.cur is not None:
            self.cur["field"] = u
        return u


class Driver:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.conf, self.traffic = ctx.cell.config, ctx.cell.traffic
        if int(self.traffic["clients"]) != 1:
            raise ValueError("closed_loop_mesh drives one client")
        self.cfg = pipeline_config(self.conf, self.traffic)
        self.pipe = None
        self.results, self.items, self.captures = [], [], None
        self.k1 = 0

    # ------------------------------------------------------------- set-up
    def setup(self):
        from one2345_tpu_torch.elevation.loftr import LoFTRModules
        from one2345_tpu_torch.pipeline.runner import One2345Pipeline
        from one2345_tpu_torch.recon.pipeline import ReconStage
        from one2345_tpu_torch.segmentation.sam import SamStage

        seed, dev, p = self.ctx.seed, self.ctx.device, self.conf["pipeline"]
        t0 = time.perf_counter()
        meta_recon = ReconStage(self.cfg.recon, device="meta").modules()
        extra = {k: weights.shapes_of(m) for k, m in meta_recon.items() if k not in ("fusion", "sdf")}
        with torch.device("meta"):
            loftr = weights.shapes_of(LoFTRModules())
        params = {"zero123": zero123_params(p["diffusion"], seed, dev),
                  "recon": recon_params(p["recon"], seed, dev, extra),
                  "loftr": weights.seeded_state_dict(loftr, seed, "loftr", dev)}
        use_sam = bool(self.traffic["use_sam"])
        if use_sam:
            sam = weights.shapes_of(SamStage(self.cfg.sam, device="meta").modules)
            params["sam"] = weights.seeded_state_dict(sam, seed, "sam", dev)
        self._sync()
        harness.log(f"weights drawn in {time.perf_counter() - t0:.2f} s")
        self.pipe = pipe = One2345Pipeline(self.cfg, params=params, use_sam=use_sam, device=dev)
        _ = pipe.zero123, pipe.recon, pipe.elevation_estimator, pipe.safety
        if use_sam:
            _ = pipe.sam
        del params
        harness.log(f"pipeline built with seeded weights in {time.perf_counter() - t0:.2f} s")
        self.images = [images.raw_image(seed, i) for i in range(IMAGES_AHEAD)]
        # one request at the cell's shapes, with fewer sampler steps
        t0 = time.perf_counter()
        full = self.cfg
        w1, w2 = self.traffic["warmup_steps"]
        warm = full.replace(diffusion=full.diffusion.replace(ddim_steps_stage1=w1,
                                                             ddim_steps_stage2=w2))
        pipe.config, pipe.zero123.config = warm, warm.diffusion
        try:
            pipe.run(images.raw_image(seed, WARMUP), seed=request_seed(seed, WARMUP))
        finally:
            pipe.config, pipe.zero123.config = full, full.diffusion
        self._sync()
        harness.log(f"warm-up request ({w1}/{w2} steps) in {time.perf_counter() - t0:.2f} s")
        self.captures = Captures(pipe, seed, self.traffic["evals"],
                                 int(self.traffic["checked_evals"]),
                                 self.traffic["sampler"] == "ddim",
                                 int(p["diffusion"]["vae"]["z_channels"]))

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    # ------------------------------------------------------------- window
    def window(self, seconds: float) -> harness.Window:
        from one2345_tpu_torch.ops.flash_attention import flash_attention

        pipe, seed = self.pipe, self.ctx.seed
        prof = None
        k1_before = flash_attention.launch_count
        attempted = failed = 0
        self._sync()
        t0 = time.perf_counter()
        i = 0
        # a traced run profiles one more request once the window's time is
        # up: a profiler session slows the launches that follow it
        while i == 0 or time.perf_counter() - t0 < seconds or (self.ctx.trace and prof is None):
            if i >= len(self.images):
                self.images.append(images.raw_image(seed, i))
            profiled = self.ctx.trace and i > 0 and time.perf_counter() - t0 >= seconds
            if profiled:
                prof = harness.Profiler()
            attempted += 1
            self.captures.begin(i)
            t_req = time.perf_counter()
            with prof if profiled else contextlib.nullcontext():
                with torch.profiler.record_function("portbench.request"):
                    try:
                        res = pipe.run(self.images[i], skip_preprocess=False,
                                       seed=request_seed(seed, i))
                    except Exception as e:  # a request that raises counts as failed
                        harness.log(f"request {i} failed: {type(e).__name__}: {e}")
                        failed += 1
                        res = None
                    self._sync()
            dt = time.perf_counter() - t_req
            harness.log(f"request {i}: {dt:.3f} s" + ("" if res is None else ", " + ", ".join(
                f"{k} {v:.3f}" for k, v in res.timings.items())))
            if res is not None:
                self.results.append((i, res))
                self.items.append({"seconds": dt, "spans": dict(res.timings),
                                   "profiled": profiled, "flops": self.flops_per_mesh()})
            i += 1
        self._sync()
        window_s = time.perf_counter() - t0
        self.captures.cur = None
        self.k1 = flash_attention.launch_count - k1_before
        done = len(self.results)
        e2e = {"mesh_s": window_s / done} if done else {}
        harness.log(f"{done} meshes in {window_s:.3f} s" + (
            f": {window_s / done:.4f} s/mesh" if done else ""))
        trace = prof.trace() if prof is not None else None
        return harness.Window(attempted, failed, window_s, e2e,
                              {"items": self.items, "attention": self.attention_calls()},
                              trace)

    def flops_per_mesh(self) -> float:
        unet = self.conf["pipeline"]["diffusion"]["unet"]
        L = self.conf["pipeline"]["diffusion"]["latent_size"]
        return sum(int(n) * yardstick.unet_flops_per_eval(int(B), unet, L)
                   for B, n in self.traffic["evals"].items())

    def attention_calls(self) -> list:
        """(B, T, H, D, launches) of the UNet's self-attentions in one mesh."""
        unet = self.conf["pipeline"]["diffusion"]["unet"]
        L = self.conf["pipeline"]["diffusion"]["latent_size"]
        out = []
        for B, n in self.traffic["evals"].items():
            for T, H, D in yardstick.self_attention_shapes(unet, L):
                out.append((int(B), T, H, D, int(n)))
        return out

    def release(self):
        """Free the program: keep the captures (moved to the host) and the
        stage-2 images and elevation of each mesh."""
        self.captures.remove()
        records = {r["request"]: r for r in self.captures.records}
        kept = {}
        for i, res in self.results:
            rec = {k: _to_cpu(v) for k, v in records[i].items()}
            rec["images"] = res.stage2_images.detach().float().cpu()
            rec["polar"] = 90.0 - float(res.elevation)
            kept[i] = rec
        self.kept = kept
        self.results = []
        self.pipe = self.captures = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- verify
    def verify(self, judge=None) -> list:
        """The reference over a sample of the window's meshes (drawn from
        the seed).  ``judge(number, reference_fn, program_output)`` gives
        what is judged in the program's place (by default the program's
        output; ``calibrate.py`` puts the control there).  ``unet_b<B>``
        pools the kept evals at batch B of every sampled mesh
        (||program - reference|| / ||reference|| over all of them) and
        ``unet`` is the largest of these; the other numbers are the
        largest over the sample."""
        dev, seed = self.ctx.device, self.ctx.seed
        judge = judge or (lambda name, fn, program: program)
        limits = self.ctx.cell.limits
        done = sorted(self.kept)
        rng = np.random.default_rng([int(seed), 11])
        k = min(len(done), int(self.traffic["checked_requests"]))
        sample = sorted(rng.choice(done, size=k, replace=False).tolist()) if k else []
        values = {}
        evals = sum(int(n) for n in self.traffic["evals"].values())
        width = len(yardstick.self_attention_shapes(self.conf["pipeline"]["diffusion"]["unet"]))
        # K1 launches on the card; the CPU runs the plain attention, uncounted
        launches = width * evals * len(self.kept) if dev.type == "cuda" else 0
        values["k1_launches"] = float(abs(self.k1 - launches))
        if sample:
            ref = self._reference_modules()
            pooled = {}
            for i in sample:
                for name, (d2, r2, pool) in self._compare(ref, self.kept[i], judge):
                    if pool:
                        acc = pooled.setdefault(name, [0.0, 0.0])
                        acc[0] += d2
                        acc[1] += r2
                    else:
                        values[name] = max(values.get(name, 0.0),
                                           math.sqrt(d2 / max(r2, 1e-300)))
            for name, (d2, r2) in pooled.items():
                values[name] = math.sqrt(d2 / max(r2, 1e-300))
            # every UNet batch of the mix has to be compared
            batches = [values.get(f"unet_b{int(b)}", math.nan) for b in self.traffic["evals"]]
            values["unet"] = math.nan if any(math.isnan(v) for v in batches) else max(batches)
        self.values = dict(values)
        for name in limits["numbers"]:
            values.setdefault(name, float("nan"))  # nothing to compare fails the check
        return [harness.Check(n, values[n], float(limits["numbers"][n]))
                for n in limits["numbers"]]

    def _reference_modules(self) -> dict:
        dev, seed = self.ctx.device, self.ctx.seed
        p = self.conf["pipeline"]
        zp = zero123_params(p["diffusion"], seed, dev)
        mods = {}
        for name, sd in zp.items():
            m = nets.build(name, p["diffusion"], device=dev)
            m.load_state_dict(sd, strict=True)
            mods[name] = m.requires_grad_(False).eval()
        del zp
        rp = recon_params(p["recon"], seed, dev)
        rmods = ref_recon.build(p["recon"], device=dev)
        for name, m in rmods.items():
            m.load_state_dict(rp[name], strict=True)
            mods["recon." + name] = m.requires_grad_(False).eval()
        return mods

    @torch.no_grad()
    def _compare(self, ref: dict, rec: dict, judge):
        """(number, (||judged - reference||^2, ||reference||^2, pooled))
        for one mesh's record, against the f32 reference on the same
        inputs."""
        dev = self.ctx.device
        d = self.conf["pipeline"]["diffusion"]

        def both(name, fn, program):
            with precision.strict_f32():
                want = fn().to(torch.float64)
                got = judge(name, fn, program).to(dev, torch.float64)
            return (float(torch.linalg.vector_norm(got - want)) ** 2,
                    float(torch.linalg.vector_norm(want)) ** 2)

        for B, caps in sorted(rec["unet"].items()):
            for x, t, ctx, eps in caps:
                x, t, ctx, eps = (c.to(dev) for c in (x, t, ctx, eps))
                yield f"unet_b{B}", (*both(f"unet_b{B}", lambda: ref["unet"](x, t, ctx), eps),
                                     True)
        ac = ref_sampler.alphas_cumprod(d["timesteps"], d["linear_start"], d["linear_end"])
        for B, st in sorted(rec["step"].items()):
            if "x_next" not in st:
                continue
            x, eps, z, x_next = (st[k].to(dev) for k in ("x", "eps", "z", "x_next"))
            t, t_next = int(st["t"][0]), int(st["t_next"][0])
            eu, ec = eps.chunk(2)
            yield "ddim_step", (*both("ddim_step", lambda: ref_sampler.ddim_step(
                x, eu, ec, z, t, t_next, float(d["cfg_scale"]), float(d["ddim_eta"]), ac),
                x_next), False)
        if "cond" in rec:
            cond, T, ctx, concat = (c.to(dev) for c in rec["cond"])
            size = d["clip"]["image_size"]

            def ref_ctx():
                emb = ref["clip"](nets.preprocess_for_clip(cond, size))[:, None, :]
                return ref["cc_projection"](torch.cat([emb, T], dim=-1))

            def ref_concat():
                return ref["encoder"](cond).chunk(2, dim=-1)[0]

            a, b = both("conditioning", ref_ctx, ctx), both("conditioning", ref_concat, concat)
            yield "conditioning", (*max(a, b, key=lambda v: v[0] / max(v[1], 1e-300)), False)
        if "decode" in rec:
            z, img = (c.to(dev) for c in rec["decode"])
            yield "vae_decode", (*both("vae_decode", lambda: ref["decoder"](z), img), False)
        if "field" in rec:
            u = rec["field"].to(dev)
            imgs = rec["images"].to(dev).reshape(-1, *rec["images"].shape[2:])
            mods = {"fusion": ref["recon.fusion"], "sdf": ref["recon.sdf"]}
            hw = tuple(self.conf["pipeline"]["recon"]["image_hw"])
            yield "field", (*both("field", lambda: ref_recon.reference_field(
                mods, imgs, rec["polar"], u.shape[0], hw), u), False)


def _to_cpu(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, (tuple, list)):
        return type(v)(_to_cpu(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_cpu(x) for k, x in v.items()}
    return v
