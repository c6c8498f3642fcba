"""Zero123 view-conditioned sampling — the multi-view stage of image -> mesh.

Counterpart of ``one2345_tpu/diffusion/zero123.py``:

- conditioning: CLIP image token ++ (radians dx, sin dy, cos dy, 0) pose
  token -> CCProjection Linear(772 -> 768); the concat conditioning is the
  VAE ``.mode()`` latent of the conditioning image, unscaled;
- classifier-free guidance runs uncond-first in one double batch, with
  ZERO unconditional context and concat latent;
- all views of a stage sample in one batch (stage 2: 4 nearby views per
  stage-1 view, 28 views for the 7 views after view 0);
- samplers (``DiffusionConfig.sampler`` or ``sample_views(sampler=)``):
  'ddim' over the trimmed schedule at the config's eta, as the original
  ``DDIMSampler.sample``; 'plms' and 'dpmpp' over the untrimmed eta=0
  schedule (S entries: S + 1 and S UNet evals), from noise draw 0 only;
- ``UNetConfig.quant="int8"``: the UNet is built in f32, loaded (or
  seeded), and replaced by the int8 UNet of its quantized state
  (``diffusion/quantize.py``); an already quantized state loads as it is.

Noise: every view's noise comes from its own ``torch.Generator`` on the
stage's device, seeded from (seed, view id, draw index), so a view's noise
does not depend on its batch position.  View ids are the JAX package's:
stage 1 uses the global candidate index, stage 2 ``12 + 4 * parent + j``.
``noise_fn(draw, view_ids, shape)`` replaces the generator (the tests feed
the JAX noise through it).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from one2345_tpu_torch.core.config import DiffusionConfig, UNetConfig
from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.diffusion.clip import CLIPVisionTower, preprocess_for_clip
from one2345_tpu_torch.diffusion.ddim import ddim_sample, trim_for_sample
from one2345_tpu_torch.diffusion.dpm_solver import dpmpp_sample
from one2345_tpu_torch.diffusion.plms import plms_sample
from one2345_tpu_torch.diffusion.quantize import is_quantized, quantize_unet_state
from one2345_tpu_torch.diffusion.schedule import DDIMSchedule, make_ddim_schedule
from one2345_tpu_torch.diffusion.unet import UNetModel, cast_compute
from one2345_tpu_torch.diffusion.vae import Decoder, Encoder, moments_mode
from one2345_tpu_torch.nn.init import flax_init_

# stage-1 view deltas: 12 candidate views, of which [0:8] are used for low
# elevation and [0:4]+[8:12] for high
STAGE1_DELTA_X = [0.0] * 4 + [30.0] * 4 + [-30.0] * 4
STAGE1_DELTA_Y = [0.0 + 90 * (i % 4) if i < 4 else 30.0 + 90 * (i % 4) for i in range(8)] + [
    30.0 + 90 * (i % 4) for i in range(4)
]
# stage-2 nearby-view deltas
STAGE2_DELTA_X = [-10.0, 10.0, 0.0, 0.0]
STAGE2_DELTA_Y = [0.0, 0.0, -10.0, 10.0]
# the stage's modules: the keys of ``params``
MODULES = ("unet", "encoder", "decoder", "clip", "cc_projection")
SAMPLERS = ("ddim", "plms", "dpmpp")
QUANT_MODES = ("none", "int8")


def pose_tokens(delta_x_deg, delta_y_deg) -> np.ndarray:
    """[B, 1, 4] (radians dx, sin radians dy, cos radians dy, 0)."""
    dx = np.radians(np.asarray(delta_x_deg, np.float64))
    dy = np.radians(np.asarray(delta_y_deg, np.float64))
    T = np.stack([dx, np.sin(dy), np.cos(dy), np.zeros_like(dx)], axis=-1)
    return T[:, None, :].astype(np.float32)


class CCProjection(nn.Module):
    """Linear(772 -> 768) as ``x @ kernel + bias``, identity+zeros init."""

    def __init__(self, in_dim: int = 772, out_dim: int = 768):
        super().__init__()
        kernel = torch.zeros(in_dim, out_dim)
        kernel[:out_dim] = torch.eye(out_dim)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return x @ self.kernel + self.bias


def make_unet(u: UNetConfig, remat: bool = False, quant: bool = False) -> UNetModel:
    """The UNet of a config (f32 unless ``quant``: the int8 UNet), built
    on the current default device."""
    return UNetModel(
        in_channels=u.in_channels,
        out_channels=u.out_channels,
        model_channels=u.model_channels,
        num_res_blocks=u.num_res_blocks,
        attention_resolutions=tuple(u.attention_resolutions),
        channel_mult=tuple(u.channel_mult),
        num_heads=u.num_heads,
        transformer_depth=u.transformer_depth,
        context_dim=u.context_dim,
        remat=remat,
        quant=quant,
    )


def noise_seed(seed: int, view_id: int, draw: int) -> int:
    """64-bit generator seed for one (seed, view id, draw index)."""
    state = np.random.SeedSequence([seed, view_id, draw]).generate_state(2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


class Zero123Stage:
    """The UNet / VAE / CLIP / CCProjection modules and the samplers.

    :param params: state dicts keyed 'unet', 'encoder', 'decoder', 'clip',
        'cc_projection' (``utils.convert_jax.zero123_from_jax`` makes them
        from the JAX parameter tree), loaded with ``strict=True``; None ->
        modules initialised from ``seed`` with flax's initialisers
        (``nn.init.flax_init_``: zero-initialised outputs, identity
        CCProjection), as the JAX stage.  With ``quant="int8"`` the 'unet'
        state is f32 or already quantized.
    :param device: None -> 'cuda' (raises without CUDA)
    """

    def __init__(self, config: DiffusionConfig | None = None, params=None, seed: int = 0,
                 device=None):
        self.config = cfg = config or DiffusionConfig()
        self.device = resolve_device(device)
        if cfg.unet.quant not in QUANT_MODES:
            # a typo ('INT8', 'w8a8') must not run the bf16 path
            raise ValueError(f"UNetConfig.quant must be 'none' or 'int8', got {cfg.unet.quant!r}")
        self.quant = cfg.unet.quant == "int8"
        self.dtype = torch.bfloat16 if cfg.unet.dtype == "bfloat16" else torch.float32
        self.scale_factor = cfg.vae.scale_factor
        # modules are built on their device, from their own seed, leaving
        # the global generators as they were
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda), self.device:
            torch.manual_seed(seed)
            self.unet = make_unet(cfg.unet)
            vae = dict(
                base_channels=cfg.vae.base_channels,
                channel_mult=tuple(cfg.vae.channel_mult),
                num_res_blocks=cfg.vae.num_res_blocks,
                z_channels=cfg.vae.z_channels,
            )
            self.encoder = Encoder(in_channels=cfg.vae.in_channels, **vae)
            self.decoder = Decoder(out_channels=cfg.vae.out_channels, **vae)
            self.clip = CLIPVisionTower(
                image_size=cfg.clip.image_size,
                patch_size=cfg.clip.patch_size,
                width=cfg.clip.width,
                layers=cfg.clip.layers,
                heads=cfg.clip.heads,
                embed_dim=cfg.clip.embed_dim,
            )
            self.cc_projection = CCProjection(cfg.clip.embed_dim + 4, cfg.unet.context_dim)
        if params is None and self.device.type != "meta":
            # flax's initialisers, as the JAX stage built from a seed
            gen = torch.Generator(device=self.device).manual_seed(seed)
            for name in MODULES:
                flax_init_(getattr(self, name), gen)
        if self.quant:
            self.unet = self._int8_unet(params["unet"] if params is not None else None)
        for name in MODULES:
            module = getattr(self, name)
            if params is not None and not (name == "unet" and self.quant):
                module.load_state_dict(params[name], strict=True)
            module.requires_grad_(False).eval()
            if name != "cc_projection":  # the JAX CCProjection runs in f32
                cast_compute(module, self.dtype)

    def _int8_unet(self, state) -> UNetModel:
        """The int8 UNet of the f32 UNet just built (seeded), of an f32
        state, or of an already quantized state; the f32 UNet is dropped."""
        if state is None or not is_quantized(state):
            if state is not None:
                self.unet.load_state_dict(state, strict=True)
            state = quantize_unet_state(self.unet.state_dict())
        with torch.device("meta"):
            unet = make_unet(self.config.unet, quant=True)
        unet = unet.to_empty(device=self.device)
        unet.load_state_dict(state, strict=True)
        return unet

    # ------------------------------------------------------------- sampling
    def _schedule(self, steps: int) -> DDIMSchedule:
        cfg = self.config
        sched = make_ddim_schedule(
            steps, cfg.timesteps, cfg.ddim_eta, cfg.linear_start, cfg.linear_end
        )
        return trim_for_sample(sched)

    def per_view_noise(self, seed: int, draw: int, view_ids, shape) -> torch.Tensor:
        """[len(view_ids), *shape] f32 gaussian noise, one generator per
        (seed, view id, draw)."""
        out = []
        for vid in view_ids:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(noise_seed(seed, int(vid), draw))
            out.append(torch.randn(shape, generator=gen, device=self.device))
        return torch.stack(out)

    @torch.inference_mode()
    def encode_conditioning(self, cond_images: torch.Tensor, T: torch.Tensor):
        """Conditioning pack for a batch of views.

        :param cond_images: [B, 256, 256, 3] in [-1, 1]
        :param T: [B, 1, 4] pose tokens
        :return: (context [B, 1, 768] f32, concat latent [B, 32, 32, 4] f32)
        """
        clip_in = preprocess_for_clip(cond_images, self.config.clip.image_size)
        emb = self.clip(clip_in)[:, None, :]
        ctx = self.cc_projection(torch.cat([emb, T], dim=-1))
        concat = moments_mode(self.encoder(cond_images))
        return ctx, concat

    def sample_views(self, cond_images, delta_x_deg, delta_y_deg, seed: int,
                     steps: int | None = None, cfg_scale: float | None = None,
                     sampler: str | None = None, noise_ids=None,
                     noise_fn=None) -> torch.Tensor:
        """Generate B novel views in one batch: [B, 256, 256, 3] in [0, 1].

        :param cond_images: [B, 256, 256, 3] in [-1, 1]
        :param delta_x_deg, delta_y_deg: the views' polar and azimuth
            offsets in degrees (``pose_tokens``)
        :param sampler: 'ddim', 'plms' or 'dpmpp'; None -> config.sampler
        :param noise_ids: int per view that keys its noise (default: batch
            position)
        :param noise_fn: optional (draw, view_ids, per-view shape) -> noise
            [B, *shape], replacing the per-view generators
        """
        T = pose_tokens(delta_x_deg, delta_y_deg)
        return self.sample_tokens(cond_images, T, seed, steps, cfg_scale, sampler, noise_ids,
                                  noise_fn)

    @torch.inference_mode()
    def sample_tokens(self, cond_images, T, seed: int, steps: int | None = None,
                      cfg_scale: float | None = None, sampler: str | None = None,
                      noise_ids=None, noise_fn=None) -> torch.Tensor:
        """``sample_views`` conditioned on given pose tokens ``T`` [B, 1, 4]
        (a training batch's own, as ``_sample_views_jit`` takes them):
        [B, 256, 256, 3] in [0, 1]."""
        cfg = self.config
        cfg_scale = cfg.cfg_scale if cfg_scale is None else cfg_scale
        steps = steps or cfg.ddim_steps_stage1
        sampler = sampler or cfg.sampler
        if sampler not in SAMPLERS:
            # a typo must not run another sampler
            raise ValueError(f"unknown sampler {sampler!r}: ddim|plms|dpmpp")
        cond = torch.as_tensor(cond_images, dtype=torch.float32, device=self.device)
        B = cond.shape[0]
        ids = list(range(B)) if noise_ids is None else [int(i) for i in noise_ids]
        if noise_fn is None:
            def draw_noise(draw, shape):
                return self.per_view_noise(seed, draw, ids, shape)
        else:
            def draw_noise(draw, shape):
                noise = noise_fn(draw, ids, shape)
                if not isinstance(noise, torch.Tensor):
                    noise = np.asarray(noise)
                return torch.as_tensor(noise, dtype=torch.float32, device=self.device)

        T = torch.as_tensor(T, dtype=torch.float32, device=self.device)
        ctx, concat = self.encode_conditioning(cond, T)
        # CFG double batch: [uncond ++ cond], zero unconditional inputs
        ctx_in = torch.cat([torch.zeros_like(ctx), ctx])
        concat_in = torch.cat([torch.zeros_like(concat), concat])
        L, zc = self.config.latent_size, self.config.vae.z_channels

        def eps_fn(x, t):
            unet_in = torch.cat([torch.cat([x, x]), concat_in], dim=-1)
            ts = torch.full((2 * B,), t, dtype=torch.int64, device=self.device)
            e_uc, e_c = self.unet(unet_in, ts, ctx_in).chunk(2)
            return e_uc + cfg_scale * (e_c - e_uc)

        x = draw_noise(0, (L, L, zc))
        if sampler == "ddim":
            x = ddim_sample(eps_fn, x, self._schedule(steps), lambda d, s: draw_noise(d, s[1:]))
        else:
            sched = make_ddim_schedule(steps, cfg.timesteps, 0.0, cfg.linear_start, cfg.linear_end)
            x = (plms_sample if sampler == "plms" else dpmpp_sample)(eps_fn, x, sched)
        imgs = self.decoder(x / self.scale_factor)
        return torch.clamp((imgs + 1.0) / 2.0, 0.0, 1.0)

    @contextlib.contextmanager
    def swapped_weights(self, states: dict):
        """Run with {module name: state dict} loaded into the stage's
        modules (cast to their dtypes, e.g. a trainer's f32 EMA weights
        into the bf16 UNet, as flax casts f32 params at use); the modules'
        own weights are restored on the way out, bit for bit."""
        saved = {name: {k: v.clone() for k, v in getattr(self, name).state_dict().items()}
                 for name in states}
        try:
            for name, state in states.items():
                getattr(self, name).load_state_dict(state, strict=True)
            yield self
        finally:
            for name, state in saved.items():
                getattr(self, name).load_state_dict(state, strict=True)

    # ---------------------------------------------------------- stage entries
    def stage1(self, input_image, seed: int, indices=None, steps=None, noise_fn=None):
        """Stage-1 views of the 12 candidates.

        :param input_image: [256, 256, 3] in [0, 1] (preprocessed, white bg)
        :param indices: subset of the 12 candidate views (default all 12)
        :return: [len(indices), 256, 256, 3] in [0, 1]
        """
        idx = list(indices) if indices is not None else list(range(12))
        img = torch.as_tensor(input_image, dtype=torch.float32, device=self.device) * 2.0 - 1.0
        cond = img[None].expand(len(idx), *img.shape)
        return self.sample_views(
            cond, [STAGE1_DELTA_X[i] for i in idx], [STAGE1_DELTA_Y[i] for i in idx], seed,
            steps=steps or self.config.ddim_steps_stage1, noise_ids=idx, noise_fn=noise_fn,
        )

    def stage2(self, stage1_images, seed: int, steps=None, view_ids=None, noise_fn=None):
        """The 4 nearby views of each stage-1 view, all in one batch.

        :param stage1_images: [N, 256, 256, 3] in [0, 1]
        :param view_ids: per-parent-view ids keying the noise (default arange)
        :return: [N, 4, 256, 256, 3] in [0, 1]
        """
        imgs = torch.as_tensor(stage1_images, dtype=torch.float32, device=self.device)
        n = imgs.shape[0]
        # snap near-white to white, as the original re-reads its own PNGs
        imgs = torch.where(imgs >= 253.0 / 255.0, torch.ones_like(imgs), imgs)
        cond = imgs.repeat_interleave(4, dim=0) * 2.0 - 1.0  # [4N, ...]
        if view_ids is None:
            view_ids = list(range(n))
        ids = [12 + int(v) * 4 + j for v in view_ids for j in range(4)]
        out = self.sample_views(
            cond, STAGE2_DELTA_X * n, STAGE2_DELTA_Y * n, seed,
            steps=steps or self.config.ddim_steps_stage2, noise_ids=ids, noise_fn=noise_fn,
        )
        return out.reshape(n, 4, *out.shape[1:])
