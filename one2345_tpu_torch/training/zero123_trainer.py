"""Zero123 finetune trainer: the counterpart of
``one2345_tpu/training/zero123_trainer.py``.

The training contract, as the JAX package reconstructs it from the
reference's config (configs/sd-objaverse-finetune-c_concat-256.yaml) and
LatentDiffusion (ddpm.py):

- eps-parameterization MSE (p_losses, ddpm.py:1004-1037);
- hybrid conditioning with 5%/5%/5% CFG dropout (get_input, ddpm.py:741-753);
- z = sample(VAE posterior) * 0.18215; c_concat = mode(VAE posterior);
- AdamW, base lr 1e-4, 10x lr on cc_projection (ddpm.py:1411-1416), with
  optax.adamw's defaults (betas (0.9, 0.999), eps 1e-8, weight decay 1e-4
  on every tensor);
- LambdaLinear warmup over 100 steps (1e-6 -> 1), read at the step count
  before the update, so the first step runs at lr * 1e-6;
- frozen VAE encoder + CLIP; LitEma of the trainable weights with the decay
  warmup min(decay, (1 + n) / (10 + n)) (ldm/modules/ema.py:26-30).

The trainable UNet and CCProjection are f32 copies built from f32 state
dicts (``utils.convert_jax.trainable_from_jax``), never from the stage's
UNet, which ``Zero123Stage`` casts to the compute dtype and freezes.  With a
bf16 config the UNet runs under ``torch.autocast`` (bf16 convs and linears
over f32 weights, as flax's ``dtype=bf16, param_dtype=f32``), so every
multi-token self-attention reaches the flash kernels as bf16 and its
backward runs on them.  The frozen towers run under ``torch.no_grad``.

Random draws (timesteps, noise, the posterior's normal draw, the dropout
uniforms) come from the trainer's ``torch.Generator`` unless the caller
injects them (``draws``), as the samplers take ``noise_fn``; the tests feed
the JAX draws through it.

Several cards: ``make_sharded_train_step`` shards the batch over the mesh's
``data`` axis and (FSDP2) the trainable weights, their AdamW state and the
EMA over its ``model`` axis, as the JAX trainer's ``make_sharded_train_step``.
"""

from __future__ import annotations

import torch

from one2345_tpu_torch.diffusion.clip import preprocess_for_clip
from one2345_tpu_torch.diffusion.schedule import training_schedule
from one2345_tpu_torch.diffusion.vae import moments_mode, moments_sample
from one2345_tpu_torch.diffusion.zero123 import CCProjection, make_unet, resolve_device

DRAWS = ("t", "noise", "z_eps", "u")


def make_optimizer(unet: torch.nn.Module, cc_projection: torch.nn.Module,
                   base_lr: float = 1e-4, warmup_steps: int = 100):
    """AdamW over two groups (UNet at ``base_lr``, CCProjection at 10x) and
    its linear warmup (f_start 1e-6 -> 1.0), as the JAX package's optax
    chain.  Returns (optimizer, scheduler)."""
    opt = torch.optim.AdamW(
        [
            {"params": list(unet.parameters()), "lr": base_lr},
            {"params": list(cc_projection.parameters()), "lr": 10.0 * base_lr},
        ],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
    )
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 1e-6 + (1.0 - 1e-6) * min(step / warmup_steps, 1.0)
    )
    return opt, sched


class Zero123Trainer:
    """One finetune step of the Zero123 UNet and CCProjection.

    :param stage: ``diffusion.zero123.Zero123Stage``: its VAE encoder, CLIP
        tower, config and compute dtype (the frozen part)
    :param params: f32 state dicts {'unet', 'cc_projection'} of the
        trainable modules (``utils.convert_jax.trainable_from_jax``)
    :param remat: recompute the UNet's blocks in the backward pass (same
        gradients, less activation memory)
    :param device: None -> 'cuda' (raises without CUDA); must be the
        stage's device
    :param seed: seed of the trainer's generator for the random draws
    """

    def __init__(self, stage, params, ema_decay: float = 0.9999, base_lr: float = 1e-4,
                 remat: bool = True, device=None, seed: int = 0):
        self.device = resolve_device(device)
        if getattr(stage, "quant", False):
            raise ValueError(
                "Zero123Trainer needs an f32 param tree: construct the stage "
                "with UNetConfig.quant='none' (int8 is an inference-only fast "
                "mode, diffusion/quantize.py)"
            )
        if stage.device != self.device:
            raise ValueError(f"stage on {stage.device}, trainer on {self.device}")
        self.stage = stage
        cfg = stage.config
        with torch.device("meta"):
            unet = make_unet(cfg.unet, remat=remat)
            cc = CCProjection(cfg.clip.embed_dim + 4, cfg.unet.context_dim)
        self.unet = unet.to_empty(device=self.device)
        self.cc_projection = cc.to_empty(device=self.device)
        self.unet.load_state_dict(params["unet"], strict=True)
        self.cc_projection.load_state_dict(params["cc_projection"], strict=True)
        self.modules = {"unet": self.unet, "cc_projection": self.cc_projection}
        self._params = [p for m in self.modules.values() for p in m.parameters()]

        sched = training_schedule(cfg.timesteps, cfg.linear_start, cfg.linear_end)
        self.sqrt_ac = torch.as_tensor(sched["sqrt_alphas_cumprod"], device=self.device)
        self.sqrt_1m_ac = torch.as_tensor(
            sched["sqrt_one_minus_alphas_cumprod"], device=self.device
        )
        self.ema_decay = ema_decay
        self.base_lr = base_lr
        self.optimizer, self.scheduler = make_optimizer(self.unet, self.cc_projection, base_lr)
        self.ema = {
            name: {k: p.detach().clone() for k, p in m.named_parameters()}
            for name, m in self.modules.items()
        }
        self._ema_list = [t for d in self.ema.values() for t in d.values()]
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._grad_sync = None  # the gradients' all-reduce of a sharded step

    def _draws(self, B: int, latent_shape, draws) -> dict:
        """The step's random draws: injected ones as given, the rest from
        the trainer's generator."""
        g, dev = self.generator, self.device
        out = {}
        given = draws or {}
        unknown = set(given) - set(DRAWS)
        if unknown:
            raise KeyError(f"unknown draws {sorted(unknown)}; expected some of {DRAWS}")
        for name in DRAWS:
            if name in given:
                dtype = torch.int64 if name == "t" else torch.float32
                out[name] = torch.as_tensor(given[name], dtype=dtype, device=dev)
            elif name == "t":
                out[name] = torch.randint(
                    0, self.stage.config.timesteps, (B,), generator=g, device=dev
                )
            elif name == "u":
                out[name] = torch.rand((B,), generator=g, device=dev)
            else:
                out[name] = torch.randn(latent_shape, generator=g, device=dev)
        return out

    def loss_fn(self, batch, draws=None) -> torch.Tensor:
        """eps-MSE over one batch, differentiable in the trainable weights.

        :param batch: {'image_target' [B, 256, 256, 3] in [-1, 1],
                       'image_cond'   [B, 256, 256, 3] in [-1, 1],
                       'T'            [B, 1, 4] pose tokens}
        :param draws: optional {'t' [B] int, 'noise' and 'z_eps' [B, h, w, 4],
            'u' [B] in [0, 1)}; missing ones come from the generator
        """
        st, dev = self.stage, self.device
        img_t, img_c, T = (
            torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
            for k in ("image_target", "image_cond", "T")
        )
        B = img_t.shape[0]
        with torch.no_grad():  # frozen first / cond stages
            moments = st.encoder(torch.cat([img_t, img_c]))
            emb = st.clip(preprocess_for_clip(img_c, st.config.clip.image_size))[:, None, :]
        moments_t, moments_c = moments[:B], moments[B:]
        d = self._draws(B, moments_mode(moments_t).shape, draws)
        z = moments_sample(moments_t, d["z_eps"]) * st.scale_factor
        concat = moments_mode(moments_c)
        ctx = self.cc_projection(torch.cat([emb, T], dim=-1))

        # 5%/5%/5% conditioning dropout (ddpm.py:741-753): u < .05 drops the
        # cross-attention context only, .05 <= u < .10 both, .10 <= u < .15
        # the concat latent only
        u = d["u"]
        ctx = ctx.masked_fill((u < 0.10)[:, None, None], 0.0)
        concat = concat.masked_fill(((u >= 0.05) & (u < 0.15))[:, None, None, None], 0.0)

        t, noise = d["t"], d["noise"]
        z_noisy = self.sqrt_ac[t][:, None, None, None] * z + self.sqrt_1m_ac[t][
            :, None, None, None
        ] * noise
        unet_in = torch.cat([z_noisy, concat], dim=-1)
        with torch.autocast(
            dev.type, dtype=torch.bfloat16, enabled=st.dtype == torch.bfloat16
        ):
            eps = self.unet(unet_in, t, ctx)
        return torch.mean((eps.float() - noise) ** 2)

    def train_step(self, batch, draws=None) -> torch.Tensor:
        """Forward, backward, AdamW and the warmup schedule, then the EMA.

        The gradients stay on the parameters until the next step.  Returns
        the loss as a detached tensor on the trainer's device (no host sync).
        """
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch, draws)
        loss.backward()
        for p in self._params:
            # the one-token cross-attention never reads attn2.to_q / to_k:
            # jax.grad gives them zeros, and optax still decays them
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self._grad_sync is not None:
            self._grad_sync()
        self.optimizer.step()
        self.scheduler.step()
        n = self.step + 1
        decay = min(self.ema_decay, (1.0 + n) / (10.0 + n))
        with torch.no_grad():
            torch._foreach_mul_(self._ema_list, decay)
            torch._foreach_add_(self._ema_list, self._params, alpha=1.0 - decay)
        self.step = n
        return loss.detach()

    # ------------------------------------------------------------- sharding
    def make_sharded_train_step(self, mesh, shard_params: bool = True):
        """The train step over a ``core.meshes.create_mesh`` mesh: each rank
        takes its rows of the global batch (``data``), and the gradients are
        the mean over the global batch, as JAX's ``jnp.mean`` over a
        ``data``-sharded batch gives them.

        With ``shard_params`` (the mesh needs a ``model`` axis) the UNet and
        CCProjection are ``fully_shard``ed (FSDP2) over ``model`` and
        replicated over ``data`` (HSDP on the (data, model) mesh): their
        parameters, AdamW state and EMA are DTensors holding this rank's
        shard, gathered for the forward and backward, and the gradients are
        reduce-scattered.  Without it the parameters stay whole on every
        rank and the gradients are all-reduced.  The frozen VAE encoder and
        CLIP tower are replicated either way.  The step's random draws are
        drawn for the global batch (or given for it) and sharded with it, so
        a sharded step equals the one-card step at the same seed.

        Shards a trainer before its first step.  Returns ``step(batch,
        draws=None)`` on the global batch and draws (as ``train_step``
        takes them), which returns the global batch's loss.
        """
        from one2345_tpu_torch.core.meshes import all_reduce_mean, shard_batch

        if self.step:
            raise ValueError("make_sharded_train_step shards a trainer before its first step")
        if shard_params:
            from torch.distributed.fsdp import fully_shard

            if "model" not in (mesh.mesh_dim_names or ()):
                raise ValueError("shard_params needs a mesh with a 'model' axis")
            hsdp = mesh["data", "model"] if "data" in mesh.mesh_dim_names else mesh["model"]
            for m in self.modules.values():
                fully_shard(m, mesh=hsdp)
            self._params = [p for m in self.modules.values() for p in m.parameters()]
            self.optimizer, self.scheduler = make_optimizer(
                self.unet, self.cc_projection, self.base_lr)
            self.ema = {
                name: {k: p.detach().clone() for k, p in m.named_parameters()}
                for name, m in self.modules.items()
            }
            self._ema_list = [t for d in self.ema.values() for t in d.values()]
        else:
            def sync():
                all_reduce_mean([p.grad for p in self._params])

            self._grad_sync = sync
        cfg = self.stage.config

        def step(batch, draws=None) -> torch.Tensor:
            B = len(batch["T"])
            d = self._draws(B, (B, cfg.latent_size, cfg.latent_size, cfg.vae.z_channels), draws)
            local = shard_batch(mesh, {k: batch[k] for k in ("image_target", "image_cond", "T")})
            loss = self.train_step(local, shard_batch(mesh, d)).reshape(1).clone()
            all_reduce_mean([loss])  # the ranks of a model group hold equal losses
            return loss[0]

        return step

    def state_dicts(self) -> dict:
        """The trainable weights, keyed as ``params``, whole (a sharded
        trainer gathers them: every rank must call)."""
        return {name: {k: _whole(v) for k, v in m.state_dict().items()}
                for name, m in self.modules.items()}

    def ema_weights(self) -> dict:
        """The trainable modules' state dicts with the EMA in place of their
        parameters, whole (every rank must call)."""
        ema = self.ema_state_dicts()
        return {name: {**sd, **ema[name]} for name, sd in self.state_dicts().items()}

    def ema_state_dicts(self) -> dict:
        """The EMA weights, keyed as ``params``, whole (every rank must call)."""
        return {name: {k: _whole(v) for k, v in d.items()} for name, d in self.ema.items()}


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered to the whole tensor; a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t
