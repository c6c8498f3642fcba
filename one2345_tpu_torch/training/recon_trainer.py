"""Generalizable-SparseNeuS reconstruction trainer, one scene per step and card.

Counterpart of ``one2345_tpu/training/recon_trainer.py`` (reference:
exp_runner_generic_blender_train.py and GenericTrainer.train_step /
cal_losses_sdf, trainer_generic.py:158-357, 1127-1269):

- the batch norms train on batch statistics (InPlaceABN / spnn.BatchNorm),
  their running statistics updated in place as flax updates them; with
  ``fix_lod0_networks`` the lod0 forward runs without a graph and still
  updates them, as the JAX trainer does;
- the loss: L1 color over rays with a valid blend, the sparsity term on
  the samples and on 1024 uniform points, the eikonal error, and the
  fg/bg mask term after ``fg_bg_gate_iter``; with ``num_lods=2`` the lod1
  branch's loss is added (its weights on the lod1 schedule);
- the step: gradients clipped to global norm 1.0 (optax's formula: scaled
  by 1 / ||g|| when ||g|| >= 1, no epsilon), then Adam (betas 0.9 / 0.999,
  eps 1e-8) at the cosine rate with a 0.1 floor, read at the step count
  before the update, as optax reads its schedule.

The trainer trains the stage's own modules in place, unfrozen here: an f32
stage, or a bf16 one built with ``f32_weights=True``.  bf16 training is
flax's ``dtype=bfloat16`` over f32 parameters: the FPN and its fusion, the
``compress`` conv, CostRegNet and the blending nets compute in bf16 over
f32 weights cast at use; the SDF MLPs and the variance nets stay f32, as
do the gradients, the Adam state and the running statistics (the batch
statistics reduce in f32).  Random draws (the stratified jitter, the
normal-query mix, the sparsity points; ``DRAWS``, with a ``_lod1`` suffix
for the fine lod) come from the trainer's ``torch.Generator`` unless the
caller gives them.

Several cards: ``make_sharded_train_step`` trains one scene per ``data``
rank, the JAX step's vmap over its scenes: the gradients are averaged
over the ranks before the clip and Adam, and the running statistics after
the step are the mean of the ranks' (the JAX step's ``stats.mean(axis=0)``).
"""

from __future__ import annotations

import math

import torch

from one2345_tpu_torch.recon.renderer import RenderParams, render_rays

DRAWS = ("t_rand", "normal_query", "pts_random")
SCENE_KEYS = ("images", "affines", "w2cs", "intrinsics", "near_far", "rays_o", "rays_v",
              "rays_color", "rays_mask")


def cosine_lr(base_lr: float, end_iter: int):
    """step -> base_lr * ((cos(pi * step / end_iter) + 1) / 2 * 0.9 + 0.1)
    (train runner :400-405)."""
    def schedule(step):
        return base_lr * ((math.cos(math.pi * step / end_iter) + 1.0) * 0.5 * 0.9 + 0.1)

    return schedule


class ReconTrainer:
    """:param stage: ``recon.pipeline.ReconStage`` in f32, or in bf16 with
        ``f32_weights=True`` (its modules are trained in place; with
        ``num_lods=2`` it must hold every lod1 module)
    :param config: the training config (defaults to the stage's)
    :param seed: seed of the trainer's generator
    """

    def __init__(self, stage, config=None, seed: int = 0):
        self.stage = stage
        self.cfg = cfg = config or stage.config
        if stage.dtype != (torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32):
            raise ValueError(f"config dtype {cfg.dtype!r}, stage in {stage.dtype}")
        if stage.dtype != torch.float32 and not stage.f32_weights:
            raise ValueError(
                "ReconTrainer trains f32 weights: build a bf16 stage with f32_weights=True "
                "(bf16 compute over f32 weights), not the inference stage's bf16 weights"
            )
        self.device = stage.device
        self.modules = stage.modules()
        if cfg.num_lods > 1 and len(self.modules) != 8:
            raise ValueError(f"num_lods=2 trains 8 networks, the stage holds {sorted(self.modules)}")
        for m in self.modules.values():
            m.requires_grad_(True)
        self._params = [p for m in self.modules.values() for p in m.parameters()]
        self.optimizer = torch.optim.Adam(self._params, lr=cfg.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.lr = cosine_lr(cfg.learning_rate, cfg.end_iter)
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # of the scene tensors and the float draws; a float64 reference
        # sets float64 with its modules
        self.dtype = torch.float32

    # ----------------------------------------------------------- state
    def state_dict(self) -> dict:
        """{'params': {module key: state dict (running statistics
        included)}, 'opt_state': the optimizer's, 'step': int}."""
        return {
            "params": {k: m.state_dict() for k, m in self.modules.items()},
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        for k, m in self.modules.items():
            m.load_state_dict(state["params"][k], strict=True)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])

    # ------------------------------------------------------- schedules
    def alpha_inter_ratio(self, step: int, lod: int = 0) -> float:
        """get_alpha_inter_ratio (train runner :412-418), per lod; a
        collapsed window (start >= end) is a step at ``start``."""
        cfg = self.cfg
        start = cfg.anneal_start if lod == 0 else cfg.anneal_start_lod1
        end = cfg.anneal_end if lod == 0 else cfg.anneal_end_lod1
        if end == 0:
            return 1.0
        if end <= start:
            return 0.0 if step < start else 1.0
        return min(max((step - start) / (end - start), 0.0), 1.0)

    def _anneal_weight(self, step: int, weight: float, lod: int = 0) -> float:
        """get_weight (trainer_generic.py:1130-1150): lod0 ramps from
        anneal_start to 2 * anneal_end; lod1 from anneal_end_lod1 to 2 *
        anneal_end_lod1 (the reference's start is lod1's end)."""
        cfg = self.cfg
        if lod == 0:
            start, end = cfg.anneal_start, cfg.anneal_end * 2
        else:
            start, end = cfg.anneal_end_lod1, cfg.anneal_end_lod1 * 2
        if end == 0:
            return weight
        return min(max((step - start) / (end - start), 0.0), 1.0) * weight

    # --------------------------------------------------------- forward
    def scene(self, scene: dict) -> dict:
        """A scene dict (arrays or tensors) as tensors of ``self.dtype`` on the
        device."""
        return {k: torch.as_tensor(scene[k]).to(self.device, self.dtype) for k in SCENE_KEYS}

    def _render_lod(self, lod, scene, feats, volume, mask_volume, step, draws):
        """One lod's training render of the scene's rays, all views but the
        reference as the support set (train_step:243-260, 305-321)."""
        cfg = self.cfg
        _, sdf_net, render_net, variance_net = self.stage.lod_modules(lod)
        imgs = scene["images"]
        H, W = imgs.shape[1], imgs.shape[2]
        out = render_rays(
            lambda p: sdf_net.sdf(p, volume),
            lambda p: sdf_net.sdf_and_gradient(p, volume, create_graph=True),
            render_net,
            variance_net(),
            scene["rays_o"], scene["rays_v"], scene["near_far"][0], scene["near_far"][1],
            volume, mask_volume, feats[1:], imgs[1:], scene["w2cs"][1:],
            scene["intrinsics"][1:], (H, W),
            query_cam_center=torch.linalg.inv(scene["w2cs"][0])[:3, 3],
            params=RenderParams(
                n_samples=cfg.n_samples, n_importance=cfg.n_importance, perturb=True,
                alpha_inter_ratio=self.alpha_inter_ratio(step, lod),
                background_rgb=1.0 if cfg.use_white_bkgd else None,
                normal_query_prob=cfg.normal_query_prob,
            ),
            generator=self.generator,
            draws=draws,
        )
        return out, sdf_net

    def _assemble_losses(self, out, scene, step, sdf_fn, pts_random, lod):
        """cal_losses_sdf (trainer_generic.py:1127-1269) of one lod."""
        cfg = self.cfg
        true_rgb = scene["rays_color"]
        mask = scene["rays_mask"][:, 0]
        color = out["color_fine"]
        cmask = out["color_fine_mask"][:, 0].to(color.dtype)
        err = (color - true_rgb).abs().mean(dim=-1) * cmask
        color_loss = err.sum() / (cmask.sum() + 1e-8)
        mse = (((color - true_rgb) ** 2).mean(-1) * cmask).sum() / (cmask.sum() + 1e-8) / 3.0
        psnr = 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12))

        sdf_random, _ = sdf_fn(pts_random)
        sparse_1 = torch.exp(-cfg.sdf_decay_param * sdf_random.abs()).mean()
        sparse_2 = torch.exp(-cfg.sdf_decay_param * out["sdf"].abs()).mean()
        sparse_loss = 0.5 * (sparse_1 + sparse_2)
        eikonal = out["gradient_error_fine"]

        # the fg/bg mask term, gated after fg_bg_gate_iter and only when the
        # batch has background rays (trainer_generic.py:1227-1248)
        fg_bg_weight = (0.0 if step < cfg.fg_bg_gate_iter
                        else self._anneal_weight(step, cfg.fg_bg_weight, lod))
        has_bg = (mask < 0.5).to(mask.dtype).mean() > 0.02
        fg_bg_loss = torch.where(has_bg, (out["weights_sum"][:, 0] - mask).abs().mean(), 0.0)

        loss = (color_loss + sparse_loss * self._anneal_weight(step, cfg.sdf_sparse_weight, lod)
                + fg_bg_loss * fg_bg_weight + eikonal * cfg.sdf_igr_weight)
        metrics = {
            "color_loss": color_loss,
            "psnr": psnr,
            "eikonal": eikonal,
            "sparse_loss": sparse_loss,
            "fg_bg_loss": fg_bg_loss,
            "variance": out["variance"],
        }
        return loss, metrics

    def _lod_draws(self, draws: dict, lod: int) -> dict:
        suffix = "" if lod == 0 else "_lod1"
        out = {}
        for k in DRAWS:
            if k + suffix in draws:
                d = torch.as_tensor(draws[k + suffix]).to(self.device)
                out[k] = d if d.dtype == torch.bool else d.to(self.dtype)
        if "pts_random" not in out:
            out["pts_random"] = torch.rand((1024, 3), generator=self.generator,
                                           device=self.device, dtype=self.dtype) * 2.0 - 1.0
        return out

    def scene_loss(self, scene: dict, step: int | None = None, draws=None):
        """The loss of one scene (train_step, trainer_generic.py:158-357),
        differentiable in the trained modules, and its metrics (tensors).

        :param scene: {'images' [V, H, W, 3] (view 0 the reference),
            'affines' [V, 4, 4], 'w2cs' [V, 4, 4], 'intrinsics' [V, 3, 3],
            'near_far' [2], 'rays_o' / 'rays_v' / 'rays_color' [N, 3],
            'rays_mask' [N, 1]}
        :param step: the schedules' step (default: the trainer's)
        :param draws: optional {'t_rand' [N, n_samples], 'normal_query'
            [N] bool, 'pts_random' [1024, 3]} and the same with '_lod1'
        """
        cfg = self.cfg
        st = self.stage
        step = self.step if step is None else step
        draws = draws or {}
        unknown = set(draws) - {k + s for k in DRAWS for s in ("", "_lod1")}
        if unknown:
            raise KeyError(f"unknown draws {sorted(unknown)}")
        sc = self.scene(scene)
        imgs = sc["images"]
        H, W = imgs.shape[1], imgs.shape[2]
        fix0 = cfg.num_lods > 1 and cfg.fix_lod0_networks

        # the conditional volume from the source views (trainer_generic:192-200);
        # a frozen lod0 still runs (and updates its running statistics)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not fix0):
            feats = st.fusion(imgs, True)
            vol = st.sdf_net.build_volume(feats[1:], sc["affines"][1:], (H, W), True)
        volume, mask_volume = vol["volume"], vol["mask"]

        loss = torch.zeros((), device=self.device)
        metrics = {}
        if not fix0:
            d0 = self._lod_draws(draws, 0)
            out0, net0 = self._render_lod(0, sc, feats, volume, mask_volume, step, d0)
            loss0, m0 = self._assemble_losses(
                out0, sc, step, lambda p: net0.sdf(p, volume), d0["pts_random"], 0)
            loss = loss + loss0
            metrics.update(m0)

        if cfg.num_lods > 1:
            # near-surface pruning of the coarse lod (train_step:269-287):
            # an index selection, so lod1's loss reaches lod0 only through
            # the lod0 volume as its extra cost channels
            if cfg.lod1_prune_depth_filter:
                pre_mask = st.prune_occupancy_depth_filter(
                    volume, mask_volume, sc["affines"][1:], sc["intrinsics"][1:],
                    torch.linalg.inv(sc["w2cs"][1:]), sc["near_far"], (H, W))
            else:
                pre_mask = st.prune_occupancy(volume, mask_volume)
            feats1 = st.fusion_lod1(imgs, True)
            vol1 = st.sdf_net_lod1.build_volume(feats1[1:], sc["affines"][1:], (H, W), True,
                                                pre_mask, volume)
            d1 = self._lod_draws(draws, 1)
            out1, net1 = self._render_lod(1, sc, feats1, vol1["volume"], vol1["mask"], step, d1)
            loss1, m1 = self._assemble_losses(
                out1, sc, step, lambda p: net1.sdf(p, vol1["volume"]), d1["pts_random"], 1)
            loss = loss + loss1
            metrics.update({f"{k}_lod1": v for k, v in m1.items()})
        metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}

    # ------------------------------------------------------------ step
    def train_step(self, scene: dict, draws=None) -> dict:
        """Forward, backward, global-norm clip and Adam at the cosine rate;
        the step count advances.  Returns the metrics as detached tensors on
        the device (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.scene_loss(scene, self.step, draws)
        loss.backward()
        self.optimizer_step()
        return metrics

    def scene_draws(self, n_rays: int) -> dict:
        """One scene's draws from the trainer's generator, in the order and
        with the values a ``scene_loss`` without draws makes them."""
        cfg, g, dev = self.cfg, self.generator, self.device
        fix0 = cfg.num_lods > 1 and cfg.fix_lod0_networks
        out = {}
        for lod in range(cfg.num_lods):
            if lod == 0 and fix0:
                continue
            sfx = "" if lod == 0 else "_lod1"
            out["pts_random" + sfx] = torch.rand((1024, 3), generator=g, device=dev,
                                                 dtype=self.dtype) * 2.0 - 1.0
            out["t_rand" + sfx] = torch.rand((n_rays, cfg.n_samples), generator=g, device=dev)
            if cfg.normal_query_prob > 0.0:
                out["normal_query" + sfx] = (torch.rand((n_rays,), generator=g, device=dev)
                                             < cfg.normal_query_prob)
        return out

    def make_sharded_train_step(self, mesh):
        """The train step over a ``core.meshes.create_mesh`` mesh, one scene
        per ``data`` rank (the DataParallel equivalent, JAX
        ``make_sharded_train_step``): every rank draws the draws of all the
        step's scenes from its generator, in scene order, and keeps its own
        (the same generator on every rank), unless the caller gives this
        rank's; after the backward the gradients and the updated running
        statistics are averaged over the ranks, then the clip and Adam run
        on every rank alike.

        Returns ``step(scene, draws=None)`` on this rank's scene, which
        returns the metrics averaged over the step's scenes.
        """
        from one2345_tpu_torch.core.meshes import all_reduce_mean, axis_rank, axis_size

        n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
        group = mesh.get_group("data")
        stats = [b for m in self.modules.values() for name, b in m.named_buffers()
                 if name.endswith(("running_mean", "running_var"))]

        def step(scene, draws=None) -> dict:
            if draws is None:
                n_rays = len(scene["rays_o"])
                draws = [self.scene_draws(n_rays) for _ in range(n)][r]
            self.optimizer.zero_grad(set_to_none=True)
            loss, metrics = self.scene_loss(scene, self.step, draws)
            loss.backward()
            self._fill_grads()
            all_reduce_mean([p.grad for p in self._params] + stats, group=group)
            names = sorted(metrics)
            values = torch.stack([metrics[k].to(torch.float32) for k in names])
            all_reduce_mean([values], group=group)
            self.optimizer_step()
            return dict(zip(names, values.unbind()))

        return step

    def _fill_grads(self) -> None:
        for p in self._params:
            # unread (a frozen lod0): zeros, as jax.grad gives them
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def optimizer_step(self) -> None:
        """The update from the gradients on the parameters: clip to global
        norm 1.0, Adam at the cosine rate of the current step; the step
        count advances."""
        self._fill_grads()
        grads = [p.grad for p in self._params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_div_(grads, torch.where(norm < 1.0, torch.ones_like(norm), norm))
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr(self.step)
        self.optimizer.step()
        self.step += 1
