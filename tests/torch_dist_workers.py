"""Gloo worlds of spawned CPU ranks for the port's multi-rank tests.

Imports torch, numpy and the port only (never JAX): spawned ranks import
this module, and a child that imported JAX would start its 8-device CPU
backend.  ``World(n, store_dir)`` starts n ranks once (a test module's
fixture); ``world.run(task, *args)`` runs a task of this module by name on
every rank and returns the ranks' results (numpy trees), in rank order
(``submit`` then ``collect``, with the caller's own work between them).
A task that raises on any rank raises here with that rank's traceback,
and the world is torn down (the other ranks may wait in a collective).
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _serve(rank: int, world: int, store: str, inbox, outbox, threads: int):
    torch.set_num_threads(threads)
    from one2345_tpu_torch.core import meshes

    meshes.init_process_group("cpu", rank=rank, world_size=world, init_method=f"file://{store}")
    try:
        while True:
            job = inbox.get()
            if job is None:
                return
            name, args, kwargs = job
            try:
                outbox.put((rank, True, _numpy(globals()[name](*args, **kwargs))))
            except BaseException:
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        meshes.destroy_process_group()


class World:
    """``n`` gloo ranks on the CPU, each with ``threads`` torch threads,
    meeting at a file store in ``store_dir``."""

    def __init__(self, n: int, store_dir: str, threads: int = 1, timeout: float = 600.0):
        ctx = mp.get_context("spawn")
        self.n, self.timeout = n, timeout
        store = os.path.join(str(store_dir), "gloo_store")
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, n, store, self.inboxes[r], self.outbox, threads))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, task: str, *args, **kwargs) -> list:
        self.submit(task, *args, **kwargs)
        return self.collect(task)

    def submit(self, task: str, *args, **kwargs) -> None:
        """Start ``task`` on every rank; ``collect`` waits for it (the
        caller may compute its JAX side meanwhile)."""
        for q in self.inboxes:
            q.put((task, args, kwargs))

    def collect(self, task: str) -> list:
        out = [None] * self.n
        for _ in range(self.n):
            rank, ok, value = self.outbox.get(timeout=self.timeout)
            if not ok:
                self.close()
                raise RuntimeError(f"rank {rank} failed in {task}:\n{value}")
            out[rank] = value
        return out

    def close(self):
        for q in self.inboxes:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()


# ---------------------------------------------------------------- tasks
def mesh_rows(axis_names, axis_sizes, n_rows: int):
    """(rank, data coordinate, this rank's rows of arange(n_rows) by
    shard_batch, a replicated array that rank 0 holds)."""
    from one2345_tpu_torch.core import meshes

    mesh = meshes.create_mesh(tuple(axis_names), tuple(axis_sizes))
    rows = meshes.shard_batch(mesh, {"x": np.arange(n_rows * 2).reshape(n_rows, 2)})["x"]
    mine = np.full(3, float(meshes.rank()), np.float32)
    return (meshes.rank(), meshes.axis_rank(mesh, "data"), rows,
            meshes.replicate(mesh, {"r": mine})["r"])


def zero123_sharded_steps(axis_sizes, stage_params, trainable, batch, draws,
                          base_lr: float, shard_params: bool = True):
    """Two sharded Zero123 train steps on the global batch with the global
    draws (one per step): the losses, the whole params and EMA after them,
    the step count."""
    from tests.torch_port_helpers import tiny_config

    from one2345_tpu_torch.core import meshes
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    cfg = tiny_config(torch_side=True)
    stage = Zero123Stage(cfg, params=_tensors(stage_params), device="cpu")
    trainer = Zero123Trainer(stage, _tensors(trainable), remat=False, device="cpu",
                             base_lr=base_lr)
    mesh = meshes.create_mesh(("data", "model"), tuple(axis_sizes))
    step = trainer.make_sharded_train_step(mesh, shard_params=shard_params)
    losses = [float(step(batch, d)) for d in draws]
    grads = {name: {k: p.grad for k, p in m.named_parameters()}
             for name, m in trainer.modules.items()}
    grad_max = {name: {k: float(_whole(g).abs().max()) for k, g in d.items()}
                for name, d in grads.items()}
    return {"losses": losses, "params": trainer.state_dicts(), "ema": trainer.ema_state_dicts(),
            "step": trainer.step, "grad_max": grad_max,
            "local_numel": sum(p.to_local().numel() if hasattr(p, "to_local") else p.numel()
                               for p in trainer._params)}


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def train_zero123_main(argv):
    """``train_zero123.main`` on this rank with the tiny config."""
    from tests.torch_port_helpers import tiny_config

    from one2345_tpu_torch.training import train_zero123

    train_zero123.build_config = lambda: tiny_config(torch_side=True)
    trainer = train_zero123.main(argv, device="cpu")
    return {"step": trainer.step}


def recon_sharded_steps(config_kw, params, scenes, draws):
    """Sharded reconstruction steps on a ``data`` mesh over the world: rank
    r trains ``scenes[r]`` with ``draws[step][r]`` at each step.  Returns
    the metrics of each step and the modules' state dicts (running
    statistics included) after them."""
    from one2345_tpu_torch.core import meshes
    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer

    cfg = ReconConfig(**config_kw)
    trainer = ReconTrainer(ReconStage(cfg, params=_tensors(params), device="cpu"), cfg)
    mesh = meshes.create_mesh(("data",))
    step = trainer.make_sharded_train_step(mesh)
    r = meshes.axis_rank(mesh, "data")
    metrics = [step(scenes[r], {k: torch.as_tensor(v) for k, v in d[r].items()})
               for d in draws]
    return {"metrics": metrics, "step": trainer.step,
            "params": {k: m.state_dict() for k, m in trainer.modules.items()}}


def train_recon_main(argv, config_kw):
    """``train_recon.main`` on this rank with ``ReconConfig`` cut by
    ``config_kw`` (the CLI builds the rest from its flags)."""
    import functools

    from one2345_tpu_torch.core import config
    from one2345_tpu_torch.training import train_recon

    full = config.ReconConfig
    config.ReconConfig = functools.partial(full, **config_kw)
    try:
        trainer = train_recon.main(argv, device="cpu")
    finally:
        config.ReconConfig = full
    return {"step": trainer.step, "params": {k: m.state_dict() for k, m in trainer.modules.items()}}


def zero123_stage1(params, sampler: str, image, indices, steps: int, noise):
    """``Zero123Stage.stage1`` of the tiny config on a ``data`` mesh over
    the world, with the per-view noise ``noise[draw][view id]``."""
    from tests.torch_port_helpers import tiny_config

    from one2345_tpu_torch.core import meshes
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage

    stage = Zero123Stage(tiny_config(torch_side=True).replace(sampler=sampler),
                         params=_tensors(params), device="cpu",
                         mesh=meshes.create_mesh(("data",)))

    def noise_fn(draw, view_ids, shape):
        return noise[draw][list(view_ids)]

    return stage.stage1(image, 0, indices=list(indices), steps=steps, noise_fn=noise_fn)


def tiny_pipeline(mesh=None, auto_mesh: bool = True):
    """The tiny runner of tests/test_torch_pipeline.py with seeded weights
    (the SDF MLP's sphere init gives the field a surface), its elevation
    estimate pinned to polar 60."""
    from tests.torch_port_helpers import tiny_config

    from one2345_tpu_torch.core import config
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    cfg = config.PipelineConfig(
        diffusion=tiny_config(torch_side=True).replace(ddim_steps_stage1=2, ddim_steps_stage2=2),
        recon=config.ReconConfig(vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0),
        mesh_resolution=32)
    pipe = One2345Pipeline(cfg, use_sam=False, device="cpu", mesh=mesh, auto_mesh=auto_mesh)
    pipe.estimate_elevation = lambda views: 60.0
    return pipe


def pipeline_run(image, out_dir: str):
    """``run`` of the tiny runner on this rank (its auto mesh over the
    world): the stage images, the mesh, the mesh path and the data size."""
    from one2345_tpu_torch.core import meshes

    pipe = tiny_pipeline()
    res = pipe.run(image, out_dir=out_dir, skip_preprocess=True, seed=0, output_format=".obj")
    return {"stage1": res.stage1_images, "stage2": res.stage2_images,
            "vertices": res.vertices, "faces": res.faces, "mesh_path": res.mesh_path,
            "data": meshes.axis_size(pipe.zero123.mesh, "data")}
