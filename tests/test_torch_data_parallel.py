"""The port's data-parallel paths on a world of 2 gloo ranks (spawned once
for the module), against the JAX package on its virtual CPU mesh:
``ReconTrainer.make_sharded_train_step``, one scene per rank, against
JAX's on a 2-device ``data`` mesh (two steps, JAX's draws per scene: the
metrics, the parameters, the running statistics averaged over the
ranks); ``train_recon.main`` on the two ranks, its checkpoint loaded by a
one-rank trainer; the view-batch sharded stage 1 (8 views, 4 views padded
to the mesh, and dpmpp) against the unsharded JAX stage with JAX's noise,
as tests/test_multichip_inference.py holds the sharded JAX stage."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.core.config import ReconConfig as JaxReconConfig
from one2345_tpu.core.meshes import create_mesh as jax_create_mesh
from one2345_tpu.diffusion import zero123 as jax_z
from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
from one2345_tpu.training.recon_trainer import ReconTrainer as JaxReconTrainer
from one2345_tpu_torch.core import checkpoint
from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.recon.pipeline import ReconStage
from one2345_tpu_torch.training.recon_trainer import ReconTrainer
from one2345_tpu_torch.utils.convert_jax import recon_from_jax, zero123_from_jax
from tests.test_torch_recon_train import LOSS_TOL, TINY, jax_draws
from tests.test_torch_train_recon_cli import write_scene
from tests.torch_dist_workers import World
from tests.torch_port_helpers import (max_err, randomize, recon_test_params, tiny_config,
                                      tiny_recon_scene)

N_RANKS = 2
CFG = dict(TINY, num_lods=1, learning_rate=1e-3, end_iter=10)
IMG_TOL = 2e-3  # max abs of a sampled image, tests/test_torch_zero123.py's


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side, and this
    process's ranks run beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N_RANKS, tmp_path_factory.mktemp("gloo2"), threads=2)
    yield w
    w.close()


@pytest.fixture(scope="module", autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


# ------------------------------------------------- sharded reconstruction step
def test_sharded_recon_step_matches_jax_on_a_data_mesh(world):
    """Two steps of two scenes, one per rank, against the JAX step's vmap
    over the two scenes on a 2-device ``data`` mesh: the metrics (means
    over the scenes) within LOSS_TOL, every element of the parameters
    within 4 lr of JAX's and at most 0.5% of them beyond 0.1 lr, and the
    running statistics (the mean of the ranks') within 1e-4: the bounds of
    tests/test_torch_recon_train.py::test_two_train_steps_match_jax."""
    params = recon_test_params(CFG, seed=3)
    scenes = [tiny_recon_scene(N=TINY["n_rays"], spread=0.05, seed=s) for s in range(N_RANKS)]
    keys = [jax.random.key(20 + i) for i in range(2)]
    # the JAX step gives scene s of a step the draws of split(key, n)[s]
    draws = [[_numpy(jax_draws(k, TINY["n_rays"], TINY["n_samples"],
                               TINY["normal_query_prob"], (0,)))
              for k in jax.random.split(key, N_RANKS)] for key in keys]
    world.submit("recon_sharded_steps", CFG, _numpy(recon_from_jax(params)), scenes, draws)
    jtr = JaxReconTrainer(JaxReconStage(JaxReconConfig(**CFG), params=params))
    mesh = jax_create_mesh(("data",), (N_RANKS,), devices=jax.devices()[:N_RANKS])
    step, state_sh = jtr.make_sharded_train_step(mesh)
    state = jax.device_put(jtr.init_state(), state_sh)
    stacked = {k: jnp.asarray(np.stack([s[k] for s in scenes])) for k in scenes[0]}
    step = step.lower(state, stacked, keys[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    jmetrics = []
    for key in keys:
        state, m = step(state, stacked, key)
        jmetrics.append({k: float(v) for k, v in m.items()})
    out = world.collect("recon_sharded_steps")
    for r in out:
        assert r["step"] == 2
        for got, ref in zip(r["metrics"], jmetrics):
            assert set(got) == set(ref)
            for k, v in ref.items():
                assert abs(float(got[k]) - v) <= LOSS_TOL * abs(v) + 1e-7, k
    for name, sd in out[1]["params"].items():  # the ranks hold one state
        for k, v in sd.items():
            np.testing.assert_array_equal(v, out[0]["params"][name][k])
    ref = recon_from_jax({k: {"params": state.params[k], "batch_stats": state.batch_stats[k]}
                          for k in state.params})
    lr, off, total = CFG["learning_rate"], 0, 0
    for key, sd in out[0]["params"].items():
        for name, v in sd.items():
            d = np.abs(v - ref[key][name].numpy())
            if "running" in name:
                assert d.max() <= 1e-4, (key, name)
                continue
            off += int(np.sum(d > 0.1 * lr))
            total += d.size
            assert d.max() <= 4 * lr, (key, name)
    assert off <= 0.005 * total, (off, total)
    # the statistics are the mean of two scenes': neither scene's alone
    one = ReconTrainer(ReconStage(ReconConfig(**CFG), params=recon_from_jax(params), device="cpu"))
    one.scene_loss(scenes[0], 0, {k: torch.as_tensor(v) for k, v in draws[0][0].items()})
    mean = one.modules["fusion"].state_dict()["fpn.ConvBnAct_0.BatchNorm_0.running_mean"]
    start = recon_from_jax(params)["fusion"]["fpn.ConvBnAct_0.BatchNorm_0.running_mean"]
    ranks = out[0]["params"]["fusion"]["fpn.ConvBnAct_0.BatchNorm_0.running_mean"]
    assert max_err(mean, start) > 1e-3 and float(np.abs(mean.numpy() - ranks).max()) > 1e-4


def test_train_recon_main_trains_a_scene_per_rank(world, tmp_path):
    """``train_recon.main`` on two ranks (the checkpoint's ``step`` counts
    steps, each of two scenes; the reader scales the views to 256^2, so one
    step); rank 0 writes the metrics and checkpoints, which a one-rank
    trainer loads strict=True."""
    root = tmp_path / "scenes"
    write_scene(str(root), "shape0", 45.0, 32, 1)
    write_scene(str(root), "shape1", 100.0, 32, 2)
    exp = str(tmp_path / "exp")
    cut = dict(vol_dims=(8, 8, 8), voxel_size=2.0 / 7.0, n_samples=4, n_importance=4,
               image_hw=(32, 32))
    out = world.run("train_recon_main",
                    ["--data_root", str(root), "--n_rays", "16", "--max_steps", "1",
                     "--ckpt_every", "100", "--log_every", "1", "--exp_dir", exp], cut)
    assert [r["step"] for r in out] == [1, 1]
    assert sorted(os.listdir(exp)) == ["metrics.jsonl", "step_000001"]
    with open(os.path.join(exp, "metrics.jsonl")) as fh:
        assert len(fh.readlines()) == 1  # rank 0 alone logs
    state = checkpoint.restore(os.path.join(exp, "step_000001"))
    cfg = ReconConfig(**cut, n_rays=16, end_iter=1)
    one = ReconTrainer(ReconStage(cfg, device="cpu"), cfg)
    one.load_state_dict(state)  # strict=True
    assert one.step == 1
    for key, module in one.modules.items():
        for name, t in module.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), out[1]["params"][key][name])


# ------------------------------------------------------- sharded stage 1
def _input_image():
    """tests/test_torch_zero123.py's: a seeded blob on white, 32^2."""
    img = np.ones((32, 32, 3), np.float32)
    yy, xx = np.mgrid[:32, :32]
    blob = (yy - 15.5) ** 2 + (xx - 15.5) ** 2 < 100
    img[blob] = np.random.default_rng(4).uniform(0.1, 0.9, size=(int(blob.sum()), 3))
    return img


@pytest.fixture(scope="module")
def zero123():
    jst = jax_z.Zero123Stage(tiny_config(torch_side=False), params={})
    jst.params = randomize(jax.eval_shape(jst.init_params, jax.random.key(0)), seed=31)
    return jst, _input_image()


def _noise_table(jst, key, draws: int):
    ids = jnp.arange(12, dtype=jnp.uint32)
    return [np.asarray(jst._per_view_noise(key, ids, d, (4, 4, 4))) for d in range(draws)]


@pytest.mark.parametrize("sampler,steps", [("ddim", 2), ("dpmpp", 3)])
def test_sharded_stage1_matches_the_unsharded_jax_stage(world, zero123, sampler, steps):
    """Stage 1 on the 2-rank ``data`` mesh against the unsharded JAX stage:
    with ddim 8 views (4 per rank) and views [0, 1, 2] (3 views padded to
    4 by repeating the last), with dpmpp 4 views; every rank returns the
    whole batch."""
    jst, img = zero123
    key = jax.random.key(1)
    jst.config = tiny_config(torch_side=False).replace(sampler=sampler)
    noise = _noise_table(jst, key, steps + 2)
    params = _numpy(zero123_from_jax(jst.params))
    cases = [list(range(8)), [0, 1, 2]] if sampler == "ddim" else [[0, 1, 2, 3]]
    world.submit("zero123_stage1", params, sampler, img, cases[0], steps, noise)
    ref = np.asarray(jst.stage1(img, key, indices=list(range(8)), steps=steps))
    for i, idx in enumerate(cases):
        out = (world.collect("zero123_stage1") if i == 0
               else world.run("zero123_stage1", params, sampler, img, idx, steps, noise))
        inside = float(np.mean((ref > 0.01) & (ref < 0.99)))
        assert inside > 0.2  # not saturated: the comparison has teeth
        for r in out:
            assert r.shape == (len(idx), 32, 32, 3)
            assert max_err(r, ref[idx]) < IMG_TOL, (sampler, idx)


# ------------------------------------------------------------ the runner
def test_runner_shards_its_view_batches_over_the_ranks(world, tmp_path):
    """``One2345Pipeline`` on two ranks builds its ``data`` mesh itself
    (``auto_mesh``: 8 % 2 == 0), samples each stage's views two by two
    ranks, and every rank ends with the one-rank run's stage images (f32:
    within 1e-5) and mesh; rank 0 alone writes the artifacts."""
    from tests.torch_dist_workers import tiny_pipeline

    img = _input_image()
    world.submit("pipeline_run", img, str(tmp_path / "out"))
    one = tiny_pipeline()
    assert one.zero123.mesh is None  # one process: no mesh, nothing changes
    ref = one.run(img, skip_preprocess=True, seed=0)
    out = world.collect("pipeline_run")
    assert [r["data"] for r in out] == [2, 2]
    for r in out:
        assert max_err(r["stage1"], ref.stage1_images) < 1e-5
        assert max_err(r["stage2"], ref.stage2_images) < 1e-5
        assert r["faces"].shape == ref.faces.shape and len(ref.faces) > 0
        assert max_err(r["vertices"], ref.vertices) < 1e-4
    assert out[0]["mesh_path"] == str(tmp_path / "out" / "mesh.obj")
    assert out[1]["mesh_path"] is None
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == ["mesh.obj", "mesh.ply", "pose.json", "stage1_8", "stage2_8"]
