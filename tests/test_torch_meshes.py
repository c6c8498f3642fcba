"""one2345_tpu_torch.core.meshes and the sharded Zero123 train step on a
world of 4 gloo ranks (spawned once for the module), against the JAX
package on its virtual 8-device CPU mesh: ``create_mesh``'s sizes,
``shard_batch``'s rows against JAX's addressable shards, ``replicate``,
``pad_to_multiple``, ``select_stage1b_plan``; two steps of
``make_sharded_train_step`` on a (data=2, model=2) mesh with the
parameters sharded (FSDP2), and on (4, 1) with them whole, against JAX's
on ``jax.devices()[:4]`` as (2, 2), with JAX's draws; ``train_zero123.main --model_shards 2`` on the
four ranks, its checkpoint loaded ``strict=True`` by a one-rank trainer."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from one2345_tpu.core.meshes import create_mesh as jax_create_mesh
from one2345_tpu.core.meshes import pad_to_multiple as jax_pad_to_multiple
from one2345_tpu.diffusion import zero123 as jax_z
from one2345_tpu.pipeline.runner import select_stage1b_plan as jax_plan
from one2345_tpu.training.zero123_trainer import Zero123Trainer as JaxTrainer
from one2345_tpu_torch.core import checkpoint, meshes
from one2345_tpu_torch.diffusion import zero123 as port_z
from one2345_tpu_torch.pipeline.runner import select_stage1b_plan
from one2345_tpu_torch.training import data
from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer
from one2345_tpu_torch.utils.convert_jax import trainable_from_jax, zero123_from_jax
from one2345_tpu_torch.utils.png import write_png
from tests.torch_dist_workers import World
from tests.torch_port_helpers import randomize, tiny_config

B = 4  # the global batch: 2 rows per data rank
NOISE_GRAD = 1e-6  # tests/test_torch_training.py: rounding noise of a zero gradient


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
    w = World(4, tmp_path_factory.mktemp("gloo4"))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _full_matmul_precision():
    with jax.default_matmul_precision("highest"):
        yield


# ---------------------------------------------------------------- meshes
def test_create_mesh_refuses_sizes_that_are_not_the_world():
    with pytest.raises(ValueError, match=r"mesh \(2, 2\) != 1 devices"):
        meshes.create_mesh(("data", "model"), (2, 2))
    with pytest.raises(ValueError):
        jax_create_mesh(("data", "model"), (2, 2), devices=jax.devices()[:1])
    # a world of one without a process group has nothing to build a mesh on
    with pytest.raises(RuntimeError, match="process group"):
        meshes.create_mesh(("data",))
    assert meshes.world_size() == 1 and meshes.rank() == 0


@pytest.mark.parametrize("names,sizes", [(("data",), (4,)), (("data", "model"), (2, 2)),
                                         (("data", "model"), (1, 4))])
def test_shard_batch_rows_are_jax_s_addressable_shards(world, names, sizes):
    n_rows = 8
    out = world.run("mesh_rows", names, sizes, n_rows)
    jmesh = jax_create_mesh(names, sizes, devices=jax.devices()[:4])
    x = np.arange(n_rows * 2).reshape(n_rows, 2)
    arr = jax.device_put(x, NamedSharding(jmesh, P("data")))
    ids = [d.id for d in jax.devices()[:4]]
    for shard in arr.addressable_shards:
        r = ids.index(shard.device.id)
        rank, coord, rows, replicated = out[r]
        assert rank == r
        np.testing.assert_array_equal(rows, np.asarray(shard.data))
        # the data coordinate is the mesh row of the rank, as in JAX's device grid
        assert coord == int(np.argwhere(jmesh.devices == shard.device)[0][0])
        np.testing.assert_array_equal(replicated, np.zeros(3, np.float32))  # rank 0's


def test_shard_batch_refuses_an_uneven_batch():
    class Two:
        mesh_dim_names = ("data",)

        def size(self, _):
            return 2

        def get_local_rank(self, _):
            return 1

    got = meshes.shard_batch(Two(), {"a": np.arange(6), "b": [torch.arange(4)]})
    np.testing.assert_array_equal(got["a"], [3, 4, 5])
    assert torch.equal(got["b"][0], torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="does not shard"):
        meshes.shard_batch(Two(), {"a": np.arange(5)})


def test_pad_to_multiple_and_specs_match_jax():
    for n in range(0, 20):
        for m in (1, 2, 3, 4, 8):
            assert meshes.pad_to_multiple(n, m) == jax_pad_to_multiple(n, m)
    from torch.distributed.tensor import Replicate, Shard

    assert meshes.batch_spec() == (Shard(0),) and meshes.replicated_spec() == (Replicate(),)


@pytest.mark.parametrize("n_data", [1, 2, 8])
@pytest.mark.parametrize("polar", [30.0, 80.0])
def test_select_stage1b_plan_matches_jax(n_data, polar):
    sample, ring, second = select_stage1b_plan(polar, n_data)
    jsample, jring, jsecond = jax_plan(polar, n_data)
    assert (sample, ring, second) == (jsample, jring, jsecond)
    assert sample[ring] == second
    assert sample == (list(range(4, 12)) if n_data == 8 else second)


# ------------------------------------------------------ sharded Zero123 step
@pytest.fixture(scope="module")
def zero123():
    # the tree's structure without compiling an init: randomize redraws every leaf
    jst = jax_z.Zero123Stage(tiny_config(torch_side=False), params={})
    jst.params = randomize(jax.eval_shape(jst.init_params, jax.random.key(0)), seed=41)
    rng = np.random.default_rng(0)
    cams = []
    for _ in range(2 * B):
        c2w = np.eye(4)
        c2w[:3, 3] = rng.normal(size=3) * 1.5
        cams.append(c2w)
    batch = {
        "image_target": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "image_cond": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "T": np.stack([data.relative_pose_token(cams[i], cams[B + i])
                       for i in range(B)])[:, None, :],
    }
    return jst, batch


def _jax_draws(key):
    """The draws of the JAX loss_fn for ``key`` on the global batch."""
    k_t, k_noise, k_z, k_drop1, _ = jax.random.split(key, 5)
    return {
        "t": np.asarray(jax.random.randint(k_t, (B,), 0, 1000)),
        "noise": np.asarray(jax.random.normal(k_noise, (B, 4, 4, 4))),
        "z_eps": np.asarray(jax.random.normal(k_z, (B, 4, 4, 4))),
        "u": np.asarray(jax.random.uniform(k_drop1, (B,))),
    }


def _key_with_some_dropout():
    for seed in range(100):
        key = jax.random.key(seed)
        u = np.asarray(jax.random.uniform(jax.random.split(key, 5)[3], (B,)))
        if (u < 0.15).any() and (u >= 0.15).any():
            return key
    raise AssertionError("no key with mixed dropout")


def _numpy_sd(tree):
    return {m: {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in d.items()} for m, d in tree.items()}


BASE_LR = 1e-2  # lifts the updates well above the f32 rounding of the weights
_JAX_STEPS = {}  # the JAX reference of the sharded steps, computed once


def _jax_two_steps(jst, batch, keys):
    """(losses, params, EMA) of two JAX sharded steps on (data=2, model=2)
    over four virtual devices, compiled at XLA's lowest optimisation level
    (a third of the compile, the same f32 math)."""
    if not _JAX_STEPS:
        jt = JaxTrainer(jst, remat=False, base_lr=BASE_LR)
        jmesh = jax_create_mesh(("data", "model"), (2, 2), devices=jax.devices()[:4])
        step, state_sh, frozen_sh = jt.make_sharded_train_step(jmesh, shard_params=True)
        state = jax.device_put(jt.init_state(), state_sh)
        frozen = jax.device_put({k: jst.params[k] for k in ("encoder", "clip")}, frozen_sh)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        step = step.lower(state, frozen, jbatch, keys[0]).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        losses = []
        for key in keys:
            state, loss = step(state, frozen, jbatch, key)
            losses.append(float(loss))
        _JAX_STEPS.update(losses=losses, params=state.params, ema=state.ema_params)
    return _JAX_STEPS


@pytest.mark.parametrize("sizes,shard_params", [((2, 2), True), ((4, 1), False)])
def test_sharded_train_step_matches_jax(world, zero123, sizes, shard_params):
    """Two sharded steps on (data=2, model=2) with the parameters sharded
    (FSDP2), and on (data=4, model=1) with them whole and the gradients
    all-reduced, against the JAX sharded step on (2, 2) over four virtual
    devices (the same math): the losses within 1e-5, each tensor's update
    and EMA change within 5e-3 relative L2 (the bounds of
    tests/test_torch_training.py's unsharded steps).  The four ranks gather
    the same whole weights, and each holds its model shard."""
    jst, batch = zero123
    keys = (_key_with_some_dropout(), jax.random.key(1000))
    trainable = {"unet": jst.params["unet"], "cc_projection": jst.params["cc_projection"]}
    world.submit("zero123_sharded_steps", sizes, _numpy_sd(zero123_from_jax(jst.params)),
                 _numpy_sd(trainable_from_jax(trainable)), batch,
                 [_jax_draws(k) for k in keys], BASE_LR, shard_params)
    ref = _jax_two_steps(jst, batch, keys)
    out = world.collect("zero123_sharded_steps")
    for r in out:
        assert r["step"] == 2
        for got, want in zip(r["losses"], ref["losses"]):
            assert abs(got - want) < 1e-5 * want
    total = sum(v.size for d in out[0]["params"].values() for v in d.values())
    assert all(abs(r["local_numel"] - total / sizes[1]) <= 0.05 * total for r in out)
    for r in out[1:]:  # every rank gathers the same whole weights
        for name, sd in r["params"].items():
            for k, v in sd.items():
                np.testing.assert_array_equal(v, out[0]["params"][name][k])
                np.testing.assert_array_equal(r["ema"][name][k], out[0]["ema"][name][k])

    def tree(x):
        return _numpy_sd(trainable_from_jax(jax.tree_util.tree_map(np.asarray, x)))

    p0, p_ref, ema_ref = tree(trainable), tree(ref["params"]), tree(ref["ema"])
    got_p, got_ema, grad_max = out[0]["params"], out[0]["ema"], out[0]["grad_max"]
    lr_sum = {"unet": BASE_LR * 0.010001, "cc_projection": 10 * BASE_LR * 0.010001}
    n_real = 0
    for name in p0:
        for k, w0 in p0[name].items():
            pairs = ((got_p[name][k] - w0, p_ref[name][k] - w0),
                     (got_ema[name][k] - w0, ema_ref[name][k] - w0))
            if grad_max[name][k] <= NOISE_GRAD:
                # Adam turns rounding noise into steps of either sign: hold
                # both sides to the size of an Adam step only
                for got, want in pairs:
                    assert np.abs(got).max() <= 3 * lr_sum[name]
                    assert np.abs(want).max() <= 3 * lr_sum[name]
                continue
            n_real += 1
            for got, want in pairs:
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel < 5e-3, (name, k, rel)
    assert n_real > 200


# ------------------------------------------------------------- the CLI
def _views(root: str, n_obj: int, n_views: int, size: int, seed: int = 0):
    """Per-object view folders (RGBA PNGs and 4x4 cameras) for the CLI."""
    rng = np.random.default_rng(seed)
    for o in range(n_obj):
        d = os.path.join(root, f"obj{o}")
        os.makedirs(d)
        for v in range(n_views):
            img = rng.integers(0, 256, (size, size, 4)).astype(np.uint8)
            img[..., 3] = 255
            write_png(os.path.join(d, f"{v:03d}.png"), img)
            c2w = np.eye(4)
            c2w[:3, 3] = rng.normal(size=3) + [0, 0, 2.0]
            np.save(os.path.join(d, f"{v:03d}.npy"), c2w)


def test_main_shards_the_parameters_over_four_ranks(world, tmp_path, zero123):
    """``--model_shards 2`` on four ranks: a (2, 2) mesh, rank 0 writes the
    metrics, the EMA sample grid and the checkpoints, which hold whole
    state dicts that a one-rank trainer loads with strict=True."""
    root, exp = str(tmp_path / "views"), str(tmp_path / "exp")
    _views(root, n_obj=3, n_views=3, size=32)
    out = world.run("train_zero123_main",
                    ["--data_root", root, "--batch_size", "4", "--max_steps", "2",
                     "--log_every", "1", "--ckpt_every", "100", "--sample_every", "1",
                     "--sample_views", "2", "--sample_steps", "2", "--total_views", "3",
                     "--model_shards", "2", "--exp_dir", exp])
    assert [r["step"] for r in out] == [2] * 4
    assert sorted(os.listdir(exp)) == ["metrics.jsonl", "samples", "step_000002"]
    # the EMA grid: the ranks gather the sharded EMA, rank 0 samples and writes
    assert os.listdir(os.path.join(exp, "samples")) == ["step_000001.png"]
    with open(os.path.join(exp, "metrics.jsonl")) as fh:
        assert len(fh.readlines()) == 2  # rank 0 alone logs
    state = checkpoint.restore(os.path.join(exp, "step_000002"))
    stage = port_z.Zero123Stage(tiny_config(torch_side=True), device="cpu")
    one = Zero123Trainer(stage, state, device="cpu")  # strict=True
    seeded = port_z.Zero123Stage(tiny_config(torch_side=True), device="cpu")
    moved = [not torch.equal(v, seeded.unet.state_dict()[k]) for k, v in state["unet"].items()]
    assert any(moved)  # two AdamW steps moved the seeded weights
    for name, module in one.modules.items():
        for k, v in module.state_dict().items():
            assert torch.equal(v, state[name][k])


# ---------------------------------------------------------- the plumbing
def test_without_torchrun_no_group_starts_and_the_card_is_the_default(monkeypatch):
    import torch.distributed as dist

    from one2345_tpu_torch.core.device import resolve_device

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with meshes.process_group("cpu") as dev:
        assert dev == torch.device("cpu") and not dist.is_initialized()
    assert meshes.init_process_group("cpu") == torch.device("cpu") and not dist.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "1")  # torchrun's: rank 1's card is cuda:1
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        meshes.init_process_group()


def test_spawned_ranks_import_no_jax():
    """The ranks import tests/torch_dist_workers.py (anywhere in it) and
    tests/torch_port_helpers.py (at module level; its functions that build
    the JAX side are not called there): torch, numpy, the standard
    library, the port and tests.torch_port_helpers only, or each rank
    would start JAX."""
    import ast

    here = os.path.dirname(os.path.abspath(__file__))
    for name, whole in (("torch_dist_workers.py", True), ("torch_port_helpers.py", False)):
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        roots = set()
        for node in (ast.walk(tree) if whole else tree.body):
            if isinstance(node, ast.Import):
                roots |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots.add(node.module)
        tops = {r.split(".")[0] for r in roots}
        assert tops <= {"__future__", "os", "traceback", "functools", "contextlib", "io",
                        "json", "threading", "urllib", "http", "datetime", "numpy", "torch",
                        "one2345_tpu_torch", "tests"}, (name, tops)
        assert {r for r in roots if r.startswith("tests")} <= {"tests.torch_port_helpers"}
