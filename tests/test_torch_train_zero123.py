"""one2345_tpu_torch.training.{data,train_zero123} against the JAX package,
CPU: the Zero123 readers (per-object folders and tar shards) give the JAX
readers' batches bit for bit (256^2 as stored, and through PIL's LANCZOS
resize; RGBA and RGB; the shuffle buffer and its draining), ``log_samples``
gives JAX's EMA grid with JAX's noise injected, and a tiny
``main(..., device='cpu')`` run writes its metrics, checkpoints and grids.
The tiny Zero123 config replaces ``DiffusionConfig()`` through
``train_zero123.build_config``."""

import io
import json
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from one2345_tpu.diffusion import zero123 as jax_z
from one2345_tpu.training import data as jdata
from one2345_tpu.training import train_zero123 as jtz
from one2345_tpu.training.zero123_trainer import TrainState
from one2345_tpu_torch.core import checkpoint
from one2345_tpu_torch.diffusion import zero123 as port_z
from one2345_tpu_torch.training import data, train_zero123
from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer
from one2345_tpu_torch.utils.convert_jax import trainable_from_jax, zero123_from_jax
from one2345_tpu_torch.utils.png import read_png
from tests.torch_port_helpers import randomize, tiny_config

GRID_TOL = 2e-3  # max abs, the sampled row in [0, 1], port f32 against JAX f32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def _png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA" if img.shape[-1] == 4 else "RGB").save(buf, "PNG")
    return buf.getvalue()


def _view(rng, size: int, channels: int) -> np.ndarray:
    """A seeded render: smooth colours, an alpha disc with soft edges."""
    yy, xx = np.mgrid[:size, :size] / size
    img = np.stack([xx, yy, 0.5 + 0.5 * np.sin(7 * xx * yy)], -1) * 255 * rng.uniform(0.5, 1)
    img = img + rng.integers(0, 30, img.shape)
    if channels == 4:
        a = np.clip(255 * (1.6 - 4 * np.hypot(xx - 0.5, yy - 0.5)), 0, 255)
        img = np.concatenate([img, a[..., None]], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _camera(rng) -> np.ndarray:
    c2w = np.eye(4)
    c2w[:3, 3] = rng.normal(size=3) + [0, 0, 2.0]
    return c2w[:3, :4] if rng.uniform() < 0.5 else c2w


def _folders(root: str, n_obj: int, n_views: int, size: int, channels: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    for o in range(n_obj):
        d = os.path.join(root, f"obj{o}")
        os.makedirs(d)
        for v in range(n_views):
            with open(os.path.join(d, f"{v:03d}.png"), "wb") as fh:
                fh.write(_png(_view(rng, size, channels)))
            np.save(os.path.join(d, f"{v:03d}.npy"), _camera(rng))


def _shards(root: str, n_shards: int, per_shard: int, n_views: int, size: int,
            channels: int = 4, seed: int = 1, broken: bool = False) -> list[str]:
    """Shards of ``per_shard`` objects; with ``broken`` the last object of
    each shard has one view only (skipped by both readers) and a stray
    member outside any object folder."""
    rng = np.random.default_rng(seed)
    paths = []

    def add(tf, name, payload):
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        tf.addfile(info, io.BytesIO(payload))

    for s in range(n_shards):
        path = os.path.join(root, f"shard_{s:03d}.tar")
        with tarfile.open(path, "w") as tf:
            if broken:
                add(tf, "README", b"stray")
            for o in range(per_shard):
                views = 1 if broken and o == per_shard - 1 else n_views
                for v in range(views):
                    add(tf, f"uid{s}_{o}/{v:03d}.png", _png(_view(rng, size, channels)))
                    buf = io.BytesIO()
                    np.save(buf, _camera(rng))
                    add(tf, f"uid{s}_{o}/{v:03d}.npy", buf.getvalue())
        paths.append(path)
    return paths


def _equal_batches(a, b):
    assert set(a) == set(b) == {"image_cond", "image_target", "T"}
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------- readers
@pytest.mark.parametrize("size,image_size,channels", [
    (256, 256, 4), (40, 32, 4), (40, 32, 3), (24, 32, 4)],
    ids=["256-rgba", "lanczos-down-rgba", "lanczos-down-rgb", "lanczos-up-rgba"])
def test_views_dataset_matches_jax(tmp_path, size, image_size, channels):
    _folders(str(tmp_path), n_obj=3, n_views=5, size=size, channels=channels)
    ours = data.ObjaverseViewsDataset(str(tmp_path), total_views=5, image_size=image_size,
                                      seed=3)
    ref = jdata.ObjaverseViewsDataset(str(tmp_path), total_views=5, image_size=image_size,
                                      seed=3)
    assert len(ours) == len(ref) == 3 and ours.paths == ref.paths
    it, jit = ours.batches(3), ref.batches(3)
    for _ in range(2):
        _equal_batches(next(it), next(jit))
    _equal_batches({k: v[None] for k, v in ours.sample(1).items()},
                   {k: v[None] for k, v in ref.sample(1).items()})


@pytest.mark.parametrize("channels", [4, 3])
@pytest.mark.parametrize("shuffle_buffer", [1, 4, 100])
def test_tar_shards_match_jax(tmp_path, shuffle_buffer, channels):
    shards = _shards(str(tmp_path), 2, 3, 3, size=20, channels=channels)
    kw = dict(image_size=16, shuffle_buffer=shuffle_buffer, seed=5)
    ours, ref = data.ObjaverseTarShards(shards, **kw), jdata.ObjaverseTarShards(shards, **kw)
    it, jit = ours.batches(4), ref.batches(4)
    for _ in range(4):  # past one pass over the 6 objects: the shards are reshuffled
        _equal_batches(next(it), next(jit))


@pytest.mark.parametrize("shuffle_buffer", [2, 100])
def test_tar_shards_drain_as_jax(tmp_path, shuffle_buffer):
    """One pass (loop=False): both readers give the same samples in the same
    order, the buffer drained at the end, the one-view objects and the stray
    member skipped."""
    shards = _shards(str(tmp_path), 2, 4, 3, size=16, broken=True)
    kw = dict(image_size=16, shuffle_buffer=shuffle_buffer, loop=False, seed=2)
    ours = list(data.ObjaverseTarShards(shards, **kw).samples())
    ref = list(jdata.ObjaverseTarShards(shards, **kw).samples())
    assert len(ours) == len(ref) == 6  # 2 shards x 3 objects with two views or more
    for a, b in zip(ours, ref):
        _equal_batches({k: v[None] for k, v in a.items()}, {k: v[None] for k, v in b.items()})
    # the port's batches end with the samples; JAX's generator raises
    # RuntimeError there (a StopIteration inside a generator, PEP 479)
    batches = list(data.ObjaverseTarShards(shards, **kw).batches(4))
    assert [len(b["T"]) for b in batches] == [4]
    with pytest.raises(RuntimeError):
        list(jdata.ObjaverseTarShards(shards, **kw).batches(4))


def test_tar_shards_need_shards():
    with pytest.raises(ValueError):
        data.ObjaverseTarShards([])


def test_port_objaverse_dataset_batches(tmp_path):
    """tests/test_data.py's checks on the port's readers."""
    _folders(str(tmp_path / "f"), 2, 4, 32, 4)
    ds = data.ObjaverseViewsDataset(str(tmp_path / "f"), total_views=4, image_size=32)
    batch = next(ds.batches(3))
    assert batch["image_target"].shape == batch["image_cond"].shape == (3, 32, 32, 3)
    assert batch["T"].shape == (3, 1, 4)
    assert batch["image_target"].min() >= -1.0 and batch["image_target"].max() <= 1.0
    pf = data.Prefetcher(ds.batches(2))
    assert next(pf)["T"].shape == (2, 1, 4)
    pf.close()
    shards = _shards(str(tmp_path), 2, 3, 3, size=16)
    batch = next(data.ObjaverseTarShards(shards, image_size=16, shuffle_buffer=4).batches(5))
    assert batch["image_target"].shape == (5, 16, 16, 3) and batch["T"].shape == (5, 1, 4)
    ds2 = data.ObjaverseTarShards(shards, image_size=16, shuffle_buffer=100, loop=False)
    assert sum(1 for _ in ds2.samples()) == 6


# ------------------------------------------------------------ log_samples
@pytest.fixture(scope="module")
def stages():
    jst = jax_z.Zero123Stage(tiny_config(torch_side=False), seed=0)
    jst.params = randomize(jst.params, seed=41)
    pst = port_z.Zero123Stage(tiny_config(torch_side=True), params=zero123_from_jax(jst.params),
                              device="cpu")
    return jst, pst


def _jax_noise(jst, key):
    def noise_fn(draw, view_ids, shape):
        return np.array(jst._per_view_noise(key, jnp.asarray(view_ids, jnp.uint32), draw, shape))

    return noise_fn


def test_log_samples_matches_jax(stages, tmp_path):
    jst, pst = stages
    trainable = {"unet": jst.params["unet"], "cc_projection": jst.params["cc_projection"]}
    ema = randomize(trainable, seed=52)  # EMA weights that differ from the stage's
    state = TrainState(params=trainable, ema_params=ema, opt_state=None, step=jnp.zeros((),
                                                                                        jnp.int32))
    trainer = Zero123Trainer(pst, trainable_from_jax(trainable), device="cpu")
    for name, sd in trainable_from_jax(ema).items():
        for k, v in sd.items():
            trainer.ema[name][k].copy_(v)
    rng = np.random.default_rng(0)
    B, S = 3, 32
    batch = {
        "image_cond": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        "image_target": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        "T": rng.normal(0, 1, (B, 1, 4)).astype(np.float32),
    }
    seen = {}
    jax_sample = jst._sample_views_jit

    def keep_jax(*args, **kw):
        seen["jax"] = np.asarray(jax_sample(*args, **kw))
        return seen["jax"]

    port_sample = pst.sample_tokens

    def keep_port(*args, **kw):
        seen["port"] = port_sample(*args, **kw).numpy()
        return torch.from_numpy(seen["port"])

    jst._sample_views_jit, pst.sample_tokens = keep_jax, keep_port
    before = {n: {k: v.clone() for k, v in getattr(pst, n).state_dict().items()}
              for n in port_z.MODULES}
    weights = [p.detach().clone() for p in trainer._params] + [
        e.clone() for e in trainer._ema_list]
    try:
        jtz.log_samples(jst, state, batch, str(tmp_path / "jax.png"), steps=3, seed=7)
        out = train_zero123.log_samples(pst, trainer, batch, str(tmp_path / "port.png"), steps=3,
                                        seed=7, noise_fn=_jax_noise(jst, jax.random.key(7)))
    finally:
        del jst._sample_views_jit, pst.sample_tokens
    assert out == str(tmp_path / "port.png")
    assert seen["port"].shape == seen["jax"].shape == (B, S, S, 3)
    err = float(np.abs(seen["port"] - seen["jax"]).max())
    assert err <= GRID_TOL, err
    grid, jgrid = read_png(out), np.asarray(Image.open(tmp_path / "jax.png"))
    assert grid.shape == jgrid.shape == (3 * S, B * S, 3)
    np.testing.assert_array_equal(grid[:S], jgrid[:S])  # conditioning row
    np.testing.assert_array_equal(grid[2 * S:], jgrid[2 * S:])  # target row
    assert int(np.abs(grid.astype(int) - jgrid).max()) <= 1  # the samples, truncated to 8 bits
    # the stage's and the trainer's weights are as they were
    for n in port_z.MODULES:
        for k, v in getattr(pst, n).state_dict().items():
            assert torch.equal(v, before[n][k]), (n, k)
    now = [p.detach() for p in trainer._params] + list(trainer._ema_list)
    assert all(torch.equal(a, b) for a, b in zip(now, weights, strict=True))
    # the EMA weights were the ones sampled: the stage's own give another grid
    own = pst.sample_tokens(batch["image_cond"], batch["T"], 7, steps=3,
                            noise_fn=_jax_noise(jst, jax.random.key(7))).numpy()
    assert float(np.abs(own - seen["port"]).max()) > 10 * GRID_TOL


# ------------------------------------------------------------------ main
def test_parser_matches_jax():
    ours, ref = train_zero123.build_parser(), jtz.build_parser()
    a = {x.dest: (x.default, x.type, x.required) for x in ours._actions if x.dest != "help"}
    b = {x.dest: (x.default, x.type, x.required) for x in ref._actions if x.dest != "help"}
    assert a == b


@pytest.fixture()
def tiny_main(monkeypatch, stages, tmp_path):
    jst, _ = stages
    monkeypatch.setattr(train_zero123, "build_config", lambda: tiny_config(torch_side=True))
    init = tmp_path / "init.pt"
    checkpoint.save(str(init), zero123_from_jax(jst.params))
    return str(init)


@pytest.mark.parametrize("source", ["folders", "shards", "glob"])
def test_main_runs_on_the_cpu(tmp_path, tiny_main, source):
    if source == "folders":
        root = str(tmp_path / "views")
        _folders(root, n_obj=3, n_views=4, size=40, channels=4)
    else:
        os.makedirs(tmp_path / "shards")
        _shards(str(tmp_path / "shards"), 2, 3, 3, size=40)
        root = str(tmp_path / "shards" / ("" if source == "shards" else "shard_*.tar"))
    exp = str(tmp_path / "exp")
    trainer = train_zero123.main(
        ["--data_root", root, "--init_params", tiny_main, "--batch_size", "2", "--max_steps", "3",
         "--log_every", "1", "--ckpt_every", "2", "--sample_every", "2", "--sample_views", "2",
         "--sample_steps", "2", "--total_views", "4", "--exp_dir", exp], device="cpu")
    assert trainer.step == 3
    with open(os.path.join(exp, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["samples_per_sec"] > 0 for r in recs)
    assert sorted(os.listdir(exp)) == ["metrics.jsonl", "samples", "step_000002", "step_000003"]
    assert os.listdir(os.path.join(exp, "samples")) == ["step_000002.png"]
    assert read_png(os.path.join(exp, "samples", "step_000002.png")).shape == (96, 64, 3)
    state = checkpoint.restore(os.path.join(exp, "step_000003"))
    assert set(state) == {"unet", "cc_projection"}
    for name, module in trainer.modules.items():
        module.load_state_dict(state[name], strict=True)
        assert all(torch.equal(v, module.state_dict()[k]) for k, v in state[name].items())
    # as in the JAX CLI, step_XXXXXX is saved after step index XXXXXX, i.e.
    # after XXXXXX + 1 updates: here the third, as the final checkpoint
    first = checkpoint.restore(os.path.join(exp, "step_000002"))
    assert all(torch.equal(first["unet"][k], v) for k, v in state["unet"].items())


def test_main_seeds_its_weights_without_init_params(tmp_path, tiny_main):
    _folders(str(tmp_path / "views"), n_obj=2, n_views=3, size=32, channels=4)
    trainer = train_zero123.main(
        ["--data_root", str(tmp_path / "views"), "--batch_size", "2", "--max_steps", "0",
         "--total_views", "3",
         "--sample_every", "0", "--exp_dir", str(tmp_path / "exp")], device="cpu")
    ref = port_z.Zero123Stage(tiny_config(torch_side=True), device="cpu")
    assert trainer.step == 0
    # the f32 trainable copy is the stage's seeded init
    for name, module in trainer.modules.items():
        for k, v in getattr(ref, name).state_dict().items():
            assert torch.equal(module.state_dict()[k], v), (name, k)
    assert sorted(os.listdir(tmp_path / "exp")) == ["metrics.jsonl", "step_000000"]


def test_main_refuses_model_shards(tmp_path):
    """A world of one refuses --model_shards 2 through create_mesh's
    ValueError, as the JAX CLI's mesh does (the 4-rank run is in
    tests/test_torch_meshes.py)."""
    with pytest.raises(ValueError, match=r"mesh \(0, 2\) != 1 devices"):
        train_zero123.main(["--data_root", str(tmp_path), "--model_shards", "2"], device="cpu")
