"""The reconstruction-training surface of one2345_tpu_torch against the JAX
package, CPU: ``ReconScenesDataset`` on shape directories written with the
port's PNG writer (views at 256^2 and, resized by LANCZOS, at 128^2)
against the JAX reader; ``Prefetcher`` passing an exception through;
``MetricsLogger``; ``Validator`` renders at lod0 and lod1 against JAX's;
and a tiny ``train_recon.main(..., device='cpu')`` run with ``--resume``."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from one2345_tpu.core.config import ReconConfig as JaxReconConfig
from one2345_tpu.core.logging import MetricsLogger as JaxMetricsLogger
from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
from one2345_tpu.recon.validation import Validator as JaxValidator
from one2345_tpu.training.data import ReconScenesDataset as JaxReconScenesDataset
from one2345_tpu_torch.core import checkpoint
from one2345_tpu_torch.core import config as port_config
from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.core.logging import MetricsLogger
from one2345_tpu_torch.geometry import cameras as cam
from one2345_tpu_torch.recon.pipeline import ReconStage
from one2345_tpu_torch.recon.validation import Validator
from one2345_tpu_torch.training import train_recon
from one2345_tpu_torch.training.data import Prefetcher, ReconScenesDataset
from one2345_tpu_torch.utils.convert_jax import recon_from_jax
from one2345_tpu_torch.utils.png import read_png, write_png
from tests.torch_port_helpers import max_err, recon_test_params

VAL_TOL = 5e-4  # relative L2 of each validation image (importance sampling, as the renderer's)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def write_scene(root, name: str, polar: float, size: int, seed: int):
    """A shape directory as ``One2345Pipeline.run`` writes it: pose.json and
    the 8 + 32 views of the rig at ``polar``, noise PNGs of ``size``^2 on a
    white background with a dark blob."""
    shape = os.path.join(root, name)
    os.makedirs(os.path.join(shape, "stage1_8"))
    os.makedirs(os.path.join(shape, "stage2_8"))
    cam.write_pose_json(shape, polar)
    rng = np.random.default_rng(seed)
    ids, _ = cam.rig_poses(polar)
    yy, xx = np.mgrid[:size, :size] / size
    blob = (yy - 0.5) ** 2 + (xx - 0.5) ** 2 < 0.1
    for k, i in enumerate(ids):
        img = np.full((size, size, 3), 255, np.uint8)
        img[blob] = rng.integers(0, 200, (int(blob.sum()), 3), dtype=np.uint8)
        write_png(os.path.join(shape, "stage1_8" if k < 8 else "stage2_8", i), img)
    return shape


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    write_scene(root, "shape0", 45.0, 256, 1)
    write_scene(root, "shape1", 100.0, 128, 2)
    return str(root)


@pytest.mark.parametrize("idx", [0, 1])
def test_scenes_dataset_matches_the_jax_reader(scenes, idx):
    """The views (256^2 as written; 128^2 resized by PIL's LANCZOS), the
    cameras of the pose's polar angle (45, and 100 with the other ring),
    and the rays of a draw, given JAX's pixel indices."""
    ours, ref = ReconScenesDataset(scenes, n_rays=64), JaxReconScenesDataset(scenes, n_rays=64)
    a, b = ours.load_scene(idx), ref.load_scene(idx)
    assert a["images"].shape == (33, 256, 256, 3)
    assert max_err(a["images"], b["images"]) <= 1e-6
    for k in ("w2cs", "affines", "intrinsics", "near_fars"):
        assert max_err(a["cameras"][k], b["cameras"][k]) <= 1e-6, k
    assert a["cameras"]["img_ids"] == b["cameras"]["img_ids"]

    key = jax.random.key(idx)
    sb = ref.sample_scene(idx, key=key)
    img0 = jnp.asarray(b["images"][0])
    flat = (~jnp.all(img0 > 245 / 255.0, axis=-1)).reshape(-1).astype(jnp.float32)
    k_fg, k_bg, _ = jax.random.split(key, 3)
    ray_idx = np.concatenate([
        np.asarray(jax.random.categorical(k_fg, jnp.where(flat > 0.5, 0.0, -1e9), shape=(32,))),
        np.asarray(jax.random.categorical(k_bg, jnp.where(flat > 0.5, -1e9, 0.0), shape=(32,))),
    ])
    sa = ours.sample_scene(idx, ray_idx=torch.from_numpy(ray_idx))
    assert set(sa) == set(sb)
    for k in sa:
        assert max_err(sa[k], sb[k]) <= 1e-5, k
    assert 0.0 < sa["rays_mask"].mean() < 1.0
    # the port's own draw: half the rays on the foreground
    own = ours.sample_scene(idx)
    assert own["rays_mask"][:32].min() == 1.0 and own["rays_mask"][32:].max() == 0.0


def test_prefetcher_passes_an_exception_through():
    def items():
        yield 1
        yield 2
        raise OSError("a shape directory went missing")

    p = Prefetcher(items())
    assert next(p) == 1 and next(p) == 2
    with pytest.raises(OSError, match="went missing"):
        next(p)
    done = Prefetcher(iter([7]))
    assert list(done) == [7]
    done.close()


def test_metrics_logger_writes_jsonl_and_pngs(tmp_path):
    img = np.random.default_rng(0).uniform(size=(8, 12, 3)).astype(np.float32)
    for cls, sub in ((MetricsLogger, "port"), (JaxMetricsLogger, "jax")):
        log = cls(str(tmp_path / sub))
        log.log(3, loss=np.float32(0.25), psnr=torch.tensor(21.5), note="text")
        log.log(4, loss=0.5)
        path = log.log_image(4, "val", img)
        log.close()
        assert os.path.relpath(path, tmp_path / sub) == os.path.join("images", "val_00000004.png")
    recs = {}
    for sub in ("port", "jax"):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            recs[sub] = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]
    assert recs["port"] == recs["jax"] == [
        {"step": 3, "loss": 0.25, "psnr": 21.5, "note": "text"}, {"step": 4, "loss": 0.5}]
    png = tmp_path / "port" / "images" / "val_00000004.png"
    want = np.asarray(Image.open(tmp_path / "jax" / "images" / "val_00000004.png"))
    assert np.array_equal(read_png(str(png)), want)
    assert np.array_equal(np.asarray(Image.open(png)), want)


VAL = dict(image_hw=(32, 32), vol_dims=(8, 8, 8), voxel_size=2.0 / 7.0, num_lods=2,
           lod1_vol_dims=(16, 16, 16), lod1_voxel_size=2.0 / 15.0, lod1_d_compress=8,
           lod1_prune_threshold=0.5, n_samples=8, n_importance=8)


@pytest.mark.parametrize("lod", [0, 1])
def test_validator_matches_jax(lod):
    """tests/test_validation.py's tiny renders (8^2 of the reference view),
    the port's against the JAX Validator's, then psnr and panel."""
    params = recon_test_params(VAL, seed=5)
    jstage = JaxReconStage(JaxReconConfig(**VAL), params=params)
    port = ReconStage(ReconConfig(**VAL), params=recon_from_jax(params), device="cpu")
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    pack = cam.build_recon_cameras(45.0)
    sel = [0, 1, 2, 3, 4]
    cams = {k: (v[sel] if isinstance(v, np.ndarray) and v.ndim >= 2 and len(v) >= 33 else v)
            for k, v in pack.items()}
    cams["intrinsics"] = pack["intrinsics"][sel] / 8.0
    cams["intrinsics"][:, 2, 2] = 1.0
    aff = np.tile(np.eye(4, dtype=np.float32)[None], (5, 1, 1))
    aff[:, :3, :4] = np.einsum("vij,vjk->vik", cams["intrinsics"], cams["w2cs"][:, :3, :4])
    cams["affines"] = aff
    ref = JaxValidator(jstage, n_rays_chunk=32).render_view(images, cams, H=8, W=8, lod=lod)
    out = Validator(port, n_rays_chunk=32).render_view(images, cams, H=8, W=8, lod=lod)
    for k in ("color", "depth", "normal"):
        assert out[k].shape == ref[k].shape and np.isfinite(out[k]).all(), k
        err = np.linalg.norm(out[k].astype(np.float64) - ref[k])
        assert err <= VAL_TOL * np.linalg.norm(ref[k]), k
    assert float(np.abs(out["depth"]).max()) > 0
    gt = images[0, :8, :8]
    assert Validator.psnr(out["color"], gt) == pytest.approx(JaxValidator.psnr(ref["color"], gt), abs=1e-2)
    assert Validator.panel(out, gt).shape == JaxValidator.panel(ref, gt).shape == (8, 32, 3)
    assert np.array_equal(Validator.panel(ref, gt), JaxValidator.panel(ref, gt))


def test_train_recon_main_runs_and_resumes(scenes, tmp_path, monkeypatch):
    """Two steps, a checkpoint, the final checkpoint, metrics for every
    step; then --resume continues at the saved step; a bf16 step runs.  ReconConfig is cut
    to an 8^3 volume and 4 + 4 samples (the CLI builds it from its flags;
    its other fields stay the defaults)."""
    tiny = functools.partial(port_config.ReconConfig, vol_dims=(8, 8, 8), voxel_size=2.0 / 7.0,
                             n_samples=4, n_importance=4)
    monkeypatch.setattr(port_config, "ReconConfig", tiny)
    exp = str(tmp_path / "exp")
    args = ["--data_root", scenes, "--n_rays", "16", "--ckpt_every", "1", "--log_every", "1",
            "--exp_dir", exp]
    tr = train_recon.main(args + ["--max_steps", "2"], device="cpu")
    assert tr.step == 2 and tr.cfg.end_iter == 2
    assert sorted(os.listdir(exp)) == ["metrics.jsonl", "step_000001", "step_000002"]
    state = checkpoint.restore(os.path.join(exp, "step_000002"))
    assert state["step"] == 2 and set(state["params"]) == {"fusion", "sdf", "render", "variance"}
    for k, sd in state["params"].items():
        for name, t in tr.modules[k].state_dict().items():
            assert torch.equal(sd[name], t), (k, name)
    tr2 = train_recon.main(args + ["--max_steps", "3", "--resume"], device="cpu")
    assert tr2.step == 3
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert all(np.isfinite(v) for k, v in r.items() if k != "time")
        assert {"loss", "eikonal", "sparse_loss", "psnr"} <= set(r)
    # --dtype bfloat16 trains: bf16 compute over f32 weights, Adam state and statistics
    bf = train_recon.main(args + ["--max_steps", "1", "--dtype", "bfloat16",
                                  "--exp_dir", str(tmp_path / "bf16")], device="cpu")
    assert bf.step == 1 and bf.stage.dtype == torch.bfloat16 and bf.stage.f32_weights
    assert all(t.dtype == torch.float32 for m in bf.modules.values() for t in m.state_dict().values())
    with open(tmp_path / "bf16" / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert all(np.isfinite(v) for k, v in rec.items() if k != "time")
