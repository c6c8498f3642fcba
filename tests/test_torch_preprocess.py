"""The port's preprocessing path against the JAX runner's, on the CPU in
f32: One2345Pipeline.preprocess (thumbnail, composite, SAM seed bbox and
box-prompted mask or the alpha / near-white mask, recentre) with the tiny
SAM of tests/test_torch_sam.py and the tiny diffusion config; check_safety
with seeded concept embeddings on the tiny CLIP tower; then the port alone
(its seeded tiny stages, elevation pinned to polar 60): run_many against
sequential runs, save_params -> checkpoint.restore, the CLI on a
PIL-written RGBA PNG.  The tiny run(skip_preprocess=False) against the JAX
runner is in tests/test_torch_pipeline.py, beside the JAX runner it
reuses."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from one2345_tpu.core import config as jax_config
from one2345_tpu.pipeline import runner as jax_runner
from one2345_tpu.segmentation.safety import SafetyChecker as JaxSafetyChecker
from one2345_tpu_torch.core import checkpoint, config
from one2345_tpu_torch.pipeline import cli, runner
from one2345_tpu_torch.segmentation.safety import SafetyChecker
from one2345_tpu_torch.utils.convert_jax import flax_to_state_dict, sam_from_jax
from tests.test_torch_pipeline import POLAR, SMALL_VOLUME, STEPS
from tests.test_torch_sam import TINY
from tests.torch_port_helpers import randomize, tiny_config

OUT_TOL = 2 / 255  # the recentred 32^2 image
R = 24  # mesh lattice of the tiny runs


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def raw_image(h, w, rgba, seed=0):
    """An object (a textured ellipse) on a white ground, or on a
    transparent one for RGBA."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    obj = ((yy - 0.55 * h) / (0.3 * h)) ** 2 + ((xx - 0.45 * w) / (0.25 * w)) ** 2 < 1
    img = np.full((h, w, 4), 255, np.uint8)
    img[obj, :3] = rng.integers(20, 200, (int(obj.sum()), 3))
    if rgba:
        img[..., 3] = np.where(obj, 255, 0)
        return img
    return img[..., :3].copy()


@pytest.fixture(scope="module")
def pipes():
    """The JAX runner and the port's with the same tiny SAM and the same
    tiny CLIP tower (the safety gate's embedding); the port's other stages
    seeded, the recon at the 16^3 volume."""
    from one2345_tpu.diffusion.zero123 import Zero123Stage
    from one2345_tpu.segmentation.sam import SamStage

    with jax.default_matmul_precision("highest"):
        jdiff = tiny_config(torch_side=False).replace(**STEPS)
        jsam_cfg = jax_config.SamConfig(**dict(TINY, window_size=3))
        sam_tree = randomize(
            jax.eval_shape(SamStage(jsam_cfg, params={}).init_params, jax.random.key(0)), 21)
        clip = Zero123Stage(jdiff, params={}).clip
        size = jdiff.clip.image_size
        clip_tree = randomize(jax.eval_shape(clip.init, jax.random.key(0),
                                             jnp.zeros((1, size, size, 3))), 22)
        jcfg = jax_config.PipelineConfig(diffusion=jdiff, sam=jsam_cfg)
        jpipe = jax_runner.One2345Pipeline(
            jcfg, params={"sam": sam_tree, "zero123": {"clip": clip_tree}}, use_sam=True,
            auto_mesh=False)
    pcfg = config.PipelineConfig(
        diffusion=tiny_config(torch_side=True).replace(**STEPS),
        recon=config.ReconConfig(**SMALL_VOLUME), sam=config.SamConfig(**dict(TINY, window_size=3)),
        mesh_resolution=R)
    pipe = runner.One2345Pipeline(pcfg, params={"sam": sam_from_jax(sam_tree)}, use_sam=True,
                                  device="cpu")
    pipe.zero123.clip.load_state_dict(zero123_clip(clip_tree), strict=True)
    pipe.estimate_elevation = lambda views: POLAR
    return jpipe, pipe


def zero123_clip(tree):
    return flax_to_state_dict(tree, free=("class_embedding", "positional_embedding", "proj"))


def _recording(stage):
    """Wrap ``stage.predict_box`` to record each (bbox, mask)."""
    calls = []
    inner = stage.predict_box

    def predict_box(cache, bbox):
        mask = inner(cache, bbox)
        calls.append((tuple(int(v) for v in bbox), mask))
        return mask

    stage.predict_box = predict_box
    return calls


@pytest.mark.parametrize("use_sam,bbox", [(True, None), (True, (60, 40, 230, 170)), (False, None)],
                         ids=["sam", "sam_bbox", "no_sam"])
@pytest.mark.parametrize("rgba", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("hw", [(200, 300), (520, 700)])
def test_preprocess_matches_jax(pipes, hw, rgba, use_sam, bbox):
    jpipe, pipe = pipes
    jpipe.use_sam = pipe.use_sam = use_sam
    img = raw_image(*hw, rgba, seed=hw[0])
    jcalls, calls = _recording(jpipe.sam), _recording(pipe.sam)
    try:
        with jax.default_matmul_precision("highest"):
            ref = jpipe.preprocess(img, bbox=bbox)
        out = pipe.preprocess(img, bbox=bbox)
    finally:
        del jpipe.sam.predict_box, pipe.sam.predict_box
    assert out.shape == ref.shape == (32, 32, 3) and out.dtype == np.float32
    assert len(calls) == len(jcalls) == (2 if use_sam and bbox is None else int(use_sam))
    for (jbox, jmask), (box, mask) in zip(jcalls, calls):
        assert box == jbox and np.array_equal(mask, jmask)
    assert np.abs(out - ref).max() <= OUT_TOL


def test_check_safety_flags_as_jax(pipes):
    """Seeded concept embeddings, thresholds set just below and just above
    the measured similarity (x 1.2 in the checker): the same flags as the
    JAX runner, and preprocess raises on the flagged one."""
    jpipe, pipe = pipes
    img = raw_image(200, 300, False, seed=3)
    concept = np.random.default_rng(8).standard_normal((2, 768)).astype(np.float32)
    probe = {"concept_embeds": concept, "concept_thresholds": np.full(2, -2.0, np.float32)}
    pipe._safety = SafetyChecker(**probe)
    captured = []  # the embedding as check_safety computes it
    pipe._safety.check = lambda e: captured.append(e) or np.ones(len(e), bool)
    assert pipe.check_safety(img)
    unit = concept / np.linalg.norm(concept, axis=1, keepdims=True)
    sim = (captured[0] / np.linalg.norm(captured[0])) @ unit.T
    for shift, flagged in ((-0.02, True), (0.02, False)):
        kw = {"concept_embeds": concept, "concept_thresholds": ((sim[0] + shift) / 1.2).astype(np.float32)}
        pipe._safety, jpipe._safety = SafetyChecker(**kw), JaxSafetyChecker(**kw)
        with jax.default_matmul_precision("highest"):
            ref = jpipe.check_safety(img)
        assert pipe.check_safety(img) == ref == flagged
        if flagged:
            with pytest.raises(runner.UnsafeImageError):
                pipe.preprocess(img)
    pipe._safety = jpipe._safety = None
    assert not pipe.check_safety(img)  # no weights: flags nothing


def test_run_many_equals_sequential_runs(pipes):
    _, pipe = pipes
    img = raw_image(200, 300, True, seed=5)
    other = raw_image(200, 300, True, seed=6)
    seq = pipe.run(img, seed=5)
    # the first image again after another: SAM's memo is shared by the threads
    par = pipe.run_many([img, other, img], seeds=[5, 6, 5])
    for res in (par[0], par[2]):
        assert res.elevation == seq.elevation
        assert torch.equal(res.stage2_images, seq.stage2_images)
        assert np.array_equal(res.vertices, seq.vertices) and np.array_equal(res.faces, seq.faces)
    assert len(par[1].vertices) > 0 and not torch.equal(par[1].stage1_images, seq.stage1_images)


def test_save_params_restores_every_stage(pipes, tmp_path):
    _, pipe = pipes
    path = str(tmp_path / "ckpt" / "params.pt")
    pipe.save_params(path)
    tree = checkpoint.restore(path)
    assert {"zero123", "recon", "sam"} <= set(tree) <= {"zero123", "recon", "sam", "loftr"}
    again = runner.One2345Pipeline(pipe.config, params=tree, use_sam=True, device="cpu")
    for a, b in ((pipe.sam.modules, again.sam.modules), (pipe.zero123.unet, again.zero123.unet),
                 (pipe.recon.sdf_net, again.recon.sdf_net)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert checkpoint.latest_step_dir(str(tmp_path)) is None


def test_cli_writes_the_mesh_and_artifacts(pipes, tmp_path, monkeypatch):
    """cli.main on a PIL-written RGBA PNG, the tiny config through
    build_config, the weights through --params."""
    _, pipe = pipes
    img = raw_image(200, 300, True, seed=5)
    path = str(tmp_path / "in.png")
    Image.fromarray(img).save(path)
    params = str(tmp_path / "params.pt")
    pipe.save_params(params)
    monkeypatch.setattr(cli, "build_config", lambda args: pipe.config.replace(seed=args.seed))
    monkeypatch.setattr(runner.One2345Pipeline, "estimate_elevation", lambda self, views: POLAR)
    out_dir = str(tmp_path / "out")
    res = cli.main(["--img_path", path, "--out_dir", out_dir, "--mesh_resolution", str(R),
                    "--output_format", ".obj", "--params", params], device="cpu")
    assert res.mesh_path == os.path.join(out_dir, "mesh.obj")
    names = {os.path.relpath(os.path.join(d, f), out_dir) for d, _, fs in os.walk(out_dir) for f in fs}
    assert {"mesh.ply", "mesh.obj", "pose.json", "stage1_8/7.png", "stage2_8/7_3.png"} <= names
    assert len(names) == 3 + 8 + 32
    ref = pipe.run(img, seed=0, mesh_resolution=R)
    assert torch.equal(res.stage2_images, ref.stage2_images)


def test_cli_runs_on_the_card_gpu_idx_names(monkeypatch):
    """With no device given, main runs on cuda:<gpu_idx> and makes it the
    current card (the pipeline is stubbed: this machine may have none)."""
    chosen = {}

    class Stop(Exception):
        pass

    def pipeline(cfg, params, use_sam, device):
        chosen["device"] = device
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: chosen.setdefault("current", i))
    monkeypatch.setattr(runner, "One2345Pipeline", pipeline)
    with pytest.raises(Stop):
        cli.main(["--img_path", "unused.png", "--gpu_idx", "1"])
    assert chosen == {"current": 1, "device": "cuda:1"}


# flags -> (sampler, quant, requested steps), as the JAX CLI sets them
FAST_MODES = {
    ("--sampler", "plms"): ("plms", "none", (75, 50)),
    ("--sampler", "dpmpp"): ("dpmpp", "none", (30, 25)),  # dpmpp defaults to 30 / 25
    ("--quant", "int8"): ("ddim", "int8", (75, 50)),  # --quant alone keeps the steps
}


@pytest.mark.parametrize("flags", [list(f) for f in FAST_MODES])
def test_cli_fast_modes_are_not_ported(flags):
    """The fast-mode flags land on the config (tests/test_dpm_solver.py's
    checks of the JAX CLI); --steps overrides any sampler's counts."""
    from one2345_tpu.pipeline import cli as jax_cli

    sampler, quant, steps = FAST_MODES[tuple(flags)]
    cfg = cli.build_config(cli.build_parser().parse_args(["--img_path", "x.png", *flags]))
    d = cfg.diffusion
    assert (d.sampler, d.unet.quant, (d.ddim_steps_stage1, d.ddim_steps_stage2)) == (sampler, quant, steps)
    ref = jax_cli.build_config(jax_cli.build_parser().parse_args(["--img_path", "x.png", *flags]))
    assert cfg.to_json() == ref.to_json()
    args = cli.build_parser().parse_args(["--img_path", "x.png", *flags, "--steps", "20", "10"])
    d = cli.build_config(args).diffusion
    assert (d.sampler, d.ddim_steps_stage1, d.ddim_steps_stage2) == (sampler, 20, 10)
    default = cli.build_config(cli.build_parser().parse_args(["--img_path", "x.png"])).diffusion
    assert (default.sampler, default.unet.quant, default.ddim_steps_stage1) == ("ddim", "none", 75)
    with pytest.raises(ValueError, match="unknown sampler"):
        cli.apply_fast_modes(cfg, sampler=sampler.upper())
