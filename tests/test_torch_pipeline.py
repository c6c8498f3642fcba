"""one2345_tpu_torch.pipeline.runner (One2345Pipeline.run) against the JAX
runner, and the exports it writes: the second-ring plan, pose.json, OBJ and
GLB bytes, the PNG writer, and one whole tiny run (the tiny Zero123 config
of tests/test_run_many.py; the reconstruction at a 16^3 volume, the recipe
of tests/test_torch_recon.py, and R=32) with the JAX noise injected and the
elevation estimate pinned to polar 60 on both sides, the polar <= 75
branch (views 4-7 and their rig); f32, CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import cKDTree

from one2345_tpu.core import config as jax_config
from one2345_tpu.diffusion import zero123 as jax_zero123
from one2345_tpu.geometry import cameras as jax_cameras
from one2345_tpu.pipeline import runner as jax_runner
from one2345_tpu.recon import gltf as jax_gltf
from one2345_tpu.recon import pipeline as jax_recon
from one2345_tpu.recon import mesh_extract as jax_mesh
from one2345_tpu_torch.core import config
from one2345_tpu_torch.geometry import cameras
from one2345_tpu_torch.pipeline import runner
from one2345_tpu_torch.recon import gltf, mesh_extract
from one2345_tpu_torch.recon.pipeline import ReconStage
from one2345_tpu_torch.utils import png
from one2345_tpu_torch.utils.convert_jax import recon_from_jax, zero123_from_jax
from tests.torch_port_helpers import max_err, randomize, tiny_config

R = 32  # mesh lattice of the tiny run
SMALL_VOLUME = dict(vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0)
STEPS = dict(ddim_steps_stage1=2, ddim_steps_stage2=2)  # the verify skill's tiny run
POLAR = 60.0  # the pinned estimate: the polar <= 75 branch
IMAGE_TOL = 2e-3  # the stage images (tests/test_torch_zero123.py's bound)


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


def test_select_stage1b_plan_matches_jax():
    for polar in (30.0, 60.0, 75.0, 76.0, 90.0, 120.0):
        for n in (1, 2, 3, 4, 8):
            assert runner.select_stage1b_plan(polar, n) == jax_runner.select_stage1b_plan(polar, n)


def test_pose_dict_and_json_match_jax(tmp_path):
    for elev in (30.0, 60.0, 90.0, 45.5):
        assert cameras.pose_dict(elev) == jax_cameras.pose_dict(elev)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    a = jax_cameras.write_pose_json(str(tmp_path / "jax"), 60.0)
    b = cameras.write_pose_json(str(tmp_path / "port"), 60.0)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _mesh(seed=0):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (80, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    return verts, faces, colors


def test_obj_glb_and_ply_bytes_match_jax(tmp_path):
    verts, faces, colors = _mesh()
    v, f = mesh_extract.convert_mesh_axes(verts, faces)
    rv, rf = jax_mesh.convert_mesh_axes(verts, faces)
    assert np.array_equal(v, rv) and np.array_equal(f, rf)
    writers = (
        ("mesh.obj", runner.save_obj, jax_runner.save_obj, (v, f, colors)),
        ("mesh.glb", gltf.save_glb, jax_gltf.save_glb, (v, f, colors)),
        ("mesh.ply", mesh_extract.save_ply, jax_mesh.save_ply,
         (verts, faces, (colors * 255).astype(np.uint8))),
    )
    for name, port_write, jax_write, args in writers:
        port_write(str(tmp_path / f"port_{name}"), *args)
        jax_write(str(tmp_path / f"jax_{name}"), *args)
        with open(tmp_path / f"port_{name}", "rb") as a, open(tmp_path / f"jax_{name}", "rb") as b:
            assert a.read() == b.read(), name
    gv, gf, gc = gltf.load_glb(str(tmp_path / "port_mesh.glb"))
    assert np.array_equal(gv, v) and np.array_equal(gf, f) and np.array_equal(gc, colors)
    pv, pf, pc = mesh_extract.load_ply(str(tmp_path / "port_mesh.ply"))
    assert np.array_equal(pv, verts) and np.array_equal(pf, faces)
    assert np.array_equal(pc, (colors * 255).astype(np.uint8))


@pytest.mark.parametrize("shape", [(256, 256), (7, 13), (1, 1)])
def test_png_writer_reads_back_exactly(tmp_path, shape):
    rgb = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, rgb)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (shape[1], shape[0])
        assert np.array_equal(np.asarray(im), rgb)
    assert np.array_equal(png.read_png(path), rgb)
    with pytest.raises(ValueError):
        png.encode_png(rgb.astype(np.float32))


class _Estimator:
    """A stand-in elevation estimator returning (or raising) what it holds."""

    def __init__(self, result):
        self.result = result

    def estimate(self, views):
        if isinstance(self.result, Exception):
            raise self.result
        return self.result


def test_estimate_elevation_falls_back_on_none_only():
    pipe = runner.One2345Pipeline(config.PipelineConfig(), device="cpu")
    pipe._elev = _Estimator(None)
    assert pipe.estimate_elevation(None) == 90.0
    pipe._elev = _Estimator(61.7)
    assert pipe.estimate_elevation(None) == 61.0
    pipe._elev = _Estimator(RuntimeError("CUDA error: an illegal memory access"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pipe.estimate_elevation(None)


def test_what_is_not_ported_raises():
    """Preprocessing, SAM, the safety gate and the fast modes of the JAX
    CLI (the PLMS and DPM-Solver++ samplers, the int8 UNet) are ported: each
    mode lands on the config as the JAX CLI puts it there; a mode that
    exists in neither package raises."""
    from one2345_tpu.pipeline import cli as jax_cli
    from one2345_tpu_torch.pipeline import cli

    pipe = runner.One2345Pipeline(device="cpu")
    assert pipe.use_sam and not pipe.check_safety(np.ones((8, 8, 3), np.uint8))
    for mode in (dict(sampler="plms"), dict(sampler="dpmpp"), dict(quant="int8")):
        out = cli.apply_fast_modes(config.PipelineConfig(), **mode)
        ref = jax_cli.apply_fast_modes(jax_config.PipelineConfig(), **mode)
        assert json.loads(out.to_json()) == json.loads(ref.to_json()), mode
    with pytest.raises(ValueError, match="unknown sampler"):
        cli.apply_fast_modes(config.PipelineConfig(), sampler="dpm++")
    with pytest.raises(ValueError, match="unknown quant"):
        cli.apply_fast_modes(config.PipelineConfig(), quant="INT8")


def test_config_copies_match_jax():
    for name in ("SamConfig", "ElevationConfig", "PipelineConfig"):
        a, b = getattr(config, name)(), getattr(jax_config, name)()
        assert json.loads(a.to_json()) == json.loads(b.to_json()), name
    cfg = config.PipelineConfig()
    assert cfg.recon.dtype == "bfloat16" and cfg.elevation.dtype == "bfloat16"
    assert config.ElevationConfig().dtype == "float32"


def _input_image():
    img = np.ones((32, 32, 3), np.float32)  # white background
    yy, xx = np.mgrid[:32, :32]
    blob = (yy - 15.5) ** 2 + (xx - 15.5) ** 2 < 100
    img[blob] = np.random.default_rng(4).uniform(0.1, 0.9, size=(int(blob.sum()), 3))
    return img


def _jax_trees(jdiff):
    """JAX parameter trees of the tiny Zero123 stage and of the recon stage,
    their structure from ``jax.eval_shape`` (no init is compiled) and their
    leaves numpy-seeded; the SDF MLP keeps a geometric (sphere) init, the
    port's own, so that the field has a surface."""
    zero123 = jax.eval_shape(
        jax_zero123.Zero123Stage(jdiff, params={}).init_params, jax.random.key(0)
    )
    recon = jax.eval_shape(
        jax_recon.ReconStage(jax_config.ReconConfig(**SMALL_VOLUME), params={}).init_params,
        jax.random.key(0),
    )
    recon = randomize(recon, seed=5)
    sphere = ReconStage(config.ReconConfig(**SMALL_VOLUME), device="cpu").sdf_net.state_dict()
    for layer, leaves in recon["sdf"]["params"]["sdf_layer"].items():
        for name in leaves:
            leaves[name] = sphere[f"sdf_layer.{layer}.{name}"].numpy()
    return {"zero123": randomize(zero123, seed=31), "recon": recon}


@pytest.fixture(scope="module")
def pipes():
    """The JAX runner and the port's on the same weights (the tiny Zero123
    config, the 16^3 recon volume), each with its elevation estimate
    pinned to polar 60."""
    with jax.default_matmul_precision("highest"):
        jdiff = tiny_config(torch_side=False).replace(**STEPS)
        jcfg = jax_config.PipelineConfig(
            diffusion=jdiff, recon=jax_config.ReconConfig(**SMALL_VOLUME), mesh_resolution=R,
        )
        jpipe = jax_runner.One2345Pipeline(
            jcfg, params=_jax_trees(jdiff), use_sam=False, auto_mesh=False,
        )
        jpipe.estimate_elevation = lambda views: POLAR
    params = {
        "zero123": zero123_from_jax(jpipe.zero123.params),
        "recon": recon_from_jax(jpipe.recon.params),
    }
    pcfg = config.PipelineConfig(
        diffusion=tiny_config(torch_side=True).replace(**STEPS),
        recon=config.ReconConfig(**SMALL_VOLUME),
        mesh_resolution=R,
    )
    pipe = runner.One2345Pipeline(pcfg, params=params, use_sam=False, device="cpu")
    pipe.estimate_elevation = lambda views: POLAR
    return jpipe, pipe


def jax_noise(jpipe, seed: int = 0) -> dict:
    """{phase: noise_fn} replaying the noise the JAX runner draws from its
    key splits (runner.py:364-365)."""
    k_s1, k_s2e, k_s2 = jax.random.split(jax.random.key(seed), 3)

    def noise(key):
        def noise_fn(draw, view_ids, shape):
            ids = jnp.asarray(view_ids, jnp.uint32)
            return np.array(jpipe.zero123._per_view_noise(key, ids, draw, shape))

        return noise_fn

    return {
        "stage1": noise(k_s1), "stage2_view0": noise(k_s2e),
        "stage1_ring2": noise(jax.random.fold_in(k_s1, 1)), "stage2": noise(k_s2),
    }


@pytest.fixture(scope="module")
def runs(pipes, tmp_path_factory):
    """One tiny run of each runner on the same weights, input and noise,
    each writing its artifacts (the port's mesh as .obj)."""
    jpipe, pipe = pipes
    out = tmp_path_factory.mktemp("runs")
    with jax.default_matmul_precision("highest"):
        ref = jpipe.run(_input_image(), out_dir=str(out / "jax"), skip_preprocess=True, seed=0)
    result = pipe.run(_input_image(), out_dir=str(out / "port"), skip_preprocess=True, seed=0,
                      output_format=".obj", noise_fn=jax_noise(jpipe))
    return ref, result, out


def test_run_matches_the_jax_runner(runs):
    ref, out, _ = runs
    assert out.elevation == ref.elevation == 90.0 - POLAR
    assert set(out.timings) == set(ref.timings) == {
        "preprocess", "stage1", "stage2_view0", "elevation", "stage2", "reconstruct"
    }
    assert out.stage1_images.shape == (8, 32, 32, 3)
    assert out.stage2_images.shape == (8, 4, 32, 32, 3)
    s2 = np.asarray(ref.stage2_images)
    assert float(np.mean((s2 > 0.01) & (s2 < 0.99))) > 0.2  # not saturated
    assert max_err(out.stage1_images, ref.stage1_images) <= IMAGE_TOL
    assert max_err(out.stage2_images, ref.stage2_images) <= IMAGE_TOL


def test_run_mesh_matches_the_jax_runner(runs):
    """The JAX runner extracts from its int8 field (clipped at +-0.12,
    rounded to 1e-3), the port from the f32 field: the vertex count within
    3% and the Chamfer distance within 0.01 (tests/test_torch_recon.py)."""
    ref, out, _ = runs
    check_mesh_against(ref, out)


def check_mesh_against(ref, out):
    assert len(out.faces) > 100 and np.isfinite(out.vertices).all()
    ratio = len(out.vertices) / len(ref.vertices)
    d1 = cKDTree(ref.vertices).query(out.vertices)[0].mean()
    d2 = cKDTree(out.vertices).query(ref.vertices)[0].mean()
    assert abs(ratio - 1.0) <= 0.03
    assert float(d1 + d2) <= 0.01
    assert out.colors.shape == out.vertices.shape
    assert 0.0 <= out.colors.min() and out.colors.max() <= 1.0


def test_run_writes_the_jax_runner_s_artifacts(runs):
    """The same files: the stage-1 views of the polar <= 75 ring (0-7),
    their nearby views, pose.json, the PLY, and the OBJ asked for."""
    ref, out, root = runs
    names = {}
    for side in ("jax", "port"):
        names[side] = sorted(
            os.path.relpath(os.path.join(d, f), root / side)
            for d, _, files in os.walk(root / side) for f in files
        )
    assert set(names["jax"]) | {"mesh.obj"} == set(names["port"])
    assert "stage1_8/7.png" in names["port"] and "stage1_8/11.png" not in names["port"]
    assert out.mesh_path == str(root / "port" / "mesh.obj")
    with open(root / "jax" / "pose.json", "rb") as a, open(root / "port" / "pose.json", "rb") as b:
        assert a.read() == b.read()
    for name in ("stage1_8/5.png", "stage2_8/7_3.png"):
        a = np.asarray(Image.open(root / "jax" / name), np.int16)
        b = png.read_png(str(root / "port" / name)).astype(np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1  # uint8 of images within 2e-3
    s1 = (out.stage1_images.numpy() * 255).astype(np.uint8)
    assert np.array_equal(png.read_png(str(root / "port" / "stage1_8" / "5.png")), s1[5])
    v, f, c = mesh_extract.load_ply(str(root / "port" / "mesh.ply"))
    assert np.array_equal(v, out.vertices.astype(np.float32)) and np.array_equal(f, out.faces)
    lines = (root / "port" / "mesh.obj").read_text().splitlines()
    assert sum(line.startswith("v ") for line in lines) == len(out.vertices)
    assert sum(line.startswith("f ") for line in lines) == len(out.faces)


def test_warmup_runs_one_synthetic_request():
    """One run on a synthetic 256^2 input, and with SAM one preprocess of a
    synthetic 512^2 image without the safety gate first."""
    for use_sam in (True, False):
        pipe = runner.One2345Pipeline(config.PipelineConfig(mesh_resolution=48), use_sam=use_sam,
                                      device="cpu")
        calls, pre = [], []

        def run(image, **kwargs):
            calls.append((image, kwargs))
            return runner.PipelineResult(None, None, None, None, 0.0, None, None, {"stage1": 1.0})

        pipe.run = run
        pipe.preprocess = lambda image, **kwargs: pre.append((image, kwargs))
        assert pipe.warmup() == {"stage1": 1.0}
        (image, kwargs), = calls
        assert image.shape == (256, 256, 3) and image.dtype == np.float32
        assert image[0, 0].tolist() == [1.0, 1.0, 1.0] and image[128, 128].max() < 1.0
        assert kwargs == {"skip_preprocess": True, "mesh_resolution": 48, "seed": 0}
        assert len(pre) == int(use_sam)
        if use_sam:
            (image, kwargs), = pre
            assert image.shape == (512, 512, 3) and image.dtype == np.uint8
            assert kwargs == {"safety_check": False}


def test_run_from_a_raw_image_matches_the_jax_runner(pipes, tmp_path):
    """run(skip_preprocess=False) on a raw 120x90 RGBA image with the tiny
    SAM of tests/test_torch_sam.py (window 3) on both sides: preprocessing
    (thumbnail, SAM seed bbox, box-prompted mask, recentring) then the
    sampling phases with the JAX noise and the reconstruction.  The JAX
    runner here is the one of ``runs``, already compiled."""
    from one2345_tpu.segmentation.sam import SamStage as JaxSamStage
    from one2345_tpu_torch.segmentation.sam import SamStage
    from one2345_tpu_torch.utils.convert_jax import sam_from_jax
    from tests.test_torch_sam import TINY

    jpipe, pipe = pipes
    kw = dict(TINY, window_size=3)
    with jax.default_matmul_precision("highest"):
        jsam = JaxSamStage(jax_config.SamConfig(**kw), params={})
        jsam.params = randomize(jax.eval_shape(jsam.init_params, jax.random.key(0)), 21)
    rng = np.random.default_rng(6)
    raw = np.zeros((90, 120, 4), np.uint8)
    yy, xx = np.mgrid[:90, :120]
    obj = ((yy - 50) / 28.0) ** 2 + ((xx - 55) / 30.0) ** 2 < 1
    raw[obj] = np.concatenate([rng.integers(20, 200, (int(obj.sum()), 3)),
                               np.full((int(obj.sum()), 1), 255)], axis=1)
    try:
        jpipe._sam, jpipe.use_sam = jsam, True
        pipe._sam = SamStage(config.SamConfig(**kw), params=sam_from_jax(jsam.params), device="cpu")
        pipe.use_sam = True
        with jax.default_matmul_precision("highest"):
            ref = jpipe.run(raw, seed=0)
        out = pipe.run(raw, seed=0, output_format=".obj", out_dir=str(tmp_path),
                       noise_fn=jax_noise(jpipe))
    finally:
        jpipe._sam, jpipe.use_sam, pipe._sam, pipe.use_sam = None, False, None, False
    assert out.elevation == ref.elevation == 90.0 - POLAR
    assert set(out.timings) == set(ref.timings) and out.timings["preprocess"] > 0
    s1 = np.asarray(ref.stage1_images)
    assert float(np.mean((s1 > 0.01) & (s1 < 0.99))) > 0.2  # not saturated
    assert max_err(out.stage1_images, ref.stage1_images) <= IMAGE_TOL
    assert max_err(out.stage2_images, ref.stage2_images) <= IMAGE_TOL
    check_mesh_against(ref, out)
    assert out.mesh_path == str(tmp_path / "mesh.obj")


def test_phase_seeds_are_distinct_and_repeatable():
    a, b = runner.phase_seeds(0), runner.phase_seeds(1)
    assert set(a) == set(runner.PHASES) and len(set(a.values())) == 4
    assert a == runner.phase_seeds(0) and a != b
    assert isinstance(torch.Generator().manual_seed(a["stage1"]), torch.Generator)


# The int8 run: a code that flips at a rounding tie moves the run by the
# int8 error itself (tests/test_torch_zero123.py), so its stage images are
# held by their mean absolute difference, within the order of the JAX
# runner's own int8 run's distance from its f32 run.
FAST_INT8_MEAN_TOL = 0.05


def _fast_jax_runner(jpipe, quant: str):
    """The JAX runner of ``pipes`` with --sampler dpmpp (and --quant), its
    compiled recon stage reused."""
    d = jpipe.config.diffusion.replace(sampler="dpmpp")
    cfg = jpipe.config.replace(diffusion=d.replace(unet=d.unet.replace(quant=quant)))
    fast = jax_runner.One2345Pipeline(cfg, params={"zero123": jpipe.zero123.params},
                                      use_sam=False, auto_mesh=False)
    fast._recon = jpipe.recon
    fast.estimate_elevation = lambda views: POLAR
    return fast


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_fast_modes_run_matches_the_jax_runner(pipes, tmp_path, quant):
    """One tiny run with --sampler dpmpp (--steps 2 2), and with --quant
    int8, on both runners: the f32 weights of ``pipes`` (each side
    quantizes them), the JAX noise injected (dpmpp takes draw 0 of each
    phase), the recon stages of ``pipes``."""
    from one2345_tpu_torch.diffusion.quantize import QConv2d
    from one2345_tpu_torch.pipeline.cli import apply_fast_modes

    jpipe, pipe = pipes
    with jax.default_matmul_precision("highest"):
        jfast = _fast_jax_runner(jpipe, quant)
        ref = jfast.run(_input_image(), seed=0, skip_preprocess=True)
    pcfg = apply_fast_modes(pipe.config, sampler="dpmpp", steps=(2, 2), quant=quant)
    assert pcfg.diffusion.sampler == "dpmpp" and pcfg.diffusion.unet.quant == quant
    fast = runner.One2345Pipeline(pcfg, params={"zero123": zero123_from_jax(jpipe.zero123.params)},
                                  use_sam=False, device="cpu")
    fast._recon = pipe.recon
    fast.estimate_elevation = lambda views: POLAR
    out = fast.run(_input_image(), seed=0, skip_preprocess=True, out_dir=str(tmp_path),
                   noise_fn=jax_noise(jfast))
    int8 = any(isinstance(m, QConv2d) for m in fast.zero123.unet.modules())
    assert int8 == (quant == "int8")
    assert out.elevation == ref.elevation and set(out.timings) == set(ref.timings)
    s2 = np.asarray(ref.stage2_images)
    assert float(np.mean((s2 > 0.01) & (s2 < 0.99))) > 0.2  # not saturated
    if quant == "none":
        assert max_err(out.stage1_images, ref.stage1_images) <= IMAGE_TOL
        assert max_err(out.stage2_images, ref.stage2_images) <= IMAGE_TOL
        check_mesh_against(ref, out)
    else:
        for name in ("stage1_images", "stage2_images"):
            diff = np.abs(getattr(out, name).numpy() - np.asarray(getattr(ref, name)))
            assert float(diff.mean()) <= FAST_INT8_MEAN_TOL, name
        assert len(out.faces) > 100 and np.isfinite(out.vertices).all()
    assert os.path.exists(tmp_path / "stage2_8" / "7_3.png") and out.mesh_path.endswith("mesh.ply")
