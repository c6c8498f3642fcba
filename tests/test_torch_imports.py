"""one2345_tpu_torch stands alone: it imports no JAX, no flax, no optax,
nothing of one2345_tpu, and no PIL, cv2, scipy, matplotlib or tensorboardX
(the machine with the card has none of them), and its entry points run on
the card unless the caller asks for the CPU.  The examples of the port
(examples/torch_*.py) are held to the same list and import no JAX example."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "one2345_tpu", "PIL", "cv2", "scipy", "matplotlib",
             "tensorboardX")

_PROBE = """
import importlib, json, pkgutil, sys
import one2345_tpu_torch
names = [m.name for m in pkgutil.walk_packages(one2345_tpu_torch.__path__, "one2345_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def test_package_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    for module in (
        "one2345_tpu_torch.diffusion.zero123",
        "one2345_tpu_torch.ops.flash_attention",
        "one2345_tpu_torch.training.data",
        "one2345_tpu_torch.training.zero123_trainer",
        "one2345_tpu_torch.core.device",
        "one2345_tpu_torch.core.meshes",
        "one2345_tpu_torch.elevation.loftr",
        "one2345_tpu_torch.elevation.solver",
        "one2345_tpu_torch.pipeline.runner",
        "one2345_tpu_torch.recon.gltf",
        "one2345_tpu_torch.utils.png",
        "one2345_tpu_torch.nn.layers",
        "one2345_tpu_torch.geometry.cameras",
        "one2345_tpu_torch.geometry.projection",
        "one2345_tpu_torch.geometry.sampling",
        "one2345_tpu_torch.native.build",
        "one2345_tpu_torch.recon.costreg",
        "one2345_tpu_torch.recon.featurenet",
        "one2345_tpu_torch.recon.mesh_extract",
        "one2345_tpu_torch.recon.pipeline",
        "one2345_tpu_torch.recon.renderer",
        "one2345_tpu_torch.recon.rendering_network",
        "one2345_tpu_torch.recon.sdf_network",
        "one2345_tpu_torch.utils.convert_jax",
        "one2345_tpu_torch.utils.image",
        "one2345_tpu_torch.utils.resample",
        "one2345_tpu_torch.segmentation.sam",
        "one2345_tpu_torch.segmentation.safety",
        "one2345_tpu_torch.core.checkpoint",
        "one2345_tpu_torch.pipeline.cli",
        "one2345_tpu_torch.pipeline.api",
        "one2345_tpu_torch.pipeline.server",
        "one2345_tpu_torch.diffusion.plms",
        "one2345_tpu_torch.diffusion.dpm_solver",
        "one2345_tpu_torch.diffusion.img2img",
        "one2345_tpu_torch.diffusion.quantize",
        "one2345_tpu_torch.core.logging",
        "one2345_tpu_torch.geometry.rays",
        "one2345_tpu_torch.recon.fast_renderer",
        "one2345_tpu_torch.recon.validation",
        "one2345_tpu_torch.training.losses",
        "one2345_tpu_torch.training.recon_trainer",
        "one2345_tpu_torch.training.train_recon",
        "one2345_tpu_torch.recon.finetune",
        "one2345_tpu_torch.training.train_zero123",
        "one2345_tpu_torch.eval.metrics",
        "one2345_tpu_torch.eval.render_harness",
        "one2345_tpu_torch.eval.clip_metric",
        "one2345_tpu_torch.eval.sweep",
        "one2345_tpu_torch.utils.convert_weights",
        "one2345_tpu_torch.utils.convert_cli",
        "one2345_tpu_torch.nn.init",
        "one2345_tpu_torch.elevation.plotting",
        "one2345_tpu_torch.core.compile_cache",
        "one2345_tpu_torch.utils.download_ckpt",
    ):
        assert module in report["modules"]
    leaked = [
        m for m in report["loaded"]
        if m.split(".")[0] in FORBIDDEN
    ]
    assert leaked == []


def test_entry_point_defaults_to_the_card():
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Zero123Stage()


def test_backward_wrappers_and_trainer_are_in_the_package():
    from one2345_tpu_torch.ops import flash_attention as fa
    from one2345_tpu_torch.ops._build import KERNELS
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer

    assert KERNELS == ("flash_attention_fwd", "flash_attention_bwd")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_attention_backward"):
        assert callable(getattr(fa, name))
    assert fa.flash_attention.dq_launch_count >= 0 and fa.flash_attention.dkv_launch_count >= 0
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Zero123Trainer(None, {})


def test_recon_stage_defaults_to_the_card():
    from one2345_tpu_torch.recon.pipeline import ReconStage

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReconStage()


def test_recon_training_defaults_to_the_card(tmp_path):
    """ReconStage with lod1, and train_recon.main (its stage, so its
    trainer and Validator), resolve device=None to the card."""
    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training import train_recon

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReconStage(ReconConfig(num_lods=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_recon.main(["--data_root", str(tmp_path), "--exp_dir", str(tmp_path / "exp")])
    assert not (tmp_path / "exp").exists()


def test_finetune_zero123_training_and_eval_default_to_the_card(tmp_path):
    """FinetuneTrainer follows its stage (ReconStage() is on the card);
    train_zero123.main, ClipScorer, the sweep and the rasteriser resolve
    device=None to the card."""
    from one2345_tpu_torch.eval import metrics, render_harness, sweep
    from one2345_tpu_torch.eval.clip_metric import ClipScorer
    from one2345_tpu_torch.training import train_zero123

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_zero123.main(["--data_root", str(tmp_path), "--exp_dir", str(tmp_path / "exp")])
    assert not (tmp_path / "exp").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClipScorer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main(["--pred_dir", str(tmp_path), "--gt_dir", str(tmp_path)])
    K, w2c = render_harness.eval_cameras(8)[0]
    tri = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_harness.rasterize(tri, np.array([[0, 1, 2]]), tri, K, w2c, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        metrics.chamfer_distance(tri, tri)


def test_marching_tets_source_is_the_jax_package_s():
    """The port keeps its own copy of the C++ extractor, byte for byte."""
    copy = os.path.join(REPO, "one2345_tpu_torch", "native", "marching_tets.cpp")
    with open(copy, "rb") as a, open(os.path.join(REPO, "one2345_tpu", "native",
                                                   "marching_tets.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_pipeline_and_elevation_default_to_the_card():
    from one2345_tpu_torch.elevation.loftr import LoFTRMatcher
    from one2345_tpu_torch.elevation.solver import ElevationEstimator
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    for entry in (One2345Pipeline, LoFTRMatcher, ElevationEstimator):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


def test_sam_stage_and_service_default_to_the_card():
    from one2345_tpu_torch.pipeline.api import One2345Service
    from one2345_tpu_torch.segmentation.sam import SamStage
    from one2345_tpu_torch.utils.image import recenter_rescale, thumbnail

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    for entry in (SamStage, One2345Service):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thumbnail(np.zeros((600, 600, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recenter_rescale(np.zeros((8, 8, 4), np.uint8))


def _imported(path: str) -> set:
    """Every module an ``import`` statement of the file names, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            if node.module == "examples":
                names |= {f"examples.{a.name}" for a in node.names}
    return names


def test_torch_examples_import_nothing_forbidden():
    """examples/torch_*.py run on the card's machine: torch, numpy, einops,
    the standard library and the port, and of the examples only the torch
    twins (torch_generative_e2e imports torch_pipeline_wiring, as its JAX
    twin imports pipeline_wiring)."""
    import glob

    paths = sorted(glob.glob(os.path.join(REPO, "examples", "torch_*.py")))
    names = {os.path.basename(p) for p in paths}
    assert {"torch_pipeline_wiring.py", "torch_recon_quality.py", "torch_diffusion_quality.py",
            "torch_generative_e2e.py", "torch_walkthrough.py", "torch_demo.py",
            "torch_validate_real_weights.py", "torch_throughput_probe.py",
            "torch_stage_probe.py", "torch_fast_mode_probe.py", "torch_train_probe.py",
            "torch_profile_pipeline.py"} <= names
    for path in paths:
        imported = _imported(path)
        assert not [m for m in imported if m.split(".")[0] in FORBIDDEN], (path, imported)
        examples = [m for m in imported if m.split(".")[0] == "examples" and m != "examples"]
        assert all(m.split(".")[1].startswith("torch_") for m in examples), (path, examples)
    assert "examples.torch_pipeline_wiring" in _imported(
        os.path.join(REPO, "examples", "torch_generative_e2e.py"))


def test_every_jax_module_has_a_twin():
    """Every module of one2345_tpu has a module of the same path in the port."""
    def modules(package: str) -> set:
        root = os.path.join(REPO, package)
        return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                for f in fs if f.endswith(".py") and "__pycache__" not in d}

    assert modules("one2345_tpu") - modules("one2345_tpu_torch") == set()


def test_card_tests_import_no_jax():
    """tests/test_torch_cuda.py runs on the card's machine, which has no
    JAX: it imports torch, pytest and the port only."""
    with open(os.path.join(REPO, "tests", "test_torch_cuda.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"pytest", "torch", "one2345_tpu_torch"}
