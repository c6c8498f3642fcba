"""The twins of the JAX walkthrough and demo (examples/torch_walkthrough.py,
examples/torch_demo.py): the walkthrough runs end to end on the CPU with
--tiny --device cpu and writes the JAX walkthrough's files and summary keys (read from
the JAX example's source, so the twin cannot drift from it); the demo
calls the pipeline as the JAX demo does and prints its lines.  Their
pipeline calls are held to JAX by tests/test_torch_pipeline.py."""

import ast
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from examples import torch_demo, torch_walkthrough

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _jax_example(name: str) -> ast.Module:
    with open(os.path.join(REPO, "examples", name)) as f:
        return ast.parse(f.read())


def jax_walkthrough_contract() -> tuple[set, set]:
    """(the artifact names, the summary.json keys) of examples/walkthrough.py."""
    tree = _jax_example("walkthrough.py")
    names, keys = {"summary.json"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and re.fullmatch(
                r"\d_\w+\.(png|ply)", node.value):
            names.add(node.value)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dump" and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys}
    return names, keys


def test_walkthrough_tiny_writes_the_jax_walkthrough_s_files(tmp_path):
    names, keys = jax_walkthrough_contract()
    assert names == set(torch_walkthrough.ARTIFACTS) and len(keys) == 4
    out = str(tmp_path / "walk")
    summary = torch_walkthrough.main(["--tiny", "--device", "cpu", "--out", out])
    assert set(os.listdir(out)) == names
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == summary
    assert set(summary) == keys
    assert summary["mesh_vertices"] > 0 and summary["mesh_faces"] > 0
    assert -90.0 <= summary["elevation_deg"] <= 90.0
    from one2345_tpu_torch.recon.mesh_extract import load_ply
    from one2345_tpu_torch.utils.png import read_png

    verts, faces, _ = load_ply(os.path.join(out, "6_mesh.ply"))
    assert (len(verts), len(faces)) == (summary["mesh_vertices"], summary["mesh_faces"])
    size = torch_walkthrough.tiny_config().diffusion.image_size
    assert read_png(os.path.join(out, "1_preprocessed.png")).shape == (size, size, 3)
    assert read_png(os.path.join(out, "4_stage1_grid.png")).shape == (2 * size, 4 * size, 3)
    assert read_png(os.path.join(out, "5_stage2_grid.png")).shape == (4 * size, 8 * size, 3)


def test_walkthrough_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_walkthrough.main(["--out", str(tmp_path / "walk")])


def test_demo_calls_the_pipeline_as_the_jax_demo(tmp_path, monkeypatch, capsys):
    """torch_demo.main: the default config, SAM only with --params, the
    demo's out_dir and mesh resolution, and its printed lines."""
    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.utils.png import write_png

    calls = {}

    class Pipeline:
        def __init__(self, cfg, params, use_sam, device):
            calls.update(cfg=cfg, params=params, use_sam=use_sam, device=device)

        def run(self, image, out_dir, mesh_resolution):
            calls.update(image=image, out_dir=out_dir, mesh_resolution=mesh_resolution)
            return SimpleNamespace(elevation=30.0, mesh_path=os.path.join(out_dir, "mesh.ply"),
                                   vertices=np.zeros((5, 3)), timings={"stage1": 1.25})

    monkeypatch.setattr(torch_demo, "One2345Pipeline", Pipeline)
    monkeypatch.setattr(torch_demo, "enable_cache", lambda: calls.setdefault("cache", True))
    img = np.zeros((8, 8, 3), np.uint8)
    write_png(str(tmp_path / "in.png"), img)
    torch_demo.main(["--img_path", str(tmp_path / "in.png")], device="cpu")
    assert calls["cfg"] == torch_demo.PipelineConfig() and calls["params"] is None
    assert (calls["use_sam"], calls["out_dir"], calls["mesh_resolution"]) == (
        False, "exp/demo", 256)
    assert calls["image"].shape == (8, 8, 4) and calls["cache"]
    assert capsys.readouterr().out.splitlines() == [
        "elevation: 30 deg", "mesh: exp/demo/mesh.ply  (5 verts)", f"  {'stage1':>14}: 1.25s"]
    checkpoint.save(str(tmp_path / "p.pt"), {"recon": {}})
    torch_demo.main(["--img_path", str(tmp_path / "in.png"), "--params", str(tmp_path / "p.pt")],
                    device="cpu")
    assert calls["params"] == {"recon": {}} and calls["use_sam"] is True
