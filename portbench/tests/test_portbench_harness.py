"""The benchmark's harness on the CPU: the manifest, cells and per-layer
metrics found from files alone, the run command's refusals, the frozen
arithmetic, and the modules each part may load.

    python -m pytest portbench/tests -q
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, images, weights, yardstick  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def manifest():
    return harness.load_manifest(ROOT)


def test_manifest_names_files_and_metrics():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["portbench"] and m["command"] == ["python3", "portbench/run.py"]
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]] + [
        x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in m["workloads"]:
        cell = harness.Cell.load(w["name"], ROOT)
        assert (ROOT / "portbench" / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for x in m["per_layer"]:
        assert (ROOT / "portbench" / "layers" / f"{x['name']}.py").is_file()
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}
    assert all(0.01 <= e["bound"] <= 0.25 for e in m["end_to_end"])


def test_new_cell_and_metric_are_files_alone(tmp_path):
    """A cell and a per-layer metric added as files and manifest entries
    only, in a copy of the benchmark."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    traffic = json.loads((ROOT / "portbench/traffic/ddim-c1.json").read_text())
    traffic.update(steps=[20, 20], evals={"8": 63, "56": 20})
    (tmp_path / "portbench/traffic/ddim-fast.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/layers/total_span_s.py").write_text(
        "from portbench.harness import span_mean\n\n\ndef read(r):\n"
        "    return span_mean(r, ('preprocess', 'reconstruct'))\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "one2345.ddim-fast", "config": "one2345",
                           "traffic": "ddim-fast", "chips": 1, "why": "a test cell"})
    m["per_layer"].append({"name": "total_span_s", "unit": "s", "better": "lower",
                           "source": "program_span", "layer": "preprocessing",
                           "moves": "mesh_s"})
    m["end_to_end"][0]["workloads"].append("one2345.ddim-fast")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.Cell.load("one2345.ddim-fast", tmp_path)
    assert cell.traffic["steps"] == [20, 20]
    # without a limits file of its own the cell takes its configuration's;
    # one added as a file is found by the cell's name
    assert cell.limits == harness.load_json(ROOT / "portbench/limits/one2345.json")
    (tmp_path / "portbench/limits/one2345.ddim-fast.json").write_text(
        json.dumps({"numbers": {"unet_b8": 0.5}}))
    assert harness.Cell.load("one2345.ddim-fast", tmp_path).limits["numbers"] == {"unet_b8": 0.5}
    assert "total_span_s" in {x["name"] for x in cell.per_layer}
    assert {x["name"] for x in cell.end_to_end} == {"mesh_s", "setup_s"}
    items = [{"profiled": False, "seconds": 1.0, "flops": 0.0,
              "spans": {"preprocess": 0.5, "reconstruct": 1.5}}]
    assert harness.reader("total_span_s", tmp_path)({"items": items}) == 2.0
    # the train cell does not report mesh_s, so the new metric is not read there
    train = harness.Cell.load("zero123xl-train.b192", tmp_path)
    assert "total_span_s" not in {x["name"] for x in train.per_layer}


def test_configuration_states_precision_and_environment():
    """A configuration or a traffic mix that states int8 builds the int8
    UNet; the train configuration states its allocator's environment,
    which the serving one does not."""
    from portbench.calibrate import int8_copy
    from portbench.drivers.closed_loop_mesh import pipeline_config

    cell = harness.Cell.load("one2345.ddim-c1", ROOT)
    assert pipeline_config(cell.config, cell.traffic).diffusion.unet.quant == "none"
    conf = json.loads(json.dumps(cell.config))
    conf["pipeline"]["diffusion"]["unet"]["quant"] = "int8"
    assert pipeline_config(conf, cell.traffic).diffusion.unet.quant == "int8"
    assert pipeline_config(cell.config, dict(cell.traffic, quant="int8")).diffusion.unet.quant \
        == "int8"
    int8 = int8_copy(cell)
    assert pipeline_config(int8.config, int8.traffic).diffusion.unet.quant == "int8"
    assert cell.config["pipeline"]["diffusion"]["unet"]["quant"] == "none"  # a copy
    assert cell.env == {}
    train = harness.Cell.load("zero123xl-train.b192", ROOT)
    assert train.env == {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def _run_command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "one2345.ddim-c1",
                           "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    res = _run_command(ROOT)
    assert res.returncode == 2 and res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    res = _run_command(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def _loaded_modules(code: str) -> set:
    res = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stderr
    return {m.split(".")[0] for m in json.loads(res.stdout.strip().splitlines()[-1])}


def test_harness_loads_no_jax_nor_the_jax_package():
    top = _loaded_modules(
        "import portbench.harness, portbench.run, portbench.calibrate\n"
        "import portbench.drivers.closed_loop_mesh, portbench.drivers.train_steps\n"
        "from portbench import harness\n"
        "for m in harness.load_manifest()['per_layer']: harness.reader(m['name'])\n"
        "import one2345_tpu_torch.pipeline.runner, one2345_tpu_torch.training.zero123_trainer\n"
        "import one2345_tpu_torch.recon.pipeline, one2345_tpu_torch.segmentation.sam\n"
        "import one2345_tpu_torch.elevation.loftr")
    assert "one2345_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    top = _loaded_modules("import portbench.reference.nets, portbench.reference.recon, "
                          "portbench.reference.train, portbench.reference.precision, "
                          "portbench.reference.sampler")
    assert not top & ({"one2345_tpu_torch"} | set(harness.FORBIDDEN))
    imports = re.compile(r"^\s*(from|import)\s+(one2345_tpu|jax|flax)", re.M)
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not imports.search(path.read_text()), path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "one2345_tpu_torch_extra", sys)
    assert "one2345_tpu_torch_extra" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_loaded() == ["jax.numpy"]


def test_yardstick_matches_the_program_and_the_published_counts():
    from one2345_tpu_torch.core.profiling import unet_flops_per_eval

    unet = harness.load_json(ROOT / "portbench/configs/one2345.json")["pipeline"]["diffusion"]["unet"]
    for B in (1, 8, 56, 192):
        assert yardstick.unet_flops_per_eval(B, unet) == pytest.approx(unet_flops_per_eval(B))
    assert yardstick.unet_flops_per_eval(1, unet) == pytest.approx(176.3e9, rel=1e-3)
    per_mesh = 201 * yardstick.unet_flops_per_eval(8, unet) + 49 * yardstick.unet_flops_per_eval(56, unet)
    assert per_mesh == pytest.approx(767.4e12, rel=1e-3)
    shapes = yardstick.self_attention_shapes(unet)
    assert len(shapes) == 16 and shapes[0] == (1024, 8, 40) and shapes[-1] == (16, 8, 160)
    # chip_smoke.py's bounds (PERF.md): K1 at level 0, B=56 0.1123 ms by
    # the exp unit; the whole backward at level 0, B=8 0.0271 ms
    assert yardstick.forward_bound(56, 1024, 8, 40) * 1e3 == pytest.approx(0.1123, abs=2e-4)
    assert yardstick.backward_bounds(8, 1024, 8, 40)["backward"][2] * 1e3 == pytest.approx(
        0.0271, abs=2e-4)


def test_reference_modules_have_the_programs_leaves():
    """The reference's state dicts have the program's keys and shapes in
    the program's order, so one seed draws the same weights for both."""
    from one2345_tpu_torch.core.config import PipelineConfig, ReconConfig
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from portbench.reference import nets, recon

    conf = harness.load_json(ROOT / "portbench/configs/one2345.json")["pipeline"]
    stage = Zero123Stage(PipelineConfig().diffusion, device="meta")
    for name in ("unet", "encoder", "decoder", "clip", "cc_projection"):
        assert weights.shapes_of(nets.build(name, conf["diffusion"])) == weights.shapes_of(
            getattr(stage, name)), name
    prog = ReconStage(ReconConfig(), device="meta").modules()
    for name, module in recon.build(conf["recon"]).items():
        assert weights.shapes_of(module) == weights.shapes_of(prog[name]), name


def test_weights_and_images_come_from_the_seed():
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "n.weight": (4,), "bn.running_var": (4,)}
    w1 = weights.seeded_state_dict(shapes, 2**40 + 3, "m", "cpu")
    w2 = weights.seeded_state_dict(shapes, 2**40 + 3, "m", "cpu")
    w3 = weights.seeded_state_dict(shapes, 2**40 + 4, "m", "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert float(w1["bn.running_var"].min()) >= 1.0
    a, b = images.raw_image(5, 0), images.raw_image(5, 1)
    assert a.shape == (512, 512, 3) and a.dtype == np.uint8
    assert np.array_equal(a, images.raw_image(5, 0)) and not np.array_equal(a, b)
    assert (a == 255).all(axis=-1).mean() > 0.5  # an object on white
