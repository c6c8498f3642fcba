"""The twins of the JAX package's measurement probes (examples/torch_{throughput,
stage,fast_mode,train}_probe.py, examples/torch_profile_pipeline.py) and
the serving path they drive, on the CPU at toy sizes.

Each twin's JSON lines carry the JAX probe's keys, read from the JAX
example's source (so a twin cannot drift from it), plus the keys it adds.
The pipeline probes share one tiny pipeline (the walkthrough's toy
config, DPM-Solver++ at 2 + 2 steps, no SAM) with the elevation pinned
(LoFTR at full width would take most of the time): run_many at two
requests in flight equals sequential runs, bit for bit.  Also here: the
launch counters under threads, and ``Timer`` on the CPU."""

import ast
import json
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from examples import (torch_fast_mode_probe, torch_profile_pipeline, torch_stage_probe,
                      torch_throughput_probe, torch_train_probe)
from one2345_tpu_torch.core.profiling import Timer
from one2345_tpu_torch.diffusion import quantize
from one2345_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--tiny", "--device", "cpu", "--sampler", "dpmpp", "--steps", "2", "2"]
SPANS = ("preprocess", "stage1", "stage2_view0", "elevation", "stage2", "reconstruct")
POLAR = 60.0  # the pinned elevation estimate: the second ring is views 4-7


def _jax_example(name: str) -> ast.Module:
    with open(os.path.join(REPO, "examples", name)) as f:
        return ast.parse(f.read())


def jax_record_keys(name: str) -> list:
    """The key sets of every dict literal that the JAX example prints
    with ``json.dumps`` (``**`` entries left out)."""
    out = []
    for node in ast.walk(_jax_example(name)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            out.append({k.value for k in node.args[0].keys if k is not None})
    return out


def jax_stage_lines() -> dict:
    """{stage name: its extra keys} of the JAX stage probe's ``emit`` calls."""
    lines = {}
    for node in ast.walk(_jax_example("stage_probe.py")):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "emit":
            lines[node.args[0].value] = {k.arg for k in node.keywords}
    return lines


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipe():
    from examples.torch_walkthrough import tiny_config
    from one2345_tpu_torch.pipeline.cli import apply_fast_modes
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    cfg = apply_fast_modes(tiny_config(), sampler="dpmpp", steps=(2, 2))
    p = One2345Pipeline(cfg, use_sam=False, device="cpu")
    p.estimate_elevation = lambda views: POLAR
    return p


def _same_result(a, b):
    assert torch.equal(a.stage1_images, b.stage1_images)
    assert torch.equal(a.stage2_images, b.stage2_images)
    assert a.elevation == b.elevation
    for key in ("vertices", "faces", "colors"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key


def test_throughput_probe_keys_and_run_many_equal_sequential_runs(pipe, capsys):
    """[a, b, a] at seeds [1, 2, 1]: two in flight against one at a time
    (``run_many(max_in_flight=1)`` is ``run`` after ``run``)."""
    (jax_keys,) = jax_record_keys("throughput_probe.py")
    seq, seq_results = torch_throughput_probe.main(
        FLAGS + ["--seeds", "1", "2", "1", "--in_flight", "1"], pipeline=pipe)
    par, par_results = torch_throughput_probe.main(
        FLAGS + ["--seeds", "1", "2", "1", "--warmups", "0"], pipeline=pipe)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines == [seq, par]
    assert set(par) == jax_keys | {"seeds", "device", "host_cpu_s_per_mesh"}
    assert par["requests"] == 3 and par["in_flight"] == 2
    assert par["mode"] == "dpmpp 2/2" and par["seeds"] == [1, 2, 1]
    for a, b in zip(seq_results, par_results):
        _same_result(a, b)
    _same_result(seq_results[0], seq_results[2])
    assert not torch.equal(seq_results[0].stage1_images, seq_results[1].stage1_images)
    assert par["mesh_vertices"] == [len(r.vertices) for r in seq_results]


def test_profile_twin_writes_under_the_temporary_directory_by_default(tmp_path,
                                                                     monkeypatch):
    """No fixed path: without --trace_dir the trace goes to one2345_trace
    in the temporary directory ($TMPDIR), so two checkouts' users do not
    share it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = torch_profile_pipeline.trace_path()
    assert path == str(tmp_path / "one2345_trace" / torch_profile_pipeline.TRACE_NAME)
    assert os.path.isdir(os.path.dirname(path))
    assert torch_profile_pipeline.trace_path(str(tmp_path / "t")) == str(
        tmp_path / "t" / torch_profile_pipeline.TRACE_NAME)


def test_a_given_pipeline_must_match_the_flags(pipe):
    with pytest.raises(ValueError, match="config"):
        torch_throughput_probe.main(["--tiny", "--device", "cpu"], pipeline=pipe)


def test_stage_probe_prints_the_jax_probe_s_lines(pipe):
    lines = jax_stage_lines()
    records = torch_stage_probe.main(FLAGS + ["--repeats", "1"], pipeline=pipe)
    want = [s for s in lines if s != "preprocess_sam"]  # no --sam: no SAM line
    assert [r["stage"] for r in records] == want
    for r in records:
        assert set(r) == {"stage", "best_s", "mean_s"} | lines[r["stage"]]
        assert 0 <= r["best_s"] <= r["mean_s"]
    assert next(r for r in records if r["stage"] == "reconstruct")["mesh_resolution"] == 24


def test_fast_mode_probe_keys_and_median(pipe):
    (jax_keys,) = jax_record_keys("fast_mode_probe.py")
    record, results = torch_fast_mode_probe.main(FLAGS, pipeline=pipe)
    assert set(record) == jax_keys | {"median_s"}
    assert tuple(record["timings"]) == SPANS
    runs = sorted(record["all_runs_s"])
    assert len(runs) == 3 == len(results) and record["secs_image_to_mesh"] == runs[0]
    assert record["median_s"] == runs[1]
    best = results[record["all_runs_s"].index(runs[0])]
    assert record["mesh_vertices"] == len(best.vertices) > 0


def test_fast_mode_probe_skips_its_warm_up_on_request(pipe, monkeypatch):
    """--warmups 0 (a pipeline that has run at these shapes): the three
    timed runs at seeds 1-3 and no other."""
    seeds = []
    run = pipe.run
    monkeypatch.setattr(pipe, "run", lambda *a, **k: seeds.append(k["seed"]) or run(*a, **k))
    record, _ = torch_fast_mode_probe.main(FLAGS + ["--warmups", "0"], pipeline=pipe)
    assert seeds == [1, 2, 3] and len(record["all_runs_s"]) == 3


def test_profile_twin_writes_a_trace_with_the_run_s_spans(pipe, tmp_path):
    path, spans = torch_profile_pipeline.main(FLAGS + ["--trace_dir", str(tmp_path)],
                                              pipeline=pipe)
    assert path == str(tmp_path / torch_profile_pipeline.TRACE_NAME)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert tuple(spans) == SPANS and set(SPANS) <= names


@pytest.mark.parametrize("recon", [False, True], ids=["zero123", "recon"])
def test_train_probe_keys(recon):
    (jax_keys,) = [k for k in jax_record_keys("train_probe.py") if ("n_rays" in k) == recon]
    flags = ["--tiny", "--device", "cpu", "--iters", "1", "--batch", "2"]
    record = torch_train_probe.main(flags + (["--recon"] if recon else []))
    assert set(record) == jax_keys  # no memory keys on the CPU
    assert record["loss_finite"] and record["sec_per_step"] > 0


@pytest.mark.parametrize("twin", [torch_throughput_probe, torch_stage_probe,
                                  torch_fast_mode_probe, torch_profile_pipeline,
                                  torch_train_probe])
def test_twins_run_on_the_card_by_default(twin):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main(["--tiny"])


def _hammer(count, threads: int = 8, each: int = 10_000):
    def work():
        for _ in range(each):
            count()

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return threads * each


@pytest.mark.parametrize("name", ["launch_count", "staged_count", "dq_launch_count",
                                  "dkv_launch_count", "bwd_staged_count"])
def test_flash_counters_lose_nothing_under_threads(name):
    f = fa.flash_attention
    before = getattr(f, name)
    n = _hammer(lambda: fa._count(name))
    assert getattr(f, name) == before + n
    setattr(f, name, before)


def test_int8_counter_loses_nothing_under_threads():
    before = quantize.int8_matmul.launch_count
    n = _hammer(quantize._count_launch)
    assert quantize.int8_matmul.launch_count == before + n
    quantize.int8_matmul.launch_count = before


@pytest.mark.parametrize("device", [None, "cpu"])
def test_timer_keeps_its_spans_on_the_cpu(device):
    timer = Timer(device=device)
    for name in ("a", "b", "a"):
        with timer.span(name):
            torch.ones(4).sum()
    assert list(timer.report()) == ["a", "b"]
    assert all(v > 0 for v in timer.report().values())
    assert timer.total() == pytest.approx(sum(timer.spans.values()))
