"""The real-weights runbook's twin (examples/torch_validate_real_weights.py)
offline: the download phase without egress and with every file present,
the convert phase on small reference-format files (those of
tests/test_torch_convert_weights.py: the manifest, a skip for the same
set, a reconversion for a changed one), ``--dry_run``, and (``slow``, as
tests/test_validate_runbook.py) the fast-mode A/B phase at the tiny config
on random weights, with the JAX phase's report keys."""

import json
import os
import urllib.error

import numpy as np
import pytest
import torch

import chip_smoke
from examples import torch_validate_real_weights as rb
from one2345_tpu_torch.core import checkpoint
from one2345_tpu_torch.utils import convert_cli
from one2345_tpu_torch.utils import download_ckpt as dl
from tests.test_torch_convert_weights import loftr_weights, recon_weights
from tests.torch_dist_workers import tiny_pipeline


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_download_without_egress_prints_guidance(tmp_path, monkeypatch, capsys):
    def deny(req, timeout=None):
        raise urllib.error.URLError(OSError("network unreachable"))

    monkeypatch.setattr(dl.urllib.request, "urlopen", deny)
    assert rb.phase_download(str(tmp_path), skip=False) is None
    out = capsys.readouterr().out
    assert "[1/5] download FAILED" in out and f"place the files in {tmp_path}/" in out
    assert rb.phase_download(str(tmp_path), skip=True) is None


def test_download_with_every_file_present_makes_no_request(tmp_path, monkeypatch):
    def forbid(*a, **k):
        raise AssertionError("must not hit the network")

    monkeypatch.setattr(dl.urllib.request, "urlopen", forbid)
    for name in dl.CKPTS:
        (tmp_path / name).write_bytes(b"\0")
    assert rb.phase_download(str(tmp_path), skip=False) == {
        n: str(tmp_path / n) for n in dl.CKPTS}


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """indoor_ds_new.ckpt and ckpt_215000.pth of full-width seeded weights,
    in the reference's format (chip_smoke.py's inverse)."""
    root = tmp_path_factory.mktemp("ckpts")
    weights = {"loftr": loftr_weights(61), "recon": recon_weights(1, 62)}
    torch.save(chip_smoke.reference_loftr(weights["loftr"]), root / "indoor_ds_new.ckpt")
    torch.save(chip_smoke.reference_recon(weights["recon"]), root / "ckpt_215000.pth")
    return root, weights


def test_convert_writes_a_manifest_and_skips_the_same_set(reference_files, tmp_path,
                                                          monkeypatch, capsys):
    root, weights = reference_files
    calls = []
    convert = convert_cli.main
    monkeypatch.setattr(convert_cli, "main", lambda argv: calls.append(argv) or convert(argv))
    params = str(tmp_path / "params.pt")
    paths = {"indoor_ds_new.ckpt": str(root / "indoor_ds_new.ckpt")}
    assert rb.phase_convert(paths, params) == params
    with open(tmp_path / "params.manifest.json") as f:
        assert json.load(f) == ["indoor_ds_new.ckpt"]
    assert calls == [["--out", params, "--loftr", paths["indoor_ds_new.ckpt"]]]
    tree = checkpoint.restore(params)
    assert chip_smoke.tree_differences(tree, {"loftr": weights["loftr"]}) == []
    # the same set again: no conversion
    assert rb.phase_convert(dict(paths), params) == params and len(calls) == 1
    assert "already covers ['indoor_ds_new.ckpt']" in capsys.readouterr().out
    # a file arrived: the whole set is converted again
    paths["ckpt_215000.pth"] = str(root / "ckpt_215000.pth")
    assert rb.phase_convert(paths, params) == params and len(calls) == 2
    assert "checkpoint set changed" in capsys.readouterr().out
    with open(tmp_path / "params.manifest.json") as f:
        assert json.load(f) == ["ckpt_215000.pth", "indoor_ds_new.ckpt"]
    tree = checkpoint.restore(params)
    assert chip_smoke.tree_differences(tree, weights) == []
    assert rb.phase_convert({}, str(tmp_path / "none.pt")) is None


def test_dry_run_stops_after_convert(reference_files, tmp_path):
    root, _ = reference_files
    work = str(tmp_path / "work")
    assert rb.main(["--work", work, "--dry_run", "--skip_download"]) == 0
    assert sorted(os.listdir(work)) == []  # no checkpoint, nothing converted
    assert rb.main(["--work", work, "--ckpt_dir", str(root), "--dry_run",
                    "--skip_download"]) == 0
    assert sorted(os.listdir(work)) == ["params.manifest.json", "params.pt"]


def test_the_runbook_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rb.main(["--work", str(tmp_path), "--skip_download"])


@pytest.mark.slow  # three tiny pipelines and a CLIP tower, as the JAX test
def test_fast_mode_ab_phase_random_weights(tmp_path):
    from one2345_tpu_torch.eval.clip_metric import ClipScorer

    pipe = tiny_pipeline()
    cfg = pipe.config
    rng = np.random.default_rng(0)
    pre = np.ones((32, 32, 3), np.float32)
    pre[8:24, 8:24] = rng.uniform(0.2, 0.8, (16, 16, 3)).astype(np.float32)
    baseline = pipe.run(pre, skip_preprocess=True, seed=0)
    scorer = ClipScorer(config=cfg.diffusion.clip, device="cpu")
    assert rb.phase_fast_mode_ab(None, str(tmp_path), pre, baseline, make_config=lambda: cfg,
                                 scorer=scorer, device="cpu")
    with open(tmp_path / "fast_mode_ab.json") as f:
        report = json.load(f)
    assert set(report) == {"weights", "baseline_secs", "modes"}
    assert report["weights"] == "random"
    assert set(report["modes"]) == {"dpmpp", "dpmpp_int8"}
    for mode, row in report["modes"].items():
        assert set(row) == {"secs", "first_run_wall_secs", "clip_sim_stage1_vs_baseline",
                            "chamfer_l2", "chamfer_l1", "f_score"}
        assert row["secs"] > 0
        assert -1.0 <= row["clip_sim_stage1_vs_baseline"] <= 1.0
        assert np.isfinite(row["chamfer_l2"]) and np.isfinite(row["f_score"])
        assert os.path.isfile(tmp_path / "ab" / mode / "mesh.ply")
