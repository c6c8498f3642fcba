"""Whole runs of both drivers at toy sizes on the CPU, below the run
command's look for a card: each per-layer reader on a traced run, the
program against the plain reference (float32 on both sides, so they agree
to rounding), and ``correct`` coming out false for the lower-precision
control and for each fault a cell can have, planted in the program.

The serving runs stub the LoFTR elevation estimate (the 90 degree
fallback it takes with seeded weights anyway), which would otherwise take
most of a toy run's CPU time.  One test needs the card (``cuda`` marker):
the fp8 control at the toy sizes on the card.
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def tiny_pipeline() -> dict:
    from examples.torch_walkthrough import tiny_config

    return json.loads(tiny_config().to_json())


def serve_cell():
    cell = harness.Cell.load("one2345.ddim-c1", ROOT)
    cell.config = dict(cell.config, pipeline=tiny_pipeline())
    # DDIM 3 / 2 steps: 3 + 1 + 3 evals at B=8, 1 at B=56
    cell.traffic = dict(cell.traffic, steps=[3, 2], evals={"8": 7, "56": 1}, use_sam=False,
                        warmup_steps=[2, 2])
    return cell


def train_cell():
    cell = harness.Cell.load("zero123xl-train.b192", ROOT)
    cell.config = dict(cell.config, diffusion=tiny_pipeline()["diffusion"])
    cell.traffic = dict(cell.traffic, batch=6, image_size=32, reference_block=4,
                        profiled_steps=1)
    return cell


@pytest.fixture
def fast_elevation(monkeypatch):
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    monkeypatch.setattr(One2345Pipeline, "estimate_elevation", lambda self, views: 90.0)


def run(cell, seconds=0.0, trace=False, seed=2**31 + 11, device="cpu"):
    torch.manual_seed(0)
    result, checks, _ = harness.run(cell, seed, seconds, trace, device, time.perf_counter(),
                                    cuda=device != "cpu")
    return result, checks


def control(cell, seed=2**31 + 11, device="cpu"):
    """The checks with the control in the program's place."""
    from portbench.calibrate import control as judge

    torch.manual_seed(0)
    _, _, driver = harness.run(cell, seed, 0.0, False, device, time.perf_counter(),
                               cuda=device != "cpu")
    return driver.verify(judge=judge)


def test_serve_traced_run_reads_every_metric(fast_elevation):
    cell = serve_cell()
    result, checks = run(cell, seconds=0.5, trace=True)
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in ("preprocess_s", "sampling_s", "elevation_s", "reconstruct_s", "mfu.serve"):
        assert metrics[name]["value"] > 0, name
    # no device operations in a CPU trace: the device metrics find nothing
    assert "k1.roofline.serve" not in metrics and "device.idle.serve" not in metrics
    assert list(result)[-1] == "checks"
    assert {c.name for c in checks} == set(cell.limits["numbers"])
    # every number compared, the sampler's step too, agrees to rounding
    assert all(c.value <= 1e-4 for c in checks if c.name != "k1_launches"), result["checks"]


def test_train_traced_run_reads_every_metric():
    result, _ = run(train_cell(), seconds=0.5, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["mfu.train"]["value"] > 0
    assert "k2.roofline.train" not in result["metrics"]


def test_untraced_runs_report_end_to_end_metrics(fast_elevation):
    result, _ = run(serve_cell())
    assert set(result["metrics"]) == {"mesh_s", "setup_s"}
    result, _ = run(train_cell())
    assert set(result["metrics"]) == {"train_step_s", "setup_s"}


@pytest.mark.parametrize("cell", ["serve", "train"])
def test_fp8_control_is_not_correct(cell, fast_elevation):
    checks = control(serve_cell() if cell == "serve" else train_cell())
    assert not all(c.ok for c in checks), checks
    if cell == "serve":  # the sampler's step, in bfloat16, fails its own number
        step = {c.name: c for c in checks}["ddim_step"]
        assert step.value > 1e-4 and not step.ok, step


def _patch_unet(monkeypatch, fault):
    from one2345_tpu_torch.diffusion import unet

    orig = unet.UNetModel.forward

    def forward(self, x, timesteps, context):
        if fault == "unchanged":  # the denoiser returns its state unchanged
            return x[..., :4].float()
        if fault == "half_batch":  # half the rows computed, the rest copied
            h = (x.shape[0] + 1) // 2
            out = orig(self, x[:h], timesteps[:h], context[:h])
            return torch.cat([out, out])[: x.shape[0]]
        out = orig(self, x, timesteps, context)
        return out * 1.1  # the answer altered where it is produced

    monkeypatch.setattr(unet.UNetModel, "forward", forward)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_serve_faults_are_not_correct(fault, monkeypatch, fast_elevation):
    _patch_unet(monkeypatch, fault)
    result, _ = run(serve_cell())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["guidance", "noise"])
def test_sampler_faults_are_not_correct(fault, monkeypatch, fast_elevation):
    """The sampler's update altered where it is produced: the guidance
    scale, or the noise term of the DDIM step."""
    from one2345_tpu_torch.diffusion import zero123

    orig = zero123.ddim_sample

    def ddim_sample(eps_fn, x, sched, noise_fn=None):
        if fault == "guidance":
            return orig(lambda x, t: 1.05 * eps_fn(x, t), x, sched, noise_fn)
        return orig(eps_fn, x, sched, lambda d, s: 1.05 * noise_fn(d, s))

    monkeypatch.setattr(zero123, "ddim_sample", ddim_sample)
    result, _ = run(serve_cell())
    assert not result["correct"], result["checks"]
    assert not result["checks"]["ddim_step"]["value"] <= result["checks"]["ddim_step"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_are_not_correct(fault, monkeypatch):
    from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer
    from portbench.calibrate import half_batch

    if fault == "unchanged":  # the step returns the state unchanged
        monkeypatch.setattr(Zero123Trainer, "train_step",
                            lambda self, batch, draws=None: self.loss_fn(batch, draws).detach())
        result, _ = run(train_cell())
    else:
        with half_batch():
            result, _ = run(train_cell())
        # the half batch turns the update, and change_dir sees it
        step = result["checks"]["change_dir"]
        assert not step["value"] <= step["limit"], step
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_fp8_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    checks = control(train_cell(), device="cuda")
    assert not all(c.ok for c in checks), checks
