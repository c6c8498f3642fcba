"""The quality examples' torch twins trained at the JAX tests' CI configs.

The port's twins of tests/test_recon_quality.py, test_diffusion_quality.py
and test_generative_e2e.py: the same configurations and the same gates
(``chip_smoke.py``'s ``*_gates`` lists, which phase 19 applies to the same
runs on the card), here on the CPU in f32.  Real (tiny) training runs, so
marked slow, as their JAX twins are.
"""

import numpy as np
import pytest

import chip_smoke
from examples import torch_diffusion_quality as tdq
from examples import torch_generative_e2e as tge
from examples import torch_recon_quality as trq

pytestmark = pytest.mark.slow


def _gates(name, gates, out):
    failed = [g for g, ok in gates if not ok]
    assert not failed, (name, failed, out)


def test_train_reconstruct_quality():
    """Measured on the CPU (seed 0, torch 2.13 CPU build, f32):
    psnr 12.56 -> 21.19 (+8.63 dB: the first gate fails), pred_verts
    37435, pred_radius_p10 0.4529, chamfer_l1_obs 0.1405, f_score_10_obs
    0.5235, junk_frac 0.5968, color_mae_bestview 0.0138, color_mae 0.085,
    held-out masked margin +10.69 dB, psnr_heldout 20.01; finetune colour
    0.2051 -> 0.094, ft_chamfer_l1_obs 0.1276, ft_f_score_10_obs 0.4214,
    ft_color_mae 0.298.  The first gate compares two single batches of
    128 rays; the JAX example fails it too at seed 1 (12.86 -> 22.02), and
    the port's train PSNR per view, averaged over steps 150-299, equals
    JAX's (ROADMAP.md section 3)."""
    out = trq.run_benchmark(**chip_smoke.RECON_QUALITY_CI, device="cpu")
    print(out)
    _gates("recon_quality", chip_smoke.recon_quality_gates(out), out)


def test_diffusion_learns_view_conditioning():
    """Measured on the CPU (seed 0, f32): vae_psnr 31.64, eps-MSE 0.9906 ->
    0.0747, psnr_heldout 14.87 against 8.10 untrained (+6.77 dB),
    pose_margin +3.78 dB, pose_hits 4."""
    out = tdq.run_benchmark(**chip_smoke.DIFFUSION_QUALITY_CI, device="cpu")
    print(out)
    _gates("diffusion_quality", chip_smoke.diffusion_quality_gates(out), out)


def test_generative_pipeline_mechanics():
    """The mechanics config: both runs through the port's runner, scored
    and finite (measured on the CPU: stage2_psnr_mean 11.66 for both, the
    trained stage's zero-initialised output convs barely moved in 12
    steps; pred_verts 5218)."""
    out = tge.run_benchmark(**chip_smoke.GENERATIVE_E2E_CI, device="cpu")
    images, pairs = tge.build_training_set(75.0, 32, device="cpu")
    print(out)
    _gates("generative_e2e", chip_smoke.generative_e2e_gates(out, images, pairs), out)
    assert np.isfinite(out["e2e"]["stage2_psnr_mean"])
