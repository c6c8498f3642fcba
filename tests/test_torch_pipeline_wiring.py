"""Inter-stage contract test of the port: oracle diffusion through its runner.

The port's twin of tests/test_pipeline_wiring.py (``examples/
torch_pipeline_wiring.py`` tier A): the port's ``One2345Pipeline.run`` with
the diffusion stage replaced by an oracle that rasterizes the GT box at
EXACTLY the world poses the delta tables claim each view has.  The 32
images the runner hands ``reconstruct()`` must be the pictures at
``build_recon_cameras``' pack poses (any azimuth sign flip, view-order
swap or normalization mismatch between the delta tables and the recon rig
breaks that), and a flipped-azimuth control must collapse: the JAX test's
three cases and gates, at 96^2.  Then the port's source images and pack
against the JAX runner's (32^2, polar 75: equal but at the rasteriser's
ties, as tests/test_torch_eval.py bounds it), the helpers against JAX on a
fixed mesh, and a mechanics run of tier B.
"""

import numpy as np
import pytest
import torch

from examples import torch_pipeline_wiring as tpw
from tests.torch_port_helpers import assert_equal_but_ties


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_oracle_wiring_exact_and_flipped_control():
    res = tpw.wiring_check(polar=75.0, size=96, device="cpu")
    # correct wiring: the oracle render and the pack render are the SAME
    # picture for every one of the 32 source rows and the query view
    assert res["psnr_min"] > 40.0, res
    assert res["psnr_query"] > 40.0, res

    flipped = tpw.wiring_check(polar=75.0, size=96, flip_azimuth=True, device="cpu")
    # the contract bug must be loudly visible (the dy=0 deltas are
    # sign-invariant, so the MIN over views is the discriminator)
    assert flipped["psnr_min"] < 25.0, flipped
    assert flipped["psnr_min"] < res["psnr_min"]


def test_oracle_wiring_high_elevation_branch():
    """polar > 75 selects the other stage-1 candidate set: the ordering
    contract must hold on that branch too."""
    res = tpw.wiring_check(polar=105.0, size=96, device="cpu")
    assert res["psnr_min"] > 40.0, res


def _recorded_renders(monkeypatch, module):
    """Record (K, w2c) of every rasterize call of ``module``'s oracle,
    keyed by the bytes of the image it made."""
    from one2345_tpu_torch.eval import render_harness as port_rh
    from one2345_tpu.eval import render_harness as jax_rh

    rh = port_rh if module is port_rh else jax_rh
    seen = {}
    raster = rh.rasterize

    def recording(verts, faces, colors, K, w2c, *args, **kwargs):
        rgb, alpha = raster(verts, faces, colors, K, w2c, *args, **kwargs)
        seen[np.asarray(rgb, np.float32).tobytes()] = (np.asarray(K, np.float64),
                                                       np.asarray(w2c, np.float64), alpha)
        return rgb, alpha

    monkeypatch.setattr(rh, "rasterize", recording)
    return seen


def test_source_images_and_pack_match_the_jax_runner(monkeypatch):
    from examples import pipeline_wiring as jpw
    from one2345_tpu.eval import render_harness as jax_rh
    from one2345_tpu_torch.eval import render_harness as port_rh

    size, polar = 32, 75.0
    port_seen = _recorded_renders(monkeypatch, port_rh)
    rec = tpw._RecorderRecon()
    tpw.build_pipeline(polar, size, False, rec, device="cpu").run(
        np.ones((size, size, 3), np.float32), skip_preprocess=True, seed=0)
    jax_seen = _recorded_renders(monkeypatch, jax_rh)
    jrec = jpw._RecorderRecon()
    jpw.build_pipeline(polar, size, False, jrec).run(
        np.ones((size, size, 3), np.float32), skip_preprocess=True, seed=0)

    got, ref = rec.calls[-1], jrec.calls[-1]
    assert got["images"].shape == ref["images"].shape == (32, size, size, 3)
    for key, value in ref["cameras"].items():
        if isinstance(value, np.ndarray):
            np.testing.assert_allclose(got["cameras"][key], value, rtol=0, atol=1e-6,
                                       err_msg=key)
    verts, faces, _ = tpw.make_world_box()
    n_ties = 0
    for k in range(32):
        img, jimg = got["images"][k], ref["images"][k]
        K, w2c, alpha = port_seen[img.astype(np.float32).tobytes()]
        jK, jw2c, jalpha = jax_seen[jimg.astype(np.float32).tobytes()]
        np.testing.assert_allclose(K, jK, rtol=1e-12)
        np.testing.assert_allclose(w2c, jw2c, atol=1e-6)
        n_ties += assert_equal_but_ties(verts, faces, jK, jw2c, (img, alpha), (jimg, jalpha))
    assert n_ties <= 32 * 4, n_ties


def test_world_box_normalization_and_scoring_match_jax(monkeypatch):
    """make_world_box, world_to_normalized and score_mesh_vs_world_box on a
    fixed mesh (the box, its vertices moved 1 % and its colours shifted),
    with 2048 surface points on both sides (the JAX function's 16384
    replaced through its metrics module)."""
    from examples import pipeline_wiring as jpw
    from examples import torch_recon_quality as trq
    from one2345_tpu.eval import metrics as jax_metrics
    from one2345_tpu_torch.geometry.cameras import build_recon_cameras

    for got, ref in zip(tpw.make_world_box(), jpw.make_world_box()):
        np.testing.assert_array_equal(got, ref)
    pack = build_recon_cameras(75.0)
    rng = np.random.default_rng(0)
    verts, faces, colors = tpw.make_world_box()
    verts = verts * (1.0 + 0.01 * rng.standard_normal(verts.shape)).astype(np.float32)
    colors = np.clip(colors + 0.05, 0, 1)
    np.testing.assert_allclose(tpw.world_to_normalized(verts, pack),
                               jpw.world_to_normalized(verts, pack), rtol=0, atol=1e-6)

    sample = jax_metrics.sample_surface
    monkeypatch.setattr(jax_metrics, "sample_surface",
                        lambda v, f, n, seed=0: sample(v, f, 2048, seed=seed))
    monkeypatch.setattr(trq, "SURFACE_POINTS", 2048)
    images = rng.uniform(size=(32, 32, 32, 3)).astype(np.float32)
    got = tpw.score_mesh_vs_world_box(verts, faces, colors, images, pack, 32, device="cpu")
    ref = jpw.score_mesh_vs_world_box(verts, faces, colors, images, pack, 32)
    assert set(got) == set(ref) == {"pred_verts", "chamfer_l1", "f_score_05", "f_score_10",
                                    "color_frac_scored", "color_mae", "color_mae_bestview"}
    for key, value in ref.items():
        assert got[key] == pytest.approx(value, abs=1e-5), key


def test_tier_b_mechanics(monkeypatch):
    """run_benchmark at a few steps on the CPU: both tiers, the trained
    recon through the full runner, the flipped control; the keys of the
    JSON and finite values."""
    from examples import torch_recon_quality as trq

    monkeypatch.setattr(trq, "SURFACE_POINTS", 2048)
    out = tpw.run_benchmark(polar=75.0, size=32, steps=2, n_rays=32, vol=16,
                            mesh_resolution=32, log_every=1, n_samples=8, n_importance=8,
                            normal_query_prob=0.0, device="cpu")
    assert set(out) == {"tier_a", "tier_a_flipped", "e2e", "e2e_flipped", "total_secs"}
    assert out["tier_a"]["psnr_min"] > 40.0 and out["tier_a_flipped"]["psnr_min"] < 25.0
    for label in ("e2e", "e2e_flipped"):
        score = out[label]
        assert score["pred_verts"] > 0, score
        assert {"chamfer_l1", "f_score_05", "f_score_10"} <= set(score), score
        assert all(np.isfinite(v) for v in score.values()), score
