"""The quality examples' torch twins against the JAX examples, on the CPU.

Each helper of ``examples/torch_{recon_quality,diffusion_quality,
generative_e2e}.py`` against its JAX twin on the same numpy inputs: the GT
meshes and ``box_surface_distance`` exactly; ``scaled_camera_pack``;
``render_views`` / ``render_pose_views`` equal but at the rasteriser's
ties (as tests/test_torch_eval.py bounds it); ``vertex_normals``,
``bestview_vertex_colors``, ``make_view_plan``, ``psnr01`` and ``ssim01``;
``held_out_view_psnr`` on recon weights converted with ``recon_from_jax``;
``build_training_set`` (images and all 44 pairs); one ``pretrain_vae``
step against an optax Adam step with the same batch indices and posterior
noise.  Then a mechanics run of each ``run_benchmark`` at a few steps:
the keys of the JSON and finite values (the trained gates are the slow
tests' business, tests/test_torch_quality_examples_slow.py), and the
refusal of a polar above 75 by the generative twin.
"""

import math

import numpy as np
import pytest
import torch

from examples import torch_diffusion_quality as tdq
from examples import torch_generative_e2e as tge
from examples import torch_recon_quality as trq
from tests.torch_port_helpers import (
    COLOR_ULPS, assert_equal_but_ties, example_diffusion_config, randomize, recon_test_params,
)

VAE_LOSS_TOL = 1e-5  # relative, the loss of one batch, f32
# one Adam step moves every element by ~lr * sign(g): an element whose true
# gradient is 0 (the biases of the convs before a one-channel-per-group
# GroupNorm, the attention's key bias under softmax's shift invariance) moves
# by its f32 noise over |noise|, so the two sides may differ there by up to
# 2 lr; as may an element whose f32 gradients differ by 1 % of themselves
VAE_GRAD_TOL = 1e-5  # relative L2 over the tree, the gradients of one batch
VAE_STEP_TOL = 1e-6  # abs, after the step, every other element
VAE_ZERO_GRAD = 1e-6  # |JAX gradient| at most this x its largest: "0 within noise"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _full_f32():
    import jax

    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(autouse=True)
def _quiet_degenerate():
    """The tie check divides by the zero det of degenerate faces (masked)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        yield


def test_gt_meshes_and_box_distance_exact():
    from examples import recon_quality as jrq

    for got, ref in ((trq.make_gt_sphere(), jrq.make_gt_sphere()),
                     (trq.make_gt_sphere(8, 12, 0.3), jrq.make_gt_sphere(8, 12, 0.3)),
                     (trq.make_gt_box(), jrq.make_gt_box())):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    p = np.random.default_rng(0).uniform(-1, 1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(trq.box_surface_distance(p), jrq.box_surface_distance(p))


def test_camera_pack_renders_normals_and_bestview():
    from examples import recon_quality as jrq

    pack, jpack = trq.scaled_camera_pack(90.0, 16), jrq.scaled_camera_pack(90.0, 16)
    assert set(pack) == set(jpack)
    for k, v in jpack.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(pack[k], v, rtol=0, atol=1e-6, err_msg=k)
    verts, faces, colors = trq.make_gt_box()
    got = trq.render_views(verts, faces, colors, pack, 16, device="cpu")
    ref = jrq.render_views(verts, faces, colors, jpack, 16)
    for i in (0, 1, 9, 20, 32):
        assert_equal_but_ties(verts, faces, jpack["intrinsics"][i], jpack["w2cs"][i],
                              (got[0][i], got[1][i]), (ref[0][i], np.asarray(ref[1][i])))
    normals = trq.vertex_normals(verts, faces)
    np.testing.assert_array_equal(normals, jrq.vertex_normals(verts, faces))
    near = verts[::7]
    args = (near, normals[::7], ref[0][1:], jpack["w2cs"][1:], jpack["intrinsics"][1:])
    np.testing.assert_array_equal(trq.bestview_vertex_colors(*args),
                                  jrq.bestview_vertex_colors(*args))


def test_pose_views_view_plan_and_scores():
    from examples import diffusion_quality as jdq

    for kw in ({}, {"n_azim": 6}, {"cond_polar": 60.0, "dx_set": (0.0,), "n_azim": 8}):
        assert tdq.make_view_plan(**kw) == jdq.make_view_plan(**kw)
    polars, azims = [75.0, 55.0, 95.0], [0.0, 135.0, 285.0]
    got = tdq.render_pose_views(polars, azims, 32, device="cpu")
    ref = jdq.render_pose_views(polars, azims, 32)
    from one2345_tpu.geometry.cameras import BLENDER2OPENCV, spherical_look_at_poses

    verts, faces, _ = trq.make_gt_box()
    w2cs = np.linalg.inv(spherical_look_at_poses(np.radians(polars), np.radians(azims),
                                                 radius=1.6) @ BLENDER2OPENCV)
    K = np.array([[38.4, 0, 16], [0, 38.4, 16], [0, 0, 1.0]])
    for i in range(3):
        assert_equal_but_ties(verts, faces, K, w2cs[i].astype(np.float32),
                              (got[i], (got[i] < 1).any(-1)), (ref[i], (ref[i] < 1).any(-1)))
    rng = np.random.default_rng(1)
    a, b = rng.uniform(size=(2, 16, 16, 3))
    assert tdq.psnr01(a, b) == jdq.psnr01(a, b) and tdq.psnr01(a, a) == jdq.psnr01(a, a)
    assert tdq.ssim01(a, b) == jdq.ssim01(a, b) and tdq.ssim01(a, a) == jdq.ssim01(a, a)


HELD = dict(image_hw=(16, 16), vol_dims=(8, 8, 8), voxel_size=2.0 / 7.0, n_samples=8,
            n_importance=8)
HELD_TOL = 1e-3  # dB, PSNR of the held-out render (renders within f32 noise)


def test_held_out_view_psnr_matches_jax():
    """Full-frame and masked PSNR at a held-out azimuth of the 16^2 rig,
    the port's Validator on recon_from_jax weights against the JAX one (each
    JAX call compiles its renderer anew: one azimuth)."""
    from examples import recon_quality as jrq
    from one2345_tpu.core.config import ReconConfig as JaxReconConfig
    from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.utils.convert_jax import recon_from_jax

    params = recon_test_params(HELD, seed=7)
    jstage = JaxReconStage(JaxReconConfig(**HELD), params=params)
    port = ReconStage(ReconConfig(**HELD), params=recon_from_jax(params), device="cpu")
    gt = trq.make_gt_sphere(8, 12)
    pack = trq.scaled_camera_pack(90.0, 16)
    pack_nm = {k: v for k, v in pack.items() if k not in ("scale_mat", "trans_mat")}
    images = trq.render_views(*gt, pack, 16, device="cpu")[0]
    got = trq.held_out_view_psnr(port, images[1:], pack_nm, *gt, res=16, azimuth_deg=200.0)
    ref = jrq.held_out_view_psnr(jstage, images[1:], pack_nm, *gt, res=16, azimuth_deg=200.0)
    assert got == pytest.approx(ref, abs=HELD_TOL), (got, ref)


def test_build_training_set_matches_jax():
    from examples import generative_e2e as jge

    images, pairs = tge.build_training_set(75.0, 16, device="cpu")
    jimages, jpairs = jge.build_training_set(75.0, 16)
    assert pairs == jpairs and len(pairs) == 44
    assert images.shape == jimages.shape == (45, 16, 16, 3)
    # no pixel of these 45 renders sits on a rasteriser tie: equal within
    # the rounding of the barycentrics
    assert np.abs(images - jimages).max() <= COLOR_ULPS
    assert {c for c, *_ in pairs} == {0, *range(1, 9)}


def test_polar_above_75_is_refused(capsys):
    with pytest.raises(ValueError, match="polar 80.0 > 75.0"):
        tge.run_benchmark(polar=80.0, device="cpu")
    with pytest.raises(SystemExit):
        tge.main(["--polar", "80", "--device", "cpu"])
    assert "pairs the model never learned" in capsys.readouterr().err


def test_one_pretrain_vae_step_matches_optax():
    """The loss of one batch and the encoder / decoder after one Adam step,
    with the JAX example's loss (its posterior draw given) under
    optax.adam, on the same batch indices and posterior noise."""
    import jax
    import jax.numpy as jnp
    import optax

    from one2345_tpu.diffusion.zero123 import Zero123Stage as JaxZero123Stage
    from one2345_tpu_torch.diffusion.zero123 import Zero123Stage
    from one2345_tpu_torch.utils.convert_jax import flax_to_state_dict, zero123_from_jax

    # the examples' tiny stage with a two-level VAE (half the JAX compile)
    jcfg = example_diffusion_config(False, 16)
    jcfg = jcfg.replace(vae=jcfg.vae.replace(base_channels=8, channel_mult=(1, 2)))
    tcfg = example_diffusion_config(True, 16)
    tcfg = tcfg.replace(vae=tcfg.vae.replace(base_channels=8, channel_mult=(1, 2)))
    shapes = jax.eval_shape(JaxZero123Stage(jcfg, params={}).init_params, jax.random.key(0))
    params = randomize(shapes, 11)
    jst = JaxZero123Stage(jcfg, params=params)
    port = Zero123Stage(tcfg, params=zero123_from_jax(params), device="cpu")

    rng = np.random.default_rng(2)
    images = rng.uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
    idx = np.array([4, 1, 4], np.int64)
    eps = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)  # latent 16 / 2
    lr = 2e-3

    def loss_fn(p, x, eps):  # examples/diffusion_quality.py's, the draw given
        moments = jst.encoder.apply(p["encoder"], x)
        mean, logvar = jnp.split(moments, 2, axis=-1)
        logvar = jnp.clip(logvar, -30.0, 20.0)
        rec = jst.decoder.apply(p["decoder"], mean + jnp.exp(0.5 * logvar) * eps)
        kl = 0.5 * jnp.mean(mean**2 + jnp.exp(logvar) - 1.0 - logvar)
        return jnp.mean((rec - x) ** 2) + 1e-6 * kl

    p = {"encoder": params["encoder"], "decoder": params["decoder"]}
    tx = optax.adam(lr)
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(p, jnp.asarray(images[idx]), eps)
    updates, _ = tx.update(g, tx.init(p))
    stepped = optax.apply_updates(p, updates)

    enc, dec = tdq._vae_modules(port)
    got_loss = tdq.vae_loss(enc, dec, torch.as_tensor(images[idx]), torch.as_tensor(eps))
    assert float(got_loss.detach()) == pytest.approx(float(loss), rel=VAE_LOSS_TOL)
    got_loss.backward()
    vae, _, _ = tdq.pretrain_vae(port, images, 1, lr, 3, seed=0,
                                 draw_fn=lambda i: {"idx": idx, "z_eps": eps})
    # the gradients, over the whole tree; then the step, element by element
    grads = {part: flax_to_state_dict(jax.device_get(g[part])) for part in ("encoder", "decoder")}
    diff = sq = 0.0
    for part, module in (("encoder", enc), ("decoder", dec)):
        for k, p_ in module.named_parameters():
            want = grads[part][k].numpy().astype(np.float64)
            diff += float(((p_.grad.numpy() - want) ** 2).sum())
            sq += float((want**2).sum())
    assert math.sqrt(diff / sq) <= VAE_GRAD_TOL, math.sqrt(diff / sq)
    g_max = max(float(np.abs(x.numpy()).max()) for d in grads.values() for x in d.values())
    n_exact = n_free = 0
    for part, module in (("encoder", enc), ("decoder", dec)):
        ref = flax_to_state_dict(jax.device_get(stepped[part]))
        assert set(ref) == set(vae[part])
        for k, p_ in module.named_parameters():
            err = np.abs(vae[part][k].numpy().astype(np.float64) - ref[k].numpy())
            gj = np.abs(grads[part][k].numpy())
            # the step's direction is set only where the gradient is
            free = (gj <= VAE_ZERO_GRAD * g_max) | (
                np.abs(p_.grad.numpy() - grads[part][k].numpy()) >= 1e-2 * gj)
            assert (err[~free] <= VAE_STEP_TOL).all(), (part, k, err[~free].max())
            assert (err <= 2.0 * lr).all(), (part, k)
            n_exact += int((~free).sum())
            n_free += int(free.sum())
    assert n_free <= 0.05 * (n_exact + n_free), (n_free, n_exact)


def _finite(d: dict) -> bool:
    return all(_finite(v) if isinstance(v, dict) else
               (isinstance(v, str) or math.isfinite(v)) for v in d.values())


def test_recon_quality_mechanics(monkeypatch):
    monkeypatch.setattr(trq, "SURFACE_POINTS", 2048)
    out = trq.run_benchmark(steps=2, res=16, vol=16, n_rays=32, n_samples=8, n_importance=8,
                            mesh_resolution=32, log_every=1, ft_steps=2, device="cpu")
    keys = {"steps", "res", "vol_dims", "n_rays", "num_lods", "shape", "normal_query_prob",
            "train_secs", "sec_per_step", "psnr_first", "psnr_last", "pred_verts",
            "pred_radius_p10", "pred_radius_p50", "pred_radius_p90", "chamfer_l1",
            "chamfer_l2", "f_score_05", "f_score_10", "junk_frac", "psnr_heldout",
            "psnr_heldout_masked", "psnr_heldout_random", "psnr_heldout_masked_random",
            "heldout_margin_min", "ft_steps", "ft_color_first", "ft_color_last",
            "ft_pred_verts", "ft_secs", "total_secs"}
    assert keys <= set(out), keys - set(out)
    assert out["pred_verts"] > 0 and _finite(out), out


def test_diffusion_quality_mechanics(tmp_path):
    from one2345_tpu_torch.utils.png import read_png

    png = str(tmp_path / "grid.png")
    out = tdq.run_benchmark(steps=2, res=16, batch=2, vae_steps=2, sample_steps=2, n_azim=4,
                            model_channels=32, log_every=1, out_png=png, device="cpu",
                            eval_variants=tdq.fast_variants(2))
    keys = {"steps", "res", "batch", "n_train", "n_heldout", "sample_steps", "sampler",
            "cfg_scale", "vae_steps", "vae_psnr", "latent_std", "scale_factor",
            "eps_mse_first", "eps_mse_last", "psnr_heldout", "psnr_heldout_min",
            "psnr_heldout_untrained", "psnr_heldout_live", "ssim_heldout", "pose_hits",
            "pose_margin_db", "vae_secs", "train_secs", "sec_per_step", "sample_secs",
            "total_secs", "variants"}
    assert set(out) == keys and _finite(out), out
    assert set(out["variants"]) == {"dpmpp_same_steps", "dpmpp_fast", "int8", "int8_dpmpp_fast"}
    assert out["n_train"] == 12 and out["n_heldout"] == 6
    assert read_png(png).shape == (3 * 16, 6 * 16, 3)


def test_generative_e2e_mechanics(monkeypatch):
    monkeypatch.setattr(trq, "SURFACE_POINTS", 2048)
    out = tge.run_benchmark(size=16, batch=2, diff_steps=2, vae_steps=2, recon_steps=2,
                            n_rays=32, vol=16, sample_steps=2, mesh_resolution=32,
                            model_channels=32, log_every=1, n_samples=8, n_importance=8,
                            device="cpu")
    assert {"polar", "size", "diff_steps", "recon_steps", "sample_steps", "vae_psnr",
            "latent_std", "eps_mse_first", "eps_mse_last", "vae_secs", "diff_train_secs",
            "e2e", "e2e_untrained", "total_secs"} == set(out)
    for label in ("e2e", "e2e_untrained"):
        score = out[label]
        assert {"pred_verts", "stage1_psnr_mean", "stage2_psnr_mean", "stage2_psnr_min",
                "run_secs"} <= set(score), score
    assert _finite(out), out
