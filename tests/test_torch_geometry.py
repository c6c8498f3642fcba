"""one2345_tpu_torch.geometry against the JAX package's geometry modules:
sampling, projection and the camera rig, on numpy-seeded inputs, f32, CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.geometry import cameras as jax_cameras
from one2345_tpu.geometry import projection as jax_projection
from one2345_tpu.geometry import sampling as jax_sampling
from one2345_tpu_torch.geometry import cameras, projection, sampling
from tests.torch_port_helpers import max_err

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pixel_coords(rng, n, W, H):
    """Coordinates inside, on the edges of and outside a W x H map."""
    x = rng.uniform(-3.0, W + 2.0, size=n).astype(np.float32)
    y = rng.uniform(-3.0, H + 2.0, size=n).astype(np.float32)
    edges = np.array([0.0, W - 1.0, -1.0, W, 0.5, W - 1.5], np.float32)
    x[: len(edges)] = edges
    y[len(edges): 2 * len(edges)] = np.array([0.0, H - 1.0, -1.0, H, 0.5, H - 1.5], np.float32)
    return x.reshape(8, -1), y.reshape(8, -1)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(0)
    H, W, C = 13, 17, 5
    img = rng.standard_normal((H, W, C)).astype(np.float32)
    x, y = _pixel_coords(rng, 400, W, H)
    ref = jax_sampling.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    out = sampling.bilinear_sample(_t(img), _t(x), _t(y))
    assert out.shape == (8, 50, C)
    assert max_err(out, ref) <= TOL


def test_bilinear_sample_of_a_stack_samples_each_map_at_its_row():
    rng = np.random.default_rng(1)
    V, H, W, C = 3, 9, 11, 4
    imgs = rng.standard_normal((V, H, W, C)).astype(np.float32)
    x, y = _pixel_coords(rng, 3 * 40, W, H)
    x, y = x.reshape(V, -1), y.reshape(V, -1)
    out = sampling.bilinear_sample(_t(imgs), _t(x), _t(y))
    ref = np.stack([
        np.asarray(jax_sampling.bilinear_sample(jnp.asarray(imgs[v]), x[v], y[v]))
        for v in range(V)
    ])
    assert out.shape == (V, 40, C)
    assert max_err(out, ref) <= TOL


def test_trilinear_sample_matches_jax():
    """[X, Y, Z, C] volume, (x, y, z) points index X, Y, Z: no axis flip."""
    rng = np.random.default_rng(2)
    vol = rng.standard_normal((6, 7, 9, 3)).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, size=(500, 3)).astype(np.float32)
    pts[:6] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0.5], [0, 0, 0], [-1.0001, 0, 0], [0, 1.0001, 0]]
    ref = jax_sampling.trilinear_sample(jnp.asarray(vol), jnp.asarray(pts))
    out = sampling.trilinear_sample(_t(vol), _t(pts))
    assert out.shape == (500, 3)
    assert max_err(out, ref) <= TOL
    # a corner point reads its voxel exactly: X is the first axis
    assert torch.equal(out[0], _t(vol[0, 0, 0]))
    assert torch.equal(out[1], _t(vol[-1, -1, -1]))


def test_trilinear_gradient_matches_jax():
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((5, 6, 7, 2)).astype(np.float32)
    pts = rng.uniform(-0.95, 0.95, size=(64, 3)).astype(np.float32)

    def f(p):
        return jnp.sum(jax_sampling.trilinear_sample(jnp.asarray(vol), p) ** 2)

    ref = jax.grad(f)(jnp.asarray(pts))
    p = _t(pts).requires_grad_(True)
    (sampling.trilinear_sample(_t(vol), p) ** 2).sum().backward()
    assert max_err(p.grad, ref) <= 1e-4


def test_project_points_matches_jax():
    rng = np.random.default_rng(4)
    projs = cameras.build_recon_cameras(45.0)["affines"][1:5]
    pts = rng.uniform(-1.5, 1.5, size=(2000, 3)).astype(np.float32)
    for proj in projs:
        # points on the camera plane (z = 0) and behind it (z < 0)
        ref = jax_projection.project_points(jnp.asarray(pts), jnp.asarray(proj))
        out = projection.project_points(_t(pts), _t(proj))
        for a, b in zip(out, ref):
            b = np.asarray(b)
            assert np.array_equal(np.isfinite(a.numpy()), np.isfinite(b))
            assert max_err(a, b) <= TOL * max(1.0, float(np.abs(b).max()))
    # z = 0 is clamped to 1e-6 before the divide; negative z is kept
    proj = np.eye(4, dtype=np.float32)
    x, y, z = projection.project_points(_t(np.array([[2.0, 3.0, 0.0], [2.0, 3.0, -2.0]],
                                                    np.float32)), _t(proj))
    assert float(x[0]) == pytest.approx(2e6) and float(x[1]) == -1.0 and float(z[1]) == -2.0


def test_sample_features_from_maps_matches_jax():
    rng = np.random.default_rng(5)
    V, H, W, C = 4, 32, 32, 6
    pack = cameras.build_recon_cameras(60.0)
    w2cs = pack["w2cs"][1: V + 1]
    K = pack["intrinsics"][1: V + 1] / 8.0  # calibrated for 256^2 -> 32^2
    K[:, 2, 2] = 1.0
    feats = rng.standard_normal((V, H, W, C)).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, size=(3000, 3)).astype(np.float32)
    # eager, op by op: under jit XLA contracts a * b + c into one FMA, which
    # rounds the projection differently from IEEE multiply-then-add
    with jax.default_matmul_precision("highest"):
        ref_f, ref_m = jax_projection.sample_features_from_maps(
            jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(w2cs), jnp.asarray(K), (H, W)
        )
    out_f, out_m = projection.sample_features_from_maps(_t(pts), _t(feats), _t(w2cs), _t(K), (H, W))
    assert out_f.shape == (V, 3000, C) and out_m.shape == (V, 3000)
    ref_m = np.asarray(ref_m)
    assert 0.05 < ref_m.mean() < 0.95  # both sides of the frustum
    assert np.array_equal(out_m.numpy(), ref_m)
    assert max_err(out_f, ref_f) <= TOL


def test_build_recon_cameras_is_the_jax_package_s():
    for elev in (90.0, 45.0, 80.0):
        ours, ref = cameras.build_recon_cameras(elev), jax_cameras.build_recon_cameras(elev)
        assert ours.keys() == ref.keys()
        for key in ref:
            if key == "img_ids":
                assert ours[key] == ref[key]
            else:
                assert ours[key].dtype == ref[key].dtype
                np.testing.assert_array_equal(ours[key], ref[key])


def _views(C: int, calibrated: bool = False, V: int = 4, N: int = 3000, seed: int = 6):
    """32^2 feature maps [V, 32, 32, C], the rig's projections (calibrated
    for 256^2, or with ``calibrated`` for the maps' 32^2) and points on both
    sides of the frusta."""
    rng = np.random.default_rng(seed)
    pack = cameras.build_recon_cameras(60.0)
    projs = np.asarray(pack["affines"][1: V + 1], np.float32)
    if calibrated:
        K = pack["intrinsics"][1: V + 1] / 8.0
        K[:, 2, 2] = 1.0
        projs[:, :3, :4] = K @ pack["w2cs"][1: V + 1, :3, :4]
    feats = rng.standard_normal((V, 32, 32, C)).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, size=(N, 3)).astype(np.float32)
    return feats, projs, pts


@pytest.mark.parametrize("calibrated, size_hw", [(True, None), (False, (256, 256))],
                         ids=["calibrated_maps", "rescaled_maps"])
def test_back_project_features_matches_jax(calibrated, size_hw):
    feats, projs, pts = _views(C=5, calibrated=calibrated)
    # eager: under jit XLA would contract the projection's a * b + c into FMAs
    ref_f, ref_m = jax_projection.back_project_features(
        jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(projs), size_hw)
    out_f, out_m = projection.back_project_features(_t(pts), _t(feats), _t(projs), size_hw)
    assert out_f.shape == (3000, 4, 5) and out_m.shape == (3000, 4) and out_m.dtype == torch.bool
    ref_m = np.asarray(ref_m)
    assert 0.05 < ref_m.mean() < 0.95
    assert np.array_equal(out_m.numpy(), ref_m)
    assert max_err(out_f, ref_f) <= TOL


@pytest.mark.parametrize("min_views", [1, 2, 4])
def test_frustum_mask_matches_jax(min_views):
    _, projs, pts = _views(C=1)
    ref = np.asarray(jax_projection.frustum_mask(jnp.asarray(pts), jnp.asarray(projs), (256, 256),
                                                 min_visible_views=min_views))
    out = projection.frustum_mask(_t(pts), _t(projs), (256, 256), min_visible_views=min_views)
    assert 0 < ref.sum() < len(ref)
    assert np.array_equal(out.numpy(), ref)
    _, masks = projection.back_project_features(_t(pts), _t(np.zeros((4, 8, 8, 1), np.float32)),
                                                _t(projs), (256, 256))
    assert torch.equal(out, masks.sum(1) >= min_views)


def test_aggregate_multiview_features_matches_jax():
    rng = np.random.default_rng(7)
    f = rng.standard_normal((500, 6, 8)).astype(np.float32)
    m = rng.uniform(size=(500, 6)) > 0.4
    m[:3] = False  # no visible view: the sums over 1e-5
    ref = jax_projection.aggregate_multiview_features(jnp.asarray(f), jnp.asarray(m, jnp.float32))
    for masks in (_t(m), _t(m.astype(np.float32))):
        out = projection.aggregate_multiview_features(_t(f), masks)
        assert out.shape == (500, 16)
        assert max_err(out, ref) <= TOL * max(1.0, float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_sample_normalized_matches_jax(padding):
    rng = np.random.default_rng(8)
    img = rng.standard_normal((7, 9, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(4, 60, 2)).astype(np.float32)
    grid[0, :4] = [[-1, -1], [1, 1], [-1, 1], [1.0001, 0]]
    ref = jax_sampling.bilinear_sample_normalized(jnp.asarray(img), jnp.asarray(grid), padding)
    out = sampling.bilinear_sample_normalized(_t(img), _t(grid), padding=padding)
    assert out.shape == (4, 60, 3)
    assert max_err(out, ref) <= TOL
    # the same as grid_sample with align_corners=True
    gs = torch.nn.functional.grid_sample(_t(img).permute(2, 0, 1)[None], _t(grid)[None],
                                         padding_mode=padding, align_corners=True)
    assert max_err(out, gs[0].permute(1, 2, 0)) <= TOL


def test_trace_annotation_names_a_profiler_range():
    from one2345_tpu.core import __all__ as jax_core_names
    from one2345_tpu_torch import core

    assert "trace_annotation" in core.__all__ and "trace_annotation" in jax_core_names
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with core.trace_annotation("convert_probe_span"):
            torch.ones(8).cumsum(0)
    assert "convert_probe_span" in {e.key for e in prof.key_averages()}
