"""one2345_tpu_torch.recon.fast_renderer (sphere tracing, depth maps with
the sampler's border padding) and training.losses against the JAX package,
CPU, f32; plus tests/test_fast_renderer.py's analytic cases on the port.

The JAX tracer runs op by op (``jax.disable_jit``): compiled, XLA's fused
arithmetic moves its own depths by up to 2.4e-2 against its eager run on
rays whose secant bracket holds no clean root (measured on the bumpy
sphere below), while the port equals the eager run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.recon import fast_renderer as jax_fast
from one2345_tpu.training import losses as jax_losses
from one2345_tpu_torch.geometry.cameras import build_recon_cameras
from one2345_tpu_torch.geometry.rays import rays_from_camera
from one2345_tpu_torch.recon import fast_renderer
from one2345_tpu_torch.training import losses
from tests.torch_port_helpers import max_err

DEPTH_TOL = 1e-4  # max abs depth of rays that hit on both sides


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _sphere_volume(res=64, r=0.5, bumps=0.0, seed=0):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    sdf = np.sqrt(x**2 + y**2 + z**2) - r
    if bumps:
        sdf = sdf + bumps * np.sin(7 * x + 1) * np.cos(5 * y) * np.sin(3 * z + 2)
    return sdf[..., None].astype(np.float32)


def test_sphere_trace_hits_and_misses():
    """tests/test_fast_renderer.py on the port."""
    vol = _t(_sphere_volume())
    th = torch.linspace(-0.1, 0.1, 5)
    rays_d = torch.stack([torch.sin(th), torch.zeros_like(th), -torch.cos(th)], -1)
    depth, hit = fast_renderer.sphere_trace_depth(vol, torch.tensor([[0.0, 0.0, 1.5]]).expand(5, 3),
                                                  rays_d, 0.6, 2.4)
    assert bool(hit.all())
    np.testing.assert_allclose(depth.numpy(), 1.0, atol=0.05)
    depth, hit = fast_renderer.sphere_trace_depth(vol, torch.tensor([[0.0, 0.0, 1.5]]),
                                                  torch.tensor([[1.0, 0.0, 0.0]]), 0.6, 2.4)
    assert not bool(hit.any()) and float(depth[0]) == 0.0


@pytest.mark.parametrize("bumps", [0.0, 0.08])
def test_sphere_trace_matches_jax(bumps):
    """Rays from outside the cube, some leaving it (the border padding
    reads the edge voxels there), per-ray near / far."""
    rng = np.random.default_rng(1)
    vol = _sphere_volume(48, 0.55, bumps)
    n = 300
    origin = rng.normal(size=(n, 3))
    origin = 1.8 * origin / np.linalg.norm(origin, axis=-1, keepdims=True)
    target = rng.uniform(-0.7, 0.7, size=(n, 3))
    d = target - origin
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.3, 0.6, size=n).astype(np.float32)
    far = rng.uniform(2.4, 3.2, size=n).astype(np.float32)
    with jax.disable_jit():
        ref_d, ref_h = jax_fast.sphere_trace_depth(
            jnp.asarray(vol), jnp.asarray(origin, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(near), jnp.asarray(far))
    depth, hit = fast_renderer.sphere_trace_depth(_t(vol), _t(origin), _t(d), _t(near), _t(far))
    ref_h = np.asarray(ref_h)
    assert 0.2 < ref_h.mean() < 0.95  # both hits and misses
    assert np.array_equal(hit.numpy(), ref_h)
    assert max_err(depth[hit], np.asarray(ref_d)[ref_h]) <= DEPTH_TOL
    assert bool((depth[~hit] == 0).all())


def test_extract_depth_maps_match_jax():
    """Quarter-size depth maps of the rig's first 4 source views, as the
    depth-filtered pruning traces them (near * 1.5): the JAX tracer on the
    port's rays gives the port's depths bit for bit (the rays themselves
    match JAX's to 1e-5, tests/test_torch_renderer.py).  From JAX's own
    rays, ulps apart, the secant's fixed steps move the depth of rays whose
    bracket holds no clean root, within the bracket (47 of 1004 hit pixels
    by more than 1e-4 on this volume), so the composed JAX function is not
    compared depth for depth."""
    cams = build_recon_cameras(45.0)
    K = cams["intrinsics"][1:5].copy()
    K[:, :2, :] *= 0.25
    c2ws = cams["c2ws"][1:5]
    near, far = cams["near_fars"][1]
    vol = _sphere_volume(32, 0.45, 0.05)
    depth, hit = fast_renderer.extract_depth_maps(_t(vol), _t(K), _t(c2ws), 16, 16,
                                                  float(near) * 1.5, float(far))
    assert depth.shape == (4, 16, 16) and hit.float().mean() > 0.1
    rays = [rays_from_camera(16, 16, _t(k), _t(c)) for k, c in zip(K, c2ws)]
    with jax.disable_jit():
        own_d, own_h = jax_fast.sphere_trace_depth(
            jnp.asarray(vol), jnp.asarray(torch.cat([r[0] for r in rays]).numpy()),
            jnp.asarray(torch.cat([r[1] for r in rays]).numpy()), near * 1.5, far)
    assert np.array_equal(hit.numpy().reshape(-1), np.asarray(own_h))
    assert max_err(depth.reshape(-1), own_d) == 0.0


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.5, 3.0, size=(20, 24)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.2] = -1.0  # invalid pixels
    pred = (gt + 0.2 * rng.standard_normal(gt.shape)).clip(0.1).astype(np.float32)
    img = rng.uniform(size=(20, 24, 3)).astype(np.float32)
    a = rng.standard_normal((6, 49, 3)).astype(np.float32)
    b = (a + 0.8 * rng.standard_normal(a.shape)).astype(np.float32)
    m = (rng.uniform(size=(6, 49)) > 0.3).astype(np.float32)
    cases = [
        (losses.depth_l1_loss(_t(pred), _t(gt)), jax_losses.depth_l1_loss(pred, gt)),
        (losses.depth_smooth_loss(_t(pred), _t(img)), jax_losses.depth_smooth_loss(pred, img)),
        (losses.ncc_loss(_t(a), _t(b)), jax_losses.ncc_loss(a, b)),
        (losses.ncc_loss(_t(a), _t(b), _t(m)), jax_losses.ncc_loss(a, b, m)),
    ]
    for ours, ref in cases:
        assert abs(float(ours) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref)))
    assert float(losses.ncc_loss(_t(a), _t(a))) < 1e-5
    mets = losses.depth_metrics(_t(pred), _t(gt))
    ref = jax_losses.depth_metrics(jnp.asarray(pred), jnp.asarray(gt))
    assert set(mets) == set(ref)
    for k in ref:
        assert abs(float(mets[k]) - float(ref[k])) <= 1e-6 * max(1.0, abs(float(ref[k]))), k
    # tests/test_fast_renderer.py's closed forms
    g = torch.tensor([1.0, 2.0, -1.0, 3.0])
    assert float(losses.depth_l1_loss(torch.tensor([1.5, 2.0, 99.0, 3.0]), g)) == pytest.approx(0.5 / 3)
    assert float(losses.depth_smooth_loss(torch.ones(8, 8), torch.zeros(8, 8, 3))) == 0.0
    m = losses.depth_metrics(g * 1.1, g)
    assert abs(float(m["abs_rel"]) - 0.1) < 1e-5 and float(m["delta_1"]) == 1.0
