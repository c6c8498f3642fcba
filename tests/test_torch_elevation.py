"""one2345_tpu_torch.elevation.solver against the JAX elevation solver: the
pose hypotheses, DLT triangulation, the sweep's error curve on the same
slates (synthetic ones of a known elevation, and the JAX matcher's own), the
two-stage sweep, the 480^2 grayscale resize, and ElevationEstimator.estimate
end to end at its fixed 480^2 on numpy-seeded weights, f32, CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from one2345_tpu.elevation import loftr as jax_loftr
from one2345_tpu.elevation import solver as jax_solver
from one2345_tpu_torch.elevation import loftr, solver
from one2345_tpu_torch.utils.convert_jax import loftr_from_jax
from tests.test_elevation_solver import _synthetic_matches
from tests.torch_port_helpers import max_err, randomize

K_MAT = np.array([[280.0, 0, 128], [0, 280.0, 128], [0, 0, 1]], np.float32)
CURVE_TOL = 1e-4  # relative, the error curve of a sweep
# a threshold at which the random-weight matcher keeps matches in all six
# pairs of the test views, so that estimate() reaches the sweep
THRESHOLD = 0.01


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def test_pose_hypothesis_matches_jax():
    elevs = np.array([30.0, 55.5, 73.0, 90.0, 149.0], np.float32)
    out = solver.pose_hypothesis(_t(elevs))
    assert out.shape == (5, 4, 4, 4)
    for e, poses in zip(elevs, out):
        assert max_err(poses, jax_solver.pose_hypothesis(jnp.asarray(e))) <= 1e-6


def test_triangulate_dlt_matches_jax():
    rng = np.random.default_rng(1)
    poses = np.asarray(jax_solver.pose_hypothesis(jnp.asarray(60.0)))
    P0 = (K_MAT @ np.linalg.inv(poses[0])[:3, :4]).astype(np.float32)
    P1 = (K_MAT @ np.linalg.inv(poses[1])[:3, :4]).astype(np.float32)
    pts0 = rng.uniform(60, 200, (64, 2)).astype(np.float32)
    pts1 = (pts0 + rng.normal(0, 3.0, (64, 2))).astype(np.float32)
    ref = np.asarray(jax_solver.triangulate_dlt(*(jnp.asarray(x) for x in (P0, P1, pts0, pts1))))
    out = solver.triangulate_dlt(_t(P0), _t(P1), _t(pts0), _t(pts1))
    assert out.shape == (64, 3)
    assert _rel(out, ref) <= 1e-4
    # batched over leading dims of the projections
    both = solver.triangulate_dlt(torch.stack([_t(P0), _t(P1)]), torch.stack([_t(P1), _t(P0)]),
                                  _t(pts0), _t(pts1))
    assert both.shape == (2, 64, 3) and max_err(both[0], out) <= 1e-5


@pytest.mark.parametrize("gt,noise", [(50.0, 0.0), (73.0, 0.3), (120.0, 0.0)])
def test_sweep_error_curve_matches_jax_on_synthetic_slates(gt, noise):
    """The recipe of tests/test_elevation_solver.py: 64 points seen from the
    4 poses of a known elevation, padded with invalid entries to 128 (one
    JAX compile for the three cases; the matcher's K=1024 slates are the
    next test's)."""
    packed = _synthetic_matches(gt, K_MAT, kpad=128, noise=noise, seed=3)
    elevs = np.arange(30.0, 150.0, 2.0).astype(np.float32)
    ref = np.asarray(jax_solver._sweep(jnp.asarray(elevs), jnp.asarray(K_MAT), packed, 6))
    out = solver._sweep(_t(elevs), _t(K_MAT), tuple(_t(np.asarray(x)) for x in packed), 6)
    assert out.shape == ref.shape
    assert _rel(out, ref) <= CURVE_TOL
    fused_ref = float(jax_solver._sweep_two_stage(jnp.asarray(K_MAT), packed, 6))
    fused = float(solver._sweep_two_stage(_t(K_MAT), tuple(_t(np.asarray(x)) for x in packed), 6))
    assert fused == fused_ref and abs(fused - gt) <= 2.0


def test_resize_to_480_matches_jax_image_resize():
    gray = np.random.default_rng(4).uniform(size=(4, 256, 256)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(gray), (4, 480, 480), method="linear"))
    out = F.interpolate(_t(gray)[:, None], size=(480, 480), mode="bilinear",
                        align_corners=False)[:, 0]
    assert max_err(out, ref) <= 1e-6
    # the estimator's whole preparation: cv2 grayscale weights, then the resize
    rgb = np.random.default_rng(5).uniform(size=(4, 256, 256, 3)).astype(np.float32)
    ref = jax.image.resize(
        jnp.tensordot(jnp.asarray(rgb), jnp.asarray([0.299, 0.587, 0.114]), axes=[[-1], [0]]),
        (4, 480, 480), method="linear",
    )
    assert max_err(solver.grayscale_480(_t(rgb)), ref) <= 1e-6


def _views():
    """Four nearby views of a textured disc on white: one seeded texture
    seen shifted by a few pixels."""
    rng = np.random.default_rng(5)
    tex = rng.uniform(0.1, 0.9, (288, 288, 3)).astype(np.float32)
    yy, xx = np.mgrid[:256, :256]
    disc = (yy - 128) ** 2 + (xx - 128) ** 2 < 90**2
    out = []
    for dy, dx in ((16, 16), (10, 16), (16, 24), (22, 12)):
        img = np.ones((256, 256, 3), np.float32)
        img[disc] = tex[dy:dy + 256, dx:dx + 256][disc]
        out.append(img)
    return np.stack(out)


@pytest.fixture(scope="module")
def estimators():
    """The JAX estimator at 480^2 with numpy-seeded weights (the tree's
    structure from ``jax.eval_shape``, no init compiled) and its port."""
    shapes = jax.eval_shape(
        jax_loftr.LoFTRModules().init, jax.random.key(0), jnp.zeros((1, 64, 64, 1))
    )
    params = randomize(shapes, seed=7)
    jm = jax_loftr.LoFTRMatcher(params, threshold=THRESHOLD)
    pm = loftr.LoFTRMatcher(loftr_from_jax(params), threshold=THRESHOLD, device="cpu")
    return jax_solver.ElevationEstimator(jm), solver.ElevationEstimator(pm)


@pytest.fixture(scope="module")
def runs(estimators):
    """One 480^2 run of each side on the same four views: the JAX slates
    (``match_views``) and their elevation through the JAX two-stage sweep
    (the body of its ``estimate``, solver.py:255-261); the port's
    ``estimate`` end to end, with the matcher's output it drew recorded."""
    je, pe = estimators
    views = _views()
    with jax.default_matmul_precision("highest"):
        ref = je.match_views(views)
        packed = tuple(jnp.asarray(np.stack([p[c] for p in ref])) for c in range(4))
        ref_elev = float(jax_solver._sweep_two_stage(jnp.asarray(je.K), packed, 6))
    drawn = []
    match = pe.matcher.match_views

    def recorded(images, pairs):
        drawn.append(match(images, pairs))
        return drawn[-1]

    pe.matcher.match_views = recorded
    elev = pe.estimate(views)
    return views, ref, ref_elev, elev, drawn[0]


def _by_kpt0(k0, k1, conf, valid):
    """{view-0 keypoint: (view-1 keypoint, conf)} of a slate's valid slots
    (one slot per coarse cell of view 0; slots of near-equal confidence may
    sit in either order)."""
    return {tuple(np.round(a, 3)): (b, c) for a, b, c in zip(k0[valid], k1[valid], conf[valid])}


def test_estimate_matches_jax_end_to_end(runs):
    """estimate() on the four views at 480^2: the JAX estimator's
    elevation."""
    _, ref, ref_elev, elev, _ = runs
    assert all(p[3].sum() > 0 for p in ref)  # every pair matched: the sweep ran
    assert elev is not None and elev == ref_elev


def test_match_views_match_jax(estimators, runs):
    """The six slates at 480^2, rescaled to 256^2 and foreground-filtered:
    the same valid matches, keypoints and confidences (``match_views`` on
    the matcher output of the estimate run)."""
    _, pe = estimators
    views, ref, _, _, drawn = runs
    with _replayed(pe, drawn):
        out = pe.match_views(views)
    for r, o in zip(ref, out):
        assert r[3].sum() > 0 and r[3].sum() == o[3].sum()
        a, b = _by_kpt0(*r), _by_kpt0(*o)
        assert a.keys() == b.keys()
        for key, (k1, c) in a.items():
            assert np.abs(b[key][0] - k1).max() <= 1e-3
            assert abs(b[key][1] - c) <= 1e-4 * r[2].max()
        assert float(o[2][~o[3]].max(initial=0.0)) == 0.0


def test_estimate_is_none_without_matches(estimators, runs):
    """An empty foreground mask leaves every pair without a valid match:
    estimate() returns None, as the JAX estimator's n_valid check does
    (solver.py:258-260)."""
    _, pe = estimators
    views, _, _, _, drawn = runs
    with _replayed(pe, drawn):
        assert pe.estimate(views, masks=np.zeros((4, 256, 256), np.float32)) is None
        counts = [int(v.sum()) for _, _, _, v in pe.match_views(views, masks=np.zeros((4, 256, 256)))]
    assert counts == [0] * 6


class _replayed:
    """The port estimator's matcher returns the output recorded in the
    estimate run (the 480^2 matcher runs once per test module)."""

    def __init__(self, estimator, result):
        self.matcher, self.result = estimator.matcher, result

    def __enter__(self):
        self.saved = self.matcher.match_views
        self.matcher.match_views = lambda images, pairs: self.result

    def __exit__(self, *exc):
        self.matcher.match_views = self.saved


def test_sweep_error_curve_matches_jax_on_matcher_slates(runs):
    """The JAX matcher's own slates fed to both sweeps."""
    _, ref, _, _, _ = runs
    packed = tuple(np.stack([p[c] for p in ref]) for c in range(4))
    elevs = np.arange(30.0, 150.0, 3.0).astype(np.float32)
    curve_ref = np.asarray(jax_solver._sweep(
        jnp.asarray(elevs), jnp.asarray(K_MAT), tuple(jnp.asarray(x) for x in packed), 6))
    curve = solver._sweep(_t(elevs), _t(K_MAT), tuple(_t(x) for x in packed), 6)
    assert np.isfinite(curve_ref).all()
    assert _rel(curve, curve_ref) <= CURVE_TOL
