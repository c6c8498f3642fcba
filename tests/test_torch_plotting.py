"""The port's LoFTR match figures against one2345_tpu/elevation/plotting.py.

The JAX module draws with matplotlib, the port in numpy, so the two are
compared by geometry, not pixels: the jet colours against
``matplotlib.cm.jet`` within 1/255, each dot's pixel at its keypoint and
each line's end pixels in its match's colour, ``valid`` rows dropped, an
empty match set, the file names of ``save_match_figures``, and
``ElevationEstimator.save_match_visualizations`` on a tiny matcher.  The
caption is left out (a deliberate divergence): the figure is the same with
and without ``text``.
"""

import os

import numpy as np
import pytest
import torch

from one2345_tpu_torch.elevation.loftr import MatchResult
from one2345_tpu_torch.elevation.plotting import (
    GAP, jet, make_matching_figure, save_match_figures,
)
from one2345_tpu_torch.utils.png import read_png


def _pair(rng, k=20, size=64):
    """Integer keypoints on a 12-px lattice (no two dots touch), confidences
    spread over [0, 1], the last 8 rows padding."""
    n = (size - 4) // 12  # lattice points per axis, at 6, 18, ...
    cells = rng.permutation(n * n)[:k]
    xy = np.stack([cells % n, cells // n], -1) * 12 + 6.0
    return MatchResult(
        kpts0=xy.astype(np.float32),
        kpts1=xy[::-1].astype(np.float32),
        conf=np.linspace(0.0, 1.0, k).astype(np.float32),
        valid=np.arange(k) < 12,
    )


def test_jet_matches_matplotlib():
    import matplotlib.cm as cm

    x = np.concatenate([np.linspace(-0.1, 1.1, 2001), [0.125, 0.35, 0.375, 0.64, 0.66, 0.89]])
    ref = cm.jet(np.clip(x, 0, 1))[:, :3]
    assert np.abs(jet(np.clip(x, 0, 1)) - ref).max() <= 1.0 / 255


def test_dots_and_line_ends_in_the_match_colour():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(64, 64)).astype(np.float32)
    m = _pair(rng)
    fig = make_matching_figure(img, img, m.kpts0, m.kpts1, m.conf, m.valid)
    assert fig.dtype == np.uint8 and fig.shape == (64, 64 + GAP + 64, 3)
    colors = (jet(m.conf) * 255 + 0.5).astype(np.uint8)
    for i in np.flatnonzero(m.valid):
        x0, y0 = np.rint(m.kpts0[i]).astype(int)
        x1, y1 = np.rint(m.kpts1[i]).astype(int) + np.array([64 + GAP, 0])
        # the dots at both keypoints (drawn after every line)
        for r, c in ((y0, x0), (y1, x1)):
            np.testing.assert_array_equal(fig[r, c], colors[i], err_msg=str((i, r, c)))
        # the line, drawn alone: 2 steps from each end (outside the 3x3
        # dot) toward the other end
        one = make_matching_figure(img, img, m.kpts0[i:i + 1], m.kpts1[i:i + 1],
                                   m.conf[i:i + 1])
        d = np.array([x1 - x0, y1 - y0], np.float64)
        sx, sy = np.rint(2 * d / np.abs(d).max()).astype(int)
        for r, c in ((y0 + sy, x0 + sx), (y1 - sy, x1 - sx)):
            np.testing.assert_array_equal(one[r, c], colors[i], err_msg=str((i, r, c)))
    # the two panels are the gray image itself away from the matches
    gray = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(fig[0, :2], np.repeat(gray[0, :2, None], 3, -1))
    assert (fig[:, 64:64 + GAP][fig[:, 64:64 + GAP] != 255].size
            <= 12 * GAP * 3 * 3)  # only line pixels cross the gap


def test_valid_rows_dropped_and_caption_left_out(tmp_path):
    from one2345_tpu.elevation.plotting import make_matching_figure as jax_figure

    rng = np.random.default_rng(1)
    img = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    m = _pair(rng)
    fig = make_matching_figure(img, img, m.kpts0, m.kpts1, m.conf, m.valid)
    keep = make_matching_figure(img, img, m.kpts0[:12], m.kpts1[:12], m.conf[:12])
    np.testing.assert_array_equal(fig, keep)
    captioned = make_matching_figure(img, img, m.kpts0, m.kpts1, m.conf, m.valid,
                                     text=["pair (0,1)", "12 matches"])
    np.testing.assert_array_equal(fig, captioned)
    # green without confidences, as JAX's (0, 1, 0)
    green = make_matching_figure(img, img, m.kpts0[:1], m.kpts1[:1])
    x, y = np.rint(m.kpts0[0]).astype(int)
    np.testing.assert_array_equal(green[y, x], [0, 255, 0])
    # a path -> None and a PNG that reads back as the array; JAX writes one
    assert make_matching_figure(img, img, m.kpts0, m.kpts1, m.conf, m.valid,
                                path=str(tmp_path / "fig.png")) is None
    np.testing.assert_array_equal(read_png(str(tmp_path / "fig.png"))[..., :3], fig)
    assert jax_figure(img, img, m.kpts0, m.kpts1, m.conf, m.valid,
                      path=str(tmp_path / "jax.png")) is None


def test_empty_matches(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(32, 32)).astype(np.float32)
    z = np.zeros((8, 2), np.float32)
    fig = make_matching_figure(img, img, z, z, np.zeros(8, np.float32), np.zeros(8, bool))
    gray = np.repeat(((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))[..., None], 3, -1)
    np.testing.assert_array_equal(fig[:, :32], gray)
    np.testing.assert_array_equal(fig[:, 32 + GAP:], gray)
    assert (fig[:, 32:32 + GAP] == 255).all()
    out = tmp_path / "empty.png"
    make_matching_figure(img, img, z, z, np.zeros(8, np.float32), np.zeros(8, bool),
                         path=str(out))
    assert out.exists()


def test_save_match_figures_file_names(tmp_path):
    from one2345_tpu.elevation.loftr import MatchResult as JaxMatchResult
    from one2345_tpu.elevation.plotting import save_match_figures as jax_save

    rng = np.random.default_rng(3)
    imgs = rng.uniform(size=(4, 64, 64)).astype(np.float32)
    matches = {(0, 1): _pair(rng), (2, 3): _pair(rng)}
    paths = save_match_figures(imgs, matches, str(tmp_path / "port"))
    ref = jax_save(imgs, {k: JaxMatchResult(*v) for k, v in matches.items()},
                   str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in ref]
    assert [os.path.basename(p) for p in paths] == ["match_0_1.png", "match_2_3.png"]
    for p in paths:
        assert read_png(p).shape == (64, 64 + GAP + 64, 3)


@pytest.fixture()
def tiny_estimator():
    from one2345_tpu_torch.elevation.loftr import LoFTRMatcher
    from one2345_tpu_torch.elevation.solver import ElevationEstimator

    torch.manual_seed(0)
    matcher = LoFTRMatcher(dtype="float32", device="cpu")
    return ElevationEstimator(matcher, device="cpu")


def test_save_match_visualizations(tmp_path, tiny_estimator, monkeypatch):
    """Six figures, one per pair of PAIRS, from the estimator's own
    match_views (replaced by fixed matches: a seeded LoFTR matches nothing,
    which would leave the lines untested)."""
    from one2345_tpu_torch.elevation import solver

    rng = np.random.default_rng(4)
    views = rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)
    packed = [tuple(_pair(rng)) for _ in solver.PAIRS]
    seen = []
    monkeypatch.setattr(tiny_estimator, "match_views",
                        lambda images, masks=None: seen.append(images) or packed)
    paths = tiny_estimator.save_match_visualizations(views, str(tmp_path / "viz"))
    assert [os.path.basename(p) for p in paths] == [f"match_{i}_{j}.png" for i, j in solver.PAIRS]
    for p, (i, j), pk in zip(paths, solver.PAIRS, packed):
        got = read_png(p)[..., :3]
        np.testing.assert_array_equal(got, make_matching_figure(views[i], views[j], *pk))
    assert seen[0] is views
