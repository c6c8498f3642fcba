"""LoFTR match figures: the elevation stage's debugging tool.

Counterpart of ``one2345_tpu/elevation/plotting.py`` (reference:
elevation_estimate/utils/plotting.py:154, make_matching_figure): the two
images side by side, a dot at every matched keypoint and a line per match,
coloured by its confidence through matplotlib's ``jet`` colormap.  The
JAX module draws with matplotlib, which the card's machine does not have:
here the figure is an RGB uint8 array drawn in numpy (``jet`` is a copy of
matplotlib's piecewise-linear segments, quantised to its 256-entry
table), written with ``utils/png.py``.

One deliberate divergence: the caption (``text``) is left out; the figure
is the same with or without it.
"""

from __future__ import annotations

import os

import numpy as np

from one2345_tpu_torch.utils.png import write_png

# matplotlib._cm._jet_data: (x, y0, y1) segments per channel
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
JET_N = 256  # matplotlib's colormap table size
GAP = 10  # white pixels between the two panels
GREEN = (0.0, 1.0, 0.0)  # the line colour without confidences


def jet(x) -> np.ndarray:
    """[..., 3] RGB in [0, 1] of ``matplotlib.cm.jet(x)`` for x in [0, 1]:
    the entry floor(x * 256) (clipped) of the 256-entry table sampled at
    i / 255."""
    x = np.asarray(x, np.float64)
    i = np.clip(np.floor(x * JET_N), 0, JET_N - 1) / (JET_N - 1)
    return np.stack([np.interp(i, [p[0] for p in seg], [p[1] for p in seg])
                     for seg in _JET.values()], axis=-1)


def _to_rgb(im) -> np.ndarray:
    """uint8 [H, W, 3] of a gray [H, W] or RGB [H, W, 3] image, float in
    [0, 1] or uint8 (as ``imshow`` shows it, gray through a gray map)."""
    im = np.asarray(im)
    if im.dtype != np.uint8:
        im = (np.clip(im.astype(np.float64), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=-1)
    return im[..., :3]


def _pixels(xy: np.ndarray, shape) -> tuple[np.ndarray, np.ndarray]:
    """Integer pixel (row, col) of (x, y) coordinates (pixel centres at
    integers), clipped to the canvas."""
    c = np.clip(np.rint(xy[..., 0]).astype(np.int64), 0, shape[1] - 1)
    r = np.clip(np.rint(xy[..., 1]).astype(np.int64), 0, shape[0] - 1)
    return r, c


def make_matching_figure(
    img0: np.ndarray,
    img1: np.ndarray,
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    conf: np.ndarray | None = None,
    valid: np.ndarray | None = None,
    dpi: int = 75,
    path: str | None = None,
    text: list[str] | None = None,
):
    """Draw matched keypoints between two images.

    :param img0, img1: [H, W] grayscale or [H, W, 3], float in [0, 1] or uint8
    :param kpts0, kpts1: [K, 2] (x, y) pixel coordinates in their image
    :param conf: [K] match confidence -> jet colour of the lines and dots
        (clipped to [0, 1]); None -> green
    :param valid: [K] bool; rows where it is false are dropped (the
        fixed-top-K matcher pads)
    :param dpi: unused (the figure is drawn at the images' own pixels)
    :param path: write the figure there as a PNG and return None
    :param text: unused (the caption is left out)
    :return: the figure, [max(H0, H1), W0 + GAP + W1, 3] uint8, or None when
        ``path`` is given
    """
    a, b = _to_rgb(img0), _to_rgb(img1)
    H = max(a.shape[0], b.shape[0])
    off = a.shape[1] + GAP
    fig = np.full((H, off + b.shape[1], 3), 255, np.uint8)
    fig[: a.shape[0], : a.shape[1]] = a
    fig[: b.shape[0], off:] = b

    k0 = np.asarray(kpts0, np.float64).reshape(-1, 2)
    k1 = np.asarray(kpts1, np.float64).reshape(-1, 2)
    if valid is not None:
        keep = np.asarray(valid, bool).reshape(-1)
        k0, k1 = k0[keep], k1[keep]
        conf = None if conf is None else np.asarray(conf).reshape(-1)[keep]
    if conf is not None and len(conf):
        color = jet(np.clip(np.asarray(conf, np.float64), 0.0, 1.0))
    else:
        color = np.tile(np.asarray(GREEN), (len(k0), 1))
    color = (color * 255.0 + 0.5).astype(np.uint8)

    p0 = k0
    p1 = k1 + np.array([off, 0.0])
    # lines first, each from kpts0 to kpts1 in the second panel
    for i in range(len(k0)):
        n = int(np.ceil(np.abs(p1[i] - p0[i]).max())) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        r, c = _pixels(p0[i] + t * (p1[i] - p0[i]), fig.shape)
        fig[r, c] = color[i]
    # then a 3x3 dot at every keypoint of both panels
    for pts in (p0, p1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                r, c = _pixels(pts + np.array([dx, dy]), fig.shape)
                fig[r, c] = color
    if path is not None:
        write_png(path, fig)
        return None
    return fig


def save_match_figures(images: np.ndarray, matches: dict, out_dir: str,
                       prefix: str = "match") -> list[str]:
    """One figure per matched pair, ``{prefix}_{i}_{j}.png``.

    :param images: [N, H, W(, 3)] the nearby views fed to the matcher
    :param matches: {(i, j): (kpts0, kpts1, conf, valid)} (a ``MatchResult``
        or a tuple), as the elevation solver's pairwise matching gives them
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for (i, j), (k0, k1, conf, valid) in matches.items():
        p = os.path.join(out_dir, f"{prefix}_{i}_{j}.png")
        make_matching_figure(images[i], images[j], np.asarray(k0), np.asarray(k1),
                             np.asarray(conf), np.asarray(valid), path=p)
        paths.append(p)
    return paths
