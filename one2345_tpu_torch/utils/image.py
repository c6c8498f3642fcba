"""Image preprocessing: bbox prediction, recentring and rescaling, compositing.

Counterpart of ``one2345_tpu/utils/image.py`` (reference: utils/utils.py:
10-77, run.py:11-16) without PIL or OpenCV.  The functions keep the JAX
package's semantics and the libraries' arithmetic:

- ``thumbnail`` and ``recenter_rescale`` resize as PIL LANCZOS does (RGBA
  premultiplied, ``Image.thumbnail``'s aspect rounding and its box
  ``reduce`` first when a side shrinks 4x or more), through
  ``utils.resample`` on a torch device; they take and return arrays;
- ``estimate_bbox`` runs on the host in numpy, as the JAX package does:
  the border median, Otsu's threshold on a 256-bin histogram (OpenCV's
  ``THRESH_OTSU``: the first maximum of the between-class variance, then
  ``> t``), a 5x5 opening (erosion padded with +inf, dilation with -inf,
  OpenCV's default border) and 8-connected components numbered as
  ``cv2.connectedComponents`` numbers them, so that ties in area go to the
  same component.
"""

from __future__ import annotations

import numpy as np

from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.utils.resample import pil_reduce, pil_resize, thumbnail_size

FLT_EPSILON = float(np.finfo(np.float32).eps)


def bbox_from_mask(mask: np.ndarray) -> tuple[int, int, int, int]:
    """(x_min, y_min, x_max, y_max) of the nonzero region; the whole frame
    when the mask is empty (pred_bbox semantics, utils/utils.py:10-19)."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        h, w = mask.shape
        return 0, 0, w - 1, h - 1
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


def otsu_threshold(gray: np.ndarray) -> int:
    """OpenCV's Otsu threshold of a uint8 image (``getThreshVal_Otsu_8u``):
    the first level that maximises the between-class variance."""
    hist = np.bincount(gray.ravel(), minlength=256)
    scale = 1.0 / gray.size
    mu = sum(i * float(hist[i]) for i in range(256)) * scale
    mu1 = q1 = 0.0
    max_sigma = max_val = 0.0
    for i in range(256):
        p_i = float(hist[i]) * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < FLT_EPSILON or max(q1, q2) > 1.0 - FLT_EPSILON:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, float(i)
    return int(max_val)


def _window(x: np.ndarray, k: int, reduce, pad_value) -> np.ndarray:
    """Separable k x k min or max filter, padded with ``pad_value``."""
    r = k // 2
    for axis in (0, 1):
        widths = [(0, 0), (0, 0)]
        widths[axis] = (r, r)
        p = np.pad(x, widths, constant_values=pad_value)
        n = x.shape[axis]
        parts = [np.take(p, np.arange(i, i + n), axis=axis) for i in range(k)]
        x = reduce.reduce(np.stack(parts), axis=0)
    return x


def morph_open(mask: np.ndarray, k: int = 5) -> np.ndarray:
    """``cv2.morphologyEx(mask, cv2.MORPH_OPEN, np.ones((k, k)))`` of a
    uint8 image: erosion (borders count as 255), then dilation (borders
    count as 0)."""
    eroded = _window(mask, k, np.minimum, 255)
    return _window(eroded, k, np.maximum, 0)


def connected_components(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """8-connected components of the nonzero pixels -> (n, labels) as
    ``cv2.connectedComponents`` gives them: background 0, components 1..n-1
    numbered in the order OpenCV's 2x2-block scan meets them (block rows of
    two pixel rows, blocks left to right; the foreground of a 2x2 block is
    always one component).  Vectorised union-find: hook the larger root of
    every 8-neighbour pair onto the smaller, then jump pointers."""
    fg = np.asarray(mask) > 0
    H, W = fg.shape
    idx = np.arange(H * W).reshape(H, W)
    ea, eb = [], []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        ca = slice(max(0, -dx), W - max(0, dx))
        cb = slice(max(0, dx), W + min(0, dx))
        both = fg[: H - dy, ca] & fg[dy:, cb]
        ea.append(idx[: H - dy, ca][both])
        eb.append(idx[dy:, cb][both])
    ea, eb = np.concatenate(ea), np.concatenate(eb)
    parent = idx.ravel().copy()
    while True:
        ra, rb = parent[ea], parent[eb]
        hook = ra != rb
        if not hook.any():
            break
        np.minimum.at(parent, np.maximum(ra, rb)[hook], np.minimum(ra, rb)[hook])
        while True:
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
    pix = idx[fg]
    roots = parent[pix]
    rows, cols = np.divmod(pix, W)
    block = (rows // 2) * ((W + 1) // 2) + cols // 2
    first = np.full(H * W, np.iinfo(np.int64).max)
    np.minimum.at(first, roots, block)
    uniq = np.unique(roots)
    order = uniq[np.argsort(first[uniq], kind="stable")]
    number = np.zeros(H * W, np.int32)
    number[order] = np.arange(1, len(order) + 1, dtype=np.int32)
    labels = np.zeros((H, W), np.int32)
    labels[fg] = number[roots]
    return len(order) + 1, labels


def estimate_bbox(image: np.ndarray) -> tuple[int, int, int, int]:
    """Coarse foreground bbox without rembg (pred_bbox stand-in,
    utils/utils.py:10-19): per-pixel colour distance from the median border
    colour, Otsu-thresholded, opened, largest connected component."""
    img = image[..., :3].astype(np.float32)
    border = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]], axis=0)
    bg = np.median(border, axis=0)
    dist = np.linalg.norm(img - bg, axis=-1)
    peak = float(dist.max())
    if peak < 12.0:  # blank frame: no object to find
        h, w = dist.shape
        return 0, 0, w - 1, h - 1
    d8 = np.clip(dist * (255.0 / peak), 0, 255).astype(np.uint8)
    fg = np.where(d8 > otsu_threshold(d8), 255, 0).astype(np.uint8)
    fg = morph_open(fg, 5)
    n, labels = connected_components(fg)
    if n > 1:
        areas = np.bincount(labels.ravel(), minlength=n)
        fg = labels == 1 + int(np.argmax(areas[1:]))
    return bbox_from_mask(fg > 0)


def thumbnail(image: np.ndarray, size: int = 512, device=None) -> np.ndarray:
    """run.py:12: ``Image.thumbnail([size, size], LANCZOS)`` of an RGB or
    RGBA uint8 array -> a uint8 array.  The image keeps its aspect ratio
    (PIL's rounding); RGB shrinking by 2 * 2.0 or more on a side is first
    box-reduced by ``int(side / out / 2)`` (``reducing_gap=2.0``); RGBA is
    resampled premultiplied, where PIL drops ``reducing_gap``."""
    dev = resolve_device(device)
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"thumbnail takes [H, W, 3 or 4] uint8, got {image.shape}")
    H, W = image.shape[:2]
    out = thumbnail_size(W, H, size)
    if out is None:
        return image.copy()
    box = None
    if image.shape[2] == 3:
        fx, fy = int(W / out[0] / 2.0) or 1, int(H / out[1] / 2.0) or 1
        if fx > 1 or fy > 1:
            image = pil_reduce(image, (fx, fy), device=dev)
            box = (0.0, 0.0, W / fx, H / fy)
    return pil_resize(image, out, "lanczos", box=box, device=dev)


def bounding_rect(mask: np.ndarray) -> tuple[int, int, int, int]:
    """``cv2.boundingRect`` of a binary mask: (x, y, w, h), zeros if empty."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, 0, 0
    return int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)


def recenter_rescale(rgba: np.ndarray, ratio: float = 0.75, out_size: int = 256,
                     device=None) -> np.ndarray:
    """Crop to the alpha bbox, pad to a square with the object filling
    ``ratio`` of the side, LANCZOS-resize to ``out_size`` (premultiplied,
    as PIL resizes RGBA) and composite on white (image_preprocess_nosave,
    utils/utils.py:50-77).  Returns [out, out, 3] float32 in [0, 1]."""
    x, y, w, h = bounding_rect(rgba[..., 3] > 0)
    if w == 0 or h == 0:
        x, y, w, h = 0, 0, rgba.shape[1], rgba.shape[0]
    side = int(max(w, h) / ratio)
    padded = np.zeros((side, side, 4), dtype=np.uint8)
    cy, cx = side // 2, side // 2
    padded[cy - h // 2: cy - h // 2 + h, cx - w // 2: cx - w // 2 + w] = rgba[y: y + h, x: x + w]
    out = pil_resize(padded, (out_size, out_size), "lanczos",
                     device=resolve_device(device)).astype(np.float32) / 255.0
    return out[..., :3] * out[..., 3:] + (1.0 - out[..., 3:])


def composite_white(rgba: np.ndarray) -> np.ndarray:
    """[H, W, 4] float in [0, 1] -> [H, W, 3] alpha-blended onto white
    (One2345_eval_new_data.py:199-200)."""
    return rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])


def image_grid(images: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Tile [N, H, W, C] images into a [rows * H, cols * W, C] grid
    (utils/utils.py:21-29)."""
    n, h, w, c = images.shape
    assert n == rows * cols
    return images.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4).reshape(
        rows * h, cols * w, c)


def camera_cone_points(c2w: np.ndarray, fov_deg: float = 50.0, scale: float = 0.3) -> np.ndarray:
    """[16, 3] polyline tracing a camera frustum cone in world space (demo/
    app.py calc_cam_cone_pts_3d:48: apex, 4 corners, connecting edges)."""
    half = np.tan(np.radians(fov_deg) / 2.0) * scale
    corners = np.array([
        [-half, -half, scale], [half, -half, scale], [half, half, scale], [-half, half, scale],
    ])
    apex = np.zeros(3)
    order = [apex, corners[0], corners[1], apex, corners[1], corners[2], apex,
             corners[2], corners[3], apex, corners[3], corners[0],
             corners[0], corners[1], corners[2], corners[3]]
    return np.stack(order) @ c2w[:3, :3].T + c2w[:3, 3]
