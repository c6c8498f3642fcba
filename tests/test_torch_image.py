"""one2345_tpu_torch.utils.image and utils.resample against PIL, OpenCV and
the JAX package's utils/image.py: PIL LANCZOS thumbnails (down, through
Image.reduce, RGBA premultiplied) and resizes up, PIL BICUBIC to 224,
cv2 INTER_LINEAR on uint8 and float32, Otsu's threshold, the 5x5 opening
and the component labels of OpenCV, estimate_bbox on the synthetic scenes
of tests/test_bbox.py, recenter_rescale, image_grid and the camera cones.
The port resizes on the CPU here (device='cpu')."""

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from one2345_tpu.utils import image as jax_image
from one2345_tpu_torch.utils import image, resample
from tests.test_bbox import _scene


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _picture(h, w, channels, seed=0):
    """Noise, sharp edges and smooth gradients; for RGBA, alpha with fully
    transparent, opaque and partial bands."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, channels)).astype(np.float64)
    yy, xx = np.mgrid[:h, :w]
    img[: h // 2] = np.sin(xx[: h // 2, :, None] / 9.0 + yy[: h // 2, :, None] / 23.0) * 120 + 128
    img[h // 4: h // 3, w // 4: w // 2] = 250
    if channels == 4:
        img[: h // 3, :, 3] = 0
        img[h // 3: h // 2, :, 3] = 255
    return np.clip(img, 0, 255).astype(np.uint8)


def _white(rgba):
    return image.composite_white(rgba.astype(np.float32) / 255.0)


def _check(ours, ref, channels):
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    if channels == 3:
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    else:
        assert np.abs(_white(ours) - _white(ref)).max() <= 2 / 255


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("hw", [(500, 700), (900, 2300)], ids=["down", "reduce"])
def test_thumbnail_matches_pil(hw, channels):
    """700x500 -> 512x366; 2300x900 -> 512x200, which PIL box-reduces by 2
    first for RGB (reducing_gap=2.0) and resamples at once for RGBa."""
    img = _picture(*hw, channels)
    ref = np.asarray(jax_image.thumbnail(Image.fromarray(img), 512))
    _check(image.thumbnail(img, 512, device="cpu"), ref, channels)


@pytest.mark.parametrize("channels", [3, 4])
def test_lanczos_up_matches_pil(channels):
    img = _picture(200, 300, channels, seed=1)
    ref = np.asarray(Image.fromarray(img).resize((512, 341), Image.LANCZOS))
    _check(resample.pil_resize(img, (512, 341), "lanczos", device="cpu"), ref, channels)


def test_thumbnail_keeps_small_images_and_reduce_matches_pil():
    small = _picture(300, 200, 3)
    assert np.array_equal(image.thumbnail(small, 512, device="cpu"), small)
    img = _picture(101, 203, 3, seed=2)
    for factor in ((2, 2), (3, 2), (1, 3)):  # partial boxes at the edges
        ref = np.asarray(Image.fromarray(img).reduce(factor))
        assert np.array_equal(resample.pil_reduce(img, factor, device="cpu"), ref)


@pytest.mark.parametrize("hw", [(500, 700), (120, 90)])
def test_bicubic_224_matches_pil(hw):
    img = _picture(*hw, 3, seed=3)
    ref = np.asarray(Image.fromarray(img).resize((224, 224), Image.BICUBIC))
    ours = resample.pil_resize(img, (224, 224), "bicubic", device="cpu")
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("size", [(1024, 731), (300, 200), (1400, 1000), (333, 777)])
def test_cv2_linear_matches_cv2(size):
    """uint8 within 1 LSB (OpenCV's 11-bit fixed point), float32 within
    1e-5 (logit-like values in [-4, 4])."""
    img = _picture(500, 700, 3, seed=4)
    ref = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    ours = resample.cv2_resize_linear(img, size, device="cpu").numpy()
    assert ours.dtype == np.uint8 and np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    f = (img[..., 0].astype(np.float32) - 128.0) / 32.0
    ref = cv2.resize(f, size)
    assert np.abs(resample.cv2_resize_linear(torch.from_numpy(f), size, device="cpu").numpy() - ref).max() <= 1e-5


def test_otsu_opening_and_components_equal_cv2():
    rng = np.random.default_rng(5)
    for trial in range(12):
        h, w = rng.integers(5, 120, 2)
        gray = rng.integers(0, 256, (h, w)).astype(np.uint8)
        if trial % 2:
            gray = (gray // 64 * 60).astype(np.uint8)  # few levels
        t, _ = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        assert image.otsu_threshold(gray) == int(t)
        mask = ((rng.uniform(size=(h, w)) < rng.uniform(0.05, 0.6)) * 255).astype(np.uint8)
        kernel = np.ones((5, 5), np.uint8)
        assert np.array_equal(image.morph_open(mask, 5), cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel))
        n, labels = image.connected_components(mask)
        ref_n, ref = cv2.connectedComponents(mask)
        assert n == ref_n and np.array_equal(labels, ref)


def test_tied_component_areas_go_to_opencv_s_first_label():
    """Two 2x3 blobs of equal area: the one whose first 2x2 block OpenCV's
    scan meets first (rows 0-1, not the pixel-raster first) is label 1 and
    wins the argmax, so estimate_bbox picks it as the JAX package does."""
    mask = np.zeros((12, 16), np.uint8)
    mask[1:3, 1:4] = 255  # first pixel at row 1: block row 0
    mask[0:2, 10:13] = 255  # first pixel at row 0, later block in that row
    n, labels = image.connected_components(mask)
    ref_n, ref = cv2.connectedComponents(mask)
    assert n == ref_n == 3 and np.array_equal(labels, ref) and labels[1, 1] == 1
    scene = np.full((40, 48, 3), 255, np.uint8)
    scene[6:14, 6:14] = 30
    scene[4:12, 30:38] = 30  # equal areas, higher up
    assert image.estimate_bbox(scene) == jax_image.estimate_bbox(scene)


@pytest.mark.parametrize("bg,obj,noise", [
    ((255, 255, 255), (90, 60, 40), 0.0),
    ((20, 22, 25), (200, 180, 90), 0.0),
    ((60, 110, 220), (220, 90, 60), 0.0),
    ((140, 140, 140), (30, 90, 200), 10.0),
], ids=["white", "dark", "colored", "textured"])
def test_estimate_bbox_matches_jax(bg, obj, noise):
    scene = _scene(bg, obj, noise=noise)
    assert image.estimate_bbox(scene) == jax_image.estimate_bbox(scene)


def test_estimate_bbox_blank_and_empty_mask():
    img = np.full((64, 48, 3), 200, np.uint8)
    assert image.estimate_bbox(img) == jax_image.estimate_bbox(img) == (0, 0, 47, 63)
    assert image.bbox_from_mask(np.zeros((8, 10), bool)) == (0, 0, 9, 7)


@pytest.mark.parametrize("hw", [(200, 300), (520, 700)])
def test_recenter_rescale_matches_jax(hw):
    rgba = _picture(*hw, 4, seed=6)
    rgba[..., 3] = 0
    h, w = hw
    rgba[h // 5: h // 2, w // 3: w - 20, 3] = 255
    rgba[h // 2: h // 2 + 9, w // 3: w // 2, 3] = 128  # a partly transparent rim
    ours = image.recenter_rescale(rgba, device="cpu")
    ref = jax_image.recenter_rescale(rgba)
    assert ours.shape == ref.shape == (256, 256, 3) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 2 / 255
    empty = rgba.copy()
    empty[..., 3] = 0  # no alpha: the whole frame is the object
    assert np.abs(image.recenter_rescale(empty, device="cpu")
                  - jax_image.recenter_rescale(empty)).max() <= 2 / 255


def test_image_grid_and_camera_cones_match_jax():
    rng = np.random.default_rng(7)
    imgs = rng.uniform(size=(6, 5, 4, 3)).astype(np.float32)
    assert np.array_equal(image.image_grid(imgs, 2, 3), jax_image.image_grid(imgs, 2, 3))
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = rng.normal(size=3)
    assert np.abs(image.camera_cone_points(c2w) - jax_image.camera_cone_points(c2w)).max() <= 1e-6
    rgba = rng.uniform(size=(4, 5, 4)).astype(np.float32)
    assert np.abs(image.composite_white(rgba) - jax_image.composite_white(rgba)).max() <= 1e-6
