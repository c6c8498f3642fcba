"""one2345_tpu_torch.segmentation.sam against the JAX SAM stage on the tiny
config of tests/test_sam.py (grid 4, window 2), and with window 3 so that
the windowed blocks pad the grid (4 -> 6) and attend over the zero pad; f32
on the CPU with numpy-seeded JAX weights converted by sam_from_jax, then a
bf16 config."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.core import config as jax_config
from one2345_tpu.segmentation import sam as jax_sam
from one2345_tpu_torch.core import config
from one2345_tpu_torch.segmentation import sam
from one2345_tpu_torch.utils.convert_jax import sam_from_jax
from tests.torch_port_helpers import randomize

REL_TOL = 1e-5  # relative L2, f32
BF16_TOL = 3e-2  # relative L2, the bf16 embedding against JAX's bf16 one
LOGIT_EPS = 1e-4  # masks may differ only where the JAX logit is this close to 0
TINY = dict(image_size=64, patch_size=16, encoder_dim=32, encoder_depth=2, encoder_heads=2,
            global_attn_indexes=(1,), prompt_embed_dim=32, dtype="float32")
BOX = (10, 10, 50, 40)


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = (b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


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


def _stages(window: int, dtype: str = "float32", seed: int = 3):
    kw = dict(TINY, window_size=window, dtype=dtype)
    jstage = jax_sam.SamStage(jax_config.SamConfig(**kw), params={})
    jstage.params = randomize(jax.eval_shape(jstage.init_params, jax.random.key(0)), seed)
    stage = sam.SamStage(config.SamConfig(**kw), params=sam_from_jax(jstage.params), device="cpu")
    return jstage, stage


@pytest.fixture(scope="module", params=[2, 3], ids=["window2", "window3_padded"])
def stages(request):
    with jax.default_matmul_precision("highest"):
        return _stages(request.param)


def _image(h=48, w=60, seed=1):
    img = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    img[h // 4: 3 * h // 4, w // 4: 3 * w // 4] //= 3  # a darker object
    return img


def test_converted_weights_load_strict(stages):
    jstage, stage = stages
    sd = sam_from_jax(jstage.params)
    fresh = sam.SamModules(stage.config)
    assert fresh.load_state_dict(sd, strict=True) is not None
    assert set(sd) == set(fresh.state_dict())
    w = sd["decoder.upscale_conv1.weight"]
    k = np.asarray(jstage.params["decoder"]["params"]["upscale_conv1"]["kernel"])
    assert w.shape == (k.shape[2], k.shape[3], 2, 2)
    assert np.array_equal(w[:, :, 0, 1].numpy(), k[1, 0])  # both spatial axes reversed


def test_rel_pos_bias_and_one_block_match_jax(stages):
    jstage, stage = stages
    c = stage.config
    enc = jstage.params["encoder"]["params"]
    grid = c.image_size // c.patch_size
    rel_h = np.asarray(enc["block_1"]["attn"]["rel_pos_h"])
    assert rel(jax_sam._rel_pos_bias(jnp.asarray(rel_h), grid, grid),
               sam.rel_pos_bias(torch.from_numpy(rel_h), grid, grid)) <= REL_TOL
    x = np.random.default_rng(2).standard_normal((1, grid, grid, c.encoder_dim)).astype(np.float32)
    for i, window in ((0, c.window_size), (1, 0)):
        block = jax_sam.SamBlock(c.encoder_dim, c.encoder_heads, window, grid, jnp.float32)
        ref = jax.jit(block.apply)({"params": enc[f"block_{i}"]}, jnp.asarray(x))
        out = getattr(stage.encoder, f"block_{i}")(torch.from_numpy(x))
        assert rel(ref, out) <= REL_TOL, i


def test_encoder_and_position_encoding_match_jax(stages):
    jstage, stage = stages
    c = stage.config
    x = np.random.default_rng(4).standard_normal((1, c.image_size, c.image_size, 3)).astype(np.float32)
    ref = jax.jit(jstage.encoder.apply)(jstage.params["encoder"], jnp.asarray(x))
    with torch.no_grad():
        assert rel(ref, stage.encoder(torch.from_numpy(x))) <= REL_TOL
    pe = np.asarray(jstage.params["extra"]["pe_gaussian"])
    grid = c.image_size // c.patch_size
    assert rel(jax_sam.position_encoding_grid(pe, grid),
               sam.position_encoding_grid(torch.from_numpy(pe), grid)) <= REL_TOL
    pts = np.array([[3.0, 7.5], [60.0, 41.0]], np.float32)
    assert rel(jax_sam.encode_point(pe, jnp.asarray(pts), 64.0),
               sam.encode_point(torch.from_numpy(pe), torch.from_numpy(pts), 64.0)) <= REL_TOL


def test_decoder_masks_and_iou_match_jax(stages):
    jstage, stage = stages
    img = _image()
    jc, tc = jstage.set_image(img), stage.set_image(img)
    assert rel(jc["embedding"], tc["embedding"]) <= REL_TOL
    box = np.asarray(BOX, np.float32) * jc["scale"]
    jm, ji = jstage._decode(jstage.params, jc["embedding"], jnp.asarray(box))
    tm, ti = stage._decode(tc["embedding"], torch.from_numpy(box))
    assert rel(jm, tm) <= REL_TOL and rel(ji, ti) <= REL_TOL


@pytest.mark.parametrize("hw", [(48, 60), (37, 29)])
def test_predict_box_and_seed_bbox_match_jax(stages, hw):
    """The masks agree except where the JAX logit (resized as predict_box
    resizes it) is within 1e-4 of zero; seed_bbox gives the same box or
    None on both sides."""
    jstage, stage = stages
    img = _image(*hw, seed=hw[0])
    jc, tc = jstage.set_image(img), stage.set_image(img)
    H, W = hw
    box = (3, 4, W - 5, H - 3)
    ref, out = jstage.predict_box(jc, box), stage.predict_box(tc, box)
    assert out.shape == (H, W) and out.dtype == bool
    masks, _ = jstage._decode(jstage.params, jc["embedding"],
                              jnp.asarray(np.asarray(box, np.float32) * jc["scale"]))
    size = stage.config.image_size
    nh, nw = jc["nhw"]
    logit = cv2.resize(cv2.resize(np.asarray(masks[0][-1], np.float32), (size, size))[:nh, :nw], (W, H))
    differ = ref != out
    assert not differ[np.abs(logit) >= LOGIT_EPS].any()
    assert stage.seed_bbox(tc) == jstage.seed_bbox(jc)


def test_set_image_is_memoised(stages, monkeypatch):
    _, stage = stages
    img = _image(seed=9)
    cache = stage.set_image(img)
    calls = []
    monkeypatch.setattr(stage, "_encode", lambda *a: calls.append(a))
    assert stage.set_image(img.copy()) is cache and calls == []
    stage.set_image(img[:, ::-1].copy())
    assert len(calls) == 1  # other content: encoded again


def test_bf16_encoder_within_bound_of_jax():
    with jax.default_matmul_precision("highest"):
        jstage, stage = _stages(3, dtype="bfloat16", seed=11)
        img = _image(seed=12)
        ref = jstage.set_image(img)["embedding"]
    out = stage.set_image(img)["embedding"]
    assert out.dtype == torch.float32
    assert stage.encoder.block_0.attn.qkv.weight.dtype == torch.bfloat16
    assert rel(ref, out) <= BF16_TOL
