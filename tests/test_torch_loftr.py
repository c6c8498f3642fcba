"""one2345_tpu_torch.elevation.loftr against the JAX LoFTR matcher: the
position encoding, linear attention, the ResNet-FPN features, the assembled
coarse transformer, the fine fusion and the whole fixed-K matching, on
numpy-seeded weights at full channel widths and a 96^2 image, f32, CPU; and
the bf16 matcher against the f32 one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.elevation import loftr as jax_loftr
from one2345_tpu_torch.elevation import loftr
from one2345_tpu_torch.utils.convert_jax import loftr_from_jax
from tests.torch_port_helpers import max_err, randomize

S = 96  # image side: a 12 x 12 coarse grid, 8 x 8 inside the border
K = 64  # slate size (<= the 144 coarse cells)
# low enough that the random-weight matcher keeps ~20 mutual nearest
# neighbours of an image and its shifted copy (the JAX tests use 0.01-0.05)
THRESHOLD = 0.005
FEAT_TOL = 1e-4  # of max |ref|, the conv stack and the transformer
CONF_TOL = 1e-4  # relative L2 of the dual-softmax confidence; of max conf per slot
KPT_TOL = 1e-3  # px, the fine keypoints (expected coordinate, 4 px window)
BF16_TOL = 5e-2  # relative L2, bf16 against f32


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


def _rel(out, ref) -> float:
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def matchers():
    """The JAX matcher with numpy-seeded weights (BN variances positive)
    and its port on the converted weights."""
    shapes = jax.eval_shape(  # the tree's structure, no init compiled
        jax_loftr.LoFTRModules().init, jax.random.key(0), jnp.zeros((1, 64, 64, 1))
    )
    jm = jax_loftr.LoFTRMatcher(
        randomize(shapes, seed=3), image_size=S, max_matches=K, threshold=THRESHOLD
    )
    pm = loftr.LoFTRMatcher(
        loftr_from_jax(jm.params), image_size=S, max_matches=K, threshold=THRESHOLD,
        device="cpu",
    )
    return jm, pm


@pytest.fixture(scope="module")
def images():
    """A seeded image and its copy shifted by one coarse cell."""
    img = np.random.default_rng(0).uniform(size=(S, S)).astype(np.float32)
    return img, np.roll(img, 8, axis=1)


@pytest.fixture(scope="module")
def jax_features(matchers, images):
    jm, _ = matchers
    with jax.default_matmul_precision("highest"):
        return jm.modules.apply(
            jm.params, jnp.asarray(np.stack(images))[..., None],
            method=jax_loftr.LoFTRModules.extract,
        )


def test_sine_position_encoding_is_exact():
    for h, w, d in ((8, 8, 256), (12, 12, 256), (60, 60, 256), (5, 7, 128)):
        a, b = loftr.sine_position_encoding(h, w, d), jax_loftr.sine_position_encoding(h, w, d)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_linear_attention_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 50, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 70, 8, 32)).astype(np.float32)
    v = rng.standard_normal((2, 70, 8, 32)).astype(np.float32)
    ref = jax_loftr.linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = loftr.linear_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert max_err(out, ref) <= 1e-5 * float(np.abs(np.asarray(ref)).max())


def test_loftr_from_jax_loads_strictly(matchers):
    jm, pm = matchers
    sd = loftr_from_jax(jm.params)
    assert set(sd) == set(pm.modules.state_dict())
    assert any(k.endswith("running_var") for k in sd)
    fresh = loftr.LoFTRModules()
    fresh.load_state_dict(sd, strict=True)
    # a conv kernel HWIO -> OIHW, a dense kernel transposed
    w = np.asarray(jm.params["params"]["backbone"]["conv1"]["kernel"])
    assert np.array_equal(fresh.backbone.conv1.weight.detach().numpy(), w.transpose(3, 2, 0, 1))
    w = np.asarray(jm.params["params"]["coarse_tf"]["cross_3"]["mlp0"]["kernel"])
    assert np.array_equal(fresh.coarse_tf.cross_3.mlp0.weight.detach().numpy(), w.T)


def test_backbone_features_match_jax(matchers, images, jax_features):
    _, pm = matchers
    coarse, fine = pm.extract(torch.from_numpy(np.stack(images)))
    ref_c, ref_f = jax_features
    assert coarse.shape == (2, S // 8, S // 8, 256) and fine.shape == (2, S // 2, S // 2, 128)
    assert max_err(coarse, ref_c) <= FEAT_TOL * float(np.abs(np.asarray(ref_c)).max())
    assert max_err(fine, ref_f) <= FEAT_TOL * float(np.abs(np.asarray(ref_f)).max())


def test_assembled_coarse_transformer_matches_jax(matchers, jax_features):
    """All 4 (self, cross) pairs, the sequential cross update included, on
    the position-encoded coarse features of both images."""
    jm, pm = matchers
    ref_c, _ = jax_features
    hc = S // 8
    pe = jax_loftr.sine_position_encoding(hc, hc, 256)
    c = (np.asarray(ref_c) + pe[None]).reshape(2, hc * hc, 256)
    r0, r1 = jm.modules.apply(
        jm.params, jnp.asarray(c[:1]), jnp.asarray(c[1:]), method=jax_loftr.LoFTRModules.coarse
    )
    o0, o1 = pm.modules.coarse_tf(torch.from_numpy(c[:1]), torch.from_numpy(c[1:]))
    for out, ref in ((o0, r0), (o1, r1)):
        assert max_err(out, ref) <= FEAT_TOL * float(np.abs(np.asarray(ref)).max())
    # the sequential update: feat1 attends to the updated feat0, and that
    # is not the same as attending to the previous one
    t0, t1 = torch.from_numpy(c[:1]), torch.from_numpy(c[1:])
    layer_self, layer_cross = pm.modules.coarse_tf.self_0, pm.modules.coarse_tf.cross_0
    a0, a1 = layer_self(t0, t0), layer_self(t1, t1)
    seq1 = layer_cross(a1, layer_cross(a0, a1))
    par1 = layer_cross(a1, a0)
    assert float((seq1 - par1).abs().max()) > 1e-3


def test_fuse_fine_matches_jax(matchers):
    jm, pm = matchers
    rng = np.random.default_rng(2)
    win = rng.standard_normal((6, 25, 128)).astype(np.float32)
    feat = rng.standard_normal((6, 256)).astype(np.float32)
    ref = jm.modules.apply(
        jm.params, jnp.asarray(win), jnp.asarray(feat), method=jax_loftr.LoFTRModules.fuse_fine
    )
    out = pm.modules.fuse_fine(torch.from_numpy(win), torch.from_numpy(feat))
    assert max_err(out, ref) <= 1e-5 * float(np.abs(np.asarray(ref)).max())
    r0, r1 = jm.modules.apply(jm.params, ref, ref[::-1], method=jax_loftr.LoFTRModules.fine)
    o0, o1 = pm.modules.fine_tf(out, out.flip(0))
    for o, r in ((o0, r0), (o1, r1)):
        assert max_err(o, r) <= FEAT_TOL * float(np.abs(np.asarray(r)).max())


def _valid_pairs(res, side=S // 8):
    """The valid slots' coarse (i, j) cell ids, from the slate's keypoints."""
    k0 = np.asarray(res.kpts0)
    k1 = np.round(np.asarray(res.kpts1) / 8.0)  # the coarse cell of a refined point
    valid = np.asarray(res.valid)
    i = (k0[:, 1] // 8) * side + k0[:, 0] // 8
    j = k1[:, 1] * side + k1[:, 0]
    return {(int(a), int(b)) for a, b in zip(i[valid], j[valid])}


def test_coarse_confidence_matches_jax(matchers, images, jax_features):
    """The dual-softmax confidence matrix of the pair (its f32 head)."""
    jm, pm = matchers
    ref_c, _ = jax_features
    hc = S // 8
    pe = jax_loftr.sine_position_encoding(hc, hc, 256)
    c = (np.asarray(ref_c) + pe[None]).reshape(2, hc * hc, 256)
    r0, r1 = jm.modules.apply(
        jm.params, jnp.asarray(c[:1]), jnp.asarray(c[1:]), method=jax_loftr.LoFTRModules.coarse
    )
    n0, n1 = np.asarray(r0[0]) / 16.0, np.asarray(r1[0]) / 16.0
    sim = (n0 @ n1.T) / 0.1
    ref = np.asarray(jax.nn.softmax(sim, axis=0) * jax.nn.softmax(sim, axis=1))
    coarse, _ = pm.extract(torch.from_numpy(np.stack(images)))
    _, _, conf = pm.coarse_confidence(coarse[:1], coarse[1:])
    assert conf.dtype == torch.float32 and conf.shape == (1, hc * hc, hc * hc)
    assert _rel(conf[0], ref) <= CONF_TOL


def test_match_pair_matches_jax(matchers, images):
    """The slate of an image against its shifted copy: the same valid (i, j)
    set, the same confidences and fine keypoints; invalid slots compared by
    validity only (torch.topk orders the tied zero rows differently)."""
    jm, pm = matchers
    img0, img1 = images
    ref = jm.match_pair(jm.params, jnp.asarray(img0), jnp.asarray(img1))
    out = pm.match_pair(torch.from_numpy(img0), torch.from_numpy(img1))
    assert out.kpts0.shape == (K, 2) and out.valid.dtype == torch.bool
    valid = np.asarray(ref.valid)
    assert 10 <= int(valid.sum()) < K  # some matches, and some invalid slots
    assert np.array_equal(out.valid.numpy(), valid)
    assert _valid_pairs(out) == _valid_pairs(ref)
    ref_conf = np.asarray(ref.conf)[valid]
    assert max_err(out.conf[out.valid], ref_conf) <= CONF_TOL * float(ref_conf.max())
    assert max_err(out.kpts0[out.valid], np.asarray(ref.kpts0)[valid]) == 0.0
    assert max_err(out.kpts1[out.valid], np.asarray(ref.kpts1)[valid]) <= KPT_TOL
    assert float(out.conf[~out.valid].abs().max()) == 0.0


def test_match_pairs_and_match_views_match_jax(matchers, images):
    """Two pairs in one batch against the JAX vmapped matcher; the port's
    per-view backbone gives the same slates as its per-pair one."""
    jm, pm = matchers
    img0, img1 = images
    a = np.stack([img0, img1])
    b = np.stack([img1, np.roll(img0, -8, axis=0)])
    ref = jm.match_pairs(jm.params, jnp.asarray(a), jnp.asarray(b))
    out = pm.match_pairs(torch.from_numpy(a), torch.from_numpy(b))
    for p in range(2):
        valid = np.asarray(ref.valid[p])
        assert valid.any() and np.array_equal(out.valid[p].numpy(), valid)
        assert max_err(out.kpts1[p][out.valid[p]], np.asarray(ref.kpts1[p])[valid]) <= KPT_TOL
    views = pm.match_views(torch.from_numpy(np.concatenate([a, b])), [(0, 2), (1, 3)])
    for x, y in zip(views, out):
        assert max_err(x, y) <= 1e-5


def test_bf16_matcher_tracks_f32(matchers, images, jax_features):
    """The bf16 matcher (convs, norms and dense layers in bf16, heads f32)
    against the f32 one and against the JAX bf16 modules."""
    jm, pm = matchers
    pm16 = loftr.LoFTRMatcher(
        loftr_from_jax(jm.params), image_size=S, max_matches=K, threshold=THRESHOLD,
        dtype="bfloat16", device="cpu",
    )
    x = torch.from_numpy(np.stack(images))
    c16, f16 = pm16.extract(x)
    assert c16.dtype == torch.bfloat16 and f16.dtype == torch.bfloat16
    c32, f32 = pm.extract(x)
    assert _rel(c16, c32) <= BF16_TOL and _rel(f16, f32) <= BF16_TOL
    ref16 = jax_loftr.LoFTRModules(dtype=jnp.bfloat16).apply(
        jm.params, jnp.asarray(np.stack(images))[..., None], method=jax_loftr.LoFTRModules.extract
    )
    assert _rel(c16, np.asarray(ref16[0], np.float32)) <= BF16_TOL
    _, _, conf16 = pm16.coarse_confidence(c16[:1], c16[1:])
    _, _, conf32 = pm.coarse_confidence(c32[:1], c32[1:])
    assert conf16.dtype == torch.float32
    assert _rel(conf16, conf32) <= 0.2  # softmax at temperature 0.1 amplifies logit errors
    res = pm16.match_pair(*(torch.from_numpy(i) for i in images))
    assert res.kpts1.dtype == torch.float32 and torch.isfinite(res.kpts1).all()


def test_identical_images_match_identity(matchers, images):
    """An image against itself: the valid matches are identity
    correspondences (the property of tests/test_loftr.py)."""
    _, pm = matchers
    img = torch.from_numpy(images[0])
    res = pm.match_pair(img, img)
    assert int(res.valid.sum()) > 0
    assert float((res.kpts0[res.valid] - res.kpts1[res.valid]).abs().max()) <= 8.0
