"""one2345_tpu_torch.recon.finetune against one2345_tpu.recon.finetune, CPU,
f32: the patch offsets, ``patch_warp`` and ``pixel_warp`` on random planes
and cameras (invalid homographies and off-image taps included), the
blending net on both branches from converted JAX weights, the TV term,
one ``train_step`` (loss, metrics, every gradient) and three steps against
optax, the loss-decrease contract of tests/test_finetune.py, and the
stage's weights left as they were.  The JAX trees come from
``jax.eval_shape`` (no init is compiled but the blending net's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.core.config import ReconConfig as JaxReconConfig
from one2345_tpu.geometry.sampling import bilinear_sample as jax_bilinear_sample
from one2345_tpu.recon import finetune as jft
from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.geometry.cameras import BLENDER2OPENCV, spherical_look_at_poses
from one2345_tpu_torch.recon import finetune as pft
from one2345_tpu_torch.recon.pipeline import ReconStage
from one2345_tpu_torch.utils.convert_jax import (
    finetune_from_jax,
    flax_to_state_dict,
    recon_from_jax,
)
from tests.torch_port_helpers import max_err, randomize, recon_test_params

# the warps: in float64 (JAX under x64) the port equals JAX within
# WARP_TOL; in f32 each side's colours lie ~1e-5 from the float64 ones
# (the homographies' rounding times the texture's slope; JAX's own f32 was
# up to 2.2e-5 off, the port's 2.5e-5), so the f32 port is held to the
# float64 colours within WARP_F32_FACTOR times JAX's own f32 error, at
# least WARP_TOL, with JAX's masks
WARP_TOL = 1e-5
WARP_F32_FACTOR = 4.0
NET_TOL = 1e-5  # max abs, blending-net colours
TV_TOL = 1e-6
LOSS_TOL = 5e-5  # relative: the loss, each metric, each gradient (L2)
STEPS_TOL = 1e-4  # max abs, every trained tensor after three Adam steps
# tests/test_finetune.py's tiny stage
TINY = dict(image_hw=(32, 32), vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0,
            n_samples=8, n_importance=8)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _lookat(pos, target=np.zeros(3)):
    """tests/test_finetune.py's look-at (OpenCV axes: z toward the target)."""
    z = target - pos
    z = z / np.linalg.norm(z)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, y, z], axis=-1)
    c2w[:3, 3] = pos
    return c2w


# --------------------------------------------------------------- offsets
@pytest.mark.parametrize("h", [0, 1, 2, 3])
def test_patch_offsets_match_jax(h):
    off = pft.build_patch_offsets(h)
    np.testing.assert_array_equal(off, jft.build_patch_offsets(h))
    assert off.shape == ((2 * h + 1) ** 2, 2) and off.dtype == np.float32
    assert (off[len(off) // 2] == [0, 0]).all()


# ------------------------------------------------------------------ warps
def _warp_case(seed: int, N: int = 24, V: int = 3, H: int = 32, W: int = 32):
    """Random cameras on a sphere around the origin, points near it with
    random normals; a third of the normals lie in the plane through the
    reference camera (|d1| below the threshold: the fronto-parallel
    fallback), a few points project near the image edge (off-image taps)."""
    rng = np.random.default_rng(seed)
    polar = np.radians(rng.uniform(40, 100, V + 1))
    azim = np.radians(rng.uniform(0, 360, V + 1))
    c2ws = spherical_look_at_poses(polar, azim, radius=rng.uniform(1.6, 2.2)) @ BLENDER2OPENCV
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1.0]])
    pts = rng.uniform(-0.4, 0.4, (N, 3))
    normals = rng.normal(size=(N, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    ref_c = c2ws[0, :3, 3]
    for i in range(0, N, 3):  # plane through the reference camera
        ray = pts[i] - ref_c
        n = np.cross(ray, rng.normal(size=3))
        normals[i] = n / np.linalg.norm(n)
    w2c = np.linalg.inv(c2ws[0])
    pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
    uv = (pc @ K.T)[:, :2] / (pc @ K.T)[:, 2:]
    uv[-3:] = [[0.5, 5.0], [W - 1.2, 17.0], [9.0, H - 0.7]]  # patches across the edge
    imgs = rng.uniform(size=(V, H, W, 3))
    Ks = np.tile(K[None], (V, 1, 1))
    args = (pts, uv, normals, imgs, K, Ks, c2ws[0], c2ws[1:])
    return [np.asarray(a, np.float32) for a in args]


def _check_warp(fn_jax, fn_port, args, **kw):
    """The port against JAX in float64 (within WARP_TOL, masks equal) and
    in f32 (masks equal, colours as accurate as JAX's); returns JAX's mask."""
    with jax.enable_x64(True):
        j64, jm64 = fn_jax(*[jnp.asarray(np.asarray(a, np.float64)) for a in args], **kw)
        j64, jm64 = np.asarray(j64), np.asarray(jm64)
    assert j64.dtype == np.float64
    p64, pm64 = fn_port(*[torch.from_numpy(np.asarray(a, np.float64)) for a in args], **kw)
    assert p64.dtype == torch.float64
    np.testing.assert_array_equal(pm64.numpy(), jm64)
    assert max_err(p64, j64) <= WARP_TOL
    jc, jm = fn_jax(*[jnp.asarray(a) for a in args], **kw)
    pc, pm = fn_port(*[t(a) for a in args], **kw)
    jm = np.asarray(jm)
    assert pc.shape == jc.shape == j64.shape and pc.dtype == torch.float32
    np.testing.assert_array_equal(pm.numpy(), jm)
    jax_err = max_err(jc, j64)
    assert max_err(pc, j64) <= max(WARP_TOL, WARP_F32_FACTOR * jax_err), jax_err
    return jm


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_patch_warp_matches_jax(seed, h):
    jm = _check_warp(jft.patch_warp, pft.patch_warp, _warp_case(seed), h_patch_size=h)
    # the case reaches both branches and both sides of the image edge
    assert 0.05 < jm.mean() < 0.95
    assert not jm[::3].any(axis=(1, 2)).all()  # some fallback homography's patch masked


def test_patch_warp_plane_consistency():
    """tests/test_finetune.py's check on the port: points on a textured
    plane, each patch centre equals the point's direct projection."""
    H = W = 64
    K = np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]], np.float32)
    ref_c2w = _lookat(np.array([0.1, 0.05, 2.0]))
    src_c2w = _lookat(np.array([0.6, 0, 1.9]))
    rng = np.random.default_rng(0)
    tex = rng.uniform(size=(H, W, 3)).astype(np.float32)
    pts = np.stack([rng.uniform(-0.2, 0.2, 8), rng.uniform(-0.2, 0.2, 8), np.zeros(8)],
                   -1).astype(np.float32)
    normals = np.tile(np.array([[0, 0, 1.0]], np.float32), (8, 1))
    w2c = np.linalg.inv(ref_c2w)
    pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
    uv = (pc @ K.T)[:, :2] / (pc @ K.T)[:, 2:]
    colors, mask = pft.patch_warp(t(pts), t(uv), t(normals), t(tex[None]), t(K), t(K[None]),
                                  t(ref_c2w), t(src_c2w[None]), h_patch_size=1)
    assert colors.shape == (8, 1, 9, 3)
    assert float(mask.float().mean()) > 0.8
    w2c_s = np.linalg.inv(src_c2w)
    pcs = pts @ w2c_s[:3, :3].T + w2c_s[:3, 3]
    uv_s = (pcs @ K.T)[:, :2] / (pcs @ K.T)[:, 2:]
    direct = np.asarray(jax_bilinear_sample(jnp.asarray(tex), jnp.asarray(uv_s[:, 0]),
                                            jnp.asarray(uv_s[:, 1])))
    valid = mask[:, 0, 4].numpy()
    np.testing.assert_allclose(colors[:, 0, 4].numpy()[valid], direct[valid], atol=2e-2)


@pytest.mark.parametrize("seed", [0, 1])
def test_pixel_warp_matches_jax(seed):
    pts, _, _, imgs, K, Ks, _, c2ws = _warp_case(seed)
    pts = pts * 3.0  # some points leave the views' frusta
    w2cs = np.linalg.inv(c2ws).astype(np.float32)
    jm = _check_warp(lambda *a: jft.pixel_warp(*a, (32, 32)),
                     lambda *a: pft.pixel_warp(*a, (32, 32)), (pts, imgs, w2cs, Ks))
    assert jm.shape == (len(pts), len(imgs))
    assert 0.2 < jm.mean() < 1.0


# ------------------------------------------------------------ blending net
def _blend_inputs(seed: int, N: int = 10, V: int = 4, P: int = 9, d_feature: int = 16):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    pix_mask = (rng.uniform(size=(N, V)) > 0.3).astype(f32)
    pix_mask[0] = 0.0  # a point no view sees
    patch_mask = rng.uniform(size=(N, V, P)) > 0.1
    patch_mask[1:4] = True  # whole patches visible
    return (
        rng.normal(size=(N, 3)).astype(f32), rng.normal(size=(N, 3)).astype(f32),
        rng.normal(size=(N, 3)).astype(f32), rng.normal(size=(N, d_feature)).astype(f32),
        rng.uniform(size=(N, V, 3)).astype(f32), pix_mask,
        rng.uniform(size=(N, V, P, 3)).astype(f32), patch_mask,
    )


@pytest.mark.parametrize("patch", [False, True], ids=["pixel", "patch"])
@pytest.mark.parametrize("seed", [0, 1])
def test_blending_network_matches_jax(seed, patch):
    args = _blend_inputs(seed)
    if not patch:
        args = args[:6]
    jnet = jft.BlendingRenderingNetwork(d_feature=16, d_hidden=32, d_out=8)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), *[jnp.asarray(a) for a in args])
    params = randomize(shapes, seed)
    jout = jnet.apply(params, *[jnp.asarray(a) for a in args])
    net = pft.BlendingRenderingNetwork(d_feature=16, d_hidden=32, d_out=8)
    net.load_state_dict(finetune_from_jax(params), strict=True)
    pout = net(*[torch.from_numpy(np.asarray(a)) for a in args])
    assert max_err(pout[0], jout[0]) <= NET_TOL
    np.testing.assert_array_equal(pout[1].numpy(), np.asarray(jout[1]))
    assert not bool(pout[1][0]) and bool(pout[1][1:].any())
    if patch:
        assert max_err(pout[2], jout[2]) <= NET_TOL
        np.testing.assert_array_equal(pout[3].numpy(), np.asarray(jout[3]))
    else:
        assert pout[2] is None and pout[3] is None


def test_blending_network_convexity():
    """tests/test_finetune.py's check on the port: the colour is a convex
    combination of the views' colours."""
    torch.manual_seed(1)
    net = pft.BlendingRenderingNetwork(d_feature=16, d_hidden=32, d_out=8)
    rng = np.random.default_rng(1)
    N, V = 6, 3
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((N, 3), (N, 3), (N, 3), (N, 16))]
    pix = torch.from_numpy(rng.uniform(size=(N, V, 3)).astype(np.float32))
    color, ok, _, _ = net(*args, pix, torch.ones(N, V))
    assert (color >= pix.min(1).values - 1e-5).all() and (color <= pix.max(1).values + 1e-5).all()
    assert ok.all()


# --------------------------------------------------------------------- TV
@pytest.mark.parametrize("seed", [0, 1])
def test_tv_regularizer_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=(9, 8, 7, 5)).astype(np.float32)
    mask = (rng.uniform(size=(9, 8, 7, 1)) > 0.3).astype(np.float32)
    ref = float(jft.FinetuneTrainer.tv_regularizer(None, jnp.asarray(vol), jnp.asarray(mask)))
    got = float(pft.tv_regularizer(t(vol), t(mask)))
    assert abs(got - ref) <= TV_TOL
    assert got > 0


# -------------------------------------------------------------- the step
def _grab_grads():
    """An optax transformation that keeps the gradients as its state and
    updates nothing: the JAX step then returns its own gradients."""
    import optax

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), updates

    return optax.GradientTransformation(init, update)


def _scene(V: int = 2, H: int = 32, W: int = 32, N: int = 64, seed: int = 2):
    """tests/test_finetune.py's scene with random source images and target
    colours and 64 rays."""
    rng = np.random.default_rng(seed)
    c2ws = np.stack([_lookat(np.array([0.1, 0.05, 1.8])), _lookat(np.array([1.8, 0, 0.2]))])
    K = np.array([[35.0, 0, 16], [0, 35.0, 16], [0, 0, 1]], np.float32)
    o = c2ws[0, :3, 3]
    dirs = -o / np.linalg.norm(o) + rng.normal(0, 0.05, (N, 3))
    scene = {
        "rays_o": np.tile(o, (N, 1)),
        "rays_v": dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
        "rays_color": rng.uniform(size=(N, 3)),
        "near_far": np.array([0.8, 2.8]),
        "images": rng.uniform(size=(V, H, W, 3)),
        "w2cs": np.linalg.inv(c2ws),
        "intrinsics": np.tile(K[None], (V, 1, 1)),
    }
    return {k: np.asarray(v, np.float32) for k, v in scene.items()}


def _volume(seed: int = 3):
    """A latent volume and an occupancy mask (a ball of radius 0.75 of the
    16^3 lattice): the masked voxels get no gradient.  The field stays near
    an SDF (eikonal error ~0.07): with latents 3x larger and 4x larger latent
    rows its gradients reach |9| and f32 gradients lie 0.3 from float64 on
    either side (the port's and JAX's alike)."""
    rng = np.random.default_rng(seed)
    vol = (0.1 * rng.normal(size=(16, 16, 16, 16))).astype(np.float32)
    lin = np.linspace(-1, 1, 16)
    r = np.sqrt(sum(g**2 for g in np.meshgrid(lin, lin, lin, indexing="ij")))
    return vol, (r < 0.75).astype(np.float32)[..., None]


@pytest.fixture(scope="module")
def jax_params():
    return recon_test_params(TINY, seed=5)


def _pair(jax_params, lr: float = 5e-4, tx=None):
    """The JAX trainer (its state from the volume) and the port's, on the
    same weights, the same blending net."""
    vol, mask = _volume()
    jtr = jft.FinetuneTrainer(JaxReconStage(JaxReconConfig(**TINY), params=jax_params), lr=lr)
    if tx is not None:
        jtr.tx = tx
    jstate = jtr.init_state(jnp.asarray(vol), jnp.asarray(mask), jax.random.key(0))
    blend = randomize(jax.tree_util.tree_map(np.asarray, jstate.blend_params), 9)
    jstate = jstate._replace(blend_params=blend, opt_state=jtr.tx.init(
        (jstate.volume, jstate.sdf_params, blend)))
    stage = ReconStage(ReconConfig(**TINY), params=recon_from_jax(jax_params), device="cpu")
    ptr = pft.FinetuneTrainer(stage, lr=lr)
    ptr.init_state(vol, mask, finetune_from_jax(blend))
    return jtr, jstate, ptr, mask


def _port_grads(ptr) -> dict:
    out = {"volume": ptr.volume.grad}
    out.update({f"sdf_layer.{k}": p.grad for k, p in ptr.sdf_layer.named_parameters()})
    out.update({f"blend.{k}": p.grad for k, p in ptr.blend_net.named_parameters()})
    return out


def _jax_tree(volume, sdf_params, blend_params) -> dict:
    out = {"volume": torch.from_numpy(np.array(volume))}
    out.update({f"sdf_layer.{k}": v for k, v in flax_to_state_dict(sdf_params).items()})
    out.update({f"blend.{k}": v for k, v in finetune_from_jax(blend_params).items()})
    return out


@pytest.fixture(scope="module")
def one_step(jax_params):
    jtr, jstate, ptr, mask = _pair(jax_params, tx=_grab_grads())
    scene = _scene()
    jscene = {k: jnp.asarray(v) for k, v in scene.items()}
    jnew, jm = jtr.train_step(jstate, jnp.asarray(mask), jscene, jax.random.key(1))
    jgrads = _jax_tree(*jnew.opt_state)
    loss, metrics = ptr.loss_fn(mask, scene)
    loss.backward()
    return jm, jgrads, metrics, _port_grads(ptr), mask


def test_train_step_loss_and_metrics_match_jax(one_step):
    jm, _, metrics, _, _ = one_step
    assert set(metrics) == set(jm) == {"loss", "color", "eikonal", "tv"}
    for name, ref in jm.items():
        ref = float(ref)
        assert np.isfinite(ref) and ref > 0, name
        assert abs(float(metrics[name].detach()) - ref) <= LOSS_TOL * abs(ref), name


def test_train_step_gradients_match_jax(one_step):
    _, jgrads, _, grads, mask = one_step
    assert set(grads) == set(jgrads)
    worst = {}
    for name, g_ref in jgrads.items():
        g_ref = g_ref.numpy().astype(np.float64)
        g = grads[name].numpy().astype(np.float64)
        norm = np.linalg.norm(g_ref)
        assert norm > 0, name
        worst[name] = np.linalg.norm(g - g_ref) / norm
    print("worst gradient relative L2:", max(worst.items(), key=lambda kv: kv[1]))
    assert max(worst.values()) <= LOSS_TOL
    # the volume's gradient is zero outside the mask, non-zero inside
    gv = grads["volume"].numpy()
    assert not gv[mask[..., 0] == 0].any() and gv[mask[..., 0] > 0].any()


def test_three_steps_match_optax(jax_params):
    jtr, jstate, ptr, mask = _pair(jax_params, lr=1e-3)
    scene = _scene()
    jscene = {k: jnp.asarray(v) for k, v in scene.items()}
    for step in range(3):
        jstate, jm = jtr.train_step(jstate, jnp.asarray(mask), jscene, jax.random.key(step))
        pm = ptr.train_step(mask, scene)
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= STEPS_TOL * float(jm["loss"]), step
    assert ptr.step == int(jstate.step) == 3
    ref = _jax_tree(jstate.volume, jstate.sdf_params, jstate.blend_params)
    state = {"volume": ptr.volume.detach()}
    state.update({f"sdf_layer.{k}": v for k, v in ptr.sdf_layer.state_dict().items()})
    state.update({f"blend.{k}": v for k, v in ptr.blend_net.state_dict().items()})
    for name, r in ref.items():
        assert max_err(state[name], r) <= STEPS_TOL, name


def test_steps_decrease_loss_and_leave_the_stage(jax_params):
    """tests/test_finetune.py's contract on the port: 30 steps on one
    fixed, consistent scene (one colour everywhere) bring the loss of the
    last five below 0.7 of the first; the stage's SDF MLP and variance are
    unchanged (the trainer trains a copy)."""
    stage = ReconStage(ReconConfig(**TINY), seed=0, device="cpu")
    before = {f"{k}.{n}": v.clone() for k, m in stage.modules().items()
              for n, v in m.state_dict().items()}
    trainer = pft.FinetuneTrainer(stage, lr=2e-3)
    rng = np.random.default_rng(2)
    trainer.init_state(rng.normal(size=(16, 16, 16, 16)).astype(np.float32) * 0.01,
                       np.ones((16, 16, 16, 1), np.float32))
    V, H, W, N = 2, 32, 32, 8
    c2ws = np.stack([_lookat(np.array([0.1, 0.05, 1.8])), _lookat(np.array([1.8, 0, 0.2]))])
    K = np.array([[35.0, 0, 16], [0, 35.0, 16], [0, 0, 1]], np.float32)
    color = np.array([0.6, 0.3, 0.2], np.float32)
    scene = {
        "rays_o": np.tile(c2ws[0, :3, 3], (N, 1)).astype(np.float32),
        "rays_v": (-c2ws[0, :3, 3] / np.linalg.norm(c2ws[0, :3, 3])
                   + rng.normal(0, 0.01, (N, 3))).astype(np.float32),
        "rays_color": np.tile(color, (N, 1)),
        "near_far": np.array([0.8, 2.8], np.float32),
        "images": np.tile(color, (V, H, W, 1)),
        "w2cs": np.linalg.inv(c2ws).astype(np.float32),
        "intrinsics": np.tile(K[None], (V, 1, 1)),
    }
    mask = np.ones((16, 16, 16, 1), np.float32)
    losses = []
    for i in range(30):
        m = trainer.train_step(mask, scene)
        for k, v in m.items():
            assert np.isfinite(float(v)), (i, k)
        losses.append(float(m["loss"]))
    assert trainer.step == 30
    assert min(losses[-5:]) < 0.7 * losses[0], (losses[0], losses[-5:])
    after = {f"{k}.{n}": v for k, m in stage.modules().items() for n, v in m.state_dict().items()}
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    moved = [n for n, p in trainer.sdf_layer.named_parameters()
             if not torch.equal(p, stage.sdf_net.sdf_layer.state_dict()[n])]
    assert moved and not any(p.requires_grad for p in stage.sdf_net.parameters())


def test_trainer_defaults_match_jax(jax_params):
    jtr = jft.FinetuneTrainer(JaxReconStage(JaxReconConfig(**TINY), params=jax_params))
    ptr = pft.FinetuneTrainer(ReconStage(ReconConfig(**TINY), device="cpu"))
    for name in ("tv_weight", "igr_weight", "sparse_weight"):
        assert getattr(ptr, name) == getattr(jtr, name)
    assert ptr.lr == 5e-4
    ptr.init_state(np.zeros((16, 16, 16, 16), np.float32), np.ones((16, 16, 16, 1), np.float32))
    net = ptr.blend_net
    assert net.lin0.v.shape == (3 + 27 + 3 + 127, 128) and net.lin3.v.shape == (128, 50)
    group = ptr.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8 and group["weight_decay"] == 0
