"""one2345_tpu_torch.recon.renderer and geometry.{rays,sampling} against the
JAX package, CPU, f32: rays, ``sample_pdf``, ``nearest_sample_volume``,
``up_sample_z``, ``cat_and_sort_z``, and ``render_rays`` (outputs, and the
gradients of a loss of its outputs with respect to the volume, the feature
maps and every network parameter, against ``jax.grad``), with the JAX
draws injected; plus tests/test_renderer.py's analytic-sphere cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.geometry import rays as jax_rays
from one2345_tpu.geometry import sampling as jax_sampling
from one2345_tpu.recon import renderer as jax_renderer
from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
from one2345_tpu.core.config import ReconConfig as JaxReconConfig
from one2345_tpu.recon.sdf_network import SdfVolumeNetwork as JaxSdfNet
from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.geometry import rays, sampling
from one2345_tpu_torch.recon import renderer
from one2345_tpu_torch.recon.pipeline import ReconStage
from one2345_tpu_torch.utils.convert_jax import recon_from_jax
from tests.torch_port_helpers import max_err, recon_test_params, tiny_recon_scene

TOL = 1e-5  # max abs, f32 outputs of the sampling and ray functions
# relative L2 per render_rays output: the importance samples come from
# inverse CDFs whose slope amplifies f32 differences (sample depths within
# 1.6e-5), and the trilinear field's SDF gradient moves with the sample
# (1.1e-4 at most measured, the weights)
RENDER_TOL = 5e-4
GRAD_TOL = 1e-3  # relative L2 per gradient tensor (floor: 1e-6 of the global norm)
# the blend's softmax is shift invariant: this bias's true gradient is 0,
# and both sides are held to 1e-6 of the global norm instead
ZERO_GRAD = "render.rgb_fc2.bias"


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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_rays_match_jax():
    rng = np.random.default_rng(0)
    K = np.array([[70.0, 0, 31.5], [0, 72.0, 30.0], [0, 0, 1]], np.float32)
    c2w = np.linalg.inv(tiny_recon_scene()["w2cs"][1]).astype(np.float32)
    o_ref, d_ref = jax_rays.rays_from_camera(48, 64, jnp.asarray(K), jnp.asarray(c2w))
    o, d = rays.rays_from_camera(48, 64, _t(K), _t(c2w))
    assert max_err(o, o_ref) <= TOL and max_err(d, d_ref) <= TOL

    # the random draw, with the indices JAX drew (categorical fg / bg halves)
    img = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    mask = (rng.uniform(size=(48, 64)) > 0.7).astype(np.float32)
    depth = rng.uniform(size=(48, 64)).astype(np.float32)
    key = jax.random.key(3)
    ref = jax_rays.random_rays_from_image(key, 64, jnp.asarray(img), jnp.asarray(K),
                                          jnp.asarray(c2w), mask=jnp.asarray(mask),
                                          depth=jnp.asarray(depth))
    k_fg, k_bg, _ = jax.random.split(key, 3)
    flat = jnp.asarray(mask).reshape(-1)
    idx = np.concatenate([
        np.asarray(jax.random.categorical(k_fg, jnp.where(flat > 0.5, 0.0, -1e9), shape=(32,))),
        np.asarray(jax.random.categorical(k_bg, jnp.where(flat > 0.5, -1e9, 0.0), shape=(32,))),
    ])
    out = rays.random_rays_from_image(None, 64, _t(img), _t(K), _t(c2w), mask=_t(mask),
                                      depth=_t(depth), idx=torch.from_numpy(idx))
    for name in ("rays_o", "rays_v", "rays_color", "rays_mask", "rays_depth"):
        assert max_err(out[name], ref[name]) <= TOL, name
    # the port's own draw: half on the foreground, uniform over all pixels
    # when a side is empty, as JAX falls back
    g = torch.Generator().manual_seed(0)
    own = rays.ray_indices(g, 64, 48 * 64, _t(mask))
    assert bool((_t(mask).reshape(-1)[own[:32]] > 0.5).all())
    assert bool((_t(mask).reshape(-1)[own[32:]] <= 0.5).all())
    none = rays.ray_indices(g, 64, 48 * 64, torch.zeros(48, 64))
    assert none.min() >= 0 and none.max() < 48 * 64 and len(none) == 64


def test_sampling_helpers_match_jax():
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((5, 6, 7, 3)).astype(np.float32)
    # points on and between the lattice, and outside it
    pts = rng.uniform(-1.2, 1.2, size=(400, 3)).astype(np.float32)
    pts[:50] = np.round((pts[:50] + 1) * 2) / 2 - 1
    ref = jax_sampling.nearest_sample_volume(jnp.asarray(vol), jnp.asarray(pts))
    assert max_err(sampling.nearest_sample_volume(_t(vol), _t(pts)), ref) == 0.0
    for pad in ("zeros", "border"):
        ref = jax_sampling.trilinear_sample(jnp.asarray(vol), jnp.asarray(pts), padding=pad)
        assert max_err(sampling.trilinear_sample(_t(vol), _t(pts), padding=pad), ref) <= TOL, pad

    bins = np.sort(rng.uniform(0.5, 2.5, size=(16, 12)), axis=-1).astype(np.float32)
    for m in (11, 12):
        w = rng.uniform(size=(16, m)).astype(np.float32) ** 4
        ref = jax_sampling.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 9)
        assert max_err(sampling.sample_pdf(_t(bins), _t(w), 9), ref) <= TOL, m
    u = rng.uniform(size=(16, 9)).astype(np.float32)
    ref = jax_sampling.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 9, key=jax.random.key(0))
    u_ref = jax.random.uniform(jax.random.key(0), (16, 9))
    assert max_err(sampling.sample_pdf(_t(bins), _t(w), 9, u=_t(u_ref)), ref) <= TOL
    assert sampling.sample_pdf(_t(bins), _t(w), 9, u=_t(u)).shape == (16, 9)


def test_up_sample_and_cat_and_sort_match_jax():
    rng = np.random.default_rng(2)
    z = np.sort(rng.uniform(0.5, 2.5, size=(8, 16)), axis=-1).astype(np.float32)
    sdf = (1.2 - z + 0.05 * rng.standard_normal(z.shape)).astype(np.float32)
    mask = (rng.uniform(size=z.shape) > 0.2).astype(np.float32)
    for inv_s in (64.0, 512.0):
        ref = jax_renderer.up_sample_z(jnp.asarray(z), jnp.asarray(sdf), jnp.asarray(mask), 8, inv_s)
        assert max_err(renderer.up_sample_z(_t(z), _t(sdf), _t(mask), 8, inv_s), ref) <= TOL
    z2 = rng.uniform(0.5, 2.5, size=(8, 8)).astype(np.float32)
    s2 = rng.standard_normal((8, 8)).astype(np.float32)
    rz, rs = jax_renderer.cat_and_sort_z(*(jnp.asarray(a) for a in (z, sdf, z2, s2)))
    pz, ps = renderer.cat_and_sort_z(_t(z), _t(sdf), _t(z2), _t(s2))
    assert max_err(pz, rz) == 0.0 and max_err(ps, rs) == 0.0


# ---------------------------------------------------------------- sphere


def _sphere_sdf(pts):
    r = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    return r - 0.5, torch.zeros(pts.shape[:-1] + (16,))


def _sphere_sdf_grad(pts):
    sdf, feat = _sphere_sdf(pts)
    return sdf, feat, pts / (torch.linalg.vector_norm(pts, dim=-1, keepdim=True) + 1e-9)


def _sphere_scene(n_rays=4, miss=False):
    th = torch.linspace(-0.05, 0.05, n_rays)
    d = torch.stack([torch.sin(th), torch.zeros_like(th), -torch.cos(th)], dim=-1)
    if miss:
        d = torch.tensor([[1.0, 0.0, 0.0]]).expand(n_rays, 3)
    V = 2
    return dict(
        rays_o=torch.tensor([[0.0, 0.0, 1.5]]).expand(n_rays, 3), rays_d=d, near=0.5, far=2.5,
        volume=torch.zeros(4, 4, 4, 16), mask_volume=torch.ones(4, 4, 4, 1),
        feature_maps=torch.zeros(V, 16, 16, 56), color_maps=torch.zeros(V, 16, 16, 3),
        w2cs=torch.eye(4).expand(V, 4, 4), intrinsics=torch.eye(3).expand(V, 3, 3),
        size_hw=(16, 16), query_cam_center=torch.tensor([0.0, 0.0, 1.5]),
    )


def _const_color_net(geo, rgb, rd, mask):
    return 0.5 * torch.ones(geo.shape[:2] + (3,)), torch.ones((geo.shape[0], 1), dtype=torch.bool)


@pytest.mark.parametrize("miss", [False, True])
def test_render_sphere(miss):
    """tests/test_renderer.py on the port: the hit at t = 1, opaque weights,
    zero eikonal error, the blend color; a miss is background."""
    s = _sphere_scene(4 if not miss else 2, miss)
    out = renderer.render_rays(
        _sphere_sdf, _sphere_sdf_grad, _const_color_net, torch.tensor(2000.0), **s,
        params=renderer.RenderParams(n_samples=32, n_importance=32, background_rgb=1.0),
    )
    if miss:
        np.testing.assert_allclose(out["weights_sum"][:, 0].numpy(), 0.0, atol=0.02)
        return
    np.testing.assert_allclose(out["depth"][:, 0].numpy(), 1.0, atol=0.05)
    np.testing.assert_allclose(out["weights_sum"][:, 0].numpy(), 1.0, atol=0.05)
    assert float(out["gradient_error_fine"]) < 1e-4
    np.testing.assert_allclose(out["color_fine"].numpy(), 0.5, atol=0.05)


# ------------------------------------------------------- the real networks

CFG = dict(image_hw=(32, 32), vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0, n_samples=16,
           n_importance=16)


@pytest.fixture(scope="module")
def render_case():
    """The JAX render (compiled) and the port's on the same networks,
    volume, maps and draws: outputs and the gradients of one loss of them."""
    params = recon_test_params(CFG, seed=7)
    jstage = JaxReconStage(JaxReconConfig(**CFG), params=params)
    port = ReconStage(ReconConfig(**CFG), params=recon_from_jax(params), device="cpu")
    sc = tiny_recon_scene(V=4, N=24, spread=0.08, seed=4)
    rng = np.random.default_rng(5)
    volume = (0.5 * rng.standard_normal((16, 16, 16, 16))).astype(np.float32)
    mask_volume = (rng.uniform(size=(16, 16, 16, 1)) > 0.15).astype(np.float32)
    feats = rng.standard_normal((3, 32, 32, 56)).astype(np.float32)
    ct = rng.standard_normal((24, 3)).astype(np.float32)
    rp = dict(n_samples=16, n_importance=16, perturb=True, alpha_inter_ratio=0.4,
              background_rgb=1.0, normal_query_prob=0.5)
    key = jax.random.key(11)
    qc = np.linalg.inv(sc["w2cs"][0])[:3, 3].astype(np.float32)
    sdf_vars = params["sdf"]

    def jax_loss(p_sdf, p_render, p_var, vol, fm):
        net = jstage.sdf_net
        v = {**sdf_vars, "params": p_sdf}
        out = jax_renderer.render_rays(
            lambda x: net.apply(v, x, vol, method=JaxSdfNet.sdf),
            lambda x: net.apply(v, x, vol, method=JaxSdfNet.sdf_and_gradient),
            lambda *a: jstage.render_net.apply({"params": p_render}, *a),
            jstage.variance_net.apply({"params": p_var}),
            jnp.asarray(sc["rays_o"]), jnp.asarray(sc["rays_v"]), 0.8, 2.8, vol,
            jnp.asarray(mask_volume), fm, jnp.asarray(sc["images"][1:]),
            jnp.asarray(sc["w2cs"][1:]), jnp.asarray(sc["intrinsics"][1:]), (32, 32),
            jnp.asarray(qc), jax_renderer.RenderParams(**rp), key=key,
        )
        loss = (jnp.sum(out["color_fine"] * ct) + out["gradient_error_fine"]
                + jnp.mean(jnp.exp(-100 * jnp.abs(out["sdf"]))) + jnp.sum(out["depth"]))
        return loss, out

    args = (params["sdf"]["params"], params["render"]["params"], params["variance"]["params"],
            jnp.asarray(volume), jnp.asarray(feats))
    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4),
                                                    has_aux=True))(*args)
    draws = {"t_rand": _t(jax.random.uniform(key, (24, 16))),
             "normal_query": torch.from_numpy(np.array(jax.random.bernoulli(
                 jax.random.fold_in(key, 101), 0.5, (24, 1, 1)))).reshape(-1)}
    vol_t, fm_t = _t(volume).requires_grad_(True), _t(feats).requires_grad_(True)
    for m in port.modules().values():
        m.requires_grad_(True)
    net = port.sdf_net
    out = renderer.render_rays(
        lambda x: net.sdf(x, vol_t), lambda x: net.sdf_and_gradient(x, vol_t, create_graph=True),
        port.render_net, port.variance_net(), _t(sc["rays_o"]), _t(sc["rays_v"]), 0.8, 2.8,
        vol_t, _t(mask_volume), fm_t, _t(sc["images"][1:]), _t(sc["w2cs"][1:]),
        _t(sc["intrinsics"][1:]), (32, 32), _t(qc), renderer.RenderParams(**rp), draws=draws,
    )
    loss = ((out["color_fine"] * _t(ct)).sum() + out["gradient_error_fine"]
            + torch.exp(-100 * out["sdf"].abs()).mean() + out["depth"].sum())
    loss.backward()
    return (jl, jout, jgrads), (loss, out, vol_t, fm_t, port)


def test_render_rays_outputs_match_jax(render_case):
    (jl, jout, _), (loss, out, *_) = render_case
    assert set(out) == set(jout)
    for name, ref in jout.items():
        a = out[name].detach().numpy().astype(np.float64)
        b = np.asarray(ref).astype(np.float64)
        assert np.linalg.norm(a - b) <= RENDER_TOL * np.linalg.norm(b), name
    ws = out["weights_sum"]
    assert float(ws.mean()) > 0.05  # the rays hit the surface
    assert bool(out["color_fine_mask"].any())
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * abs(float(jl))


def test_render_rays_gradients_match_jax(render_case):
    (_, _, jgrads), (_, _, vol_t, fm_t, port) = render_case
    g_sdf, g_render, g_var, g_vol, g_fm = jgrads
    ref = recon_from_jax({"sdf": g_sdf, "render": g_render, "variance": g_var})
    pairs = [("volume", vol_t.grad, np.asarray(g_vol)), ("feature_maps", fm_t.grad, np.asarray(g_fm))]
    for key in ("sdf", "render", "variance"):
        for name, p in port.modules()[key].named_parameters():
            if name in ref[key]:
                pairs.append((f"{key}.{name}", p.grad, ref[key][name].numpy()))
    floor = 1e-6 * np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64))) for *_, r in pairs))
    worst = {}
    for name, g, r in pairs:
        g = np.zeros_like(r) if g is None else g.numpy()
        if name == ZERO_GRAD:
            assert max(np.linalg.norm(g), np.linalg.norm(r)) <= floor, name
            continue
        worst[name] = np.linalg.norm(g - r) / max(np.linalg.norm(r), floor)
    print("worst render gradient:", max(worst.items(), key=lambda kv: kv[1]))
    assert np.linalg.norm(np.asarray(g_vol)) > 0 and np.linalg.norm(np.asarray(g_fm)) > 0
    assert max(worst.values()) <= GRAD_TOL
