"""The reconstruction networks of one2345_tpu_torch against the JAX
package's (nn/layers, recon/featurenet, costreg, sdf_network,
rendering_network), weights carried over by utils.convert_jax, on
numpy-seeded inputs, f32, CPU; and the converter and test helper they rely
on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.diffusion import unet as jax_unet
from one2345_tpu.nn import layers as jax_layers
from one2345_tpu.recon import costreg as jax_costreg
from one2345_tpu.recon.featurenet import PyramidFeatureFusion as JaxFusion
from one2345_tpu.recon.rendering_network import GeneralRenderingNetwork as JaxRenderNet
from one2345_tpu.recon.sdf_network import LatentSDFLayer as JaxLatentSDF
from one2345_tpu.recon.sdf_network import SdfVolumeNetwork as JaxSdfNet
from one2345_tpu_torch.geometry.cameras import build_recon_cameras
from one2345_tpu_torch.nn import layers
from one2345_tpu_torch.recon import costreg
from one2345_tpu_torch.recon.featurenet import PyramidFeatureFusion
from one2345_tpu_torch.recon.rendering_network import GeneralRenderingNetwork
from one2345_tpu_torch.recon.sdf_network import (
    LatentSDFLayer,
    SdfVolumeNetwork,
    SingleVarianceNetwork,
)
from one2345_tpu_torch.utils.convert_jax import flax_to_state_dict
from tests.torch_port_helpers import max_err, randomize

TOL = 1e-5
REL_TOL = 1e-4  # of max |ref|, for the conv stacks


@pytest.fixture(autouse=True)
def _full_f32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _init(module, *args, seed=0, static=()):
    variables = jax.jit(module.init, static_argnums=static)(jax.random.key(0), *args)
    return randomize(variables, seed=seed)


def _load(module, variables):
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module.eval().requires_grad_(False)


def _rel(out, ref) -> float:
    return max_err(out, ref) / float(np.abs(np.asarray(ref)).max())


# ------------------------------------------------------------------ layers
def test_positional_encoding_matches_jax():
    x = np.random.default_rng(0).uniform(-1.2, 1.2, size=(50, 3)).astype(np.float32)
    ref = jax_layers.positional_encoding(jnp.asarray(x), 6)
    out = layers.positional_encoding(_t(x), 6)
    assert out.shape == (50, 39)
    assert max_err(out, ref) <= TOL


def test_wndense_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, 24)).astype(np.float32)
    jm = jax_layers.WNDense(12)
    variables = _init(jm, jnp.asarray(x), seed=2)
    tm = _load(layers.WNDense(24, 12), variables)
    ref = jm.apply(variables, jnp.asarray(x))
    out = tm(_t(x))
    assert max_err(out, ref) <= TOL
    assert float(np.abs(np.asarray(ref)).max()) > 0.1


@pytest.mark.parametrize("k,s,hw", [(3, 1, (9, 10)), (5, 2, (12, 16)), (3, 2, (11, 8))])
def test_conv_bn_act_matches_jax(k, s, hw):
    """Symmetric k//2 padding (stride 2 on even sizes included), BN from
    the running statistics, LeakyReLU 0.01."""
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    jm = jax_layers.ConvBnAct(6, (k, k), (s, s))
    variables = _init(jm, jnp.asarray(x), seed=3)
    assert "batch_stats" in variables
    tm = _load(layers.ConvBnAct(4, 6, (k, k), (s, s)), variables)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    out = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert max_err(out, ref) <= TOL


def test_masked_batch_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 6, 7, 3)).astype(np.float32)
    mask = (rng.uniform(size=(5, 6, 7, 1)) > 0.4).astype(np.float32)
    jm = jax_layers.MaskedBatchNorm()
    variables = _init(jm, jnp.asarray(x), jnp.asarray(mask), seed=5)
    tm = _load(layers.MaskedBatchNorm(3), variables)
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    out = tm(_t(x).permute(3, 0, 1, 2)[None], _t(mask).permute(3, 0, 1, 2)[None])
    assert max_err(out[0].permute(1, 2, 3, 0), ref) <= TOL


def test_resize_bilinear_align_corners_matches_jax():
    img = np.random.default_rng(6).standard_normal((2, 7, 9, 3)).astype(np.float32)
    ref = jax.vmap(lambda im: jax_layers.resize_bilinear_align_corners(im, (28, 36)))(img)
    out = layers.resize_bilinear_align_corners(_t(img).permute(0, 3, 1, 2), (28, 36))
    assert max_err(out.permute(0, 2, 3, 1), ref) <= TOL


# ------------------------------------------------------------- featurenet
def test_pyramid_feature_fusion_matches_jax():
    imgs = np.random.default_rng(7).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JaxFusion()
    variables = _init(jm, jnp.asarray(imgs), seed=8)
    tm = _load(PyramidFeatureFusion(), variables)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(imgs))
    out = tm(_t(imgs))
    assert out.shape == (2, 32, 32, 56)
    assert _rel(out, ref) <= REL_TOL


# ----------------------------------------------------------------- costreg
def test_mask_helpers_match_jax():
    rng = np.random.default_rng(9)
    m = (rng.uniform(size=(8, 6, 4, 1)) > 0.8).astype(np.float32)
    ref = jax_costreg._mask_down(jnp.asarray(m))
    out = costreg._mask_down(_t(m).permute(3, 0, 1, 2)[None])[0].permute(1, 2, 3, 0)
    assert np.array_equal(out.numpy(), np.asarray(ref))
    x = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    ref = jax_costreg._upsample2x_zero(jnp.asarray(x))
    out = costreg._upsample2x_zero(_t(x).permute(3, 0, 1, 2)[None])[0].permute(1, 2, 3, 0)
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_costreg_matches_jax():
    """16^3, random mask, the full channel plan (32 in, 16 out): the 5-D
    kernels map DHWIO -> OIDHW and the deconvs need no flip."""
    rng = np.random.default_rng(10)
    vol = rng.standard_normal((16, 16, 16, 32)).astype(np.float32)
    mask = (rng.uniform(size=(16, 16, 16, 1)) > 0.4).astype(np.float32)
    jm = jax_costreg.CostRegNet(d_out=16)
    variables = _init(jm, jnp.asarray(vol), jnp.asarray(mask), seed=11)
    tm = _load(costreg.CostRegNet(d_in=32, d_out=16), variables)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(vol), jnp.asarray(mask)))
    out = tm(_t(vol), _t(mask))
    assert out.shape == (16, 16, 16, 16)
    assert _rel(out, ref) <= REL_TOL
    inactive = np.broadcast_to(mask == 0, out.shape)
    assert np.all(out.numpy()[inactive] == 0.0) and np.all(ref[inactive] == 0.0)
    assert float(np.abs(ref).max()) > 0.1


# ------------------------------------------------------------- sdf network
def test_latent_sdf_layer_matches_jax():
    rng = np.random.default_rng(12)
    pts = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    latent = rng.standard_normal((300, 16)).astype(np.float32)
    jm = JaxLatentSDF()
    variables = _init(jm, jnp.asarray(pts), jnp.asarray(latent), seed=13)
    tm = _load(LatentSDFLayer(), variables)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(pts), jnp.asarray(latent))
    out = tm(_t(pts), _t(latent))
    assert out.shape == (300, 128)
    assert max_err(out, ref) <= TOL


def test_port_init_keeps_the_geometric_sdf_init():
    """The port's own init: a sphere of radius ~0.5, latent columns zero."""
    torch.manual_seed(0)
    tm = LatentSDFLayer().eval()
    rng = np.random.default_rng(14)
    pts = _t(rng.uniform(-1, 1, size=(2000, 3)))
    with torch.no_grad():
        sdf = tm(pts, torch.zeros(2000, 16))[:, 0].numpy()
        sdf_latent = tm(pts, torch.ones(2000, 16))[:, 0].numpy()
    r = np.linalg.norm(pts.numpy(), axis=-1)
    far = np.abs(r - 0.5) > 0.15
    assert (np.sign(sdf[far]) == np.sign(r[far] - 0.5)).mean() > 0.95
    np.testing.assert_array_equal(sdf, sdf_latent)
    for name in ("lin1", "lin2"):
        assert torch.count_nonzero(getattr(tm, name).v[-16:]) == 0
    assert torch.count_nonzero(tm.lin0.v[3:]) == 0  # encoding columns


@pytest.fixture(scope="module")
def sdf_pair():
    """A JAX SdfVolumeNetwork at 16^3 with randomized weights and its port,
    and 4 views of the rig at 32^2."""
    V, H, W = 4, 32, 32
    kw = dict(vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0)
    rng = np.random.default_rng(15)
    feats = rng.standard_normal((V, H, W, 56)).astype(np.float32)
    pack = build_recon_cameras(45.0)
    K = pack["intrinsics"][1: V + 1] / 8.0  # calibrated for 256^2
    K[:, 2, 2] = 1.0
    projs = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    projs[:, :3, :4] = K @ pack["w2cs"][1: V + 1, :3, :4]
    jm = JaxSdfNet(**kw)
    with jax.default_matmul_precision("highest"):
        variables = _init(jm, jnp.asarray(feats), jnp.asarray(projs), (H, W), seed=16, static=(3,))
    tm = _load(SdfVolumeNetwork(**kw), variables)
    return jm, variables, tm, feats, projs, (H, W)


def test_build_volume_matches_jax(sdf_pair):
    jm, variables, tm, feats, projs, hw = sdf_pair
    ref = jax.jit(
        lambda v, f, p: jm.apply(v, f, p, hw, method=JaxSdfNet.build_volume)
    )(variables, jnp.asarray(feats), jnp.asarray(projs))
    out = tm.build_volume(_t(feats), _t(projs), hw)
    ref_mask = np.asarray(ref["mask"])
    assert 0.2 < ref_mask.mean() < 1.0
    assert np.array_equal(out["mask"].numpy(), ref_mask)
    assert out["volume"].shape == (16, 16, 16, 16)
    assert _rel(out["volume"], ref["volume"]) <= REL_TOL


def test_sdf_and_gradient_match_jax(sdf_pair):
    """sdf and features at points, and the autograd gradient against the
    JAX package's forward-mode JVPs."""
    jm, variables, tm, *_ = sdf_pair
    rng = np.random.default_rng(17)
    vol = rng.standard_normal((16, 16, 16, 16)).astype(np.float32)
    pts = rng.uniform(-0.95, 0.95, size=(400, 3)).astype(np.float32)
    ref = jax.jit(lambda v, p, x: jm.apply(v, p, x, method=JaxSdfNet.sdf_and_gradient))(
        variables, jnp.asarray(pts), jnp.asarray(vol)
    )
    sdf, feat, grad = tm.sdf_and_gradient(_t(pts), _t(vol))
    assert max_err(sdf, ref[0]) <= TOL and max_err(feat, ref[1]) <= TOL
    assert grad.shape == (400, 3)
    assert max_err(grad, ref[2]) <= 1e-4
    assert float(np.abs(np.asarray(ref[2])).max()) > 0.1


def test_single_variance_network():
    np.testing.assert_allclose(float(SingleVarianceNetwork(0.2)().detach()), np.exp(2.0), rtol=1e-6)


# ------------------------------------------------------- rendering network
def test_rendering_network_matches_jax():
    V, Nr, Ns = 5, 3, 12
    rng = np.random.default_rng(18)
    geo = rng.standard_normal((Nr, Ns, 16)).astype(np.float32)
    rgb = rng.uniform(size=(V, Nr, Ns, 59)).astype(np.float32)
    rd = rng.standard_normal((V, Nr, Ns, 4)).astype(np.float32)
    mask = (rng.uniform(size=(V, Nr, Ns)) > 0.3).astype(np.float32)
    mask[:, 0, 0] = 0.0  # a point no view sees
    args = [jnp.asarray(a) for a in (geo, rgb, rd, mask)]
    jm = JaxRenderNet()
    variables = _init(jm, *args, seed=19)
    tm = _load(GeneralRenderingNetwork(), variables)
    ref_rgb, ref_valid = jax.jit(jm.apply)(variables, *args)
    out_rgb, out_valid = tm(_t(geo), _t(rgb), _t(rd), _t(mask) > 0)
    assert out_rgb.shape == (Nr, Ns, 3) and out_valid.shape == (Nr, 1)
    assert max_err(out_rgb, ref_rgb) <= TOL
    assert np.array_equal(out_valid.numpy(), np.asarray(ref_valid))


# --------------------------------------------- converter and test helper
def _old_flax_to_state_dict(variables):
    """The converter as it was before it carried batch stats and 5-D
    kernels: the UNet's mapping must not change."""
    import re
    from collections.abc import Mapping

    def flatten(tree, prefix=()):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                yield from flatten(value, prefix + (str(key),))
            else:
                yield prefix + (str(key),), value

    out = {}
    for path, leaf in flatten(variables.get("params", variables)):
        scope = [p for p in path[:-1] if not re.fullmatch(r"GroupNorm_\d+", p)]
        name = path[-1]
        a = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight"
        elif name == "scale":
            name = "weight"
        out[".".join(scope + [name])] = a
    return out


def test_converter_leaves_the_unet_mapping_unchanged():
    jm = jax_unet.UNetModel(model_channels=32, channel_mult=(1, 2), attention_resolutions=(1,),
                            num_heads=4)
    variables = _init(jm, jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,), jnp.int32),
                      jnp.zeros((1, 1, 768)), seed=20)
    new, old = flax_to_state_dict(variables), _old_flax_to_state_dict(variables)
    assert new.keys() == old.keys()
    for key, value in old.items():
        assert np.array_equal(new[key].numpy(), value), key


def test_converter_carries_batch_stats_and_5d_kernels():
    kernel = np.arange(3 * 3 * 3 * 4 * 5, dtype=np.float32).reshape(3, 3, 3, 4, 5)
    variables = {
        "params": {"c": {"Conv_0": {"kernel": kernel}, "BatchNorm_0": {
            "scale": np.ones(5, np.float32), "bias": np.zeros(5, np.float32)}}},
        "batch_stats": {"c": {"BatchNorm_0": {"mean": np.full(5, 0.5, np.float32),
                                              "var": np.full(5, 2.0, np.float32)}}},
    }
    sd = flax_to_state_dict(variables)
    assert sorted(sd) == [
        "c.BatchNorm_0.bias", "c.BatchNorm_0.running_mean", "c.BatchNorm_0.running_var",
        "c.BatchNorm_0.weight", "c.Conv_0.weight",
    ]
    w = sd["c.Conv_0.weight"].numpy()
    assert w.shape == (5, 4, 3, 3, 3)
    # torch weight[o, i, d, h, w] is flax kernel[d, h, w, i, o]
    assert w[4, 3, 2, 1, 0] == kernel[2, 1, 0, 3, 4]
    assert np.all(sd["c.BatchNorm_0.running_var"].numpy() == 2.0)


def test_randomize_draws_positive_variances():
    variables = _init(jax_layers.ConvBnAct(8), jnp.zeros((1, 4, 4, 3)), seed=21)
    var = variables["batch_stats"]["BatchNorm_0"]["var"]
    mean = variables["batch_stats"]["BatchNorm_0"]["mean"]
    assert np.all((var >= 1.0) & (var <= 1.5))
    assert np.all(np.abs(mean) < 0.5) and np.any(mean != 0)
