"""one2345_tpu_torch.recon.pipeline at lod1 (coarse-to-fine) against the JAX
stage, CPU, f32: the converter's lod1 trees (loaded with strict=True), both
prunings of the lod0 field (equal masks), the lod1 conditional volume, and
``reconstruct(num_lods=2)``: the lod1 f32 field against JAX's pointwise SDF
and the mesh against one built from JAX pieces (tests/test_torch_recon.py's
recipe), on tests/test_lod1.py's tiny config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.core.config import ReconConfig as JaxReconConfig
from one2345_tpu.recon import mesh_extract as jax_mesh
from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.recon.pipeline import OUTSIDE, ReconStage
from one2345_tpu_torch.utils.convert_jax import RECON_KEYS, recon_from_jax
from tests.test_torch_recon import _lattice, _small_cameras
from tests.torch_port_helpers import max_err, recon_test_params

# tests/test_lod1.py: 16^3 coarse, 32^3 fine, 4 source views at 64^2, a
# 24^3 mesh lattice
CFG = dict(num_lods=2, vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0,
           lod1_vol_dims=(32, 32, 32), lod1_voxel_size=2.0 / 31.0, lod1_d_compress=8,
           image_hw=(64, 64), mesh_resolution=24)
R = 24
FIELD_TOL = 1e-4  # max abs, f32 field


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


@pytest.fixture(scope="module")
def stages():
    params = recon_test_params(CFG, seed=11, latent_std=0.02)
    jstage = JaxReconStage(JaxReconConfig(**CFG), params=params)
    port = ReconStage(ReconConfig(**CFG), params=recon_from_jax(params), device="cpu")
    imgs = np.random.default_rng(0).uniform(size=(4, 64, 64, 3)).astype(np.float32)
    return jstage, port, imgs, _small_cameras()


@pytest.fixture(scope="module")
def lod0(stages):
    """The JAX stage's lod0 features and volume, and both its prunings."""
    jstage, _, imgs, cams = stages
    p = jstage.params
    src = slice(1, 5)
    feats = jstage.feature_maps(p, jnp.asarray(imgs))
    out = jstage.conditional_volume(p, feats, jnp.asarray(cams["affines"][src]))
    plain = jstage.prune_occupancy(p, out["volume"], out["mask"])
    depth = jstage.prune_occupancy_depth_filter(
        p, out["volume"], out["mask"], jnp.asarray(cams["affines"][src]),
        jnp.asarray(cams["intrinsics"][src]), jnp.asarray(cams["c2ws"][src]),
        jnp.asarray(cams["near_fars"][1]), (64, 64))
    return out, np.asarray(plain), np.asarray(depth)


def test_converter_maps_the_lod1_trees(stages):
    jstage, port, _, _ = stages
    sd = recon_from_jax(jstage.params)
    assert set(sd) == set(RECON_KEYS) == set(port.modules())
    # strict=True: every key of every module, lod1 ones included
    for key, module in port.modules().items():
        assert set(sd[key]) == set(module.state_dict()), key
    lod0_only = recon_from_jax({k: v for k, v in jstage.params.items() if "lod1" not in k})
    assert set(lod0_only) == {"fusion", "sdf", "render", "variance"}
    # a lod0 checkpoint plus the fine SDF net: lod0's modules serve lod1
    partial = ReconStage(ReconConfig(**CFG), params={**lod0_only, "sdf_lod1": sd["sdf_lod1"]},
                         device="cpu")
    fusion, _, render, variance = partial.lod_modules(1)
    assert fusion is partial.fusion and render is partial.render_net
    assert variance is partial.variance_net
    with pytest.raises(ValueError, match="num_lods=2"):
        ReconStage(ReconConfig(**{**CFG, "num_lods": 1}), device="cpu").lod_modules(1)


@pytest.mark.parametrize("depth_filter", [False, True])
def test_prunings_match_jax(stages, lod0, depth_filter):
    jstage, port, _, cams = stages
    out, plain, depth = lod0
    vol, mask = _t(out["volume"]), _t(out["mask"])
    if depth_filter:
        ours = port.prune_occupancy_depth_filter(
            vol, mask, _t(cams["affines"][1:5]), _t(cams["intrinsics"][1:5]),
            _t(cams["c2ws"][1:5]), _t(cams["near_fars"][1]), (64, 64))
        ref = depth
    else:
        ours, ref = port.prune_occupancy(vol, mask), plain
    assert ours.dtype == torch.bool and ours.shape == (16, 16, 16, 1)
    assert 0.02 < ref.mean() < 0.9  # a shell, not everything
    assert np.array_equal(ours.numpy(), ref)
    if depth_filter:
        assert not np.any(depth & ~plain)  # the filter only removes voxels


def test_lod1_volume_matches_jax(stages, lod0):
    jstage, port, imgs, cams = stages
    out, plain, _ = lod0
    p = jstage.params
    feats1 = jstage.feature_maps_lod1(p, jnp.asarray(imgs))
    ref = jstage.conditional_volume_lod1(p, feats1, jnp.asarray(cams["affines"][1:5]),
                                         jnp.asarray(plain), out["volume"])
    pf = port.feature_maps_lod1(_t(imgs))
    assert max_err(pf, feats1) <= 1e-4
    ours = port.conditional_volume_lod1(pf, _t(cams["affines"][1:5]), torch.from_numpy(plain),
                                        _t(out["volume"]))
    assert ours["volume"].shape == (32, 32, 32, 16)
    assert np.array_equal(ours["mask"].numpy(), np.asarray(ref["mask"]))
    m = np.asarray(ref["mask"])
    assert 0.01 < m.mean() < 0.9
    # children outside the kept parents are inactive
    up = plain.repeat(2, 0).repeat(2, 1).repeat(2, 2)
    assert not np.any(m[~up])
    scale = float(jnp.abs(ref["volume"]).max())
    assert max_err(ours["volume"], ref["volume"]) <= 1e-4 * max(1.0, scale)


@pytest.fixture(scope="module")
def meshes(stages, lod0):
    """The port's reconstruct(num_lods=2), and a reference from JAX pieces:
    the plain pruning, the lod1 volume, the f32 pointwise lod1 field gated
    as the port gates it, the JAX package's marching tets, its lod1
    color_chunk."""
    jstage, port, imgs, cams = stages
    out, plain, _ = lod0
    p = jstage.params
    src = slice(1, 5)
    feats1 = jstage.feature_maps_lod1(p, jnp.asarray(imgs))
    v1 = jstage.conditional_volume_lod1(p, feats1, jnp.asarray(cams["affines"][src]),
                                        jnp.asarray(plain), out["volume"])
    u = -np.asarray(jstage.sdf_chunk(p, jnp.asarray(_lattice(R)), v1["volume"], 1))
    u = u.reshape(R, R, R)
    occ = np.asarray(v1["mask"])[..., 0] > 0
    idx = (np.arange(R, dtype=np.float32) * np.float32(32 / R)).astype(np.int64)
    u_gated = np.where(occ[idx][:, idx][:, :, idx], u, np.float32(0.0 - OUTSIDE)).astype(np.float32)
    verts_grid, faces = jax_mesh.marching_tetrahedra(u_gated, 0.0)
    verts_n = jax_mesh.grid_to_world(verts_grid, (-1, -1, -1), (1, 1, 1), R)
    colors = np.asarray(jstage.color_chunk(
        p, jnp.asarray(verts_n), v1["volume"], v1["mask"], feats1, jnp.asarray(imgs),
        jnp.asarray(cams["w2cs"][src]), jnp.asarray(cams["intrinsics"][src]), 1))
    ref = {"vertices": jax_mesh.apply_mesh_transforms(verts_n, cams["scale_mat"], cams["trans_mat"]),
           "faces": faces, "colors": np.clip(colors, 0, 1), "u": u}
    return port.reconstruct(imgs, cams), ref, port, v1


def test_lod1_field_matches_jax(meshes):
    _, ref, port, v1 = meshes
    u = port.field_grid(_t(v1["volume"]), R, lod=1)
    assert u.shape == (R, R, R) and u.dtype == torch.float32
    assert max_err(u, ref["u"]) <= FIELD_TOL
    assert float(np.std(ref["u"])) > 0.01
    # the lod1 SDF net, not lod0's, on the lod1 lattice
    assert max_err(port.field_grid(_t(v1["volume"]), R, lod=0), ref["u"]) > 1e-3


def test_reconstruct_lod1_matches_the_jax_pieces(meshes):
    out, ref, _, _ = meshes
    assert len(out["faces"]) > 100 and np.isfinite(out["vertices"]).all()
    assert out["vertices"].shape == ref["vertices"].shape
    assert max_err(out["vertices"], ref["vertices"]) <= 1e-4
    np.testing.assert_array_equal(out["faces"], ref["faces"])
    assert max_err(out["colors"], ref["colors"]) <= 1e-3
    assert float(out["colors"].std()) > 1e-3


def test_reconstruct_lod1_spans(stages):
    """The lod1 steps are spans of their own."""
    from one2345_tpu_torch.core.profiling import Timer

    _, port, imgs, cams = stages
    timer = Timer()
    port.reconstruct(imgs, cams, timer=timer)
    assert tuple(timer.report()) == (
        "feature_maps", "conditional_volume", "prune", "feature_maps_lod1",
        "conditional_volume_lod1", "field_grid", "field_to_host", "marching_tets", "colors")
