"""one2345_tpu_torch.recon.pipeline (ReconStage, lod0) against the JAX
package: the f32 field grid, the C++ marching tetrahedra, the projector, and
the whole stage (image stack -> colored mesh) on the JAX stage's own
weights, f32, CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from one2345_tpu.core.config import ReconConfig as JaxReconConfig
from one2345_tpu.geometry import cameras as jax_cameras
from one2345_tpu.recon import mesh_extract as jax_mesh
from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
from one2345_tpu.recon.renderer import projector_features as jax_projector_features
from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.recon import mesh_extract
from one2345_tpu_torch.recon.pipeline import OUTSIDE, ReconStage
from one2345_tpu_torch.recon.renderer import projector_features
from one2345_tpu_torch.utils.convert_jax import recon_from_jax
from tests.torch_port_helpers import max_err, randomize

# the whole-slice recipe of tests/test_lod1.py at one lod: 16^3 volume, four
# source views of the rig at 64^2, a 24^3 mesh lattice
SMALL = dict(vol_dims=(16, 16, 16), voxel_size=2.0 / 15.0, image_hw=(64, 64), mesh_resolution=24)
R = 24


@pytest.fixture(autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _small_cameras():
    """1 reference + 4 source views of the rig, intrinsics rescaled from
    256^2 to 64^2."""
    pack = jax_cameras.build_recon_cameras(45.0)
    sel = [0, 1, 2, 3, 4]
    small = {
        k: (v[sel] if isinstance(v, np.ndarray) and v.ndim >= 2 and len(v) >= 33 else v)
        for k, v in pack.items() if k != "img_ids"
    }
    small["intrinsics"] = small["intrinsics"] / 4.0
    small["intrinsics"][:, 2, 2] = 1.0
    aff = np.tile(np.eye(4, dtype=np.float32)[None], (5, 1, 1))
    aff[:, :3, :4] = np.einsum("vij,vjk->vik", small["intrinsics"], small["w2cs"][:, :3, :4])
    small["affines"] = aff
    return small


@pytest.fixture(scope="module")
def stages():
    """The JAX stage from seed 0 and its port on the converted weights."""
    jstage = JaxReconStage(JaxReconConfig(**SMALL), seed=0)
    port = ReconStage(ReconConfig(**SMALL), params=recon_from_jax(jstage.params), device="cpu")
    return jstage, port


@pytest.fixture(scope="module")
def inputs():
    imgs = np.random.default_rng(0).uniform(size=(4, 64, 64, 3)).astype(np.float32)
    return imgs, _small_cameras()


def _lattice(n):
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.stack([xx, yy, zz], -1).reshape(-1, 3)


def test_stage_ports_lod0_only():
    """A num_lods=1 stage holds the lod0 networks only and refuses lod 1
    (the lod1 path is tests/test_torch_recon_lod1.py's)."""
    stage = ReconStage(ReconConfig(**SMALL), device="cpu")
    assert set(stage.modules()) == {"fusion", "sdf", "render", "variance"}
    with pytest.raises(ValueError, match="num_lods=2"):
        stage.lod_modules(1)


def test_field_grid_matches_jax_pointwise_sdf(stages):
    """The separable resize + chunked MLP against the JAX stage's pointwise
    trilinear fetch + MLP on the R^3 lattice (tests/test_field_grid.py's
    recipe), with randomized weights so the latent moves the field."""
    jstage, _ = stages
    params = randomize(jstage.params, seed=1)
    port = ReconStage(ReconConfig(**SMALL), params=recon_from_jax(params), device="cpu")
    vol = np.random.default_rng(0).normal(size=(16, 16, 16, 16)).astype(np.float32)
    for n in (17, R):
        u = port.field_grid(_t(vol), n)
        assert u.dtype == torch.float32 and u.shape == (n, n, n)
        ref = -np.asarray(jstage.sdf_chunk(params, jnp.asarray(_lattice(n)), jnp.asarray(vol)))
        assert max_err(u.reshape(-1), ref) <= 1e-4
        assert float(np.std(ref)) > 0.01  # the field varies over the lattice


def test_gate_field_uses_the_f32_voxel_index(stages):
    _, port = stages
    u = torch.ones(R, R, R)
    mask = torch.ones(16, 16, 16, 1)
    mask[:4] = 0.0
    gated = port.gate_field(u, mask)
    idx = (np.arange(R, dtype=np.float32) * np.float32(16 / R)).astype(np.int64)
    outside = idx < 4
    assert torch.all(gated[outside] == -OUTSIDE) and torch.all(gated[~outside] == 1.0)


def _sphere_field(res, r=0.6, seed=0):
    """A bumpy sphere, -sdf convention (positive inside), f32."""
    p = _lattice(res).reshape(res, res, res, 3)
    noise = np.random.default_rng(seed).normal(scale=0.02, size=(res, res, res))
    return (r - np.linalg.norm(p, axis=-1) + noise).astype(np.float32)


@pytest.mark.parametrize("res,threshold", [(33, 0.0), (28, 0.05)])
def test_marching_tets_are_the_jax_package_s_bit_for_bit(res, threshold):
    u = _sphere_field(res)
    v, f = mesh_extract.marching_tetrahedra(u, threshold)
    v_ref, f_ref = jax_mesh.marching_tetrahedra(u, threshold)  # the JAX package's C++ build
    assert len(f) > 100
    assert v.dtype == np.float32 and f.dtype == np.int32
    assert np.array_equal(v, v_ref) and np.array_equal(f, f_ref)
    v_np, f_np = mesh_extract.marching_tetrahedra_np(u, threshold)
    v_np_ref, f_np_ref = jax_mesh.marching_tetrahedra_np(u, threshold)
    assert np.array_equal(v_np, v_np_ref) and np.array_equal(f_np, f_np_ref)
    # the two extractors give one mesh, in another vertex order
    assert len(v_np) == len(v) and len(f_np) == len(f)
    np.testing.assert_array_equal(np.unique(v, axis=0), np.unique(v_np, axis=0))


def test_mesh_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    verts = rng.uniform(0, 23, size=(50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, size=(30, 3)).astype(np.int32)
    colors = rng.integers(0, 256, size=(50, 3)).astype(np.uint8)
    pack = jax_cameras.build_recon_cameras(45.0)
    w = mesh_extract.grid_to_world(verts, (-1, -1, -1), (1, 1, 1), 24)
    np.testing.assert_array_equal(w, jax_mesh.grid_to_world(verts, (-1, -1, -1), (1, 1, 1), 24))
    np.testing.assert_array_equal(
        mesh_extract.apply_mesh_transforms(w, pack["scale_mat"], pack["trans_mat"]),
        jax_mesh.apply_mesh_transforms(w, pack["scale_mat"], pack["trans_mat"]),
    )
    mesh_extract.save_ply(str(tmp_path / "m.ply"), w, faces, colors)
    v2, f2, c2 = jax_mesh.load_ply(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(v2, w)
    np.testing.assert_array_equal(f2, faces)
    np.testing.assert_array_equal(c2, colors)


def test_projector_features_match_jax(inputs):
    imgs, cams = inputs
    rng = np.random.default_rng(3)
    V = 4
    vol = rng.standard_normal((16, 16, 16, 16)).astype(np.float32)
    mask_vol = (rng.uniform(size=(16, 16, 16, 1)) > 0.3).astype(np.float32)
    feats = rng.standard_normal((V, 64, 64, 56)).astype(np.float32)
    pts = rng.uniform(-1.05, 1.05, size=(1, 500, 3)).astype(np.float32)
    normals = rng.standard_normal((500, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    w2cs, K = cams["w2cs"][1:], cams["intrinsics"][1:]
    # eager, op by op: under jit XLA contracts a * b + c into one FMA
    ref = jax_projector_features(
        *(jnp.asarray(a) for a in (pts, vol, mask_vol, feats, imgs, w2cs, K)), (64, 64),
        jnp.asarray(normals),
    )
    out = projector_features(
        *(_t(a) for a in (pts, vol, mask_vol, feats, imgs, w2cs, K)), (64, 64), _t(normals)
    )
    for name, a, b in zip(("geo_feat", "rgb_feat", "ray_diff"), out[:3], ref[:3]):
        assert a.shape == b.shape, name
        assert max_err(a, b) <= 1e-5, name
    ref_mask = np.asarray(ref[3])
    assert 0.2 < ref_mask.mean() < 0.95
    assert np.array_equal(out[3].numpy(), ref_mask)


@pytest.fixture(scope="module")
def meshes(stages, inputs):
    """The port's reconstruct, a reference from JAX pieces (the f32
    pointwise field, gated as the port gates it -> the JAX package's
    marching tets -> its color_chunk), and the JAX stage's own reconstruct
    (int8 field)."""
    jstage, port = stages
    imgs, cams = inputs
    params = jstage.params
    src = slice(1, 5)

    feats = jstage.feature_maps(params, jnp.asarray(imgs))
    vol_out = jstage.conditional_volume(params, feats, jnp.asarray(cams["affines"][src]))
    volume, mask = vol_out["volume"], vol_out["mask"]
    u = -np.asarray(jstage.sdf_chunk(params, jnp.asarray(_lattice(R)), volume)).reshape(R, R, R)
    occ = np.asarray(mask)[..., 0] > 0
    idx = (np.arange(R, dtype=np.float32) * np.float32(16 / R)).astype(np.int64)
    u = np.where(occ[idx][:, idx][:, :, idx], u, np.float32(0.0 - OUTSIDE)).astype(np.float32)
    verts_grid, faces = jax_mesh.marching_tetrahedra(u, 0.0)
    verts_n = jax_mesh.grid_to_world(verts_grid, (-1, -1, -1), (1, 1, 1), R)
    colors = np.asarray(jstage.color_chunk(
        params, jnp.asarray(verts_n), volume, mask, feats, jnp.asarray(imgs),
        jnp.asarray(cams["w2cs"][src]), jnp.asarray(cams["intrinsics"][src]),
    ))
    ref = {
        "vertices": jax_mesh.apply_mesh_transforms(verts_n, cams["scale_mat"], cams["trans_mat"]),
        "faces": faces,
        "colors": np.clip(colors, 0, 1),
    }
    return port.reconstruct(imgs, cams), ref, jstage.reconstruct(imgs, cams)


def test_reconstruct_matches_the_jax_pieces(meshes):
    out, ref, _ = meshes
    assert len(out["faces"]) > 100  # not an empty mesh
    assert np.isfinite(out["vertices"]).all()
    assert out["vertices"].shape == ref["vertices"].shape
    assert out["faces"].shape == ref["faces"].shape
    assert max_err(out["vertices"], ref["vertices"]) <= 1e-4
    np.testing.assert_array_equal(out["faces"], ref["faces"])
    assert out["colors"].shape == (len(out["vertices"]), 3)
    assert max_err(out["colors"], ref["colors"]) <= 1e-3
    assert 0.0 <= out["colors"].min() and out["colors"].max() <= 1.0
    assert float(out["colors"].std()) > 1e-3


def test_reconstruct_is_close_to_the_jax_stage_s_own(meshes):
    """The JAX stage clips its field to +-0.12 and rounds it to 1e-3 (its
    int8 transfer); the port keeps the f32 field."""
    out, _, jax_mesh_out = meshes
    n, n_ref = len(out["vertices"]), len(jax_mesh_out["vertices"])
    ratio = n / n_ref
    d1 = cKDTree(jax_mesh_out["vertices"]).query(out["vertices"])[0].mean()
    d2 = cKDTree(out["vertices"]).query(jax_mesh_out["vertices"])[0].mean()
    chamfer = float(d1 + d2)
    print(f"vertices {n} vs {n_ref} (ratio {ratio:.4f}), chamfer {chamfer:.3e}")
    assert abs(ratio - 1.0) <= 0.03
    assert chamfer <= 0.01


def test_reconstruct_writes_the_ply(stages, inputs, tmp_path):
    _, port = stages
    imgs, cams = inputs
    out = port.reconstruct(torch.from_numpy(imgs), cams, out_path=str(tmp_path / "mesh.ply"))
    v, f, c = jax_mesh.load_ply(out["path"])
    np.testing.assert_array_equal(v, out["vertices"].astype(np.float32))
    np.testing.assert_array_equal(f, out["faces"])
    np.testing.assert_array_equal(c, (out["colors"] * 255).astype(np.uint8))


def test_bf16_stage_tracks_the_f32_stage(stages, inputs):
    """ReconConfig(dtype='bfloat16'): the conv path and the blending net in
    bf16, the cost sums and the SDF MLP in f32, as the JAX stage does it
    (tests/test_recon_nets.py::test_sdf_volume_mixed_precision_fidelity)."""
    jstage, _ = stages
    imgs, cams = inputs
    params = recon_from_jax(randomize(jstage.params, seed=2))
    s32 = ReconStage(ReconConfig(**SMALL), params=params, device="cpu")
    s16 = ReconStage(ReconConfig(**SMALL, dtype="bfloat16"), params=params, device="cpu")
    projs = _t(cams["affines"][1:5])
    out = {}
    for name, st in (("f32", s32), ("bf16", s16)):
        feats = st.feature_maps(_t(imgs))
        vol = st.conditional_volume(feats, projs)
        out[name] = (feats, vol, st.field_grid(vol["volume"], R))
    # the fused features come out f32, as the JAX stage's: its upsampled
    # levels interpolate with f32 weights, which promote the bf16 maps
    assert out["bf16"][0].dtype == torch.float32 and out["bf16"][1]["volume"].dtype == torch.bfloat16
    assert torch.equal(out["bf16"][1]["mask"], out["f32"][1]["mask"])
    v32, v16 = out["f32"][1]["volume"], out["bf16"][1]["volume"].float()
    assert float((v32 - v16).abs().mean() / v32.abs().mean()) < 0.05
    u32, u16 = out["f32"][2], out["bf16"][2]
    assert u16.dtype == torch.float32
    far = u32.abs() > 1e-2
    assert float((torch.sign(u16[far]) == torch.sign(u32[far])).float().mean()) > 0.99
    mesh = s16.reconstruct(imgs, cams)
    assert len(mesh["faces"]) > 100 and np.isfinite(mesh["vertices"]).all()
    assert np.isfinite(mesh["colors"]).all()
