"""one2345_tpu_torch.eval against one2345_tpu.eval, CPU: surface sampling,
Chamfer distance and F-score against the scipy-based JAX functions, the
eval cameras, the batched rasteriser against the JAX per-face loop (equal
but at depth ties and pixel centres on an edge), the CLIP scorer on
converted weights, the sweep's table on .obj / .ply / .glb pairs, and the
sweep CLI with and without ``--clip_params``; then the JAX test files'
cases (tests/test_eval_metrics.py, test_eval_sweep.py, test_clip_metric.py,
test_render_harness.py) on the port."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from one2345_tpu.core.config import CLIPVisionConfig as JaxCLIPVisionConfig
from one2345_tpu.eval import metrics as jmetrics
from one2345_tpu.eval import render_harness as jrh
from one2345_tpu.eval import sweep as jsweep
from one2345_tpu.eval.clip_metric import ClipScorer as JaxClipScorer
from one2345_tpu_torch.core import checkpoint
from one2345_tpu_torch.core.config import CLIPVisionConfig
from one2345_tpu_torch.eval import metrics, render_harness, sweep
from one2345_tpu_torch.eval.clip_metric import ClipScorer
from one2345_tpu_torch.pipeline.runner import save_obj
from one2345_tpu_torch.recon.gltf import save_glb
from one2345_tpu_torch.recon.mesh_extract import marching_tetrahedra_np, save_ply
from one2345_tpu_torch.utils.convert_jax import clip_from_jax
from one2345_tpu_torch.utils.png import read_png
from tests.torch_port_helpers import assert_equal_but_ties, randomize

METRIC_TOL = 1e-9  # relative, Chamfer (L2, L1) against scipy's cKDTree distances
EMBED_TOL = 1e-5  # relative L2, CLIP embeddings of converted f32 weights
CLIP_SIM_TOL = 1e-5  # abs, clip_sim of the sweep, port against JAX


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def _sphere_mesh(res=33, r=0.6):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    v, f = marching_tetrahedra_np(r - np.sqrt(x**2 + y**2 + z**2), 0.0)
    return (v / (res - 1.0) * 2.0 - 1.0).astype(np.float32), f


def _random_mesh(seed: int, n_faces: int = 150):
    """Random overlapping triangles (sizes up to half the box) with random
    colours: many faces cover a pixel."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-0.35, 0.35, (n_faces, 1, 3))
    v = (centres + rng.normal(0, 0.12, (n_faces, 3, 3))).reshape(-1, 3).astype(np.float32)
    f = np.arange(3 * n_faces, dtype=np.int32).reshape(-1, 3)
    c = rng.uniform(size=(len(v), 3)).astype(np.float32)
    return v, f, c


def _cube(scale=1.0):
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32) * scale
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)
    return v, f


def _tiny_clip(torch_side: bool):
    cls = CLIPVisionConfig if torch_side else JaxCLIPVisionConfig
    return cls(image_size=28, patch_size=14, width=32, layers=2, heads=2, dtype="float32")


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("n", [1, 500, 4096])
@pytest.mark.parametrize("seed", [0, 3])
def test_sample_surface_matches_jax(seed, n):
    v, f = _sphere_mesh(17)
    np.testing.assert_array_equal(metrics.sample_surface(v, f, n, seed),
                                  jmetrics.sample_surface(v, f, n, seed))


def test_sample_surface_degenerate_mesh():
    v = np.zeros((3, 3), np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    assert metrics.sample_surface(v, f, 10).shape == (0, 3)
    assert metrics.sample_surface(v, np.zeros((0, 3), np.int32), 10).shape == (0, 3)


@pytest.mark.parametrize("case", ["shifted", "random", "identical"])
def test_nn_metrics_match_scipy(case):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(700, 3)).astype(np.float32)
    b = {"shifted": a + 0.02, "random": rng.normal(size=(500, 3)).astype(np.float32),
         "identical": a.copy()}[case]
    np.testing.assert_allclose(metrics.nn_dists(a, b, "cpu"), jmetrics._nn_dists(a, b),
                               rtol=METRIC_TOL, atol=0)
    for squared in (True, False):
        got = metrics.chamfer_distance(a, b, squared, device="cpu")
        ref = jmetrics.chamfer_distance(a, b, squared)
        assert abs(got - ref) <= METRIC_TOL * abs(ref), (squared, got, ref)
    for thr in (0.01, 0.05, 0.3):
        assert metrics.f_score(a, b, thr, device="cpu") == jmetrics.f_score(a, b, thr)
    if case == "identical":
        assert metrics.chamfer_distance(a, b, device="cpu") == 0.0


def test_nn_dists_chunks(monkeypatch):
    """Several query chunks give the one-chunk result."""
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(300, 3)), rng.normal(size=(200, 3))
    whole = metrics.nn_dists(a, b, "cpu")
    monkeypatch.setattr(metrics, "NN_CHUNK", 1000)
    np.testing.assert_array_equal(metrics.nn_dists(a, b, "cpu"), whole)


@pytest.mark.parametrize("normalize", [True, False])
def test_evaluate_mesh_pair_matches_jax(normalize):
    v, f = _sphere_mesh()
    pv = v * 1.3 + np.float32(0.05)
    got = metrics.evaluate_mesh_pair(pv, f, v, f, n_points=1500, normalize=normalize,
                                     device="cpu")
    ref = jmetrics.evaluate_mesh_pair(pv, f, v, f, n_points=1500, normalize=normalize)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_TOL * abs(ref[k]), k
    np.testing.assert_array_equal(metrics.normalize_to_unit_box(pv),
                                  jmetrics.normalize_to_unit_box(pv))


# ------------------------------------------------------------ rasteriser
@pytest.mark.parametrize("res", [64, 512])
def test_eval_cameras_match_jax(res):
    for (K, w2c), (jK, jw2c) in zip(render_harness.eval_cameras(res), jrh.eval_cameras(res),
                                    strict=True):
        np.testing.assert_array_equal(K, jK)
        np.testing.assert_array_equal(w2c, jw2c)


@pytest.fixture(autouse=True)
def _quiet_degenerate(recwarn):
    """_covering divides by the zero det of degenerate faces (then masked)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        yield


@pytest.mark.parametrize("shade", [True, False])
@pytest.mark.parametrize("view", [0, 5, 17])
def test_rasterize_matches_jax_on_a_sphere(view, shade):
    v, f = _sphere_mesh(21)
    v = v * 0.4
    c = (0.5 + 0.5 * v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    K, w2c = render_harness.eval_cameras(64)[view]
    got = render_harness.rasterize(v, f, c, K, w2c, 64, shade, device="cpu")
    ref = jrh.rasterize(v, f, c, K, w2c, 64, shade)
    n = assert_equal_but_ties(v, f, K, w2c, got, ref)
    assert 0.05 < got[1].mean() < 0.6 and n <= 0.01 * got[1].sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_matches_jax_on_overlapping_faces(seed, monkeypatch):
    """Random overlapping triangles, and a chunk small enough that the faces
    span many passes."""
    v, f, c = _random_mesh(seed)
    K, w2c = render_harness.eval_cameras(96)[3 + seed]
    ref = jrh.rasterize(v, f, c, K, w2c, 96)
    monkeypatch.setattr(render_harness, "RASTER_CHUNK", 512)
    got = render_harness.rasterize(v, f, c, K, w2c, 96, device="cpu")
    assert_equal_but_ties(v, f, K, w2c, got, ref)
    assert 0.1 < got[1].mean() < 0.9


def test_rasterize_culls_and_skips_as_jax():
    """A face behind the camera, a degenerate face and one off the image
    draw nothing; an empty mesh gives the white background."""
    K, w2c = render_harness.eval_cameras(32)[0]
    cam = np.linalg.inv(w2c)[:3, 3]
    v = np.array([[0, 0, 0], [0.1, 0, 0], [0, 0, 0.1],            # visible
                  *(cam * 1.5 + np.eye(3) * 0.1),                  # behind the camera
                  [0, 0, 0], [0.1, 0, 0], [0.2, 0, 0],             # degenerate
                  [5, 0, 0], [5.1, 0, 0], [5, 0, 0.1]], np.float32)  # off the image
    f = np.arange(12, dtype=np.int32).reshape(4, 3)
    c = np.tile(np.float32([[0.2, 0.4, 0.6]]), (12, 1))
    got = render_harness.rasterize(v, f, c, K, w2c, 32, device="cpu")
    ref = jrh.rasterize(v, f, c, K, w2c, 32)
    assert_equal_but_ties(v, f, K, w2c, got, ref)
    alone = render_harness.rasterize(v[:3], f[:1], c[:3], K, w2c, 32, device="cpu")
    np.testing.assert_array_equal(got[0], alone[0])
    rgb, alpha = render_harness.rasterize(v[:0], f[:0], c[:0], K, w2c, 32, device="cpu")
    assert not alpha.any() and (rgb == 1).all()


def test_render_eval_views_match_jax():
    v, f = _sphere_mesh(13)
    got = render_harness.render_eval_views(v, f, res=32, device="cpu")
    ref = jrh.render_eval_views(v, f, res=32)
    assert got.shape == ref.shape == (24, 32, 32, 3)
    vn = metrics.normalize_to_unit_box(v, 0.8)
    for i, (K, w2c) in enumerate(render_harness.eval_cameras(32)):
        alpha = (got[i] < 1).any(-1)
        assert_equal_but_ties(vn, f, K, w2c, (got[i], alpha), (ref[i], (ref[i] < 1).any(-1)))
    assert render_harness.blender_command("m.glb", "out") == jrh.blender_command("m.glb", "out")


# ------------------------------------------------------------------- CLIP
@pytest.fixture(scope="module")
def clip_pair():
    js = JaxClipScorer(config=_tiny_clip(False))
    js.params = randomize(jax.tree_util.tree_map(np.asarray, js.params), 11)
    ps = ClipScorer(clip_from_jax(js.params), config=_tiny_clip(True), device="cpu")
    return js, ps


def test_clip_embed_matches_jax(clip_pair):
    js, ps = clip_pair
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(5, 40, 40, 3)).astype(np.float32)
    got, ref = ps.embed(imgs), js.embed(imgs)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= EMBED_TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


# ------------------------------------------------------------------ sweep
def _write_meshes(root, writer_ext: dict):
    """pred/ and gt/ directories of the same three shapes, each pair in the
    formats given: {name: (pred ext, gt ext)}."""
    pred, gt = os.path.join(root, "pred"), os.path.join(root, "gt")
    os.makedirs(pred), os.makedirs(gt)
    shapes = {}
    v, f = _sphere_mesh(15)
    shapes["ball"] = (v, f, (0.5 + 0.5 * v).astype(np.float32))
    cv, cf = _cube()
    shapes["box"] = (cv, cf, np.tile(np.float32([[0.8, 0.2, 0.1]]), (8, 1)))
    rv, rf, rc = _random_mesh(7, 40)
    shapes["shards"] = (rv, rf, rc)

    def write(path, v, f, c):
        ext = os.path.splitext(path)[1]
        if ext == ".ply":
            save_ply(path, v, f, (c * 255).astype(np.uint8))
        elif ext == ".obj":
            save_obj(path, v, f, c)
        else:
            save_glb(path, v, f, c)

    for name, (pe, ge) in writer_ext.items():
        v, f, c = shapes[name]
        write(os.path.join(pred, f"{name}_ours{pe}"), v + np.float32(0.03), f, c)
        write(os.path.join(gt, f"{name}_gt{ge}"), v * np.float32(1.2), f, c)
    return pred, gt


FORMATS = {"ball": (".obj", ".glb"), "box": (".ply", ".obj"), "shards": (".glb", ".ply")}
_JAX_LOAD_MESH = jsweep.load_mesh


def _jax_load_mesh_scaled(path):
    """The JAX sweep's reader with a .ply's 0-255 colours scaled by 1/255, as
    the port reads them (a deliberate divergence: the JAX renders of a .ply
    saturate)."""
    v, f, c = _JAX_LOAD_MESH(path)
    if path.endswith(".ply") and c is not None:
        c = c / np.float32(255)
    return v, f, c


@pytest.fixture
def jax_ply_scaled(monkeypatch):
    monkeypatch.setattr(jsweep, "load_mesh", _jax_load_mesh_scaled)


def test_run_sweep_matches_jax(tmp_path, clip_pair, jax_ply_scaled):
    js, ps = clip_pair
    pred, gt = _write_meshes(str(tmp_path), FORMATS)
    for ext in MESH_EXTS_CHECK:
        path = next(os.path.join(pred, n) for n in os.listdir(pred) if n.endswith(ext))
        for a, b in zip(sweep.load_mesh(path), jsweep.load_mesh(path), strict=True):
            np.testing.assert_array_equal(a, b)
    got = sweep.run_sweep(pred, gt, n_points=800, clip_scorer=ps, device="cpu")
    ref = jsweep.run_sweep(pred, gt, n_points=800, clip_scorer=js)
    assert got["n_pairs"] == ref["n_pairs"] == 3
    assert sweep.discover_pairs(pred, gt) == jsweep.discover_pairs(pred, gt)
    for k in ("threshold", "n_points"):
        assert got[k] == ref[k]
    for row, jrow in zip(got["per_mesh"], ref["per_mesh"], strict=True):
        assert {k: row[k] for k in ("name", "pred", "gt")} == {
            k: jrow[k] for k in ("name", "pred", "gt")}
        for k in ("chamfer_l2", "chamfer_l1"):
            assert abs(row[k] - jrow[k]) <= METRIC_TOL * jrow[k], (row["name"], k)
        assert row["f_score"] == jrow["f_score"]
        assert abs(row["clip_sim"] - jrow["clip_sim"]) <= CLIP_SIM_TOL, row["name"]
    assert set(got["summary"]) == set(ref["summary"]) == {"chamfer_l2", "chamfer_l1",
                                                          "f_score", "clip_sim"}
    json.dumps(got)


MESH_EXTS_CHECK = (".obj", ".ply", ".glb")


@pytest.mark.parametrize("name", ["a_ours.obj", "a_gt.glb", "a_pred.ply", "a_gen.obj", "a.b.ply"])
def test_stem_matches_jax(name):
    assert sweep._stem(name) == jsweep._stem(name)


def test_ply_colours_read_in_unit_range_and_score_one(tmp_path, clip_pair):
    """A mesh with 8-bit colours as its own GT (.glb), predicted as .glb and
    as .ply: the .ply's colours read back equal to the .glb's, and both
    pairs score clip_sim 1 (the JAX sweep, which reads the .ply's colours
    as 0-255, scores that pair 0.237)."""
    _, ps = clip_pair
    v, f = _cube()
    rng = np.random.default_rng(4)
    c = rng.integers(0, 256, size=v.shape).astype(np.float32) / np.float32(255)
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir(), gt.mkdir()
    for name in ("mglb", "mply"):
        save_glb(str(gt / f"{name}_gt.glb"), v, f, c)
    save_glb(str(pred / "mglb_ours.glb"), v, f, c)
    save_ply(str(pred / "mply_ours.ply"), v, f, np.round(c * 255).astype(np.uint8))
    ply, glb = sweep.load_mesh(str(pred / "mply_ours.ply")), sweep.load_mesh(str(pred / "mglb_ours.glb"))
    for a, b in zip(ply, glb, strict=True):
        np.testing.assert_array_equal(a, b)
    got = sweep.run_sweep(str(pred), str(gt), n_points=400, clip_scorer=ps, device="cpu")
    rows = {r["name"]: r for r in got["per_mesh"]}
    assert sorted(rows) == ["mglb", "mply"]
    for row in rows.values():
        assert abs(row["clip_sim"] - 1.0) <= CLIP_SIM_TOL, row


def test_sweep_main_without_and_with_clip_params(tmp_path, clip_pair, monkeypatch,
                                                 jax_ply_scaled):
    js, ps = clip_pair
    pred, gt = _write_meshes(str(tmp_path), {"box": (".obj", ".ply")})
    base = ["--pred_dir", pred, "--gt_dir", gt, "--n_points", "600"]
    out = tmp_path / "table.json"
    table = sweep.main(base + ["--out", str(out)], device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(table))
    assert table["n_pairs"] == 1 and "clip_sim" not in table["summary"]

    monkeypatch.setattr(sweep, "clip_config", lambda: _tiny_clip(True))
    bare = sweep.main(base + ["--clip_params"], device="cpu")
    assert -1.0 <= bare["summary"]["clip_sim"] <= 1.0
    for k in ("chamfer_l2", "f_score"):
        assert bare["summary"][k] == table["summary"][k]

    tree = tmp_path / "params.pt"
    checkpoint.save(str(tree), {"zero123": {"clip": ps.tower.state_dict()}})
    loaded = sweep.main(base + ["--clip_params", str(tree), "--render_dir",
                                str(tmp_path / "r")], device="cpu")
    ref = jsweep.run_sweep(pred, gt, n_points=600, clip_scorer=js)
    assert abs(loaded["summary"]["clip_sim"] - ref["summary"]["clip_sim"]) <= CLIP_SIM_TOL
    pngs = sorted(os.listdir(tmp_path / "r" / "box"))
    assert pngs == [f"{i:03d}.png" for i in range(24)]
    views = render_harness.render_eval_views(*sweep.load_mesh(os.path.join(pred, "box_ours.obj")),
                                             device="cpu")
    np.testing.assert_array_equal(read_png(str(tmp_path / "r" / "box" / "007.png")),
                                  (np.clip(views[7], 0, 1) * 255).astype(np.uint8))

    checkpoint.save(str(tree), {"zero123": {"unet": {}}})
    with pytest.raises(SystemExit, match="no 'clip'"):
        sweep.main(base + ["--clip_params", str(tree)], device="cpu")


# -------------------------------------------- the JAX test files' cases
def test_port_sample_surface_on_sphere():
    v, f = _sphere_mesh()
    r = np.linalg.norm(metrics.sample_surface(v, f, 2048), axis=1)
    assert abs(r.mean() - 0.6) < 0.02


def test_port_identical_meshes_zero_cd():
    v, f = _sphere_mesh()
    out = metrics.evaluate_mesh_pair(v, f, v.copy(), f.copy(), n_points=4096, normalize=False,
                                     device="cpu")
    assert out["chamfer_l2"] < 5e-3 and out["f_score"] > 0.99


def test_port_shifted_mesh_worse():
    v, f = _sphere_mesh()
    out0 = metrics.evaluate_mesh_pair(v, f, v, f, n_points=2048, normalize=False, device="cpu")
    out1 = metrics.evaluate_mesh_pair(v + 0.2, f, v, f, n_points=2048, normalize=False,
                                      device="cpu")
    assert out1["chamfer_l2"] > out0["chamfer_l2"] * 10 and out1["f_score"] < out0["f_score"]
    out2 = metrics.evaluate_mesh_pair(v + 0.2, f, v, f, n_points=2048, normalize=True,
                                      device="cpu")
    assert out2["chamfer_l2"] < 5e-3


def test_port_scale_invariance_of_normalized_eval():
    v, f = _sphere_mesh()
    out = metrics.evaluate_mesh_pair(v * 3.0, f, v, f, n_points=2048, device="cpu")
    assert out["f_score"] > 0.99


def test_port_sweep_identical_meshes(tmp_path):
    v, f = _cube()
    (tmp_path / "pred").mkdir()
    (tmp_path / "gt").mkdir()
    save_ply(str(tmp_path / "pred" / "cube_ours.ply"), v, f)
    with open(tmp_path / "gt" / "cube_gt.obj", "w") as fh:
        for p in v * 3.0:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for tri in f + 1:
            fh.write(f"f {tri[0]}//1 {tri[1]}//1 {tri[2]}//1\n")
    table = sweep.main(["--pred_dir", str(tmp_path / "pred"), "--gt_dir", str(tmp_path / "gt"),
                        "--n_points", "2048"], device="cpu")
    assert table["n_pairs"] == 1 and table["per_mesh"][0]["name"] == "cube"
    assert table["summary"]["chamfer_l2"] < 1e-3 and table["summary"]["f_score"] > 0.95


def _box_mesh(shift=0.0, color=(0.8, 0.2, 0.1)):
    v, _ = _cube()
    f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                  [3, 2, 6], [3, 6, 7], [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2]], np.int32)
    return v - 0.5 + shift, f, np.tile(np.asarray(color, np.float32), (8, 1))


def test_port_identical_meshes_score_one():
    scorer = ClipScorer(config=_tiny_clip(True), device="cpu")
    mesh = _box_mesh()
    assert abs(scorer.similarity(mesh, mesh, res=32) - 1.0) < 1e-4


def test_port_embeddings_normalized_and_similarity_bounded():
    scorer = ClipScorer(config=_tiny_clip(True), device="cpu")
    imgs = np.random.default_rng(0).uniform(size=(3, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(np.linalg.norm(scorer.embed(imgs), axis=-1), 1.0, atol=1e-4)
    s = scorer.similarity(_box_mesh(color=(0.9, 0.1, 0.1)),
                          _box_mesh(shift=0.2, color=(0.1, 0.1, 0.9)), res=32)
    assert -1.0 <= s < 1.0 - 1e-6


def test_port_rasterize_sphere():
    v, f = _sphere_mesh(21)
    colors = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (len(v), 1))
    K, w2c = render_harness.eval_cameras(res=64)[0]
    rgb, alpha = render_harness.rasterize(v * 0.4, f, colors, K, w2c, 64, shade=False,
                                          device="cpu")
    assert alpha[32, 32] and not alpha[2, 2] and not alpha[61, 61]
    np.testing.assert_allclose(rgb[32, 32], [1, 0, 0], atol=1e-5)
    assert 0.05 < alpha.mean() < 0.6


def test_port_eval_camera_protocol():
    cams = render_harness.eval_cameras()
    elevs = []
    for K, w2c in cams:
        c = np.linalg.inv(np.vstack([w2c[:3], [0, 0, 0, 1]]))[:3, 3]
        np.testing.assert_allclose(np.linalg.norm(c), 1.3, atol=1e-6)
        elevs.append(np.degrees(np.arcsin(c[2] / 1.3)))
    assert len(cams) == 24
    np.testing.assert_allclose(elevs[:12], 30.0, atol=1e-4)
    np.testing.assert_allclose(elevs[12:], 0.0, atol=1e-4)
