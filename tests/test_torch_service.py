"""one2345_tpu_torch.pipeline.api (One2345Service) and pipeline.server:
the service's preprocess, init_bbox, camera_visualization and
selected_view_indices against the JAX service on the same tiny SAM; the
unsafe-input placeholder; the HTTP server on 127.0.0.1 (port 0): /healthz,
413 over MAX_BODY_BYTES, an image over MAX_IMAGE_PIXELS refused, a
/preprocess round trip, and one tiny
/estimate_elevation + /generate_mesh with the port's seeded tiny stages
(elevation pinned to polar 60); CPU."""

import base64
import inspect
import json
import socket
import struct
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from one2345_tpu.core import config as jax_config
from one2345_tpu.pipeline import api as jax_api
from one2345_tpu.pipeline import runner as jax_runner
from one2345_tpu.segmentation.sam import SamStage as JaxSamStage
from one2345_tpu_torch.core import config
from one2345_tpu_torch.pipeline import api, runner, server
from one2345_tpu_torch.recon import gltf, mesh_extract
from one2345_tpu_torch.segmentation.safety import SafetyChecker
from one2345_tpu_torch.utils import png
from one2345_tpu_torch.utils.convert_jax import sam_from_jax
from tests.test_torch_pipeline import POLAR, SMALL_VOLUME, STEPS
from tests.test_torch_preprocess import raw_image
from tests.test_torch_sam import TINY
from tests.torch_port_helpers import randomize, tiny_config

R = 24


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def services():
    """The JAX service and the port's with the same tiny SAM; the port's
    diffusion and recon stages seeded and tiny."""
    kw = dict(TINY, window_size=3)
    with jax.default_matmul_precision("highest"):
        jsam = JaxSamStage(jax_config.SamConfig(**kw), params={})
        tree = randomize(jax.eval_shape(jsam.init_params, jax.random.key(0)), 31)
        jcfg = jax_config.PipelineConfig(diffusion=tiny_config(torch_side=False),
                                         sam=jax_config.SamConfig(**kw))
        jservice = jax_api.One2345Service(jax_runner.One2345Pipeline(
            jcfg, params={"sam": tree}, use_sam=True, auto_mesh=False))
    pcfg = config.PipelineConfig(diffusion=tiny_config(torch_side=True).replace(**STEPS),
                                 recon=config.ReconConfig(**SMALL_VOLUME),
                                 sam=config.SamConfig(**kw), mesh_resolution=R)
    pipe = runner.One2345Pipeline(pcfg, params={"sam": sam_from_jax(tree)}, device="cpu")
    pipe.estimate_elevation = lambda views: POLAR
    return jservice, api.One2345Service(pipe)


@pytest.mark.parametrize("rgba", [False, True], ids=["rgb", "rgba"])
def test_preprocess_and_init_bbox_match_jax(services, rgba):
    jservice, service = services
    img = raw_image(520, 700, rgba, seed=2)
    with jax.default_matmul_precision("highest"):
        jbox = jservice.init_bbox(img)
        ref = jservice.preprocess(img, bbox=jbox["bbox"])
    box = service.init_bbox(img)
    assert box["bbox"] == jbox["bbox"]
    assert np.array_equal(box["preview"], jbox["preview"])
    out = service.preprocess(img, bbox=box["bbox"])
    assert np.abs(out - ref).max() <= 2 / 255
    assert service._session.keys() == {"input_256"} and not service.last_input_unsafe


def test_init_bbox_without_sam_matches_jax(services):
    jservice, service = services
    img = raw_image(200, 300, False, seed=4)
    jservice.pipeline.use_sam = service.pipeline.use_sam = False
    try:
        assert service.init_bbox(img)["bbox"] == jservice.init_bbox(img)["bbox"]
    finally:
        jservice.pipeline.use_sam = service.pipeline.use_sam = True


def test_init_bbox_lets_sam_errors_through(services, monkeypatch):
    """The deliberate divergence: the JAX service logs and falls back."""
    _, service = services

    def fail(cache, margin=0.05):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(service.pipeline.sam, "seed_bbox", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        service.init_bbox(raw_image(60, 80, False))


def test_camera_visualization_and_views_match_jax(services):
    jservice, service = services
    for polar in (None, 60.0, 80.0):
        if polar is not None:
            jservice._session["polar"] = service._session["polar"] = polar
        a, b = service.camera_visualization(), jservice.camera_visualization()
        assert np.abs(a["input_cone"] - b["input_cone"]).max() <= 1e-6
        assert np.abs(a["view_cones"] - b["view_cones"]).max() <= 1e-6
        assert service.selected_view_indices() == jservice.selected_view_indices()
    jservice._session.clear()
    service._session.clear()


def test_unsafe_input_returns_the_placeholder_and_clears_the_session(services):
    _, service = services
    pipe = service.pipeline
    img = raw_image(80, 80, True, seed=7)
    service._session.update(input_256=np.zeros((32, 32, 3)), polar=60.0)
    rng = np.random.default_rng(7)
    pipe._safety = SafetyChecker(concept_embeds=rng.normal(size=(2, 768)).astype(np.float32),
                                 concept_thresholds=np.full(2, -1.0, np.float32))
    try:
        out = service.preprocess(img)
        assert service.last_input_unsafe and service._session == {"unsafe": True}
        assert out.shape == (32, 32, 3) and np.all(out == 0.5)
        pipe._safety = SafetyChecker()
        out = service.preprocess(img)
        assert not service.last_input_unsafe and not np.all(out == 0.5)
    finally:
        pipe._safety = None


@pytest.fixture(scope="module")
def url(services):
    _, service = services
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(service, threading.Lock()))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(url, path, payload):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def test_server_health_and_body_limit(url):
    assert inspect.signature(server.serve).parameters["host"].default == "127.0.0.1"
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True}
    host, port = url.rsplit("/", 1)[-1].split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall((f"POST /preprocess HTTP/1.1\r\nHost: t\r\nContent-Length: "
                   f"{server.MAX_BODY_BYTES + 1}\r\nContent-Type: application/json\r\n\r\n").encode())
        status = s.recv(4096).decode(errors="replace").splitlines()[0]
    assert " 413 " in status
    header = struct.pack(">IIBBBBB", 4097, 4096, 8, 6, 0, 0, 0)  # one column over the cap
    bomb = png.SIGNATURE + png._chunk(b"IHDR", header) + png._chunk(b"IEND", b"")
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, "/preprocess", {"image_b64": base64.b64encode(bomb).decode()})
    assert err.value.code == 500 and "decompression bomb" in json.loads(err.value.read())["error"]


def test_server_preprocess_round_trip(url, services):
    _, service = services
    img = raw_image(200, 300, True, seed=8)
    body = {"image_b64": base64.b64encode(png.encode_png(img)).decode()}
    with _post(url, "/preprocess", body) as r:
        out = png.decode_png(base64.b64decode(json.loads(r.read())["image_b64"]))
    ref = (np.clip(service.pipeline.preprocess(img), 0, 1) * 255).astype(np.uint8)
    assert np.array_equal(out, ref)


def test_server_estimate_elevation_and_generate_mesh(url, services, tmp_path):
    _, service = services
    with _post(url, "/preprocess", {"image_b64": base64.b64encode(
            png.encode_png(raw_image(120, 90, True, seed=9))).decode()}) as r:
        assert r.status == 200
    with _post(url, "/estimate_elevation", {"seed": 0}) as r:
        assert json.loads(r.read()) == {"elevation": 90.0 - POLAR}
    assert service._session["stage1_all"].shape == (12, 32, 32, 3)
    assert service._session["stage2_v0"].shape == (1, 4, 32, 32, 3)
    for fmt in (".ply", ".glb"):
        with _post(url, "/generate_mesh", {"mesh_resolution": R, "format": fmt}) as r:
            path = tmp_path / f"mesh{fmt}"
            path.write_bytes(r.read())
        v, f, _ = (mesh_extract.load_ply if fmt == ".ply" else gltf.load_glb)(str(path))
        assert len(f) > 100 and np.isfinite(v).all()
    before = service._session["stage1_all"][[2, 0]].copy()
    service.regenerate_views([2, 0], seed=7)
    assert not np.array_equal(service._session["stage1_all"][[2, 0]], before)
    mesh = service.regenerate_mesh(mesh_resolution=R, seed=1)
    assert len(mesh["faces"]) > 100
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, "/nowhere", {})
    assert err.value.code == 404 and json.loads(err.value.read()) == {"error": "not found"}


def test_fast_modes_reach_the_service():
    """--sampler dpmpp and --quant int8 reach the service through
    PipelineConfig, as in the JAX service: /estimate_elevation and a view
    retry sample with DPM-Solver++ on the int8 UNet (S schedule entries, S
    UNet evals per stage call)."""
    from one2345_tpu_torch.diffusion.quantize import QConv2d
    from one2345_tpu_torch.diffusion.schedule import make_ddim_schedule
    from one2345_tpu_torch.pipeline.cli import apply_fast_modes

    cfg = apply_fast_modes(
        config.PipelineConfig(diffusion=tiny_config(torch_side=True)), sampler="dpmpp",
        steps=(4, 2), quant="int8")
    pipe = runner.One2345Pipeline(cfg, use_sam=False, device="cpu")
    pipe.estimate_elevation = lambda views: POLAR
    service = api.One2345Service(pipe)
    evals = []
    unet = pipe.zero123.unet
    assert any(isinstance(m, QConv2d) for m in unet.modules())
    unet.register_forward_hook(lambda m, a, o: evals.append(int(a[1][0])))
    img = np.ones((32, 32, 3), np.float32)
    img[8:24, 8:24] = 0.4
    assert service.estimate_elevation(img) == 90.0 - POLAR
    s1, s2 = (make_ddim_schedule(n, eta=0.0).num_steps for n in (4, 2))
    assert len(evals) == s1 + s2  # stage 1 of the 12 views, stage 2 of view 0
    evals.clear()
    views = service.regenerate_views([0, 5], seed=3)
    assert views.shape == (2, 32, 32, 3) and len(evals) == s1 + s2  # view 0: its nearby views too
