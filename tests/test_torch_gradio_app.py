"""The port's build_gradio_app against a recording stub of gradio.

The four tests of tests/test_gradio_app.py (the JAX builder's), with the
same stub, against ``one2345_tpu_torch.pipeline.api.build_gradio_app``:
the named API endpoints, the component graph, the retry checkbox-slot ->
elevation-dependent view-id mapping (demo/app.py:276-322 is_rerun
semantics) and the regenerate-mesh chain.  gradio is on neither machine.
"""

import sys
import types

import numpy as np
import pytest


class _Component:
    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs
        self.events = []

    def change(self, fn, inputs=None, outputs=None, api_name=None):
        self.events.append(("change", fn, inputs, outputs, api_name))

    def click(self, fn, inputs=None, outputs=None, api_name=None):
        self.events.append(("click", fn, inputs, outputs, api_name))


class _Container(_Component):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _make_stub_gradio():
    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Row", "Column"):
        setattr(gr, name, _Container)
    for name in (
        "Image", "Slider", "Number", "Plot", "Gallery", "CheckboxGroup",
        "Model3D", "Button",
    ):
        setattr(gr, name, _Component)
    return gr


class _StubService:
    """Records calls; session shaped like One2345Service after estimate."""

    def __init__(self, polar: float):
        self._session = {
            "stage1_all": np.linspace(0, 1, 12 * 4 * 4 * 3, dtype=np.float32).reshape(
                12, 4, 4, 3
            ),
            "polar": polar,
        }
        self.calls = []

    def selected_view_indices(self):
        polar = self._session["polar"]
        return list(range(8)) if polar <= 75 else list(range(4)) + list(range(8, 12))

    def init_bbox(self, image):
        self.calls.append(("init_bbox",))
        return {"bbox": (1, 2, 3, 4), "preview": image}

    def preprocess(self, image, bbox=None):
        self.calls.append(("preprocess", bbox))
        return image

    def estimate_elevation(self):
        self.calls.append(("estimate_elevation",))
        return 30.0

    def camera_visualization(self):
        return {
            "input_cone": np.zeros((16, 3)),
            "view_cones": np.zeros((8, 16, 3)),
            "image": None,
        }

    def regenerate_views(self, idxs, seed=None):
        self.calls.append(("regenerate_views", list(idxs)))
        return self._session["stage1_all"][list(idxs)]

    def generate_mesh(self, out_dir=None, mesh_resolution=256, seed=0):
        self.calls.append(("generate_mesh", out_dir))
        return {"path": "exp/gradio/mesh.ply"}

    def regenerate_mesh(self, out_dir=None, mesh_resolution=256, seed=0):
        self.calls.append(("regenerate_mesh", out_dir))
        return {"path": "exp/gradio/mesh.ply"}


def _build(polar: float):
    from one2345_tpu_torch.pipeline.api import build_gradio_app

    stub = _make_stub_gradio()
    service = _StubService(polar)
    saved = sys.modules.get("gradio")
    sys.modules["gradio"] = stub
    try:
        demo = build_gradio_app(service)
    finally:
        if saved is None:
            sys.modules.pop("gradio", None)
        else:
            sys.modules["gradio"] = saved
    return demo, service


@pytest.fixture()
def recorded(monkeypatch):
    """Build the app with a global event recorder on the stub classes."""
    all_events = []

    def change(self, fn, inputs=None, outputs=None, api_name=None):
        all_events.append(("change", self, fn, inputs, outputs, api_name))

    def click(self, fn, inputs=None, outputs=None, api_name=None):
        all_events.append(("click", self, fn, inputs, outputs, api_name))

    monkeypatch.setattr(_Component, "change", change)
    monkeypatch.setattr(_Component, "click", click)

    def build(polar):
        all_events.clear()
        demo, service = _build(polar)
        return list(all_events), service

    return build


def test_api_endpoint_names(recorded):
    events, _ = recorded(30.0)
    api_names = {e[5] for e in events if e[5]}
    assert api_names == {"preprocess", "estimate_elevation", "generate_mesh"}


def test_component_graph_wiring(recorded):
    events, service = recorded(30.0)
    # 1 change (bbox init) + 5 button clicks
    kinds = [e[0] for e in events]
    assert kinds.count("change") == 1 and kinds.count("click") == 5

    # the bbox-init change fans out to preview + 4 sliders
    change = next(e for e in events if e[0] == "change")
    assert len(change[4]) == 5
    img = np.zeros((8, 8, 3), np.uint8)
    out = change[2](img)
    assert out[1:] == (1, 2, 3, 4)

    # preprocess click passes the 4 slider values through as an int bbox
    pre = next(e for e in events if e[5] == "preprocess")
    assert len(pre[3]) == 5  # image + 4 sliders
    pre[2](img, 1.0, 2.0, 3.0, 4.0)
    assert ("preprocess", (1, 2, 3, 4)) in service.calls

    # generate_mesh click returns the mesh path for the Model3D output
    gen = next(e for e in events if e[5] == "generate_mesh")
    assert gen[2]() == "exp/gradio/mesh.ply"


@pytest.mark.parametrize(
    "polar,slots,expected_view_ids",
    [
        (30.0, ["0", "2"], [0, 2]),  # low-elevation branch: slots == ids
        (80.0, ["4", "6"], [8, 10]),  # high branch: slots 4..7 -> views 8..11
        (80.0, ["0", "7"], [0, 11]),
    ],
)
def test_retry_slot_to_view_id_mapping(recorded, polar, slots, expected_view_ids):
    events, service = recorded(polar)
    # the retry button is the 4th click, with no api_name and the checkbox
    # group as input
    retry = [e for e in events if e[0] == "click" and e[5] is None][0]
    gallery = retry[2](slots)
    assert ("regenerate_views", expected_view_ids) in service.calls
    # gallery re-renders the SELECTED views (slots), as uint8
    assert len(gallery) == 8 and gallery[0].dtype == np.uint8


def test_regen_mesh_chain(recorded):
    events, service = recorded(30.0)
    regen = [e for e in events if e[0] == "click" and e[5] is None][1]
    assert regen[2]() == "exp/gradio/mesh.ply"
    assert ("regenerate_mesh", "exp/gradio") in service.calls


def test_builder_raises_without_gradio(monkeypatch):
    from one2345_tpu_torch.pipeline.api import build_gradio_app

    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio -> ImportError
    with pytest.raises(ImportError, match="gradio is not installed"):
        build_gradio_app(_StubService(30.0))
