"""Service API surface: the reference demo's endpoint contract.

Counterpart of ``one2345_tpu/pipeline/api.py`` (reference: demo/app.py's
``/preprocess``, ``/estimate_elevation`` and ``/generate_mesh``, README.md:
170-215, plus the demo UI's per-view retries, demo/app.py:276-322) as
plain callables any HTTP layer can wrap (``pipeline.server``).  Session
semantics are the JAX service's; noise comes from integer seeds (each
call's sampling phases draw from ``runner.phase_seeds(seed)``), not from
JAX keys.  ``build_gradio_app`` wraps the service in the demo's Gradio UI
when gradio is installed (it is on neither machine: its test records the
wiring against a stub).

One deliberate divergence: ``init_bbox`` lets an exception of SAM's bbox
seeding through and falls back to ``estimate_bbox`` only when SAM's
proposal is degenerate (None), as the runner's ``estimate_elevation``
does; the JAX service logs any exception and falls back.
"""

from __future__ import annotations

import os

import numpy as np

from one2345_tpu_torch.geometry import cameras as cam
from one2345_tpu_torch.pipeline.runner import One2345Pipeline, UnsafeImageError, phase_seeds
from one2345_tpu_torch.utils import image as img_utils


def _unsafe_placeholder(size: int) -> np.ndarray:
    """Flat mid-gray stand-in for the demo's unsafe.png (app.py:383)."""
    return np.full((size, size, 3), 0.5, np.float32)


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


class One2345Service:
    """Stateful service with the demo's three endpoints and per-view retry."""

    def __init__(self, pipeline: One2345Pipeline | None = None):
        self.pipeline = pipeline or One2345Pipeline()
        self._session: dict = {}

    # ---- bbox initializer for the slider flow (demo/app.py init_bbox:418)
    def init_bbox(self, image: np.ndarray) -> dict:
        """Foreground bbox of the (thumbnailed) input.

        :return: {'bbox': (x0, y0, x1, y1) in the 512-thumbnail frame,
                  'preview': uint8 RGB with the box drawn}
        """
        _, rgb = self.pipeline.thumbnail_rgb(image)
        # SAM's own object proposal (the demo seeds its sliders from rembg);
        # set_image memoises by content, so /preprocess reuses the encoding
        box = None
        if self.pipeline.use_sam:
            sam = self.pipeline.sam
            box = sam.seed_bbox(sam.set_image(rgb))
        x0, y0, x1, y1 = box if box is not None else img_utils.estimate_bbox(rgb)
        preview = rgb.copy()
        color = np.array([88, 191, 131], np.uint8)  # app.py:398 box colour
        t = max(2, max(preview.shape) // 200)
        preview[y0:y0 + t, x0:x1] = color
        preview[max(y1 - t, 0):y1, x0:x1] = color
        preview[y0:y1, x0:x0 + t] = color
        preview[y0:y1, max(x1 - t, 0):x1] = color
        return {"bbox": (int(x0), int(y0), int(x1), int(y1)), "preview": preview}

    # ---- /preprocess (demo/app.py preprocess_run:388)
    def preprocess(self, image: np.ndarray, bbox: tuple[int, int, int, int] | None = None
                   ) -> np.ndarray:
        """NSFW gate -> segment (optional bbox-slider prompt) -> recentre.
        A flagged image returns the unsafe placeholder (app.py:376-391),
        clears the session and sets session['unsafe']."""
        try:
            out = self.pipeline.preprocess(image, bbox=bbox)
        except UnsafeImageError:
            # downstream endpoints must not serve the previous request's state
            self._session.clear()
            self._session["unsafe"] = True
            return _unsafe_placeholder(self.pipeline.config.diffusion.image_size)
        self._session.clear()
        self._session["input_256"] = out
        return out

    def reset_session(self) -> None:
        """Forget the session: the next ``generate_mesh`` needs a new
        ``preprocess`` and ``estimate_elevation``."""
        self._session.clear()

    @property
    def last_input_unsafe(self) -> bool:
        return bool(self._session.get("unsafe", False))

    # ---- /estimate_elevation (demo/app.py stage1_run:276 + elevation)
    def estimate_elevation(self, image: np.ndarray | None = None, seed: int = 0) -> float:
        """Stage-1 views 0..11 and the nearby views of view 0 -> elevation
        (degrees above the equator); caches them for ``generate_mesh``."""
        cfg = self.pipeline.config
        z = self.pipeline.zero123
        input_256 = image if image is not None else self._session["input_256"]
        seeds = phase_seeds(seed)
        s1_all = z.stage1(input_256, seeds["stage1"])
        s2_v0 = z.stage2(s1_all[:1], seeds["stage2_view0"], steps=cfg.diffusion.ddim_steps_stage2)
        polar = self.pipeline.estimate_elevation(s2_v0[0])
        self._session.update(input_256=input_256, stage1_all=_host(s1_all),
                             stage2_v0=_host(s2_v0), polar=polar)
        return 90.0 - polar  # the demo reports elevation above the equator

    def selected_view_indices(self) -> list[int]:
        """The 8 stage-1 view ids the mesh is built from (run.py:41-54):
        ring 4..7 at polar <= 75 degrees, 8..11 above."""
        polar = self._session.get("polar", 90.0)
        return list(range(8)) if polar <= 75 else list(range(4)) + list(range(8, 12))

    # ---- per-view retry (demo/app.py stage1_run(is_rerun):306-322)
    def regenerate_view(self, view_idx: int, seed: int | None = None) -> np.ndarray:
        """Re-sample one stage-1 view (and refresh its nearby views)."""
        return self.regenerate_views([view_idx], seed)[0]

    def regenerate_views(self, view_idxs: list[int], seed: int | None = None) -> np.ndarray:
        """Re-sample the selected stage-1 views (the demo's 'Regenerate
        selected view(s)').  Without a seed each call draws from a fresh
        per-session counter, so repeated retries give new candidates."""
        if seed is None:
            seed = 1000 + self._session.get("retry_count", 0)
            self._session["retry_count"] = self._session.get("retry_count", 0) + 1
        z = self.pipeline.zero123
        seeds = phase_seeds(seed)
        s1 = np.array(self._session["stage1_all"])  # writable copy
        self._session["stage1_all"] = s1
        new_views = _host(z.stage1(self._session["input_256"], seeds["stage1"],
                                   indices=list(view_idxs)))
        for k, idx in enumerate(view_idxs):
            s1[idx] = new_views[k]
        if 0 in view_idxs:
            self._session["stage2_v0"] = _host(z.stage2(s1[:1], seeds["stage2_view0"]))
        return new_views

    # ---- regenerate-mesh chaining (demo/app.py regen_mesh_btn:622-626)
    def regenerate_mesh(self, out_dir: str | None = None, mesh_resolution: int = 256,
                        seed: int = 0) -> dict:
        """Re-run stage 2 and the reconstruction from the (possibly
        retried) cached stage-1 views."""
        return self.generate_mesh(out_dir, mesh_resolution, seed)

    # ---- camera-pose visualisation (demo/app.py CameraVisualizer:112,
    #      calc_cam_cone_pts_3d:48) as frontend-agnostic polylines
    def camera_visualization(self, polar: float | None = None) -> dict:
        """Frustum-cone polylines of the input view and the 8 stage-1 views.

        :return: {'input_cone': [16, 3], 'view_cones': [8, 16, 3],
                  'image': the preprocessed input or None}
        """
        polar = self._session.get("polar", 90.0) if polar is None else polar
        pack = cam.build_recon_cameras(float(polar))
        input_cone = img_utils.camera_cone_points(np.asarray(pack["c2ws"][0]))
        view_c2ws = np.linalg.inv(np.asarray(pack["target_w2cs"]))  # the stage-1 ring
        cones = np.stack([img_utils.camera_cone_points(c) for c in view_c2ws])
        return {"input_cone": input_cone, "view_cones": cones,
                "image": self._session.get("input_256")}

    # ---- /generate_mesh (demo/app.py stage2_run:324)
    def generate_mesh(self, out_dir: str | None = None, mesh_resolution: int = 256,
                      seed: int = 0) -> dict:
        cfg = self.pipeline.config
        s1_all = self._session["stage1_all"]
        stage1_images = s1_all[self.selected_view_indices()]
        rest = _host(self.pipeline.zero123.stage2(
            stage1_images[1:], phase_seeds(seed)["stage2"], steps=cfg.diffusion.ddim_steps_stage2))
        stage2_images = np.concatenate([self._session["stage2_v0"], rest], axis=0)
        camera_pack = cam.build_recon_cameras(self._session["polar"])
        src = stage2_images.reshape(-1, *stage2_images.shape[2:])
        out_path = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            out_path = os.path.join(out_dir, "mesh.ply")
        return self.pipeline.recon.reconstruct(
            src, camera_pack, resolution=mesh_resolution, out_path=out_path)


def build_gradio_app(service: One2345Service | None = None):
    """Optional Gradio UI mirroring the reference demo surface
    (demo/app.py:441-626): bbox sliders with live preview, per-view retry
    checkboxes + regenerate-mesh chaining, camera-cone pose plot.  The same
    components, endpoint names and retry slot -> view-id mapping as the JAX
    builder; gradio (and plotly, for the pose plot) are imported here and
    are not dependencies of the package.

    :raises ImportError: without gradio
    """
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("gradio is not installed in this environment") from e

    service = service or One2345Service()

    def gallery(s1, sel):
        return [(np.clip(s1[i] * 255, 0, 255)).astype(np.uint8) for i in sel]

    with gr.Blocks(title="One-2-3-45") as demo:
        with gr.Row():
            with gr.Column():
                inp = gr.Image(label="Input image", type="numpy")
                bbox_preview = gr.Image(label="Foreground bbox")
                with gr.Row():
                    x_min = gr.Slider(0, 512, 0, step=1, label="bbox x_min")
                    y_min = gr.Slider(0, 512, 0, step=1, label="bbox y_min")
                with gr.Row():
                    x_max = gr.Slider(0, 512, 512, step=1, label="bbox x_max")
                    y_max = gr.Slider(0, 512, 512, step=1, label="bbox y_max")
                pre = gr.Image(label="Preprocessed (256x256)")
            with gr.Column():
                elev = gr.Number(label="Estimated elevation (deg)")
                cam_plot = gr.Plot(label="Camera poses")
                views = gr.Gallery(label="Stage-1 views", columns=4)
                retry = gr.CheckboxGroup([str(i) for i in range(8)], label="Retry view(s)")
                mesh_file = gr.Model3D(label="Mesh")
        b1 = gr.Button("Preprocess")
        b2 = gr.Button("Estimate elevation & views")
        b3 = gr.Button("Generate mesh")
        b4 = gr.Button("Regenerate selected view(s)")
        b5 = gr.Button("Regenerate nearby views and mesh")

        def _init_bbox(image):
            out = service.init_bbox(image)
            x0, y0, x1, y1 = out["bbox"]
            return out["preview"], x0, y0, x1, y1

        inp.change(_init_bbox, inp, [bbox_preview, x_min, y_min, x_max, y_max])

        def _pre(image, x0, y0, x1, y1):
            return service.preprocess(image, bbox=(int(x0), int(y0), int(x1), int(y1)))

        b1.click(_pre, [inp, x_min, y_min, x_max, y_max], pre, api_name="preprocess")

        def _cam_figure():
            import plotly.graph_objects as go

            viz = service.camera_visualization()
            fig = go.Figure()
            cones = [(viz["input_cone"], "input")] + [
                (c, f"view {i}") for i, c in enumerate(viz["view_cones"])]
            for cone, name in cones:
                fig.add_trace(go.Scatter3d(x=cone[:, 0], y=cone[:, 1], z=cone[:, 2],
                                           mode="lines", name=name))
            return fig

        def _estimate():
            e = service.estimate_elevation()
            return e, _cam_figure(), gallery(service._session["stage1_all"],
                                             service.selected_view_indices())

        b2.click(_estimate, None, [elev, cam_plot, views], api_name="estimate_elevation")

        def _gen():
            return service.generate_mesh(out_dir="exp/gradio").get("path")

        b3.click(_gen, None, mesh_file, api_name="generate_mesh")

        def _retry(selected):
            # checkbox labels are gallery SLOTS (0..7), mapped to the
            # elevation-dependent view ids (8..11 in the high branch)
            sel = service.selected_view_indices()
            service.regenerate_views([sel[int(s)] for s in selected])
            return gallery(service._session["stage1_all"], sel)

        b4.click(_retry, retry, views)

        def _regen_mesh():
            return service.regenerate_mesh(out_dir="exp/gradio").get("path")

        b5.click(_regen_mesh, None, mesh_file)
    return demo
