"""Service API surface: the reference demo's endpoint contract.

Counterpart of ``one2345_tpu/pipeline/api.py`` (reference: demo/app.py's
``/preprocess``, ``/estimate_elevation`` and ``/generate_mesh``, README.md:
170-215, plus the demo UI's per-view retries, demo/app.py:276-322) as
plain callables any HTTP layer can wrap (``pipeline.server``).  Session
semantics are the JAX service's; noise comes from integer seeds (each
call's sampling phases draw from ``runner.phase_seeds(seed)``), not from
JAX keys.  The Gradio UI (``build_gradio_app``) is not ported: gradio and
plotly are on neither machine.

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
