"""End-to-end single image -> vertex-colored mesh, on one card.

Counterpart of ``one2345_tpu/pipeline/runner.py`` (reference: run.py,
preprocess -> stage1_run -> stage2_run -> reconstruct, run.py:79-119).
``One2345Pipeline.run`` keeps the JAX runner's phase order and span names:

1. ``preprocess`` (the input must already be a recentred 256^2 image:
   preprocessing is not ported yet, ROADMAP item 9);
2. ``stage1``: stage-1 views 0-3;
3. ``stage2_view0``: the 4 nearby views of view 0;
4. ``elevation``: the LoFTR elevation estimate from those 4 views, which
   picks the second stage-1 ring (views 4-7 at polar <= 75, else 8-11) and
   the camera rig;
5. ``stage1`` again: the second ring;
6. ``stage2``: the nearby views of the other 7 views, one batch;
7. ``reconstruct``: the 32 views -> mesh (``recon.pipeline.ReconStage``).

Stage outputs stay on the card between phases; the artifact PNGs,
``pose.json`` and the .obj / .glb mesh are optional exports.  Each phase
draws its noise from its own integer seed, derived from ``seed``; a
``noise_fn`` map replaces the draws of any phase (the tests feed the noise
the JAX runner drew from its key splits).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from one2345_tpu_torch.core.config import PipelineConfig
from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.core.profiling import Timer
from one2345_tpu_torch.geometry import cameras as cam
from one2345_tpu_torch.utils.png import write_png

# the sampling phases of ``run``, each with its own noise seed
PHASES = ("stage1", "stage2_view0", "stage1_ring2", "stage2")
NOT_PORTED = "is not ported yet (ROADMAP §1 item 9: preprocessing, SAM and the safety checker)"


def select_stage1b_plan(polar: float, n_devices: int):
    """Second-ring stage-1 sampling plan (run.py:40-44 view-index logic).

    One card (or any device count the 4-view batch divides) samples just
    the needed ring; on a mesh that would pad the 4-view batch, both rings
    (views 4..11) are sampled and the needed one sliced out.

    :return: (indices_to_sample, slice_for_needed_ring, second_ring_ids)
    """
    second = [4, 5, 6, 7] if polar <= 75 else [8, 9, 10, 11]
    if n_devices > 1 and 4 % n_devices != 0:
        sample = list(range(4, 12))
        off = 0 if polar <= 75 else 4
        return sample, slice(off, off + 4), second
    return second, slice(0, 4), second


def phase_seeds(seed: int) -> dict:
    """{phase: integer noise seed} for the sampling phases of one run."""
    return {
        phase: int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
        for i, phase in enumerate(PHASES)
    }


class UnsafeImageError(RuntimeError):
    """Raised when the safety checker flags the input image
    (demo/app.py:376-386); the checker is not ported yet."""


@dataclass
class PipelineResult:
    mesh_path: str | None
    vertices: np.ndarray
    faces: np.ndarray
    colors: np.ndarray
    elevation: float
    stage1_images: torch.Tensor  # [8, 256, 256, 3] on the pipeline's device
    stage2_images: torch.Tensor  # [8, 4, 256, 256, 3]
    timings: dict = field(default_factory=dict)


class One2345Pipeline:
    """The stages, built at first use from ``params``.

    :param params: state dicts keyed 'zero123' (``Zero123Stage`` params),
        'recon' (``ReconStage``) and 'loftr' (``LoFTRMatcher``); a missing
        key -> that stage initialised from its seed
    :param use_sam: True is not ported yet (raises)
    :param device: None -> 'cuda' (raises without CUDA)
    """

    def __init__(self, config: PipelineConfig | None = None, params: dict | None = None,
                 use_sam: bool = False, device=None):
        if use_sam:
            raise NotImplementedError(f"use_sam=True: SAM segmentation {NOT_PORTED}")
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self._params = params or {}
        self.use_sam = use_sam
        self._zero123 = None
        self._recon = None
        self._elev = None

    # lazy stage constructors -------------------------------------------------
    @property
    def zero123(self):
        if self._zero123 is None:
            from one2345_tpu_torch.diffusion.zero123 import Zero123Stage

            self._zero123 = Zero123Stage(
                self.config.diffusion, self._params.get("zero123"), device=self.device
            )
        return self._zero123

    @property
    def recon(self):
        if self._recon is None:
            from one2345_tpu_torch.recon.pipeline import ReconStage

            self._recon = ReconStage(
                self.config.recon, self._params.get("recon"), device=self.device
            )
        return self._recon

    @property
    def elevation_estimator(self):
        if self._elev is None:
            from one2345_tpu_torch.elevation.loftr import LoFTRMatcher
            from one2345_tpu_torch.elevation.solver import ElevationEstimator

            ecfg = self.config.elevation
            matcher = LoFTRMatcher(self._params.get("loftr"), dtype=ecfg.dtype, device=self.device)
            self._elev = ElevationEstimator(matcher, focal=ecfg.focal, image_size=ecfg.image_size)
        return self._elev

    # not ported --------------------------------------------------------------
    def preprocess(self, raw_image, bbox=None, safety_check: bool = True):
        raise NotImplementedError(f"One2345Pipeline.preprocess {NOT_PORTED}")

    def check_safety(self, rgb_uint8) -> bool:
        raise NotImplementedError(f"One2345Pipeline.check_safety {NOT_PORTED}")

    def warmup(self, mesh_resolution: int | None = None) -> dict:
        """One ``run`` on a synthetic input, so that the first real request
        finds the kernels built and the allocator warm; returns its timings.
        (The JAX runner also compiles the pose sweep on empty slates here;
        eager PyTorch has nothing to compile, so that step is left out.)"""
        rng = np.random.default_rng(0)
        size = self.config.diffusion.image_size
        img = np.ones((size, size, 3), np.float32)
        q = size // 4
        img[q : 3 * q, q : 3 * q] = rng.uniform(0.2, 0.8, (2 * q, 2 * q, 3))
        result = self.run(
            img, skip_preprocess=True,
            mesh_resolution=mesh_resolution or self.config.mesh_resolution, seed=0,
        )
        return result.timings

    # the main path -----------------------------------------------------------
    def run(
        self,
        image,
        out_dir: str | None = None,
        mesh_resolution: int | None = None,
        output_format: str | None = None,
        seed: int | None = None,
        skip_preprocess: bool = False,
        noise_fn: dict | None = None,
    ) -> PipelineResult:
        """Image -> textured mesh (predict_multiview + reconstruct).

        :param image: [256, 256, 3] f32 in [0, 1], recentred on white (a
            tensor or an array); requires ``skip_preprocess=True``
        :param noise_fn: optional {phase: noise_fn} for phases of
            ``PHASES``, each ``noise_fn(draw, view_ids, shape)`` as
            ``Zero123Stage.sample_views`` takes it
        """
        if not skip_preprocess:
            raise NotImplementedError(f"run(skip_preprocess=False): preprocessing {NOT_PORTED}")
        cfg = self.config
        timer = Timer(device=self.device)
        seeds = phase_seeds(cfg.seed if seed is None else seed)
        noise = noise_fn or {}
        z = self.zero123
        steps2 = cfg.diffusion.ddim_steps_stage2

        with timer.span("preprocess"):
            input_256 = torch.as_tensor(image, dtype=torch.float32).to(self.device)

        # stage 1a: the 4 same-elevation views; the elevation-dependent 4
        # come after the estimate
        with timer.span("stage1"):
            s1_first = z.stage1(input_256, seeds["stage1"], indices=[0, 1, 2, 3],
                                noise_fn=noise.get("stage1"))

        # stage 2 for view 0: the elevation estimate's input (run.py:28-30)
        with timer.span("stage2_view0"):
            s2_v0 = z.stage2(s1_first[:1], seeds["stage2_view0"], steps=steps2, view_ids=[0],
                             noise_fn=noise.get("stage2_view0"))

        with timer.span("elevation"):
            polar = self.estimate_elevation(s2_v0[0])

        # stage 1b: the second elevation ring (run.py:40-44), on one card
        sel = list(range(8)) if polar <= 75 else list(range(4)) + list(range(8, 12))
        sample_idx, ring, _ = select_stage1b_plan(polar, 1)
        with timer.span("stage1"):
            s1_second = z.stage1(input_256, seeds["stage1_ring2"], indices=sample_idx,
                                 noise_fn=noise.get("stage1_ring2"))[ring]
        stage1_images = torch.cat([s1_first, s1_second])

        # stage 2 for the other 7 views (run.py stage2_run)
        with timer.span("stage2"):
            rest = z.stage2(stage1_images[1:], seeds["stage2"], steps=steps2,
                            view_ids=list(range(1, 8)), noise_fn=noise.get("stage2"))
        stage2_images = torch.cat([s2_v0, rest])  # [8, 4, ...]

        with timer.span("reconstruct"):
            camera_pack = cam.build_recon_cameras(polar)
            src_images = stage2_images.reshape(-1, *stage2_images.shape[2:])  # [32, ...]
            mesh_path = None
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                mesh_path = os.path.join(out_dir, "mesh.ply")
            mesh = self.recon.reconstruct(
                src_images, camera_pack, resolution=mesh_resolution or cfg.mesh_resolution,
                out_path=mesh_path,
            )

        if out_dir:
            self.export_artifacts(out_dir, polar, stage1_images, stage2_images, sel)
            fmt = output_format or cfg.output_format
            if fmt in (".obj", ".glb"):
                mesh_path = self.convert_mesh(out_dir, mesh, fmt)

        return PipelineResult(
            mesh_path=mesh_path,
            vertices=mesh["vertices"],
            faces=mesh["faces"],
            colors=mesh["colors"],
            elevation=90.0 - polar,
            stage1_images=stage1_images,
            stage2_images=stage2_images,
            timings=timer.report(),
        )

    def estimate_elevation(self, nearby_views) -> float:
        """[4, 256, 256, 3] nearby views -> polar angle in degrees, truncated
        to an integer; the config's ``default_elevation`` (90) when the
        estimator finds no match in some pair (run.py:32-36).  Unlike the
        JAX runner, an exception is not turned into the fallback: a failed
        launch or a device error propagates."""
        est = self.elevation_estimator.estimate(nearby_views)
        return float(int(est)) if est is not None else self.config.elevation.default_elevation

    # artifact exports (reference-compatible layout) --------------------------
    def export_artifacts(self, out_dir, polar, stage1_images, stage2_images, sel):
        """stage1_8/{i}.png, stage2_8/{i}_{j}.png and pose.json: the file
        layout of the reference (SURVEY data-flow table)."""
        s1 = (torch.as_tensor(stage1_images).cpu().numpy() * 255).astype(np.uint8)
        s2 = (torch.as_tensor(stage2_images).cpu().numpy() * 255).astype(np.uint8)
        s1_dir = os.path.join(out_dir, "stage1_8")
        s2_dir = os.path.join(out_dir, "stage2_8")
        os.makedirs(s1_dir, exist_ok=True)
        os.makedirs(s2_dir, exist_ok=True)
        for k, i in enumerate(sel):
            write_png(os.path.join(s1_dir, f"{i}.png"), s1[k])
            for j in range(4):
                write_png(os.path.join(s2_dir, f"{i}_{j}.png"), s2[k, j])
        cam.write_pose_json(out_dir, polar)

    def convert_mesh(self, out_dir, mesh, fmt: str) -> str:
        from one2345_tpu_torch.recon import mesh_extract

        v, f = mesh_extract.convert_mesh_axes(mesh["vertices"], mesh["faces"])
        path = os.path.join(out_dir, f"mesh{fmt}")
        if fmt == ".obj":
            save_obj(path, v, f, mesh["colors"])
        else:
            from one2345_tpu_torch.recon.gltf import save_glb

            save_glb(path, v, f, mesh["colors"])
        return path


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray, colors: np.ndarray):
    """OBJ with per-vertex colors (trimesh include_color=True format)."""
    with open(path, "w") as f:
        for v, c in zip(verts, colors):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
