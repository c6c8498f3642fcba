"""End-to-end single image -> vertex-colored mesh, on one card or a data mesh.

Counterpart of ``one2345_tpu/pipeline/runner.py`` (reference: run.py,
preprocess -> stage1_run -> stage2_run -> reconstruct, run.py:79-119).
``One2345Pipeline.run`` keeps the JAX runner's phase order and span names:

1. ``preprocess``: thumbnail to 512, composite on white, the safety gate,
   SAM seeds a bbox (``estimate_bbox`` when its proposal is degenerate) and
   segments under a box prompt, recentre to 256^2 (``skip_preprocess=True``
   takes an already recentred 256^2 image);
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

from one2345_tpu_torch.core import meshes
from one2345_tpu_torch.core.config import PipelineConfig
from one2345_tpu_torch.core.device import resolve_device
from one2345_tpu_torch.core.profiling import Timer
from one2345_tpu_torch.geometry import cameras as cam
from one2345_tpu_torch.utils import image as img_utils
from one2345_tpu_torch.utils.png import write_png

# the sampling phases of ``run``, each with its own noise seed
PHASES = ("stage1", "stage2_view0", "stage1_ring2", "stage2")


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
    (the library-level equivalent of demo/app.py:376-386 returning the
    unsafe-placeholder image)."""


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
        'recon' (``ReconStage``), 'loftr' (``LoFTRMatcher``) and 'sam'
        (``SamStage``), and 'safety': a ``SafetyChecker`` or its keyword
        arguments; a missing key -> that stage initialised from its seed
        (the safety checker without weights flags nothing).  The tree
        ``save_params`` writes loads back here.
    :param use_sam: segment with SAM in ``preprocess`` (else alpha > 0 for
        RGBA, not-near-white for RGB)
    :param device: None -> 'cuda' (raises without CUDA)
    :param mesh: a ``core.meshes.create_mesh`` mesh with a ``data`` axis over
        which the diffusion stage shards its view batches.  With
        ``auto_mesh`` (default) a ``data`` mesh over the process group is
        made when one with more than one rank exists and its size divides
        8 (the stage batches, 8 / 56 views x CFG, then split evenly); one
        process changes nothing.  Every rank runs the unsharded phases
        (preprocess, elevation, reconstruct) on the same inputs, the JAX
        runner's replicated placement; rank 0 alone writes the artifacts.
    """

    def __init__(self, config: PipelineConfig | None = None, params: dict | None = None,
                 use_sam: bool = True, device=None, mesh=None, auto_mesh: bool = True):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self._params = params or {}
        self.use_sam = use_sam
        self._mesh = mesh
        self._auto_mesh = auto_mesh
        self._zero123 = None
        self._recon = None
        self._elev = None
        self._sam = None
        self._safety = None

    # lazy stage constructors -------------------------------------------------
    def _resolve_mesh(self):
        if self._mesh is None and self._auto_mesh:
            n = meshes.world_size()
            # shard only over divisor-of-8 worlds so every batch splits evenly
            if n > 1 and 8 % n == 0:
                self._mesh = meshes.create_mesh(("data",))
        return self._mesh

    @property
    def zero123(self):
        if self._zero123 is None:
            from one2345_tpu_torch.diffusion.zero123 import Zero123Stage

            self._zero123 = Zero123Stage(
                self.config.diffusion, self._params.get("zero123"), device=self.device,
                mesh=self._resolve_mesh(),
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

    @property
    def sam(self):
        if self._sam is None:
            from one2345_tpu_torch.segmentation.sam import SamStage

            self._sam = SamStage(self.config.sam, self._params.get("sam"), device=self.device)
        return self._sam

    @property
    def safety(self):
        if self._safety is None:
            from one2345_tpu_torch.segmentation.safety import SafetyChecker

            sp = self._params.get("safety")
            self._safety = sp if isinstance(sp, SafetyChecker) else SafetyChecker(**(sp or {}))
        return self._safety

    def check_safety(self, rgb_uint8: np.ndarray) -> bool:
        """NSFW gate on the input (demo/app.py nsfw_check:376-386): resize
        to CLIP's frame as PIL BICUBIC resizes uint8, embed with the
        zero123 stage's CLIP tower, score against the concept embeddings.
        Free when no safety weights are loaded (the checker flags nothing)."""
        if not self.safety.has_weights:
            return False
        from one2345_tpu_torch.diffusion.clip import preprocess_for_clip
        from one2345_tpu_torch.utils.resample import pil_resize

        csize = self.config.diffusion.clip.image_size
        im = pil_resize(rgb_uint8, (csize, csize), "bicubic", device=self.device)
        x = torch.as_tensor(im, device=self.device).float() / 127.5 - 1.0  # [-1, 1]
        with torch.inference_mode():
            emb = self.zero123.clip(preprocess_for_clip(x[None], csize))
        return bool(self.safety.check(emb.float().cpu().numpy())[0])

    # checkpointing -----------------------------------------------------------
    def save_params(self, path: str) -> None:
        """Persist every constructed stage's state dicts as one tree
        (``core.checkpoint``); ``One2345Pipeline(params=checkpoint.restore(
        path))`` loads it back."""
        from one2345_tpu_torch.core import checkpoint
        from one2345_tpu_torch.diffusion.zero123 import MODULES

        tree = {}
        if self._zero123 is not None:
            tree["zero123"] = {n: getattr(self._zero123, n).state_dict() for n in MODULES}
        if self._recon is not None:
            tree["recon"] = {n: m.state_dict() for n, m in self._recon.modules().items()}
        if self._sam is not None:
            tree["sam"] = self._sam.modules.state_dict()
        if self._elev is not None:
            tree["loftr"] = self._elev.matcher.modules.state_dict()
        checkpoint.save(path, tree)

    # stages ------------------------------------------------------------------
    def thumbnail_rgb(self, raw_image: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(the 512 thumbnail of a uint8 RGB(A) image, its RGB composited on
        white); the composite truncates to uint8, as the JAX runner's
        ``astype`` does."""
        arr = img_utils.thumbnail(raw_image, 512, device=self.device)
        if arr.shape[-1] != 4:
            return arr, arr
        return arr, (img_utils.composite_white(arr.astype(np.float32) / 255.0) * 255).astype(np.uint8)

    def preprocess(self, raw_image: np.ndarray, bbox: tuple[int, int, int, int] | None = None,
                   safety_check: bool = True) -> np.ndarray:
        """uint8 RGB(A) -> [256, 256, 3] float32 in [0, 1], recentred on
        white (run.py preprocess: thumbnail 512 -> SAM bbox segment ->
        recentre).

        :param bbox: optional (x0, y0, x1, y1) prompt in the 512-thumbnail
            frame (the demo's bbox sliders, demo/app.py:418,607-614); None
            -> SAM's own proposal, ``estimate_bbox`` when it is degenerate
        :raises UnsafeImageError: when the safety checker flags the image
        """
        arr, rgb = self.thumbnail_rgb(raw_image)
        if safety_check and self.check_safety(rgb):
            raise UnsafeImageError("NSFW content detected")
        if self.use_sam:
            # one encode serves the bbox seed and the final box-prompted mask
            cache = self.sam.set_image(rgb)
            if bbox is None:
                bbox = self.sam.seed_bbox(cache)
                if bbox is None:
                    bbox = img_utils.estimate_bbox(rgb)
            mask = self.sam.predict_box(cache, bbox)
        else:
            mask = ~np.all(rgb > 245, axis=-1)
            if arr.shape[-1] == 4:
                mask = arr[..., 3] > 0
        rgba = np.concatenate([rgb, (mask[..., None] * 255).astype(np.uint8)], axis=-1)
        return img_utils.recenter_rescale(
            rgba, out_size=self.config.diffusion.image_size, device=self.device)

    def warmup(self, mesh_resolution: int | None = None) -> dict:
        """One ``run`` on a synthetic input (and, with SAM, one
        ``preprocess``), so that the first real request finds the kernels
        built and the allocator warm; returns the run's timings.  (The JAX
        runner also compiles the pose sweep on empty slates here; eager
        PyTorch has nothing to compile, so that step is left out.)"""
        rng = np.random.default_rng(0)
        size = self.config.diffusion.image_size
        img = np.ones((size, size, 3), np.float32)
        q = size // 4
        img[q : 3 * q, q : 3 * q] = rng.uniform(0.2, 0.8, (2 * q, 2 * q, 3))
        if self.use_sam:
            pre = np.full((512, 512, 3), 255, np.uint8)
            pre[128:384, 128:384] = rng.uniform(40, 200, (256, 256, 3)).astype(np.uint8)
            self.preprocess(pre, safety_check=False)
        result = self.run(
            img, skip_preprocess=True,
            mesh_resolution=mesh_resolution or self.config.mesh_resolution, seed=0,
        )
        return result.timings

    def run_many(self, images, seeds=None, out_dirs=None, max_in_flight: int = 2,
                 **run_kwargs) -> list:
        """Overlapped multi-request mode (serving): requests run in a small
        thread pool, so one request's host work (preprocessing, the
        elevation sweep, marching tets, PLY and PNG writes) overlaps
        another's device work.  Every run draws its noise from its own
        seed, so the results equal sequential ``run`` calls.

        On the card each request runs on a CUDA stream of its own, made to
        wait for the caller's current stream first, so that a host fetch
        inside one request (the elevation's matches, the field for marching
        tets) waits for that request's kernels only; its stage images are
        handed back on the caller's current stream.  The weights are read
        on every stream: the stages are built here, before the pool starts.
        ``max_in_flight=1`` (and a sharded stage, whose ranks must issue the
        sampler's all-gathers in one order) runs the requests one after the
        other on the calling thread, as ``run`` calls.  On an H100 two
        requests in flight were measured slower per mesh than
        ``max_in_flight=1`` (PERF.md, Findings): the two dispatch threads
        share the host's time rather than fill the card's idle time, as
        long as every kernel is launched one by one (no CUDA graphs yet).

        :param seeds: per-request seeds (default: config.seed + index)
        :param out_dirs: per-request out_dir list (default: no exports)
        :return: list of PipelineResult in input order
        """
        from concurrent.futures import ThreadPoolExecutor

        # build the lazy stages on the calling thread: the `is None` checks
        # of the properties are not thread-safe
        _ = self.zero123, self.recon, self.elevation_estimator, self.safety
        if self.use_sam and not run_kwargs.get("skip_preprocess"):
            _ = self.sam
        if getattr(self.zero123, "mesh", None) is not None:
            max_in_flight = 1
        n = len(images)
        if seeds is None:
            seeds = [self.config.seed + i for i in range(n)]
        if out_dirs is None:
            out_dirs = [None] * n

        def one(i):
            return self.run(images[i], out_dir=out_dirs[i], seed=seeds[i], **run_kwargs)

        if max_in_flight <= 1:
            return [one(i) for i in range(n)]
        work = one
        if self.device.type == "cuda":
            caller = torch.cuda.current_stream(self.device)

            def work(i):
                stream = torch.cuda.Stream(self.device)
                stream.wait_stream(caller)  # the inputs and anything queued before
                with torch.cuda.stream(stream):
                    result = one(i)
                caller.wait_stream(stream)
                for images_out in (result.stage1_images, result.stage2_images):
                    # their memory must outlive the caller's reads, not only this stream's
                    images_out.record_stream(caller)
                return result

        with ThreadPoolExecutor(max_workers=max_in_flight) as ex:
            return list(ex.map(work, range(n)))

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
        """Image -> textured mesh (preprocess + predict_multiview +
        reconstruct).

        :param image: a uint8 RGB(A) array of any size, or with
            ``skip_preprocess=True`` a [256, 256, 3] f32 image in [0, 1]
            recentred on white (a tensor or an array)
        :param noise_fn: optional {phase: noise_fn} for phases of
            ``PHASES``, each ``noise_fn(draw, view_ids, shape)`` as
            ``Zero123Stage.sample_views`` takes it
        """
        cfg = self.config
        timer = Timer(device=self.device)
        if meshes.rank() != 0:
            out_dir = None  # rank 0 writes the artifacts
        seeds = phase_seeds(cfg.seed if seed is None else seed)
        noise = noise_fn or {}
        z = self.zero123
        steps2 = cfg.diffusion.ddim_steps_stage2

        with timer.span("preprocess"):
            input_256 = image if skip_preprocess else self.preprocess(image)
            input_256 = torch.as_tensor(input_256, dtype=torch.float32).to(self.device)

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

        # stage 1b: the second elevation ring (run.py:40-44); a mesh that
        # would pad the 4 views samples both rings
        sel = list(range(8)) if polar <= 75 else list(range(4)) + list(range(8, 12))
        sample_idx, ring, _ = select_stage1b_plan(
            polar, meshes.axis_size(getattr(z, "mesh", None), "data"))
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
