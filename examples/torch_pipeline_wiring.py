"""Full-pipeline wiring proof on the port, with meaningful content (oracle diffusion).

The twin of ``examples/pipeline_wiring.py`` for ``one2345_tpu_torch``.  A
flipped azimuth sign or a misordered view list between the zero123 delta
tables (``diffusion/zero123.py`` STAGE1_/STAGE2_DELTA_*) and the recon
camera rig (``geometry/cameras.py`` rig_view_angles) would be invisible to
every weight-level test.  This module drives the port's REAL
``pipeline/runner.py`` path with the diffusion stage replaced by an ORACLE
that rasterizes the known GT box at EXACTLY the world poses the delta
tables claim each view has.

Tier A (``wiring_check``, no training): the production runner with the
oracle and a recorder recon stub; the 32 source images the runner hands
``reconstruct()`` (in its own assembly order) are compared with rasters at
``build_recon_cameras``' normalized pack poses, row by row: if and only if
the delta tables, the rig angles, the view order and the normalization
chain agree, every pair is the same picture (PSNR >> 30 dB).  The
``flip_azimuth`` negative control must score LOW.

Tier B (``run_benchmark``): train ``ReconStage`` on the pack views at the
production 256^2 rig, run the full runner (oracle stage-1/2 grids ->
pinned elevation -> pose pack -> trained recon -> mesh) and score the mesh
against the GT box in WORLD coordinates (CD/F-score), plus the flipped
control.

Differences from the JAX example: the oracle implements the port's stage
signatures (integer seeds, ``noise_fn``) and returns tensors on the
runner's device; every function that touches the device takes ``device``
(None -> the card); the recon training draws its rays from a
``torch.Generator``.  ``--nq`` keeps the JAX default 0.5; pass ``--nq 0``
for geometry (0.5 collapsed the JAX tier-B F@0.05 from 0.893 to 0.455).

    python examples/torch_pipeline_wiring.py [--steps 1500] [--polar 75] \
        [--nq 0] [--tier-a-only] [--device cpu] [--json out.json]
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np
import torch

BOX_SCALE = 0.6  # full box half-diag 0.62 would clip the 256^2/f280 frame


def make_world_box():
    """The recon-quality asymmetric box, scaled to sit inside every rig
    frustum (cameras at radius 1.2, focal 280 @ 256^2), direction-coded
    vertex colors: azimuth-distinctive, so any view/pose mismatch shows up
    as the wrong face colors in frame."""
    from examples.torch_recon_quality import make_gt_box

    verts, faces, colors = make_gt_box()
    return verts * BOX_SCALE, faces, colors


class OracleZero123:
    """Drop-in for ``Zero123Stage`` inside ``One2345Pipeline.run``: instead
    of sampling, rasterize the GT box at the world pose each view SHOULD
    depict per the delta-table semantics,

        polar = input_polar + dx,   azimuth = 30 deg + dy

    (stage-1 view 0 is generated at delta (0, 0) and the rig assigns it
    absolute azimuth 30).  Only the delta tables and
    ``spherical_look_at_poses`` are used; the recon pack builds its poses
    through the independent ``rig_view_angles`` path, so agreement between
    the two is exactly the inter-stage contract under test.

    :param flip_azimuth: negative control: every view rendered with the
        azimuth DELTA sign flipped (the classic contract bug)
    :param device: where the renders are made and returned (None -> the card)
    """

    def __init__(self, polar_deg: float, image_size: int = 256,
                 flip_azimuth: bool = False, azimuth0: float = 30.0, device=None):
        from one2345_tpu_torch.core.device import resolve_device

        self.polar = float(polar_deg)
        self.size = int(image_size)
        self.sign = -1.0 if flip_azimuth else 1.0
        self.az0 = azimuth0
        self.device = resolve_device(device)
        self.verts, self.faces, self.colors = make_world_box()

    def _candidates(self):
        """Stage-1 candidate ids for this elevation (the runner's `sel`)."""
        return (list(range(8)) if self.polar <= 75
                else list(range(4)) + list(range(8, 12)))

    def _render(self, dx, dy) -> torch.Tensor:
        from one2345_tpu_torch.eval.render_harness import rasterize
        from one2345_tpu_torch.geometry.cameras import (
            BLENDER2OPENCV, intrinsic_matrix, spherical_look_at_poses,
        )

        polar = self.polar + np.asarray(dx, np.float64)
        azim = self.az0 + self.sign * np.asarray(dy, np.float64)
        c2ws = spherical_look_at_poses(np.radians(polar), np.radians(azim)) @ BLENDER2OPENCV
        w2cs = np.linalg.inv(c2ws)
        K = intrinsic_matrix() * (self.size / 256.0)
        K[2, 2] = 1.0
        imgs = [
            rasterize(self.verts, self.faces, self.colors, K, w2cs[i].astype(np.float32),
                      res=self.size, shade=False, device=self.device)[0]
            for i in range(w2cs.shape[0])
        ]
        return torch.as_tensor(np.stack(imgs), dtype=torch.float32, device=self.device)

    # --- the two methods the runner calls (the port's signatures) ---------
    def stage1(self, input_image, seed, indices=None, steps=None, noise_fn=None):
        from one2345_tpu_torch.diffusion.zero123 import STAGE1_DELTA_X, STAGE1_DELTA_Y

        idx = list(indices) if indices is not None else list(range(12))
        return self._render([STAGE1_DELTA_X[i] for i in idx], [STAGE1_DELTA_Y[i] for i in idx])

    def stage2(self, stage1_images, seed, steps=None, view_ids=None, noise_fn=None):
        from one2345_tpu_torch.diffusion.zero123 import (
            STAGE1_DELTA_X, STAGE1_DELTA_Y, STAGE2_DELTA_X, STAGE2_DELTA_Y,
        )

        n = stage1_images.shape[0]
        ids = list(view_ids) if view_ids is not None else list(range(n))
        sel = self._candidates()
        dx, dy = [], []
        for pos in ids:
            c = sel[pos]
            for j in range(4):
                dx.append(STAGE1_DELTA_X[c] + STAGE2_DELTA_X[j])
                dy.append(STAGE1_DELTA_Y[c] + STAGE2_DELTA_Y[j])
        return self._render(dx, dy).reshape(n, 4, self.size, self.size, 3)


class _RecorderRecon:
    """Recon stub: records exactly what the runner hands reconstruct()."""

    def __init__(self):
        self.calls = []

    def reconstruct(self, images, cameras, resolution=None, out_path=None):
        self.calls.append({"images": torch.as_tensor(images).cpu().numpy(), "cameras": cameras})
        z = np.zeros((0, 3), np.float32)
        return {"vertices": z, "faces": np.zeros((0, 3), np.int32), "colors": z}


def world_to_normalized(verts_w: np.ndarray, pack: dict) -> np.ndarray:
    """Invert recon's normalized->world map (mesh_extract.
    apply_mesh_transforms: v_w = trans_mat @ (r*v_n + t))."""
    T_inv = np.linalg.inv(pack["trans_mat"].astype(np.float64))
    vh = np.concatenate([verts_w, np.ones_like(verts_w[:, :1])], axis=1)
    v = (T_inv @ vh.T).T[:, :3]
    r = float(pack["scale_mat"][0, 0])
    t = pack["scale_mat"][:3, 3].astype(np.float64)
    return ((v - t) / r).astype(np.float32)


def render_pack_views(pack: dict, res: int, device=None):
    """GT rasters at the NORMALIZED pack poses [33, res, res, 3] (+ alpha):
    the pictures recon's cameras claim its inputs depict."""
    from one2345_tpu_torch.eval.render_harness import rasterize

    verts_w, faces, colors = make_world_box()
    verts_n = world_to_normalized(verts_w, pack)
    s = res / 256.0
    imgs, alphas = [], []
    for i in range(pack["w2cs"].shape[0]):
        K = pack["intrinsics"][i].astype(np.float64).copy()
        K[:2] *= s
        rgb, a = rasterize(verts_n, faces, colors, K, pack["w2cs"][i], res=res, shade=False,
                           device=device)
        imgs.append(rgb)
        alphas.append(a)
    return np.stack(imgs), np.stack(alphas)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-10)))


def build_pipeline(polar: float, size: int, flip: bool, recon_stage, device=None):
    """The port's ``One2345Pipeline`` with the oracle diffusion stage, a
    pinned elevation, and the given recon stage swapped in."""
    from one2345_tpu_torch.core.config import DiffusionConfig, PipelineConfig
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    cfg = PipelineConfig(diffusion=DiffusionConfig(image_size=size))
    pipe = One2345Pipeline(cfg, use_sam=False, device=device)
    pipe._zero123 = OracleZero123(polar, size, flip_azimuth=flip, device=pipe.device)
    pipe._recon = recon_stage
    # LoFTR at random weights cannot estimate elevation; the contract under
    # test is delta tables <-> rig, so it is pinned
    pipe.estimate_elevation = lambda views: float(polar)
    return pipe


def wiring_check(polar: float = 75.0, size: int = 256, flip_azimuth: bool = False,
                 device=None) -> dict:
    """Tier A: run the port's runner (oracle diffusion + recorder recon),
    compare what it hands reconstruct() against GT rasters at the pack
    poses.  Correct wiring scores >> 30 dB on every row, a flipped azimuth
    sign ~10 dB."""
    rec = _RecorderRecon()
    pipe = build_pipeline(polar, size, flip_azimuth, rec, device=device)
    dummy = np.ones((size, size, 3), np.float32)
    res = pipe.run(dummy, skip_preprocess=True, seed=0)
    call = rec.calls[-1]
    pack = call["cameras"]

    gt_imgs, _ = render_pack_views(pack, size, device=pipe.device)
    src = call["images"]  # [32, size, size, 3] in runner order
    if src.shape[0] != 32:
        raise RuntimeError(f"the runner handed reconstruct() {src.shape[0]} images, not 32")
    psnrs = [_psnr(src[k], gt_imgs[1 + k]) for k in range(32)]
    # the query view the pack's row 0 claims (stage-1 view 0)
    q = _psnr(res.stage1_images[0].cpu().numpy(), gt_imgs[0])
    return {
        "polar": polar, "size": size, "flip_azimuth": flip_azimuth,
        "psnr_mean": round(float(np.mean(psnrs)), 2),
        "psnr_min": round(float(np.min(psnrs)), 2),
        "psnr_query": round(q, 2),
    }


def train_recon_on_pack(pack, images, alphas, steps: int, n_rays: int,
                        vol: int, seed: int = 0, lr: float = 1e-3,
                        log_every: int = 100, n_samples: int = 48,
                        n_importance: int = 48, mesh_resolution: int = 128,
                        normal_query_prob: float = 0.5, device=None, draw_fn=None):
    """The port's ``ReconStage`` trained on the pack views (the
    recon_quality protocol at the production rig); returns the trained
    stage.  ``normal_query_prob=0.5`` is the JAX benchmark's default (the
    package default stays 0.0, the reference's semantics).

    :param draw_fn: optional step -> {'idx': ray indices, and the trainer's
        draws}"""
    from examples.torch_recon_quality import train_recon_loop, trained_stage
    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer

    res = images.shape[1]
    # the pack is built in the native 256^2 frame; supervision images are
    # rendered at `res` with K scaled by res/256 (render_pack_views), so the
    # ray / affine geometry scales identically
    s = res / 256.0
    pack = dict(pack)
    pack["intrinsics"] = np.array(pack["intrinsics"], np.float64)
    pack["intrinsics"][:, :2] *= s
    pack["affines"] = np.array(pack["affines"], np.float64)
    pack["affines"][:, :2] *= s
    cfg = ReconConfig(
        image_hw=(res, res), vol_dims=(vol, vol, vol),
        voxel_size=2.0 / (vol - 1), n_rays=n_rays,
        n_samples=n_samples, n_importance=n_importance,
        learning_rate=lr, anneal_end=max(steps // 3, 1),
        end_iter=steps, mesh_resolution=mesh_resolution,
        fg_bg_gate_iter=max(steps // 10, 1),
        normal_query_prob=normal_query_prob,
    )
    trainer = ReconTrainer(ReconStage(cfg, seed=seed, device=device), cfg, seed=seed)
    train_recon_loop(trainer, images, alphas, pack, steps, n_rays, seed, log_every,
                     label="recon step", draw_fn=draw_fn)
    return trained_stage(trainer)


def score_mesh_vs_world_box(verts, faces, colors=None, images=None,
                            pack=None, size: int = 256, device=None) -> dict:
    """Geometry (CD/F-score) + color agreement vs the GT world box.

    Geometry CANNOT discriminate an azimuth flip here: a mirrored cuboid is
    the same cuboid.  The box's direction-coded colors are the
    mirror-sensitive channel: with ``colors`` (production vertex colors)
    and ``images`` / ``pack`` (the 32 source rows the runner handed recon,
    for the network-free best-view projection), the color MAE against the
    analytic field c(p) = 0.5 + 0.5 * unit(p) is scored on vertices near
    the GT surface."""
    from examples import torch_recon_quality as rq
    from one2345_tpu_torch.eval.metrics import chamfer_distance, f_score, sample_surface

    gt_verts, gt_faces, _ = make_world_box()
    out = {"pred_verts": int(len(verts))}
    if not (len(verts) and len(faces)):
        return out
    n = rq.SURFACE_POINTS
    pv = np.asarray(verts, np.float32)
    pp = sample_surface(pv, faces, n, seed=0)
    gp = sample_surface(gt_verts, gt_faces, n, seed=1)
    out["chamfer_l1"] = round(float(chamfer_distance(pp, gp, squared=False, device=device)), 5)
    out["f_score_05"] = round(float(f_score(pp, gp, 0.05, device=device)), 4)
    out["f_score_10"] = round(float(f_score(pp, gp, 0.10, device=device)), 4)

    # color agreement on vertices near the GT surface (the GT box is the
    # recon-quality box scaled by BOX_SCALE, so distances scale with it)
    near = rq.box_surface_distance(pv / BOX_SCALE) * BOX_SCALE < 0.05
    if near.sum() > 100:
        rn = np.linalg.norm(pv[near], axis=1, keepdims=True)
        want = 0.5 + 0.5 * pv[near] / np.maximum(rn, 1e-6)
        out["color_frac_scored"] = round(float(near.mean()), 3)
        if colors is not None:
            pc = np.asarray(colors, np.float32)
            out["color_mae"] = round(float(np.abs(pc[near] - want).mean()), 4)
        if images is not None and pack is not None:
            # best-view projection of the SOURCE IMAGES onto the predicted
            # surface: no network, so it scores exactly what the flip
            # corrupts, which picture each camera claims to be
            vn_w = world_to_normalized(pv, pack)
            nrm = rq.vertex_normals(vn_w, np.asarray(faces, np.int64))
            w2cs = np.asarray(pack["w2cs"][1:], np.float32)
            Ks = np.asarray(pack["intrinsics"][1:], np.float64).copy()
            Ks[:, :2] *= size / 256.0
            oc = rq.bestview_vertex_colors(vn_w[near], nrm[near],
                                           np.asarray(images, np.float32), w2cs, Ks)
            out["color_mae_bestview"] = round(float(np.abs(oc - want).mean()), 4)
    return out


def run_benchmark(polar: float = 75.0, size: int = 256, steps: int = 1500,
                  n_rays: int = 512, vol: int = 48, seed: int = 0,
                  mesh_resolution: int = 128, log_every: int = 100,
                  n_samples: int = 48, n_importance: int = 48,
                  with_flipped_control: bool = True,
                  normal_query_prob: float = 0.5,
                  save_npz: str | None = None, device=None) -> dict:
    """Tier B: tier-A checks + recon trained on the production pack, the
    FULL runner with oracle diffusion, the world-frame mesh scored."""
    from one2345_tpu_torch.core.device import resolve_device
    from one2345_tpu_torch.geometry.cameras import build_recon_cameras

    dev = resolve_device(device)
    t0 = time.perf_counter()
    out: dict = {"tier_a": wiring_check(polar, size, device=dev),
                 "tier_a_flipped": wiring_check(polar, size, flip_azimuth=True, device=dev)}
    print(json.dumps(out), flush=True)

    pack = build_recon_cameras(polar)
    # the pack rendered at `size` for the recon training's supervision
    imgs, alphas = render_pack_views(pack, size, device=dev)
    stage = train_recon_on_pack(
        pack, imgs, alphas, steps, n_rays, vol, seed=seed,
        log_every=log_every, n_samples=n_samples, n_importance=n_importance,
        mesh_resolution=mesh_resolution, normal_query_prob=normal_query_prob, device=dev)

    for label, flip in ([("e2e", False), ("e2e_flipped", True)]
                        if with_flipped_control else [("e2e", False)]):
        pipe = build_pipeline(polar, size, flip, stage, device=dev)
        res = pipe.run(np.ones((size, size, 3), np.float32), skip_preprocess=True, seed=0,
                       mesh_resolution=mesh_resolution)
        src = res.stage2_images.reshape(-1, size, size, 3).cpu().numpy()
        out[label] = score_mesh_vs_world_box(
            res.vertices, res.faces, colors=res.colors, images=src,
            pack=pack, size=size, device=dev)
        print(json.dumps({label: out[label]}), flush=True)
        if save_npz:
            np.savez_compressed(
                f"{save_npz}_{label}.npz", vertices=res.vertices,
                faces=res.faces, colors=res.colors, src=src)
    out["total_secs"] = round(time.perf_counter() - t0, 1)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--polar", type=float, default=75.0)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--rays", type=int, default=512)
    p.add_argument("--vol", type=int, default=48)
    p.add_argument("--tier-a-only", action="store_true")
    p.add_argument("--nq", type=float, default=0.5,
                   help="recon normal_query_prob (0.0 = reference semantics, the "
                        "setting for geometry; 0.5 = the JAX example's default)")
    p.add_argument("--json", default=None)
    p.add_argument("--save-npz", default=None,
                   help="prefix for per-run mesh/sample artifact dumps")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    if args.tier_a_only:
        out = {"tier_a": wiring_check(args.polar, args.size, device=args.device),
               "tier_a_flipped": wiring_check(args.polar, args.size, flip_azimuth=True,
                                              device=args.device)}
    else:
        out = run_benchmark(polar=args.polar, size=args.size,
                            steps=args.steps, n_rays=args.rays, vol=args.vol,
                            normal_query_prob=args.nq,
                            save_npz=args.save_npz, device=args.device)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
