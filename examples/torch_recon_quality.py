"""In-env recon quality benchmark on the port: train -> reconstruct -> CD/F-score vs GT.

The twin of ``examples/recon_quality.py`` for ``one2345_tpu_torch``: render
a KNOWN coloured mesh to the production 32-view recon rig with the port's
rasteriser, train the port's ``ReconStage`` from scratch on those posed
views (``training.recon_trainer.ReconTrainer``), run the production
``reconstruct()``, and score the mesh against the ground truth with
``eval.metrics`` (Chamfer + F-score) plus vertex-colour agreement, the
novel-view renders of ``recon.validation.Validator`` and, with
``--ft-steps``, the per-shape finetune (``recon.finetune.FinetuneTrainer``).

The public functions, their arguments and the keys of ``run_benchmark``'s
dict are those of the JAX example.  The differences: every function that
touches the device takes ``device`` (None -> the card; ``--device cpu``),
the random draws come from ``torch.Generator``s seeded from ``seed``
(rays, the trainer's jitter and sparsity points) and can be given instead
through ``draw_fn(step) -> {'idx': ray indices, ...the trainer's draws}``,
and ``--ply`` writes through the port's PLY writer.

    python examples/torch_recon_quality.py [--steps 1500] [--res 128] \
        [--vol 48] [--rays 512] [--ft-steps 600] [--device cpu] [--json out.json]
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

# the observable ball of the normalized frame (the rig's cameras sit at
# radius ~0.86): the *_obs metrics and the held-out render clip to it
OBS_RADIUS = 0.8
# points sampled on each surface for the Chamfer / F-score metrics
SURFACE_POINTS = 16384


def stream_seed(seed: int, stream: int) -> int:
    """The generator seed of one draw stream of a run (rays, batches, ...).
    A trainer's own generator takes the run's ``seed``; a second generator
    seeded with the same number would repeat its draws, correlating, say,
    which pixels are picked with their samples' jitter.  The JAX examples
    split their keys for the same reason."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0] >> 1)


def make_gt_sphere(n_lat: int = 24, n_lon: int = 48, radius: float = 0.45):
    """UV sphere in the NORMALIZED recon frame (volume spans [-1,1]) with
    position-coded vertex colors c = 0.5 + 0.5 * p/|p| — every surface
    point's color is analytically known, so the color pass is checkable."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts = [(0.0, 0.0, radius)]
    for t in lat[1:-1]:
        for p in lon:
            verts.append((
                radius * np.sin(t) * np.cos(p),
                radius * np.sin(t) * np.sin(p),
                radius * np.cos(t),
            ))
    verts.append((0.0, 0.0, -radius))
    verts = np.asarray(verts, np.float32)

    faces = []
    for j in range(n_lon):  # top cap
        faces.append((0, 1 + j, 1 + (j + 1) % n_lon))
    for i in range(n_lat - 2):  # bands
        a = 1 + i * n_lon
        b = 1 + (i + 1) * n_lon
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            faces.append((a + j, b + j, b + j2))
            faces.append((a + j, b + j2, a + j2))
    last = len(verts) - 1  # bottom cap
    a = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        faces.append((last, a + (j + 1) % n_lon, a + j))
    faces = np.asarray(faces, np.int32)

    colors = 0.5 + 0.5 * verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return verts, faces, colors.astype(np.float32)


def make_gt_box(half_extents=(0.35, 0.25, 0.45), n: int = 10):
    """Axis-aligned ASYMMETRIC cuboid with n x n quads per face and the
    same direction-coded colors as the sphere: sharp edges and three
    distinct half-extents, so the SDF's sphere init is no help."""
    hx, hy, hz = half_extents
    verts, faces = [], []
    lin = np.linspace(-1.0, 1.0, n + 1)

    def add_face(origin, du, dv):
        base = len(verts)
        for a in lin:
            for b in lin:
                verts.append(origin + a * du + b * dv)
        for i in range(n):
            for j in range(n):
                k = base + i * (n + 1) + j
                faces.append((k, k + n + 1, k + n + 2))
                faces.append((k, k + n + 2, k + 1))

    ex, ey, ez = (np.array([hx, 0, 0]), np.array([0, hy, 0]),
                  np.array([0, 0, hz]))
    add_face(ex, ey, ez)      # +x (the rasteriser is two-sided and the
    add_face(-ex, ez, ey)     # -x  normals are re-oriented downstream)
    add_face(ey, ez, ex)      # +y
    add_face(-ey, ex, ez)     # -y
    add_face(ez, ex, ey)      # +z
    add_face(-ez, ey, ex)     # -z
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    colors = 0.5 + 0.5 * verts / np.maximum(
        np.linalg.norm(verts, axis=1, keepdims=True), 1e-12)
    return verts, faces, colors.astype(np.float32)


def box_surface_distance(p: np.ndarray, half_extents=(0.35, 0.25, 0.45)):
    """|SDF| of the axis-aligned box at points p [N,3] (exact)."""
    q = np.abs(p) - np.asarray(half_extents, np.float32)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return np.abs(outside + inside)


def scaled_camera_pack(polar_deg: float, res: int) -> dict:
    """build_recon_cameras pack rescaled from its native 256^2 frame to
    res^2 (intrinsics and affines rows 0-1 scale linearly with K)."""
    from one2345_tpu_torch.geometry.cameras import build_recon_cameras

    pack = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in build_recon_cameras(polar_deg).items()}
    s = res / 256.0
    pack["intrinsics"][:, :2] *= s
    pack["affines"][:, :2] *= s
    return pack


def render_views(verts, faces, colors, pack, res: int, device=None):
    """[33, res, res, 3] white-background renders of the GT mesh on the
    recon rig (view 0 = reference) + [33, res, res] alpha masks."""
    from one2345_tpu_torch.eval.render_harness import rasterize

    imgs, alphas = [], []
    for i in range(pack["w2cs"].shape[0]):
        rgb, alpha = rasterize(verts, faces, colors, pack["intrinsics"][i], pack["w2cs"][i],
                               res=res, shade=False, device=device)
        imgs.append(rgb)
        alphas.append(alpha)
    return np.stack(imgs), np.stack(alphas)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals, oriented OUTWARD (away from the
    mesh centroid — exact for star-shaped surfaces like the GT sphere;
    marching-tets winding is not guaranteed consistent)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted face normals
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    outward = verts - verts.mean(axis=0)
    flip = np.sum(n * outward, axis=1, keepdims=True) < 0
    return np.where(flip, -n, n)


def bestview_vertex_colors(verts, normals, images, w2cs, intrinsics):
    """Oracle vertex colors: bilinear-sample each vertex from its most
    face-on source view (max dot(normal, dir_to_camera)) — no network, so
    it isolates geometry + projection accuracy from the learned blending."""
    H, W = images.shape[1:3]
    cams = np.linalg.inv(w2cs)[:, :3, 3]  # [V,3]
    d = cams[:, None, :] - verts[None]  # [V,N,3]
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    best = np.argmax(np.sum(d * normals[None], axis=-1), axis=0)  # [N]

    p = np.einsum("nij,nj->ni", w2cs[best, :3, :3], verts) + w2cs[best, :3, 3]
    uv = np.einsum("nij,nj->ni", intrinsics[best], p)
    u = uv[:, 0] / np.maximum(uv[:, 2], 1e-6)
    v = uv[:, 1] / np.maximum(uv[:, 2], 1e-6)
    u = np.clip(u, 0.0, W - 1.001)
    v = np.clip(v, 0.0, H - 1.001)
    u0, v0 = u.astype(np.int64), v.astype(np.int64)
    fu, fv = (u - u0)[:, None], (v - v0)[:, None]
    c00 = images[best, v0, u0]
    c01 = images[best, v0, u0 + 1]
    c10 = images[best, v0 + 1, u0]
    c11 = images[best, v0 + 1, u0 + 1]
    return (c00 * (1 - fu) * (1 - fv) + c01 * fu * (1 - fv)
            + c10 * (1 - fu) * fv + c11 * fu * fv)


def held_out_view_psnr(stage, images_src, pack, gt_verts, gt_faces, gt_colors,
                       res: int, azimuth_deg: float = 22.5,
                       lod: int = 0) -> tuple[float, float]:
    """Render a camera pose NOT in the training rig through the production
    ``Validator`` path and score PSNR against the rasterized GT at that
    pose (val_step protocol, trainer_generic.py:359-475).

    Returns (full-frame PSNR, object-masked PSNR).  The held-out rays are
    CLIPPED to the observable ball |p| < 0.8 (near / far of the view): the
    unobservable shell behind the rig's cameras would otherwise occlude the
    object at short schedules (the JAX example's docstring has the
    measurement)."""
    from one2345_tpu_torch.eval.render_harness import rasterize
    from one2345_tpu_torch.recon.validation import Validator

    a = np.radians(azimuth_deg)
    rz = np.array([
        [np.cos(a), -np.sin(a), 0, 0],
        [np.sin(a), np.cos(a), 0, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ], np.float32)
    c2w_h = rz @ pack["c2ws"][0]
    w2c_h = np.linalg.inv(c2w_h).astype(np.float32)

    pack_h = dict(pack)
    pack_h["c2ws"] = np.concatenate([c2w_h[None], pack["c2ws"][1:]])
    pack_h["w2cs"] = np.concatenate([w2c_h[None], pack["w2cs"][1:]])
    cam_dist = float(np.linalg.norm(c2w_h[:3, 3]))
    nf = np.array(pack["near_fars"], np.float32).copy()
    nf[0] = (max(cam_dist - OBS_RADIUS, 0.05), cam_dist + OBS_RADIUS)
    pack_h["near_fars"] = nf

    gt_rgb, gt_alpha = rasterize(gt_verts, gt_faces, gt_colors, pack["intrinsics"][0], w2c_h,
                                 res=res, shade=False, device=stage.device)
    out = Validator(stage).render_view(images_src, pack_h, view_idx=0, H=res, W=res, lod=lod)
    full = float(Validator.psnr(out["color"], gt_rgb))
    m = np.asarray(gt_alpha) > 0.5
    mse = float(np.mean((np.asarray(out["color"])[m] - gt_rgb[m]) ** 2))
    masked = float(-10.0 * np.log10(max(mse, 1e-10)))
    return full, masked


def _rig_tensors(images, alphas, pack, device) -> dict:
    """The supervision views and their cameras as tensors on the device."""
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return {"images": t(images), "masks": t(alphas), "Ks": t(pack["intrinsics"]),
            "c2ws": t(pack["c2ws"]), "w2cs": t(pack["w2cs"]), "affines": t(pack["affines"]),
            "near_fars": t(pack["near_fars"])}


def train_recon_loop(trainer, images, alphas, pack, steps: int, n_rays: int, seed: int,
                     log_every: int = 100, label: str = "step", draw_fn=None):
    """The JAX examples' recon training loop on the port's trainer: step i
    supervises n_rays foreground-weighted rays of rig view i % 33, the
    scene's source set being views 1..32 (the production 32-source
    contract).  Rays come from a generator seeded from ``stream_seed(seed,
    1)``, or from ``draw_fn(i)['idx']``; the rest of ``draw_fn(i)`` goes to
    the trainer (whose own generator takes ``seed``).
    Returns the logged (color losses, psnrs)."""
    from one2345_tpu_torch.geometry.rays import random_rays_from_image

    dev = trainer.device
    rig = _rig_tensors(images, alphas, pack, dev)
    scene_const = {k: rig[k][1:] for k in ("images", "affines", "w2cs")}
    scene_const["intrinsics"] = rig["Ks"][1:]
    gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1))
    n_views = rig["images"].shape[0]
    losses, psnrs = [], []
    for i in range(steps):
        v = i % n_views
        draws = dict(draw_fn(i)) if draw_fn is not None else {}
        rays = random_rays_from_image(gen, n_rays, rig["images"][v], rig["Ks"][v],
                                      rig["c2ws"][v], mask=rig["masks"][v],
                                      idx=draws.pop("idx", None))
        scene = dict(scene_const, near_far=rig["near_fars"][v], **rays)
        metrics = trainer.train_step(scene, draws or None)
        if i % log_every == 0 or i == steps - 1:
            c = float(metrics["color_loss"])
            p = float(metrics["psnr"])
            losses.append(c)
            psnrs.append(p)
            print(f"{label} {i:5d}  color_loss {c:.4f}  psnr {p:.2f}", flush=True)
            if not np.isfinite(c):
                raise RuntimeError(f"recon training diverged at step {i}")
    return losses, psnrs


def trained_stage(trainer):
    """A frozen ``ReconStage`` of the trainer's weights (running statistics
    included), as the JAX ``ReconStage(cfg, params=stage_variables(state))``."""
    from one2345_tpu_torch.recon.pipeline import ReconStage

    st = trainer.stage
    params = {k: m.state_dict() for k, m in st.modules().items()}
    return ReconStage(trainer.cfg, params=params, device=st.device)


def run_finetune_phase(
    stage, images, alphas, pack, ft_steps: int, n_rays: int,
    mesh_resolution: int, seed: int, gt_verts, gt_faces, surf_dist_fn,
    log_every: int = 100, draw_fn=None,
) -> dict:
    """Per-shape finetune on top of the trained stage (the reference's `-ft`
    mode): the conditional volume becomes the optimized parameter, the SDF
    MLP warm-starts from the stage, a fresh blending net learns per-view
    blending; the mesh is re-extracted from the finetuned field and scored
    again (geometry + blend-net colours).

    :param images: [33, res, res, 3] rig renders (view 0 = reference view)
    :param pack: normalized-frame camera pack (no scale/trans mats)
    :param draw_fn: optional step -> {'idx': ray indices}
    """
    from one2345_tpu_torch.eval.metrics import chamfer_distance, f_score, sample_surface
    from one2345_tpu_torch.geometry.rays import random_rays_from_image
    from one2345_tpu_torch.recon import mesh_extract
    from one2345_tpu_torch.recon.finetune import FinetuneTrainer, pixel_warp
    from one2345_tpu_torch.recon.pipeline import ReconStage

    t0 = time.perf_counter()
    dev = stage.device
    cfg = stage.config
    res = images.shape[1]
    rig = _rig_tensors(images, alphas, pack, dev)
    src_imgs, src_w2cs, src_intr = rig["images"][1:], rig["w2cs"][1:], rig["Ks"][1:]

    # the conditional volume at the trained weights (reconstruct()'s own
    # first two stages): the finetune optimizes THIS volume
    vol_out = stage.conditional_volume(stage.feature_maps(src_imgs), rig["affines"][1:])
    volume, mask_volume = vol_out["volume"], vol_out["mask"]

    ft = FinetuneTrainer(stage, lr=5e-4, seed=seed + 101)
    ft.init_state(volume, mask_volume)

    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    n_views = rig["images"].shape[0]
    losses = []
    for i in range(ft_steps):
        v = i % n_views
        idx = draw_fn(i).get("idx") if draw_fn is not None else None
        rays = random_rays_from_image(gen, n_rays, rig["images"][v], rig["Ks"][v],
                                      rig["c2ws"][v], mask=rig["masks"][v], idx=idx)
        scene = {
            "rays_o": rays["rays_o"], "rays_v": rays["rays_v"],
            "rays_color": rays["rays_color"], "near_far": rig["near_fars"][v],
            "images": src_imgs, "w2cs": src_w2cs, "intrinsics": src_intr,
        }
        metrics = ft.train_step(mask_volume, scene)
        if i % log_every == 0 or i == ft_steps - 1:
            c = float(metrics["color"])
            losses.append(c)
            print(f"ft step {i:5d}  color {c:.4f}  loss {float(metrics['loss']):.4f}",
                  flush=True)
            if not np.isfinite(c):
                raise RuntimeError(f"finetune diverged at step {i}")

    # mesh from the finetuned field: the stage's weights with the finetuned
    # sdf_layer, evaluated on the finetuned volume (ungated, as in JAX)
    params_ft = {k: m.state_dict() for k, m in stage.modules().items()}
    params_ft["sdf"] = dict(params_ft["sdf"], **{
        f"sdf_layer.{k}": t.detach() for k, t in ft.sdf_layer.state_dict().items()})
    stage_ft = ReconStage(cfg, params=params_ft, device=dev)
    with torch.no_grad():
        vol_ft = ft.volume.detach() * mask_volume
    u = stage_ft.field_grid(vol_ft, mesh_resolution).cpu().numpy()
    verts_grid, faces = mesh_extract.marching_tetrahedra(u, cfg.mesh_threshold)
    pv = mesh_extract.grid_to_world(verts_grid, (-1, -1, -1), (1, 1, 1), mesh_resolution)

    out = {
        "ft_steps": ft_steps,
        "ft_color_first": round(losses[0], 4),
        "ft_color_last": round(losses[-1], 4),
        "ft_pred_verts": int(len(pv)),
    }
    if len(pv) and len(faces):
        pp = sample_surface(pv, faces, SURFACE_POINTS, seed=0)
        gp = sample_surface(gt_verts, gt_faces, SURFACE_POINTS, seed=1)
        out["ft_chamfer_l1"] = round(
            float(chamfer_distance(pp, gp, squared=False, device=dev)), 5)
        out["ft_f_score_05"] = round(float(f_score(pp, gp, 0.05, device=dev)), 4)
        out["ft_f_score_10"] = round(float(f_score(pp, gp, 0.10, device=dev)), 4)
        obs = np.linalg.norm(pp, axis=1) < OBS_RADIUS
        out["ft_junk_frac"] = round(float(1.0 - obs.mean()), 4)
        if obs.sum() > 256:
            out["ft_chamfer_l1_obs"] = round(
                float(chamfer_distance(pp[obs], gp, squared=False, device=dev)), 5)
            out["ft_f_score_10_obs"] = round(float(f_score(pp[obs], gp, 0.10, device=dev)), 4)

        # colors through the FINETUNED blending net (validate_colored_mesh's
        # finetune branch): normals from the finetuned SDF, per-view pixel
        # colours warped onto the surface, blend weights from the net
        near = surf_dist_fn(pv) < 0.05
        if near.sum() > 100:
            pts_near = torch.as_tensor(pv[near], device=dev)
            cols = []
            for i in range(0, len(pts_near), 8192):
                pts = pts_near[i:i + 8192]
                _, feat, grads = ft.sdf_net.sdf_and_gradient(pts, vol_ft)
                with torch.no_grad():
                    nrm = grads / torch.sqrt((grads**2).sum(dim=-1, keepdim=True) + 1e-12)
                    pix_c, pix_m = pixel_warp(pts, src_imgs, src_w2cs, src_intr, (res, res))
                    cols.append(ft.blend_net(pts, nrm, nrm, feat, pix_c,
                                             pix_m.to(pix_c.dtype))[0])
            pc = torch.cat(cols).float().cpu().numpy()
            rn = np.linalg.norm(pv[near], axis=1, keepdims=True)
            want = 0.5 + 0.5 * pv[near] / np.maximum(rn, 1e-6)
            out["ft_color_mae"] = round(float(np.abs(pc - want).mean()), 4)
    out["ft_secs"] = round(time.perf_counter() - t0, 1)
    return out


def run_benchmark(
    steps: int = 1500,
    res: int = 128,
    vol: int = 48,
    n_rays: int = 512,
    n_samples: int = 48,
    n_importance: int = 48,
    lr: float = 1e-3,
    mesh_resolution: int = 128,
    seed: int = 0,
    log_every: int = 100,
    radius: float = 0.45,
    sphere_lat: int = 24,
    sphere_lon: int = 48,
    out_ply: str | None = None,
    ft_steps: int = 0,
    num_lods: int = 1,
    shape: str = "sphere",
    normal_query_prob: float = 0.0,
    device=None,
    draw_fn=None,
) -> dict:
    """:param draw_fn: optional step -> {'idx': ray indices, and the
        trainer's draws} of the recon training (the finetune draws its own)"""
    from one2345_tpu_torch.core.config import ReconConfig
    from one2345_tpu_torch.core.device import resolve_device
    from one2345_tpu_torch.eval.metrics import chamfer_distance, f_score, sample_surface
    from one2345_tpu_torch.recon.pipeline import ReconStage
    from one2345_tpu_torch.training.recon_trainer import ReconTrainer

    dev = resolve_device(device)
    t_all = time.perf_counter()
    if shape == "sphere":
        gt_verts, gt_faces, gt_colors = make_gt_sphere(sphere_lat, sphere_lon, radius)
        surf_dist_fn = lambda p: np.abs(np.linalg.norm(p, axis=1) - radius)  # noqa: E731
    elif shape == "box":
        gt_verts, gt_faces, gt_colors = make_gt_box()
        surf_dist_fn = box_surface_distance
    else:
        raise ValueError(f"unknown shape {shape!r}")
    pack = scaled_camera_pack(90.0, res)
    images, alphas = render_views(gt_verts, gt_faces, gt_colors, pack, res, device=dev)
    print(f"data: 33 x {res}^2 renders of a {len(gt_verts)}-vert {shape} "
          f"({time.perf_counter() - t_all:.1f}s)", flush=True)

    lod_extra = {}
    if num_lods > 1:
        # coarse-to-fine: fine lattice at 2x the coarse dims (the production
        # ratio is 96 -> 192), lod1 anneal scaled like lod0's
        if ft_steps:
            raise ValueError("the finetune phase is a lod0 flow: --ft-steps needs --lods 1")
        lod_extra = dict(
            num_lods=2,
            lod1_vol_dims=(2 * vol, 2 * vol, 2 * vol),
            lod1_voxel_size=2.0 / (2 * vol - 1),
            anneal_end_lod1=max(steps // 3, 1),
        )
    cfg = ReconConfig(
        image_hw=(res, res), vol_dims=(vol, vol, vol),
        voxel_size=2.0 / (vol - 1), n_rays=n_rays,
        n_samples=n_samples, n_importance=n_importance,
        learning_rate=lr, anneal_end=max(steps // 3, 1),
        end_iter=steps, mesh_resolution=mesh_resolution,
        # the reference gates its mask loss at 50k of 200k iters; scaled to
        # this schedule so background rays constrain floaters in the run
        fg_bg_gate_iter=max(steps // 10, 1),
        normal_query_prob=normal_query_prob,
        **lod_extra,
    )
    stage = ReconStage(cfg, seed=seed, device=dev)

    pack_nm = {k: v for k, v in pack.items() if k not in ("scale_mat", "trans_mat")}
    # random-init held-out renders FIRST: the novel-view gate is the
    # trained-minus-untrained OBJECT-MASKED margin, a mean over four
    # held-out azimuths (the JAX example explains the choice)
    fine_lod = 1 if num_lods > 1 else 0
    heldout_az = (22.5, 120.0, 200.0, 292.5)
    ho_rand = [held_out_view_psnr(
        stage, images[1:], pack_nm, gt_verts, gt_faces, gt_colors, res=res,
        azimuth_deg=az, lod=fine_lod,
    ) for az in heldout_az]
    psnr_heldout_random = float(np.mean([h[0] for h in ho_rand]))
    psnr_heldout_masked_random = float(np.mean([h[1] for h in ho_rand]))

    trainer = ReconTrainer(stage, cfg, seed=seed)
    t_train = time.perf_counter()
    losses, psnrs = train_recon_loop(trainer, images, alphas, pack, steps, n_rays, seed,
                                     log_every, draw_fn=draw_fn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_secs = time.perf_counter() - t_train

    # ---- production reconstruct() on the trained weights, in the
    # NORMALIZED frame (no scale/trans: pred and GT share coordinates)
    stage_trained = trained_stage(trainer)
    del trainer, stage
    recon = stage_trained.reconstruct(images[1:], pack_nm, resolution=mesh_resolution,
                                      out_path=out_ply)
    pv, pf, pc = recon["vertices"], recon["faces"], recon["colors"]
    print(f"reconstructed {len(pv)} verts / {len(pf)} faces", flush=True)

    out: dict = {
        "steps": steps, "res": res, "vol_dims": vol, "n_rays": n_rays,
        "num_lods": num_lods, "shape": shape,
        "normal_query_prob": normal_query_prob,
        "train_secs": round(train_secs, 1),
        "sec_per_step": round(train_secs / steps, 4),
        "psnr_first": round(psnrs[0], 2), "psnr_last": round(psnrs[-1], 2),
        "pred_verts": int(len(pv)),
    }
    if len(pv):
        # radius distribution of the predicted vertices (for the sphere:
        # p10/p50/p90 near `radius` = a clean surface)
        r_all = np.linalg.norm(pv, axis=1)
        out["pred_radius_p10"] = round(float(np.percentile(r_all, 10)), 4)
        out["pred_radius_p50"] = round(float(np.percentile(r_all, 50)), 4)
        out["pred_radius_p90"] = round(float(np.percentile(r_all, 90)), 4)
    if len(pv) and len(pf):
        # both meshes live in the normalized frame: ABSOLUTE distances
        pp = sample_surface(pv, pf, SURFACE_POINTS, seed=0)
        gp = sample_surface(gt_verts, gt_faces, SURFACE_POINTS, seed=1)
        out["chamfer_l1"] = round(float(chamfer_distance(pp, gp, squared=False, device=dev)), 5)
        out["chamfer_l2"] = round(float(chamfer_distance(pp, gp, squared=True, device=dev)), 6)
        out["f_score_05"] = round(float(f_score(pp, gp, 0.05, device=dev)), 4)
        out["f_score_10"] = round(float(f_score(pp, gp, 0.10, device=dev)), 4)
        # the observable region: the shell beyond the rig's cameras is
        # reached by no training ray (junk_frac measures what is left there)
        obs = np.linalg.norm(pp, axis=1) < OBS_RADIUS
        out["junk_frac"] = round(float(1.0 - obs.mean()), 4)
        if obs.sum() > 256:
            out["chamfer_l1_obs"] = round(
                float(chamfer_distance(pp[obs], gp, squared=False, device=dev)), 5)
            out["f_score_05_obs"] = round(float(f_score(pp[obs], gp, 0.05, device=dev)), 4)
            out["f_score_10_obs"] = round(float(f_score(pp[obs], gp, 0.10, device=dev)), 4)
        # colour agreement at predicted vertices near the GT surface with the
        # analytic field c(p) = 0.5 + 0.5 * p/|p|: the production blending
        # path, and the network-free best-view projection
        near = surf_dist_fn(pv) < 0.05
        if near.sum() > 100:
            rn = np.linalg.norm(pv[near], axis=1, keepdims=True)
            want = 0.5 + 0.5 * pv[near] / np.maximum(rn, 1e-6)
            out["color_mae"] = round(float(np.abs(pc[near] - want).mean()), 4)
            out["color_frac_scored"] = round(float(near.mean()), 3)
            vn = vertex_normals(pv, pf)
            oc = bestview_vertex_colors(
                pv[near], vn[near], images[1:],
                pack["w2cs"][1:], pack["intrinsics"][1:],
            )
            out["color_mae_bestview"] = round(float(np.abs(oc - want).mean()), 4)
        # novel-view generalization through the production Validator, paired
        # with the random-init renders of the same poses above
        ho_tr = [held_out_view_psnr(
            stage_trained, images[1:], pack_nm, gt_verts, gt_faces,
            gt_colors, res=res, azimuth_deg=az, lod=fine_lod,
        ) for az in heldout_az]
        out["psnr_heldout"] = round(float(np.mean([h[0] for h in ho_tr])), 2)
        out["psnr_heldout_masked"] = round(float(np.mean([h[1] for h in ho_tr])), 2)
        out["psnr_heldout_random"] = round(psnr_heldout_random, 2)
        out["psnr_heldout_masked_random"] = round(psnr_heldout_masked_random, 2)
        out["heldout_margin_min"] = round(float(min(
            t[1] - r[1] for t, r in zip(ho_tr, ho_rand))), 2)
    if ft_steps > 0:
        out.update(run_finetune_phase(
            stage_trained, images, alphas, pack_nm, ft_steps, n_rays,
            mesh_resolution, seed, gt_verts, gt_faces, surf_dist_fn,
            log_every,
        ))
    out["total_secs"] = round(time.perf_counter() - t_all, 1)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--vol", type=int, default=48)
    p.add_argument("--rays", type=int, default=512)
    p.add_argument("--json", default=None)
    p.add_argument("--ply", default=None, help="save the reconstructed mesh")
    p.add_argument("--ft-steps", type=int, default=0,
                   help="per-shape finetune steps after recon (0 = off)")
    p.add_argument("--lods", type=int, default=1, choices=(1, 2),
                   help="2 = coarse-to-fine (lod1) training + reconstruction")
    p.add_argument("--shape", default="sphere", choices=("sphere", "box"),
                   help="GT shape (box = asymmetric cuboid, breaks the sphere-init prior)")
    p.add_argument("--normal-query-prob", type=float, default=0.0,
                   help="fraction of training rays queried with surface normals "
                        "(ReconConfig.normal_query_prob)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    out = run_benchmark(steps=args.steps, res=args.res, vol=args.vol,
                        n_rays=args.rays, out_ply=args.ply,
                        ft_steps=args.ft_steps, num_lods=args.lods,
                        shape=args.shape, normal_query_prob=args.normal_query_prob,
                        device=args.device)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
