"""Eval sweep CLI: directories of (predicted, GT) meshes -> a JSON table of
Chamfer distance and F-score (and, with ``--clip_params``, CLIP view
similarity).

Counterpart of ``one2345_tpu/eval/sweep.py`` (the GSO / Objaverse protocol
runner the reference lacks; it ships only the Blender render harness,
render/launch_render_eval.py:19-43).  Meshes are paired by stem, ignoring
``_ours`` / ``_gt`` / ``_pred`` / ``_gen`` suffixes (the reference's
example pair render/examples/{ours/backpack_ours.obj,
objaverse/backpack_gt.glb}).

    python -m one2345_tpu_torch.eval.sweep --pred_dir exp/preds --gt_dir data/gso \
        [--out results.json] [--n_points 16384] [--threshold 0.05] \
        [--render_dir renders/] [--clip_params [params.pt]]

``--render_dir`` also writes each prediction's 24 eval renders as PNGs;
``--clip_params`` reads the CLIP tower from a ``core/checkpoint.py`` tree
(its 'clip' or 'zero123/clip' entry; the bare flag: a seeded tower, a
protocol check only).  Metrics, renders and CLIP run on the card.  Unlike
the JAX sweep, ``load_mesh`` reads a .ply's 8-bit colours as [0, 1].
"""

from __future__ import annotations

import json
import os

import numpy as np

MESH_EXTS = (".ply", ".obj", ".glb")
_SUFFIXES = ("_ours", "_gt", "_pred", "_gen")


def load_obj(path: str):
    """Minimal OBJ reader: ``v`` (optionally with vertex colours) and ``f``
    (v, v/vt, v/vt/vn or v//vn; polygons fanned into triangles)."""
    verts, colors, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
    c = np.asarray(colors, np.float32) if len(colors) == len(verts) else None
    return v, f, c


def load_mesh(path: str):
    """(verts [N, 3] f32, faces [M, 3] int32, colors [N, 3] f32 in [0, 1] or
    None) of a .ply, .obj or .glb.  A PLY's uint8 colours are scaled by
    1/255, as the .glb reader scales integer colours; the JAX sweep keeps
    them 0-255, so its renders of a .ply saturate (a deliberate divergence)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        from one2345_tpu_torch.recon.mesh_extract import load_ply

        v, f, c = load_ply(path)
        if c is not None:
            c = c.astype(np.float32) / np.float32(255)
    elif ext == ".obj":
        v, f, c = load_obj(path)
    elif ext == ".glb":
        from one2345_tpu_torch.recon.gltf import load_glb

        v, f, c = load_glb(path)
    else:
        raise ValueError(f"unsupported mesh format: {path}")
    return (np.asarray(v, np.float32), np.asarray(f, np.int32),
            None if c is None else np.asarray(c, np.float32))


def _stem(name: str) -> str:
    s = os.path.splitext(name)[0]
    for suf in _SUFFIXES:
        if s.endswith(suf):
            s = s[: -len(suf)]
    return s


def discover_pairs(pred_dir: str, gt_dir: str) -> list[tuple[str, str, str]]:
    """[(key, pred_path, gt_path)] matched by suffix-stripped stem."""

    def index(d):
        out = {}
        for root, _, files in os.walk(d):
            for f in sorted(files):
                if f.lower().endswith(MESH_EXTS):
                    out.setdefault(_stem(f), os.path.join(root, f))
        return out

    preds, gts = index(pred_dir), index(gt_dir)
    return [(k, preds[k], gts[k]) for k in sorted(preds) if k in gts]


def run_sweep(pred_dir: str, gt_dir: str, n_points: int = 16384, threshold: float = 0.05,
              render_dir: str | None = None, clip_scorer=None, device=None) -> dict:
    """The table of every pair: {'n_pairs', 'threshold', 'n_points',
    'summary' (the means), 'per_mesh' [{'name', 'pred', 'gt', metrics}]}.

    :param clip_scorer: optional ``eval.clip_metric.ClipScorer``: adds
        'clip_sim', the 24-view CLIP similarity with vertex colours
    :param device: of the metrics and the renders; None -> 'cuda'
    """
    from one2345_tpu_torch.eval.metrics import evaluate_mesh_pair
    from one2345_tpu_torch.eval.render_harness import render_eval_views

    rows = []
    for key, ppath, gpath in discover_pairs(pred_dir, gt_dir):
        pv, pf, pc = load_mesh(ppath)
        gv, gf, gc = load_mesh(gpath)
        m = evaluate_mesh_pair(pv, pf, gv, gf, n_points=n_points, fscore_threshold=threshold,
                               device=device)
        # the prediction's 24 views are rendered once, for CLIP and --render_dir
        pred_views = None
        if clip_scorer is not None or render_dir:
            pred_views = render_eval_views(pv, pf, pc, device=device)
        if clip_scorer is not None:
            gt_views = render_eval_views(gv, gf, gc, device=device)
            m["clip_sim"] = clip_scorer.similarity_from_renders(pred_views, gt_views)
        rows.append({"name": key, "pred": ppath, "gt": gpath, **m})
        if render_dir:
            _save_renders(key, pred_views, render_dir)
    summary = {}
    if rows:
        metrics = ["chamfer_l2", "chamfer_l1", "f_score"]
        if clip_scorer is not None:
            metrics.append("clip_sim")
        for metric in metrics:
            summary[metric] = float(np.mean([r[metric] for r in rows]))
    return {"n_pairs": len(rows), "threshold": threshold, "n_points": n_points,
            "summary": summary, "per_mesh": rows}


def _save_renders(key: str, views, render_dir: str):
    from one2345_tpu_torch.utils.png import write_png

    out = os.path.join(render_dir, key)
    os.makedirs(out, exist_ok=True)
    for i, v in enumerate(views):
        write_png(os.path.join(out, f"{i:03d}.png"), (np.clip(v, 0, 1) * 255).astype(np.uint8))


def clip_config():
    """The scorer's tower: the stage's ViT-L/14 (``CLIPVisionConfig()``)."""
    from one2345_tpu_torch.core.config import CLIPVisionConfig

    return CLIPVisionConfig()


def main(argv=None, device=None):
    """Run the sweep, print (and with ``--out`` write) its JSON table;
    ``device`` None -> the card (raises without CUDA)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--out", default=None, help="write the JSON table here")
    p.add_argument("--n_points", type=int, default=16384)
    p.add_argument("--threshold", type=float, default=0.05)
    p.add_argument("--render_dir", default=None, help="save 24-view eval renders per prediction")
    p.add_argument("--clip_params", default=None, nargs="?", const="",
                   help="add the 24-view CLIP-similarity metric; a core/checkpoint.py tree "
                        "with a 'clip' (or 'zero123/clip') entry for real ViT-L/14 weights "
                        "(bare flag = a seeded tower, protocol check only)")
    args = p.parse_args(argv)

    from one2345_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    clip_scorer = None
    if args.clip_params is not None:
        from one2345_tpu_torch.eval.clip_metric import ClipScorer

        params = None
        if args.clip_params:
            from one2345_tpu_torch.core import checkpoint

            tree = checkpoint.restore(args.clip_params)
            params = tree.get("zero123", tree).get("clip")
            if params is None:
                # a real-checkpoint run must not fall back to the seeded
                # tower: only the bare flag means a protocol check
                raise SystemExit(
                    f"--clip_params {args.clip_params}: the tree has no 'clip' (or "
                    "'zero123/clip') entry; pass a checkpoint with the CLIP tower, or the "
                    "bare flag for a seeded tower"
                )
        clip_scorer = ClipScorer(params, config=clip_config(), device=dev)

    table = run_sweep(args.pred_dir, args.gt_dir, args.n_points, args.threshold,
                      args.render_dir, clip_scorer=clip_scorer, device=dev)
    text = json.dumps(table, indent=2)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return table


if __name__ == "__main__":
    main()
