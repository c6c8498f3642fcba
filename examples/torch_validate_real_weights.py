"""Real-weights validation runbook on the port: download -> convert -> golden run -> eval.

The twin of ``examples/validate_real_weights.py`` for ``one2345_tpu_torch``:
one command chains what it takes to hold the port to the reference's
published checkpoints, once they can be fetched or a directory of files
obtained elsewhere is at hand:

    python examples/torch_validate_real_weights.py --work exp/real_weights \
        [--ckpt_dir ckpts] [--img input.png] [--skip_download] [--dry_run]

Phases (each skipped when its output is already there):
  1. download the 4 published checkpoints (``utils/download_ckpt.py``);
     without network access it fails at once and says where to put files
  2. convert them into one parameter file of the port
     (``utils/convert_cli.py``), ``<work>/params.pt``; a sibling manifest
     records the checkpoint set, so a later run skips only a conversion of
     the same set
  3. golden pipeline run on a demo image (a synthetic one when the image
     is absent): the preprocessed input, the stage-1 and stage-2 grids and
     the mesh, for comparison with the reference's outputs
  4. eval sweep (CD / F-score) over the reference's example meshes, when a
     checkout of the reference is at ``reference/`` (skipped otherwise)
  5. fast-mode A/B: the same input and seed with dpmpp 30/25 and with
     dpmpp + int8, each scored against the golden run (mesh CD / F-score,
     stage-1 CLIP view similarity, seconds); with random weights the
     numbers check the protocol only, and the report says so

Exit code 0: every phase that could run succeeded.  Every phase runs on the
card unless ``main(argv, device="cpu")``.
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os
import sys
import time

import numpy as np

# a checkout of the reference repository beside the working directory
DEMO_IMG = "reference/demo/demo_examples/01_wild_hydrant.png"
REF_RENDER = "reference/render/examples"
# --ckpt_dir file -> convert_cli flag
CONVERT_FLAGS = (
    ("--zero123", "zero123-xl.ckpt"),
    ("--sam", "sam_vit_h_4b8939.pth"),
    ("--loftr", "indoor_ds_new.ckpt"),
    ("--recon", "ckpt_215000.pth"),
)


def phase_download(ckpt_dir: str, skip: bool) -> dict | None:
    """{name: path} of the checkpoints at hand after the phase, or None."""
    from one2345_tpu_torch.utils.download_ckpt import CKPTS, DownloadError, download_all

    have = {
        n: os.path.join(ckpt_dir, n)
        for n in CKPTS
        if os.path.isfile(os.path.join(ckpt_dir, n))
    }
    missing = sorted(set(CKPTS) - set(have))
    if not missing:
        print(f"[1/5] download: all 4 checkpoints present in {ckpt_dir}")
        return have
    if skip:
        print(f"[1/5] download skipped; missing {missing}")
        return have or None
    try:
        return download_all(ckpt_dir)
    except DownloadError as e:
        print(f"[1/5] download FAILED: {e}")
        print(f"      place the files in {ckpt_dir}/ and re-run.")
        return have or None


def manifest_path(params_path: str) -> str:
    """The manifest beside the parameter file: params.pt -> params.manifest.json."""
    return os.path.splitext(params_path)[0] + ".manifest.json"


def phase_convert(paths: dict, params_path: str) -> str | None:
    """Convert the checkpoints of ``paths`` into ``params_path``; returns it
    (None when there is nothing to convert)."""
    # skip only when an earlier conversion covered the SAME checkpoint set:
    # a partial tree (a file arrived later, or the conversion died) must not
    # hide the new files, or the golden run would validate seeded weights
    # for the missing stages
    manifest = manifest_path(params_path)
    want = sorted(paths)
    if os.path.isfile(manifest) and os.path.isfile(params_path):
        with open(manifest) as f:
            if json.load(f) == want:
                print(f"[2/5] convert: {params_path} already covers {want}")
                return params_path
        print("[2/5] convert: checkpoint set changed — reconverting")
    from one2345_tpu_torch.utils import convert_cli

    argv = ["--out", params_path]
    for flag, name in CONVERT_FLAGS:
        if name in paths:
            argv += [flag, paths[name]]
    if len(argv) == 2:
        print("[2/5] convert: no checkpoints to convert")
        return None
    convert_cli.main(argv)
    with open(manifest, "w") as f:
        json.dump(want, f)
    return params_path


def phase_golden_run(params_path: str | None, work: str, img_path: str | None, device=None):
    """Returns (ok, preprocessed_image, baseline_result, params)."""
    from examples.torch_walkthrough import synthetic_input, to_uint8
    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline
    from one2345_tpu_torch.utils.image import image_grid
    from one2345_tpu_torch.utils.png import read_png, to_rgba, write_png

    params = checkpoint.restore(params_path) if params_path else None
    if params is None:
        print("[3/5] golden run on RANDOM weights (no converted params) — "
              "timing/shape check only, outputs are not comparable")
    pipe = One2345Pipeline(PipelineConfig(), params, use_sam=True, device=device)

    out_dir = _ensure(os.path.join(work, "golden"))
    if img_path and os.path.isfile(img_path) and os.path.getsize(img_path) > 10_000:
        raw = to_rgba(read_png(img_path))
    else:
        print(f"[3/5] {img_path} unavailable — synthetic input")
        raw = synthetic_input()

    pre = pipe.preprocess(raw, safety_check=False)
    write_png(os.path.join(out_dir, "preprocessed.png"), to_uint8(pre))
    result = pipe.run(pre, out_dir=out_dir, skip_preprocess=True, seed=0)
    s1 = to_uint8(result.stage1_images)
    s2 = to_uint8(result.stage2_images).reshape(-1, *s1.shape[1:])
    write_png(os.path.join(out_dir, "stage1_grid.png"), image_grid(s1, 2, 4))
    write_png(os.path.join(out_dir, "stage2_grid.png"), image_grid(s2, 4, 8))
    print(
        f"[3/5] golden run OK: elevation={result.elevation:.1f} deg, "
        f"{len(result.vertices)} verts -> {out_dir}/ "
        f"(timings {json.dumps({k: round(v, 2) for k, v in result.timings.items()})})"
    )
    return True, pre, result, params


def phase_fast_mode_ab(params, work: str, pre: np.ndarray, baseline, make_config=None,
                       scorer=None, device=None) -> bool:
    """A/B the opt-in fast modes against the golden run.

    The same preprocessed input and seed; each mode runs the whole pipeline
    and is scored against the golden run's stage-1 views (CLIP view
    similarity) and mesh (CD / F-score).

    :param make_config: () -> PipelineConfig (tests pass a tiny one; the
        default is the full-size config)
    :param scorer: a ``ClipScorer`` (tests pass a tiny one); None -> the
        CLIP tower of the converted Zero123 weights, else a seeded one
    """
    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.eval.clip_metric import ClipScorer
    from one2345_tpu_torch.eval.metrics import evaluate_mesh_pair
    from one2345_tpu_torch.pipeline.cli import apply_fast_modes
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    make_config = make_config or PipelineConfig
    weights = "converted" if params is not None else "random"
    if scorer is None:
        clip_params = None
        if params is not None and "zero123" in params:
            clip_params = params["zero123"].get("clip")
        scorer = ClipScorer(clip_params, device=device)
    base_emb = scorer.embed(baseline.stage1_images.float().cpu().numpy())

    base_secs = round(sum(baseline.timings.values()), 3) if baseline.timings else None
    report = {"weights": weights, "baseline_secs": base_secs, "modes": {}}
    for mode, kw in (
        ("dpmpp", dict(sampler="dpmpp", quant="none")),
        ("dpmpp_int8", dict(sampler="dpmpp", quant="int8")),
    ):
        cfg = apply_fast_modes(make_config(), steps=None, **kw)
        pipe = One2345Pipeline(cfg, params, use_sam=False, device=device)
        out_dir = _ensure(os.path.join(work, "ab", mode))
        t0 = time.perf_counter()
        res = pipe.run(pre, out_dir=out_dir, skip_preprocess=True, seed=0)
        wall = time.perf_counter() - t0
        del pipe
        emb = scorer.embed(res.stage1_images.float().cpu().numpy())
        clip_sim = float(np.mean(np.sum(emb * base_emb, axis=-1)))
        mesh = evaluate_mesh_pair(res.vertices, res.faces, baseline.vertices, baseline.faces,
                                  device=device)
        # seconds on the golden run's basis: the run's own spans, without
        # the first call's one-off costs (kernel build, allocator warm-up)
        mode_secs = round(sum(res.timings.values()), 3) if res.timings else None
        report["modes"][mode] = {
            "secs": mode_secs,
            "first_run_wall_secs": round(wall, 3),
            "clip_sim_stage1_vs_baseline": round(clip_sim, 4),
            **{k: round(float(v), 5) for k, v in mesh.items()},
        }
        print(f"[5/5] {mode}: {json.dumps(report['modes'][mode])}")

    out = os.path.join(work, "fast_mode_ab.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    if weights == "random":
        print("[5/5] NOTE: random weights — the A/B above checks protocol "
              "and wiring only; quality numbers are meaningful only with "
              "converted checkpoints")
    print(f"[5/5] fast-mode A/B -> {out}")
    return True


def phase_eval_sweep(work: str, device=None) -> bool:
    gt = os.path.join(REF_RENDER, "objaverse")
    pred = os.path.join(REF_RENDER, "ours")
    if not (os.path.isdir(gt) and os.path.isdir(pred)):
        print("[4/5] eval sweep skipped: reference example meshes not mounted")
        return True
    from one2345_tpu_torch.eval.sweep import run_sweep

    table = run_sweep(pred, gt, device=device)
    out = os.path.join(work, "eval_sweep.json")
    with open(out, "w") as f:
        json.dump(table, f, indent=2)
    print(f"[4/5] eval sweep -> {out}: {json.dumps(table)[:300]}")
    return True


def _ensure(d):
    os.makedirs(d, exist_ok=True)
    return d


def main(argv=None, device=None):
    """:param device: of the pipeline phases; None -> the card"""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work", default="exp/real_weights")
    p.add_argument("--ckpt_dir", default=None, help="default <work>/ckpts")
    p.add_argument("--img", default=DEMO_IMG)
    p.add_argument("--skip_download", action="store_true")
    p.add_argument(
        "--dry_run", action="store_true",
        help="stop after the download/convert phases (no card required)",
    )
    args = p.parse_args(argv)

    work = _ensure(args.work)
    ckpt_dir = args.ckpt_dir or os.path.join(work, "ckpts")
    paths = phase_download(ckpt_dir, args.skip_download)
    params_path = phase_convert(paths, os.path.join(work, "params.pt")) if paths else None
    if args.dry_run:
        print("dry run: stopping before the pipeline phases")
        return 0
    ok, pre, baseline, params = phase_golden_run(params_path, work, args.img, device=device)
    ok = phase_eval_sweep(work, device=device) and ok
    ok = phase_fast_mode_ab(params, work, pre, baseline, device=device) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
