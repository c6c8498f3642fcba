"""Example: single image -> textured 3D mesh on the port (the reference's example.ipynb).

The twin of ``examples/demo.py`` for ``one2345_tpu_torch``.  Run on a host
with an NVIDIA card:

    python examples/torch_demo.py --img_path my_object.png --out_dir exp/demo \
        [--params params.pt]

``--params`` names a ``core.checkpoint`` file of the port
(``utils/convert_cli.py`` writes one from the reference's checkpoints);
without it the stages are seeded and SAM is off, as in the JAX demo.
Artifacts land in the reference-compatible layout:
    exp/demo/mesh.ply        vertex-colored mesh
    exp/demo/stage1_8/       8 first-stage views
    exp/demo/stage2_8/       32 second-stage views
    exp/demo/pose.json       camera rig (focal 280, near/far [0.5, 1.8])
"""

# allow `python examples/<name>.py` from the repo root without installing
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse

from one2345_tpu_torch.core.compile_cache import enable as enable_cache
from one2345_tpu_torch.core.config import PipelineConfig
from one2345_tpu_torch.pipeline.runner import One2345Pipeline
from one2345_tpu_torch.utils.png import read_png, to_rgba


def main(argv=None, device=None):
    """:param device: None -> the card (raises without CUDA)"""
    parser = argparse.ArgumentParser()
    parser.add_argument("--img_path", required=True)
    parser.add_argument("--out_dir", default="exp/demo")
    parser.add_argument("--mesh_resolution", type=int, default=256)
    parser.add_argument("--params", default=None, help="core.checkpoint file of stage params")
    args = parser.parse_args(argv)

    enable_cache()
    params = None
    if args.params:
        from one2345_tpu_torch.core import checkpoint

        params = checkpoint.restore(args.params)

    pipe = One2345Pipeline(PipelineConfig(), params, use_sam=params is not None, device=device)
    image = to_rgba(read_png(args.img_path))
    result = pipe.run(image, out_dir=args.out_dir, mesh_resolution=args.mesh_resolution)

    print(f"elevation: {result.elevation:.0f} deg")
    print(f"mesh: {result.mesh_path}  ({len(result.vertices)} verts)")
    for stage, secs in result.timings.items():
        print(f"  {stage:>14}: {secs:.2f}s")

    # evaluate against a ground-truth mesh, if you have one:
    #   from one2345_tpu_torch.recon.mesh_extract import load_ply
    #   from one2345_tpu_torch.eval.metrics import evaluate_mesh_pair
    #   gv, gf, _ = load_ply("gt.ply")
    #   print(evaluate_mesh_pair(result.vertices, result.faces, gv, gf))
    return result


if __name__ == "__main__":
    main()
