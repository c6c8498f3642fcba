"""Checkpoint conversion CLI: the reference's .ckpt / .pth files -> one
``core.checkpoint`` file of the port's parameter tree.

    python -m one2345_tpu_torch.utils.convert_cli \
        --zero123 zero123-xl.ckpt --sam sam_vit_h_4b8939.pth \
        --loftr indoor_ds_new.ckpt --recon ckpt_215000.pth \
        --safety safety_checker.bin --out params.pt

Counterpart of ``one2345_tpu/utils/convert_cli.py`` with the same flags.
The file it writes is the tree ``One2345Pipeline`` takes ('zero123',
'sam', 'loftr', 'recon', 'safety'): ``python -m
one2345_tpu_torch.pipeline.cli --params params.pt`` loads it.  The safety
entry holds the thresholds already scaled by 1.2 and ``threshold_scale``
1.0, as tensors: ``core.checkpoint.restore`` reads tensors and Python
scalars only.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> dict:
    """Convert every checkpoint named on the command line and save the
    tree to ``--out``; returns the tree."""
    p = argparse.ArgumentParser(description="Convert the reference's checkpoints to one "
                                            "parameter file of the port")
    p.add_argument("--zero123", type=str, default=None, help="zero123-xl.ckpt")
    p.add_argument("--sam", type=str, default=None, help="sam_vit_h_4b8939.pth")
    p.add_argument("--loftr", type=str, default=None, help="indoor_ds_new.ckpt")
    p.add_argument("--recon", type=str, default=None, help="ckpt_215000.pth")
    p.add_argument("--safety", type=str, default=None,
                   help="HF stable-diffusion-safety-checker state dict (.pt/.bin)")
    p.add_argument("--out", type=str, required=True, help="the parameter file to write")
    args = p.parse_args(argv)

    import torch

    from one2345_tpu_torch.core import checkpoint
    from one2345_tpu_torch.segmentation.safety import convert_safety_checker
    from one2345_tpu_torch.utils import convert_weights as cw

    def safety_entry(sd):
        checker = convert_safety_checker(sd)
        return {
            "concept_embeds": torch.from_numpy(checker.concept_embeds),
            "concept_thresholds": torch.from_numpy(checker.concept_thresholds),
            "special_embeds": torch.from_numpy(checker.special_embeds),
            "special_thresholds": torch.from_numpy(checker.special_thresholds),
            # the thresholds above are scaled already: load with scale 1
            "threshold_scale": 1.0,
        }

    jobs = (
        ("zero123", args.zero123, cw.load_torch_state_dict, cw.convert_zero123),
        ("sam", args.sam, cw.load_torch_state_dict, cw.convert_sam),
        ("loftr", args.loftr, cw.load_torch_state_dict, cw.convert_loftr),
        # a dict of per-network state dicts, read as it is
        ("recon", args.recon,
         lambda path: torch.load(path, map_location="cpu", weights_only=False),
         cw.convert_recon),
        ("safety", args.safety, cw.load_torch_state_dict, safety_entry),
    )
    tree = {}
    for name, path, load, convert in jobs:
        if not path:
            continue
        t0 = time.perf_counter()
        sd = load(path)
        t1 = time.perf_counter()
        tree[name] = convert(sd)
        t2 = time.perf_counter()
        del sd
        print(f"converted {name}: {path} ({os.path.getsize(path)} bytes): load {t1 - t0:.3f} s, "
              f"convert {t2 - t1:.3f} s", flush=True)
    if not tree:
        p.error("nothing to convert: pass at least one checkpoint path")

    t0 = time.perf_counter()
    checkpoint.save(args.out, tree)
    print(f"saved {sorted(tree)} -> {args.out} ({os.path.getsize(args.out)} bytes) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return tree


if __name__ == "__main__":
    main()
