"""One checkpoint format for the port: a nested tree of state dicts.

Counterpart of ``one2345_tpu/core/checkpoint.py``, which saves a pytree
with orbax; the port saves the tree (dicts of dicts of tensors, e.g.
``One2345Pipeline.save_params``'s {'zero123': {...}, 'recon': {...}, ...})
as one ``torch.save`` file and loads it back with ``weights_only=True``.
The JAX package's orbax directories are not read.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save(path: str, tree: Any) -> None:
    """Write ``tree`` to the file ``path`` (its directory is created)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(tree, path)


def restore(path: str, map_location="cpu") -> Any:
    """The tree ``save`` wrote, its tensors on ``map_location``."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)


def latest_step_dir(root: str, prefix: str = "step_") -> str | None:
    """The newest ``step_XXXXXX`` entry under ``root`` (the reference's
    latest-by-sort resume, exp_runner_generic_blender_val.py:135-149)."""
    if not os.path.isdir(root):
        return None
    steps = sorted(
        d for d in os.listdir(root) if d.startswith(prefix) and d[len(prefix):].isdigit()
    )
    return os.path.join(root, steps[-1]) if steps else None
