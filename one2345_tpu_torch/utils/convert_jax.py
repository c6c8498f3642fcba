"""Carry the JAX package's Zero123 parameters over to the port.

``zero123_from_jax(params)`` takes ``one2345_tpu``'s ``Zero123Stage.params``
(nested dicts of arrays, keys 'unet', 'encoder', 'decoder', 'clip',
'cc_projection', each a flax variables dict) and returns one state dict per
module, which the port's modules load with ``strict=True``;
``trainable_from_jax`` does the same for the trainer's trainable tree.

The port names its submodules after the flax scopes, so the mapping is
mechanical:
- scope path 'a/b/c' -> 'a.b.c'; the auto-named 'GroupNorm_0' scope inside
  the norm wrappers is dropped;
- conv kernels HWIO -> OIHW; Dense kernels (in, out) -> Linear weight
  (out, in); norm 'scale' -> 'weight';
- free parameters (CLIP embeddings and 'proj', the CCProjection 'kernel'
  used as ``x @ kernel``) keep their name and layout.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_NORM_SCOPE = re.compile(r"GroupNorm_\d+")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def flax_to_state_dict(variables: Mapping, free=()) -> dict:
    """One flax variables dict -> a torch state dict.

    :param free: leaf names kept as they are (no rename, no transpose)
    """
    tree = variables.get("params", variables)
    out = {}
    for path, leaf in _flatten(tree):
        scope = [p for p in path[:-1] if not _NORM_SCOPE.fullmatch(p)]
        name = path[-1]
        a = np.asarray(leaf, dtype=np.float32)
        if name in free and not scope:
            pass
        elif name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight"
        elif name == "scale":
            name = "weight"
        out[".".join(scope + [name])] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def trainable_from_jax(tree: Mapping) -> dict:
    """The JAX trainer's trainable tree {'unet', 'cc_projection'} -> the
    state dicts ``training.zero123_trainer.Zero123Trainer`` takes.

    The mapping only renames and transposes, so a tree of gradients maps to
    the gradients of the mapped weights."""
    return {
        "unet": flax_to_state_dict(tree["unet"]),
        "cc_projection": flax_to_state_dict(tree["cc_projection"], free=("kernel", "bias")),
    }


def zero123_from_jax(params: Mapping) -> dict:
    """JAX ``Zero123Stage.params`` -> {module name: torch state dict}."""
    return {
        **trainable_from_jax(params),
        "encoder": flax_to_state_dict(params["encoder"]),
        "decoder": flax_to_state_dict(params["decoder"]),
        "clip": flax_to_state_dict(
            params["clip"], free=("class_embedding", "positional_embedding", "proj")
        ),
    }
