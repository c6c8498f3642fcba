"""Seeded weights, drawn on the card in one call per module.

The distributions are those of ``seeded_state_dict`` in ``chip_smoke.py``
(non-zero output convs, so that a comparison checks something):

- kernels N(0, 1 / fan_in): ``weight`` of rank >= 2 over its per-output
  size, ``proj`` / ``kernel`` (used as x @ w) over dim 0;
- norm scales (``weight`` of rank 1) 1 + N(0, 0.1^2);
- CLIP's ``class_embedding`` and ``positional_embedding`` N(0, 0.02^2);
- BN ``running_var`` 1 + U(0, 0.5); every other leaf N(0, 0.1^2).

Here every normal of one module comes from one ``torch.randn`` on the
device, split into its leaves in state-dict order, so the values differ
from ``chip_smoke.py``'s CPU draws; a (seed, module name) pair always gives
the same tensors on the same device, which is how the reference gets the
weights the program was built with.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def module_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for one module of one run's seed."""
    tag = [int(b) for b in name.encode()]
    return int(np.random.SeedSequence([int(seed), *tag]).generate_state(1, np.uint64)[0] >> 1)


def seeded_state_dict(shapes: dict, seed: int, name: str, device) -> dict:
    """{leaf: f32 tensor on ``device``} for the leaves of ``shapes`` ({leaf:
    shape}, a state dict's keys in order), seeded by (``seed``, ``name``)."""
    gen = torch.Generator(device=device).manual_seed(module_seed(seed, name))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (key, shape), x in zip(shapes.items(), torch.split(flat, sizes)):
        x = x.view(shape)
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("class_embedding", "positional_embedding"):
            x.mul_(0.02)
        elif leaf in ("proj", "kernel"):
            x.div_(math.sqrt(shape[0]))
        elif leaf == "weight" and len(shape) >= 2:
            x.div_(math.sqrt(math.prod(shape[1:])))
        elif leaf == "weight":
            x.mul_(0.1).add_(1.0)
        elif leaf == "running_var":
            x = 1.0 + 0.5 * torch.rand(shape, generator=gen, device=device)
        else:
            x.mul_(0.1)
        out[key] = x
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    """{leaf: shape} of a module's state dict (build it on the meta device)."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def sdf_mlp_state(shapes: dict, seed: int, name: str, device, prefix: str = "sdf_layer.",
                  d_latent: int = 16, bias: float = 0.5) -> dict:
    """The SDF MLP's leaves under ``prefix``: the geometric (IDR) init of
    ``LatentSDFLayer`` (a sphere of radius about ``bias``, so that the
    field has a surface), with its latent columns drawn N(0, 0.01^2) so
    that the cost volume moves the surface, as ``recon_params`` of
    ``chip_smoke.py`` seeds it.  Frozen copy of the init of
    ``one2345_tpu_torch/recon/sdf_network.py``."""
    gen = torch.Generator(device=device).manual_seed(module_seed(seed, name + ".sdf_mlp"))
    layers = sorted({k[len(prefix):].split(".")[0] for k in shapes if k.startswith(prefix)},
                    key=lambda s: int(s[3:]))
    out = {}
    last = layers[-1]
    for lname in layers:
        d_in, h = shapes[f"{prefix}{lname}.v"]
        v = torch.randn((d_in, h), generator=gen, device=device)
        lat = 0.01 * torch.randn((d_latent, h), generator=gen, device=device)
        b = torch.zeros(h, device=device)
        if lname == "lin0":
            v[3:] = 0.0
            v[:3] *= math.sqrt(2) / math.sqrt(h)
        elif lname == last:
            v = math.sqrt(math.pi) / math.sqrt(d_in) + 1e-4 * v
            v[-d_latent:] = lat
            b.fill_(-bias)
            b[-d_latent:] = 0.0
        else:
            v *= math.sqrt(2) / math.sqrt(h)
            v[-d_latent:] = lat
        out[f"{prefix}{lname}.v"] = v
        out[f"{prefix}{lname}.g"] = torch.linalg.vector_norm(v, dim=0)
        out[f"{prefix}{lname}.bias"] = b
    return out
