"""Carry the JAX package's parameters over to the port.

``zero123_from_jax(params)`` takes ``one2345_tpu``'s ``Zero123Stage.params``
(nested dicts of arrays, keys 'unet', 'encoder', 'decoder', 'clip',
'cc_projection', each a flax variables dict) and returns one state dict per
module, which the port's modules load with ``strict=True``;
``trainable_from_jax`` does the same for the trainer's trainable tree, and
``recon_from_jax`` for ``ReconStage.params`` ('fusion', 'sdf', 'render',
'variance' and the lod1 trees), ``finetune_from_jax`` for the finetune's
blending net, ``loftr_from_jax`` for ``LoFTRMatcher.params`` and
``sam_from_jax`` for ``SamStage.params``.

The port names its submodules after the flax scopes, so the mapping is
mechanical:
- scope path 'a/b/c' -> 'a.b.c'; the auto-named 'GroupNorm_0' scope inside
  the norm wrappers is dropped;
- conv kernels HWIO -> OIHW and DHWIO -> OIDHW; Dense kernels (in, out) ->
  Linear weight (out, in); norm 'scale' -> 'weight';
- the int8 UNet's 'kernel_q' (int8, kept int8) is laid out as 'kernel' is
  and named 'weight_q'; its 'kernel_scale' (f32 [out]) becomes
  'weight_scale', so a JAX ``quantize_unet_params`` tree loads into
  ``UNetModel(quant=True)``;
- the 'batch_stats' collection: 'mean' -> 'running_mean', 'var' ->
  'running_var';
- flax ``ConvTranspose`` kernels (SAM's ``upscale_conv1/2``) apply without
  a flip, so as ``nn.ConvTranspose2d`` weights [I, O, kh, kw] both spatial
  axes are reversed (``sam_from_jax``);
- every other leaf keeps its name and layout: biases, free parameters (CLIP
  embeddings and 'proj', the CCProjection 'kernel' used as ``x @ kernel``,
  the blending net's 's', the variance scalar) and the weight-normalised
  layers' 'v' [in, out] and 'g'.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_NORM_SCOPE = re.compile(r"GroupNorm_\d+")
_STATS = {"mean": "running_mean", "var": "running_var"}
# flax conv kernels (spatial..., in, out) -> torch (out, in, spatial...)
_KERNEL_AXES = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def flax_to_state_dict(variables: Mapping, free=()) -> dict:
    """One flax variables dict ('params', and 'batch_stats' where the module
    has batch norms) -> a torch state dict.

    :param free: top-level leaf names kept as they are (no rename, no
        transpose)
    """
    out = {}
    leaves = [(path, leaf, False) for path, leaf in _flatten(variables.get("params", variables))]
    leaves += [(path, leaf, True) for path, leaf in _flatten(variables.get("batch_stats", {}))]
    for path, leaf, stat in leaves:
        scope = [p for p in path[:-1] if not _NORM_SCOPE.fullmatch(p)]
        name = path[-1]
        a = np.asarray(leaf, dtype=np.int8 if name == "kernel_q" else np.float32)
        if stat:
            name = _STATS[name]
        elif name in free and not scope:
            pass
        elif name in ("kernel", "kernel_q"):
            a = a.transpose(_KERNEL_AXES[a.ndim]) if a.ndim in _KERNEL_AXES else a.T
            name = name.replace("kernel", "weight")
        elif name == "kernel_scale":
            name = "weight_scale"
        elif name == "scale":
            name = "weight"
        out[".".join(scope + [name])] = torch.from_numpy(np.array(a, order="C"))
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
        "clip": clip_from_jax(params["clip"]),
    }


def clip_from_jax(variables: Mapping) -> dict:
    """JAX ``CLIPVisionTower`` variables -> the state dict of
    ``diffusion.clip.CLIPVisionTower`` (the stage's tower, the eval's
    ``ClipScorer``)."""
    return flax_to_state_dict(variables, free=("class_embedding", "positional_embedding", "proj"))


RECON_KEYS = ("fusion", "sdf", "render", "variance",
              "fusion_lod1", "sdf_lod1", "render_lod1", "variance_lod1")


def recon_from_jax(params: Mapping) -> dict:
    """JAX ``ReconStage.params`` -> the state dicts
    ``recon.pipeline.ReconStage`` loads: {'fusion', 'sdf', 'render',
    'variance'} and, where the tree has them (``num_lods=2``),
    {'fusion_lod1', 'sdf_lod1', 'render_lod1', 'variance_lod1'}.  A tree of
    the JAX trainer's params or gradients maps the same way."""
    return {name: flax_to_state_dict(params[name]) for name in RECON_KEYS if name in params}


def finetune_from_jax(blend_params: Mapping) -> dict:
    """The JAX ``FinetuneState.blend_params`` (``BlendingRenderingNetwork``
    variables) -> the state dict of ``recon.finetune.BlendingRenderingNetwork``
    (``FinetuneTrainer.init_state(blend_params=...)``).  A tree of its
    gradients maps the same way."""
    return flax_to_state_dict(blend_params)


def loftr_from_jax(params: Mapping) -> dict:
    """JAX ``LoFTRMatcher.params`` (the ``LoFTRModules`` variables: 'params'
    and 'batch_stats') -> the state dict ``elevation.loftr.LoFTRMatcher``
    loads."""
    return flax_to_state_dict(params)


def sam_from_jax(params: Mapping) -> dict:
    """JAX ``SamStage.params`` ({'encoder', 'decoder'} flax variables and
    'extra': {'pe_gaussian', 'box_embed'}) -> the state dict of
    ``segmentation.sam.SamModules``."""
    sd = {}
    for part in ("encoder", "decoder"):
        for key, value in flax_to_state_dict(params[part]).items():
            sd[f"{part}.{key}"] = value
    dec = params["decoder"].get("params", params["decoder"])
    for name in ("upscale_conv1", "upscale_conv2"):
        kernel = np.asarray(dec[name]["kernel"], np.float32)  # [kh, kw, I, O]
        sd[f"decoder.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]))
    for name in ("pe_gaussian", "box_embed"):
        sd[f"extra.{name}"] = torch.from_numpy(np.array(params["extra"][name], np.float32))
    return sd
