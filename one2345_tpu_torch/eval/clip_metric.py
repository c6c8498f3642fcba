"""CLIP view similarity, the paper's third metric (arXiv 2306.16928).

Counterpart of ``one2345_tpu/eval/clip_metric.py``: the prediction and the
GT are rendered through the 24-view protocol (``render_harness``), every
view is embedded by the CLIP ViT-L/14 image tower of the diffusion stage
(``diffusion/clip.py``, so the stage's weights apply), and the cosine
similarities of matched views are averaged.  The tower runs on the card,
in the config's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from one2345_tpu_torch.core.config import CLIPVisionConfig
from one2345_tpu_torch.core.device import resolve_device


class ClipScorer:
    """Embeds image batches with the CLIP tower and scores mesh pairs.

    :param params: a ``CLIPVisionTower`` state dict (e.g. the 'clip' entry
        of ``One2345Pipeline.save_params``'s 'zero123' tree, or
        ``utils.convert_jax.clip_from_jax``), loaded with ``strict=True``;
        None -> a tower seeded from ``seed``: the protocol runs, the
        absolute numbers mean nothing
    :param device: None -> 'cuda' (raises without CUDA)
    """

    def __init__(self, params=None, config: CLIPVisionConfig | None = None, seed: int = 0,
                 device=None):
        from one2345_tpu_torch.diffusion.clip import CLIPVisionTower
        from one2345_tpu_torch.diffusion.unet import cast_compute

        self.config = c = config or CLIPVisionConfig()
        self.device = resolve_device(device)
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda), self.device:
            torch.manual_seed(seed)
            self.tower = CLIPVisionTower(image_size=c.image_size, patch_size=c.patch_size,
                                         width=c.width, layers=c.layers, heads=c.heads,
                                         embed_dim=c.embed_dim)
        if params is not None:
            self.tower.load_state_dict(params, strict=True)
        self.tower.requires_grad_(False).eval()
        cast_compute(self.tower, torch.bfloat16 if c.dtype == "bfloat16" else torch.float32)

    @torch.inference_mode()
    def embed(self, images: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] float in [0, 1] -> [N, D] L2-normalised embeddings."""
        from one2345_tpu_torch.diffusion.clip import preprocess_for_clip

        x = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=self.device)
        emb = self.tower(preprocess_for_clip(x * 2.0 - 1.0, self.config.image_size))
        emb = emb.float().cpu().numpy()
        return emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-8)

    def similarity_from_renders(self, pred: np.ndarray, gt: np.ndarray) -> float:
        """Mean cosine similarity of matched views ([V, H, W, 3] each)."""
        if pred.shape[0] != gt.shape[0]:
            raise ValueError(f"{pred.shape[0]} predicted views, {gt.shape[0]} GT views")
        ep, eg = self.embed(pred), self.embed(gt)
        return float(np.mean(np.sum(ep * eg, axis=-1)))

    def similarity(self, pred_mesh, gt_mesh, res: int = 224) -> float:
        """The 24-view similarity of two (verts, faces[, colors]) meshes,
        rendered on the scorer's device."""
        from one2345_tpu_torch.eval.render_harness import render_eval_views

        def renders(mesh):
            c = mesh[2] if len(mesh) > 2 and mesh[2] is not None else None
            return render_eval_views(mesh[0], mesh[1], c, res=res, device=self.device)

        return self.similarity_from_renders(renders(pred_mesh), renders(gt_mesh))
