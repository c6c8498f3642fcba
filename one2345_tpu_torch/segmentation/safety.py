"""Safety checker: a CLIP-embedding concept filter.

Counterpart of ``one2345_tpu/segmentation/safety.py`` (reference:
StableDiffusionSafetyChecker as init_model uses it, utils/zero123_utils.py:
49-55, and nsfw_check, demo/app.py:376-386): the cosine similarity of the
CLIP image embedding against learned concept embeddings and special-care
embeddings, every threshold scaled by 1.2 to reduce false positives.  It
runs on the host in numpy, as the JAX package's does.  Without weights the
checker flags nothing.  ``convert_safety_checker`` reads the embeddings of
the HF checkpoint (CompVis/stable-diffusion-safety-checker).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x):
    """An array or a tensor (e.g. from a ``core.checkpoint`` tree, which holds
    tensors only) as a numpy array; a tensor becomes float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return None if x is None else np.asarray(x)


class SafetyChecker:
    """:param concept_embeds, special_embeds: [C, 768] / [S, 768] arrays or
    tensors; :param concept_thresholds, special_thresholds: [C] / [S],
    multiplied by ``threshold_scale``"""

    def __init__(
        self,
        concept_embeds=None,
        concept_thresholds=None,
        special_embeds=None,
        special_thresholds=None,
        threshold_scale: float = 1.2,  # zero123_utils.py:54-55
    ):
        concept_thresholds, special_thresholds = _host(concept_thresholds), _host(special_thresholds)
        self.concept_embeds = _host(concept_embeds)
        self.concept_thresholds = (
            None if concept_thresholds is None else concept_thresholds * threshold_scale
        )
        self.special_embeds = _host(special_embeds)
        self.special_thresholds = (
            None if special_thresholds is None else special_thresholds * threshold_scale
        )

    @property
    def has_weights(self) -> bool:
        return self.concept_embeds is not None

    def check(self, image_embeds: np.ndarray) -> np.ndarray:
        """[B, 768] CLIP image embeddings -> [B] bool flagged."""
        if not self.has_weights:
            return np.zeros(image_embeds.shape[0], bool)

        def cos(a, b):
            a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12)
            b = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-12)
            return a @ b.T

        flagged = (cos(image_embeds, self.concept_embeds) > self.concept_thresholds[None]).any(axis=1)
        if self.special_embeds is not None:
            # any special-care hit flags, as the JAX checker does
            s = cos(image_embeds, self.special_embeds)
            flagged |= (s > self.special_thresholds[None]).any(axis=1)
        return flagged


def convert_safety_checker(sd) -> SafetyChecker:
    """The checker of an HF safety-checker state dict: its concept and
    special-care embeddings and their thresholds (scaled by 1.2)."""
    return SafetyChecker(
        concept_embeds=sd["concept_embeds"],
        concept_thresholds=sd["concept_embeds_weights"],
        special_embeds=sd["special_care_embeds"],
        special_thresholds=sd["special_care_embeds_weights"],
    )
