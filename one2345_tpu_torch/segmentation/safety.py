"""Safety checker: a CLIP-embedding concept filter.

Counterpart of ``one2345_tpu/segmentation/safety.py`` (reference:
StableDiffusionSafetyChecker as init_model uses it, utils/zero123_utils.py:
49-55, and nsfw_check, demo/app.py:376-386): the cosine similarity of the
CLIP image embedding against learned concept embeddings and special-care
embeddings, every threshold scaled by 1.2 to reduce false positives.  It
runs on the host in numpy, as the JAX package's does.  Without weights the
checker flags nothing.  Loading the HF checkpoint's embeddings
(``convert_safety_checker``) comes with the torch-checkpoint loader.
"""

from __future__ import annotations

import numpy as np


class SafetyChecker:
    def __init__(
        self,
        concept_embeds: np.ndarray | None = None,  # [C, 768]
        concept_thresholds: np.ndarray | None = None,  # [C]
        special_embeds: np.ndarray | None = None,  # [S, 768]
        special_thresholds: np.ndarray | None = None,  # [S]
        threshold_scale: float = 1.2,  # zero123_utils.py:54-55
    ):
        self.concept_embeds = concept_embeds
        self.concept_thresholds = (
            None if concept_thresholds is None else concept_thresholds * threshold_scale
        )
        self.special_embeds = special_embeds
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
