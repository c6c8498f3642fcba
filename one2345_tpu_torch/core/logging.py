"""Metrics and image artifacts of a training run.

Counterpart of ``one2345_tpu/core/logging.py``: one JSONL metrics stream
(``<log_dir>/<name>.jsonl``, one record per call: 'step', 'time' and the
scalars) and PNG dumps through the port's writer.  The JAX logger's
optional TensorBoard mirror is not kept (tensorboardX is not a dependency
of the port).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "metrics"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a", buffering=1)

    def log(self, step: int, **scalars) -> None:
        """Append one record; a value that is not a number is kept as its
        string."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._fh.write(json.dumps(rec) + "\n")

    def log_image(self, step: int, name: str, image) -> str:
        """Write a [H, W, 3] float image in [0, 1] as
        ``images/<name>_<step:08d>.png`` beside the metrics; returns its path."""
        from one2345_tpu_torch.utils.png import write_png

        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        path = os.path.join(img_dir, f"{name}_{step:08d}.png")
        write_png(path, np.clip(np.asarray(image) * 255, 0, 255).astype(np.uint8))
        return path

    def close(self):
        self._fh.close()
