"""The serving cells' inputs: raw 512^2 RGB photos of an object on white.

The idea of ``raw_inputs`` in ``examples/torch_throughput_probe.py`` (a
textured object on a white 512^2 canvas), except that every (seed,
request) pair draws its own image: a request never repeats an earlier
one, so SAM's memo of the last encoded image never serves a request.
"""

from __future__ import annotations

import numpy as np


def raw_image(seed: int, request: int, size: int = 512) -> np.ndarray:
    """[size, size, 3] uint8: a shaded, textured ellipse at a random place,
    size and angle on white, drawn from (``seed``, ``request``)."""
    rng = np.random.default_rng([int(seed), int(request)])
    yy, xx = np.mgrid[:size, :size].astype(np.float32) / size
    cy, cx = rng.uniform(0.35, 0.65, 2)
    ay, ax = rng.uniform(0.15, 0.3, 2)
    th = rng.uniform(0.0, np.pi)
    dy, dx = yy - cy, xx - cx
    u = (dx * np.cos(th) + dy * np.sin(th)) / ax
    v = (-dx * np.sin(th) + dy * np.cos(th)) / ay
    inside = u * u + v * v < 1.0
    base = rng.uniform(40, 200, 3).astype(np.float32)
    grad = rng.uniform(-60, 60, (2, 3)).astype(np.float32)
    tex = base + u[..., None] * grad[0] + v[..., None] * grad[1]
    tex += rng.normal(0.0, 12.0, (size, size, 3)).astype(np.float32)
    img = np.full((size, size, 3), 255, np.uint8)
    img[inside] = np.clip(tex[inside], 0, 250).astype(np.uint8)
    return img
