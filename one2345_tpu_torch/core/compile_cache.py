"""Where the port's compiled kernels persist across processes.

Counterpart of ``one2345_tpu/core/compile_cache.py``.  The port's compiled
artifacts are the nvcc builds of ``csrc/*.cu`` (``ops/_build.py``) and the
g++ builds of ``native/*.cpp`` (``native/build.py``): each library's name
carries a hash of its sources, so a directory of them serves every later
process that runs the same sources.  The directory is
``$ONE2345_COMPILE_CACHE`` in every process that has it set (the JAX
module's variable), else ``one2345_tpu_torch/_build/`` in the checkout, so
a fresh checkout builds from its own sources.  ``enable`` is the JAX
module's entry: it creates the directory, and pins one when given
``cache_dir``.  The entry points call it at start-up (``pipeline/cli.py``,
``training/train_zero123.py``, ``training/train_recon.py``,
``examples/torch_demo.py``).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "ONE2345_COMPILE_CACHE"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"

_dir: Path | None = None  # pinned by enable(cache_dir)


def enable(cache_dir: str | None = None) -> str:
    """Create the kernels' directory and return its path: ``cache_dir``,
    pinned for the rest of the process, else ``build_dir()``'s."""
    global _dir
    path = Path(cache_dir).resolve() if cache_dir else build_dir()
    path.mkdir(parents=True, exist_ok=True)
    if cache_dir:
        _dir = path
    return str(path)


def build_dir() -> Path:
    """The directory of the compiled kernels: ``enable``'s, else
    ``$ONE2345_COMPILE_CACHE``, else ``DEFAULT_DIR``."""
    return _dir or Path(os.environ.get(ENV) or DEFAULT_DIR).resolve()
