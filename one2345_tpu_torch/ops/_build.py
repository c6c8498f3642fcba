"""Build the package's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled on its own into ``<build dir>/lib<name>-<hash>.so``, where the build
directory is ``core.compile_cache.build_dir()`` (``one2345_tpu_torch/_build/``
unless ``compile_cache.enable`` chose another):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

The library name carries a hash of the source and of the shared headers
(``csrc/*.cuh``, included by the sources), so an edited kernel or header is
never served from a stale build.  ``build_all`` starts one nvcc per source,
all at once, and waits for them.  The compiler's ``-Xptxas -v`` report
(registers, shared memory, spills) is kept beside the library as
``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from one2345_tpu_torch.core import compile_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()  # two threads' first launches build once


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes: named by a hash of the
    source and of every shared header ``csrc/*.cuh``."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return compile_cache.build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every kernel in ``names`` that has no current build, one nvcc
    process per source, all started together.  Raises on a failed build."""
    out = {name: library_path(name) for name in names}
    for lib in out.values():
        lib.parent.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        lib = out[name]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOAD_LOCK:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            _loaded[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's report for the current build of ``name`` ('' if none kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
