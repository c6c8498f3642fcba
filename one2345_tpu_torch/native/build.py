"""Build and bind the host C++ marching tetrahedra (``marching_tets.cpp``).

The source is a copy of ``one2345_tpu/native/marching_tets.cpp``.  At first
use it is compiled into ``one2345_tpu_torch/_build/`` under a name that
carries a hash of the source, so an edited source is never served from a
stale build:

    g++ -O3 -shared -fPIC -std=c++17 -o _build/libmarching_tets-<hash>.so marching_tets.cpp

A failed build raises: the mesh path has no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "marching_tets.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libmarching_tets-{digest}.so"


def build() -> Path:
    """Compile the library if it has no current build; raises on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {res.returncode}) for {SOURCE}:\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.marching_tetrahedra_cpp.restype = ctypes.c_int
        lib.marching_tetrahedra_cpp.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.free_mesh.restype = None
        lib.free_mesh.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def marching_tetrahedra_native(field: np.ndarray, threshold: float = 0.0):
    """(vertices [N, 3] f32 in grid-index coordinates, faces [M, 3] int32)
    of the ``field == threshold`` surface of an [X, Y, Z] field, every cube
    of the lattice scanned."""
    lib = load()
    f = np.ascontiguousarray(field, dtype=np.float32)
    if f.ndim != 3:
        raise ValueError(f"field must be [X, Y, Z], got shape {f.shape}")
    X, Y, Z = f.shape
    pv = ctypes.POINTER(ctypes.c_float)()
    pf = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.marching_tetrahedra_cpp(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), X, Y, Z, ctypes.c_float(threshold),
        ctypes.byref(pv), ctypes.byref(pf), ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"marching_tetrahedra_cpp returned {rc}")
    try:
        verts = (np.ctypeslib.as_array(pv, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(pf, shape=(nf.value, 3)).copy()
                 if nf.value else np.zeros((0, 3), np.int32))
    finally:
        lib.free_mesh(pv, pf)
    return verts, faces
