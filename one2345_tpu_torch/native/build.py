"""Build and bind the host C++ of the port: the marching tetrahedra
(``marching_tets.cpp``, a copy of ``one2345_tpu/native/marching_tets.cpp``)
and the PNG row unfiltering (``png_unfilter.cpp``).

At first use each source is compiled into ``one2345_tpu_torch/_build/``
under a name that carries a hash of the source, so an edited source is
never served from a stale build:

    g++ -O3 -shared -fPIC -std=c++17 -o _build/lib<stem>-<hash>.so <stem>.cpp

A failed build raises: neither the mesh path nor the PNG reader has a
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "marching_tets.cpp"
PNG_SOURCE = SOURCE.with_name("png_unfilter.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()  # the server decodes PNGs on several threads


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile the library if it has no current build; raises on failure."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(
        ["g++", *GXX_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True
    )
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {res.returncode}) for {source}:\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


def _load(source: Path, bind) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
        return _libs[source]


def _bind_marching_tets(lib: ctypes.CDLL) -> None:
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


def _bind_png_unfilter(lib: ctypes.CDLL) -> None:
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.png_unfilter.restype = ctypes.c_int64
    lib.png_unfilter.argtypes = [u8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8]


def load() -> ctypes.CDLL:
    """The bound marching tetrahedra library, built first if needed."""
    return _load(SOURCE, _bind_marching_tets)


def png_unfilter_native(scanlines: np.ndarray, bpp: int) -> np.ndarray:
    """[h, 1 + stride] filtered PNG scanlines (a filter byte, then the row)
    -> [h, stride] uint8 rows; ``bpp`` is the bytes of one pixel (at least
    1).  Raises on a filter type other than 0-4."""
    lib = _load(PNG_SOURCE, _bind_png_unfilter)
    raw = np.ascontiguousarray(scanlines, dtype=np.uint8)
    if raw.ndim != 2 or raw.shape[1] < 1:
        raise ValueError(f"scanlines must be [h, 1 + stride], got shape {raw.shape}")
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bad = lib.png_unfilter(raw.ctypes.data_as(u8), h, stride, max(1, int(bpp)),
                           out.ctypes.data_as(u8))
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type {raw[bad - 1, 0]}")
    return out


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
