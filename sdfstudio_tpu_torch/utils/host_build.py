"""Build and load the port's host C++ library, ``csrc/marching_tets.cc``:
``g++ -O3 -shared -fPIC`` into ``_build/libsst_marching_tets.so``, bound
with ``ctypes`` (the JAX package's loader is
``sdfstudio_tpu/native/__init__.py:30-54``).

The library is rebuilt when the hash of its source and flags changes, and
built at first use, never at import. There is no fallback: a failed build
or load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from sdfstudio_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "marching_tets.cc"
LIB_PATH = BUILD_DIR / "libsst_marching_tets.so"
STAMP_PATH = BUILD_DIR / "libsst_marching_tets.sha256"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None  # loaded once per process


def build(force: bool = False) -> None:
    """Compile ``SOURCE`` into ``LIB_PATH`` unless it is up to date. Raises
    when g++ is missing or fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()
    if (not force and LIB_PATH.exists() and STAMP_PATH.exists()
            and STAMP_PATH.read_text() == digest):
        return
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the marching-tetrahedra library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="host-build-", dir=BUILD_DIR)
    try:
        tmp = os.path.join(work, LIB_PATH.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}")
        os.replace(tmp, LIB_PATH)  # atomic: concurrent builds each install a whole library
        STAMP_PATH.write_text(digest)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """Build if needed, then load (once per process)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        i64 = ctypes.c_int64
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(i64)
        lib.sst_free.argtypes = [ctypes.c_void_p]
        lib.sst_free.restype = None
        lib.sst_marching_tets.argtypes = [
            f32p, i64, i64, i64, ctypes.c_float, f32p, f32p,
            ctypes.POINTER(f32p), i64p, ctypes.POINTER(i64p), i64p,
        ]
        lib.sst_marching_tets.restype = ctypes.c_int
        _lib = lib
    return _lib


def marching_tets(grid: np.ndarray, level: float, origin, spacing) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices [V, 3] f32, faces [F, 3] int64) of the ``level`` surface of
    ``grid`` [nx, ny, nz], vertices at ``origin + index * spacing``."""
    lib = load_library()
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be [nx, ny, nz], got shape {grid.shape}")
    o = np.ascontiguousarray(origin, np.float32).reshape(3)
    s = np.ascontiguousarray(spacing, np.float32).reshape(3)
    f32p = ctypes.POINTER(ctypes.c_float)
    pverts, pfaces = f32p(), ctypes.POINTER(ctypes.c_int64)()
    nv, nf = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.sst_marching_tets(
        grid.ctypes.data_as(f32p), *grid.shape, ctypes.c_float(level), o.ctypes.data_as(f32p),
        s.ctypes.data_as(f32p), ctypes.byref(pverts), ctypes.byref(nv), ctypes.byref(pfaces),
        ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"sst_marching_tets returned {rc}")
    verts, faces = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    if nv.value:
        verts = np.ctypeslib.as_array(pverts, shape=(nv.value, 3)).copy()
        lib.sst_free(pverts)
    if nf.value:
        faces = np.ctypeslib.as_array(pfaces, shape=(nf.value, 3)).copy()
        lib.sst_free(pfaces)
    return verts, faces
