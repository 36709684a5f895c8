"""Build and load the port's CUDA kernels: ``nvcc`` into a plain-C shared
library, loaded with ``ctypes``.

Every ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers they include) is
compiled for ``sm_90a`` by its own ``nvcc`` process, all started together,
and linked into ``_build/libsst_kernels.so``. The library is rebuilt when
the hash of the sources or flags changes, and built at first use, never at
import. No PyTorch header is compiled: a build takes about a minute, most
of it ptxas on the fused-MLP kernels' instantiations, where
``torch.utils.cpp_extension`` spends minutes on PyTorch's headers alone.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libsst_kernels.so"
STAMP_PATH = BUILD_DIR / "libsst_kernels.sha256"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None  # loaded once per process


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False, verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` unless it is up to date.
    Returns (library path, compiler output). ``verbose`` adds
    ``-Xptxas=-v`` (registers, shared memory and spills per kernel)."""
    digest = sources_hash()
    if (not force and LIB_PATH.exists() and STAMP_PATH.exists()
            and STAMP_PATH.read_text() == digest):
        return LIB_PATH, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas=-v"] if verbose else [])
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        jobs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = work / f"{src.stem}.o"
            proc = subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((src, obj, proc))
        log = []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = work / LIB_PATH.name
        link = subprocess.run(
            [nvcc, *flags, "-shared", *[str(o) for _, o, _ in jobs], "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(link.stdout)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, LIB_PATH)
        STAMP_PATH.write_text(digest)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return LIB_PATH, "".join(log)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sst_fused_mlp_fwd.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.sst_fused_mlp_fwd.restype = ci
    lib.sst_fused_mlp_fwd_workspace.argtypes = [vp, ci, vp]
    lib.sst_fused_mlp_fwd_workspace.restype = None
    for name in ("sst_fused_mlp_fwd_smem_limit", "sst_fused_mlp_fwd_max_layers",
                 "sst_fused_mlp_fwd_max_width", "sst_fused_mlp_bwd_smem_limit"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    lib.sst_fused_mlp_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.sst_fused_mlp_bwd.restype = ci
    lib.sst_fused_mlp_bwd_workspace.argtypes = [vp, ci, ci, ci, vp]
    lib.sst_fused_mlp_bwd_workspace.restype = None
    ll = ctypes.c_longlong
    for name in ("sst_row_gather_take", "sst_row_gather_loop"):
        getattr(lib, name).argtypes = [vp, vp, vp, ci, ci, ll, vp]
        getattr(lib, name).restype = ci
    lib.sst_row_gather_smem_limit.argtypes = []
    lib.sst_row_gather_smem_limit.restype = ci
    lib.sst_row_gather_take_rows.argtypes = [ci]
    lib.sst_row_gather_take_rows.restype = ci
    lib.sst_row_gather_loop_smem_bytes.argtypes = [ci, ci]
    lib.sst_row_gather_loop_smem_bytes.restype = ll
    ints, u32s = ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_uint32)
    lib.sst_hash_encode_fwd.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, ints, u32s, ints, ci, ci, vp]
    lib.sst_hash_encode_fwd.restype = ci
    lib.sst_hash_encode_bwd.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, ints, u32s, ints, ci, ci, vp]
    lib.sst_hash_encode_bwd.restype = ci
    lib.sst_hash_corner_rows.argtypes = [vp, vp, vp, vp, vp, ll, ll, ci, ci, ints, u32s, ints, ci, ci,
                                         vp]
    lib.sst_hash_corner_rows.restype = ci
    lib.sst_hash_segment_sum.argtypes = [vp, vp, vp, vp, ll, ll, ci, vp]
    lib.sst_hash_segment_sum.restype = ci
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, then load (once per process)."""
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = _bind(ctypes.CDLL(str(path)))
    return _lib
