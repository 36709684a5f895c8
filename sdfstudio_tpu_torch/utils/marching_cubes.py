"""Mesh extraction from an SDF (counterpart of
``sdfstudio_tpu/utils/marching_cubes.py:65-227``): the SDF on a dense grid,
evaluated on the model's device in chunks, then marching tetrahedra on the
host (``csrc/marching_tets.cc``, the same 6-tet decomposition and
edge-keyed vertex dedup as the JAX package's native path) and the vertex
weld of ``utils/mesh_io.py``.

The grid's points, their order and their f32 arithmetic are the
reference's: point ``(i, j, k)`` of a block lies at ``lo + (i, j, k) *
cell`` with ``cell = (hi - lo) / (resolution - 1)`` in f32, ``i`` slowest.
There is no numpy marching-tetrahedra fallback: without the host library
the extraction raises.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sdfstudio_tpu_torch.utils.host_build import marching_tets
from sdfstudio_tpu_torch.utils.mesh_io import TriMesh, concatenate

CHUNK = 131072  # points per SDF evaluation (marching_cubes.py:151)


@torch.no_grad()
def evaluate_sdf_grid(
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],  # [N, 3] -> [N]
    resolution: int,
    bounds_min: np.ndarray,
    bounds_max: np.ndarray,
    device,
    chunk: int = CHUNK,
) -> np.ndarray:
    """``sdf_fn`` on the ``resolution^3`` grid spanning the bounds, as a
    host f32 array [r, r, r] (marching_cubes.py:147-188). Points are made on
    ``device`` chunk by chunk and the values read back once."""
    lo = torch.as_tensor(np.asarray(bounds_min), dtype=torch.float32, device=device)
    hi = torch.as_tensor(np.asarray(bounds_max), dtype=torch.float32, device=device)
    cell = (hi - lo) / max(resolution - 1, 1)
    n = resolution**3
    vals = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, chunk):
        ids = torch.arange(start, min(start + chunk, n), device=device)
        ijk = torch.stack([ids // (resolution * resolution), (ids // resolution) % resolution,
                           ids % resolution], dim=-1)
        vals[start:start + len(ids)] = sdf_fn(lo + ijk.to(torch.float32) * cell)
    return vals.cpu().numpy().reshape(resolution, resolution, resolution)


def marching_tetrahedra(
    grid: np.ndarray,  # [Nx, Ny, Nz] sdf values
    level: float = 0.0,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> TriMesh:
    """The ``level`` surface of ``grid`` in world coordinates
    (marching_cubes.py:65-88, the native path: not welded here)."""
    grid = np.asarray(grid, np.float32)
    if min(grid.shape) < 2:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    verts, faces = marching_tets(grid, float(level), origin, spacing)
    return TriMesh(verts, faces)


def get_surface_sliding(
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    device,
    resolution: int = 512,
    bounding_box_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0),
    bounding_box_max: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    block_res: int = 256,
    level: float = 0.0,
    chunk: int = CHUNK,
    seconds: Optional[Dict[str, float]] = None,
) -> TriMesh:
    """The surface over the box in blocks of ``block_res`` cells that share
    their boundary planes, welded (marching_cubes.py:191-227). ``seconds``,
    when given, receives the time of each stage: ``grid`` (the SDF
    evaluation, read back included), ``marching_tets`` and ``merge``."""
    seconds = {} if seconds is None else seconds
    for k in ("grid", "marching_tets", "merge"):
        seconds[k] = 0.0
    if not (resolution % block_res == 0 or resolution <= block_res):
        raise ValueError(f"resolution {resolution} is not a multiple of block_res {block_res}")
    bmin = np.asarray(bounding_box_min, np.float32)
    bmax = np.asarray(bounding_box_max, np.float32)
    n_blocks = max(1, resolution // block_res)
    cell = (bmax - bmin) / (resolution - 1)
    meshes = []
    for bi in range(n_blocks):
        for bj in range(n_blocks):
            for bk in range(n_blocks):
                i0 = np.array([bi, bj, bk]) * block_res
                i1 = np.minimum(i0 + block_res, resolution - 1)
                res_block = (i1 - i0) + 1
                lo = bmin + i0 * cell
                hi = bmin + i1 * cell
                t0 = time.perf_counter()
                grid = evaluate_sdf_grid(sdf_fn, int(res_block[0]), lo, hi, device, chunk=chunk)
                t1 = time.perf_counter()
                spacing = (hi - lo) / np.maximum(res_block - 1, 1)
                mesh = marching_tetrahedra(grid, level, origin=lo, spacing=spacing)
                seconds["grid"] += t1 - t0
                seconds["marching_tets"] += time.perf_counter() - t1
                if len(mesh.vertices):
                    meshes.append(mesh)
    t0 = time.perf_counter()
    mesh = concatenate(meshes).merge_close_vertices()
    seconds["merge"] = time.perf_counter() - t0
    return mesh
