"""Triangle mesh container, vertex welding and binary PLY export
(counterpart of ``sdfstudio_tpu/utils/mesh_io.py:14-152``), numpy only.

The port's meshes carry vertices and faces; the reference's optional
per-vertex colours and normals, OBJ export and PLY reading are not ported.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # [V, 3] float
    faces: np.ndarray  # [F, 3] int

    def merge_close_vertices(self, digits: int = 6) -> "TriMesh":
        """Weld vertices equal after rounding to ``digits`` and drop the
        faces that become degenerate (mesh_io.py:21-42)."""
        if len(self.vertices) == 0:
            return self
        key = np.round(self.vertices, digits)
        _, idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
        verts = self.vertices[idx]
        faces = inv.reshape(-1)[self.faces]
        good = (
            (faces[:, 0] != faces[:, 1])
            & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2])
        )
        return TriMesh(verts, faces[good])

    def export(self, path) -> None:
        """Binary little-endian PLY (mesh_io.py:68-104): f32 vertices, and
        faces as a uchar count with three int32 indices."""
        V, F = len(self.vertices), len(self.faces)
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {V}",
                  "property float x", "property float y", "property float z",
                  f"element face {F}", "property list uchar int vertex_indices", "end_header"]
        face_dtype = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        farr = np.empty(F, dtype=face_dtype)
        farr["n"] = 3
        farr["idx"] = self.faces.astype("<i4")
        with open(Path(path), "wb") as f:
            f.write(("\n".join(header) + "\n").encode())
            f.write(self.vertices.astype("<f4").tobytes())
            f.write(farr.tobytes())


def concatenate(meshes: List[TriMesh]) -> TriMesh:
    """One mesh of ``meshes``, face indices offset (mesh_io.py:139-152)."""
    meshes = [m for m in meshes if len(m.vertices)]
    if not meshes:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    offsets = np.cumsum([0] + [len(m.vertices) for m in meshes[:-1]])
    verts = np.concatenate([m.vertices for m in meshes])
    faces = np.concatenate([m.faces + o for m, o in zip(meshes, offsets)])
    return TriMesh(verts, faces)
