"""The sphere judge (counterpart of
``sdfstudio_tpu/scripts/benchmarking/eval_geometry.py::chamfer_l1_to_sphere``,
:27-55): Chamfer-L1 between a mesh's vertices and the analytic sphere of
``data/synthetic.py::generate_sphere_dataset``. The final evaluation takes
it for ``final_eval_gt="sphere"``. The script's own command line (a
checkpoint, a mesh, the judge) is not ported (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import numpy as np


def chamfer_l1_to_sphere(verts: np.ndarray, radius: float, center=None) -> dict:
    """accuracy: the mean of | |v| - r | over the vertices; completeness: the
    mean distance from 20,000 Fibonacci points on the sphere to their
    nearest vertex; chamfer_l1: the mean of the two."""
    center = np.zeros(3) if center is None else np.asarray(center)
    v = verts - center
    r = np.linalg.norm(v, axis=1)
    accuracy = float(np.abs(r - radius).mean())
    n = 20000
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    pts = radius * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1
    )
    from scipy.spatial import cKDTree

    d_min, _ = cKDTree(v).query(pts, k=1)
    completeness = float(np.asarray(d_min).mean())
    return {"accuracy": accuracy, "completeness": completeness,
            "chamfer_l1": 0.5 * (accuracy + completeness)}
