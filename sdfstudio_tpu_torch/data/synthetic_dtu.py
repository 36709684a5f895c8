"""Ground truth of the DTU-like parity scene and the Chamfer-L1 judge
(counterpart of ``sdfstudio_tpu/data/synthetic_dtu.py``: ``gt_sdf`` :39,
``gt_normal`` :74, ``gt_surface_samples`` :238, ``chamfer_l1_to_gt`` :258),
in numpy float64 with scipy's ``cKDTree`` for the nearest-vertex search, as
the reference does. The scene renderer is not ported: the parity scene is
committed (``.parity/dtu_like``) and never regenerated.

The object fits in ``|x| < 0.62``; the judge crops predicted vertices to
``r < crop_radius`` (default 0.75), the scene's analog of DTU's ObsMask.
"""
from __future__ import annotations

import numpy as np


def _smin(a, b, k):
    """Polynomial smooth min (quadratic)."""
    h = np.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b + (a - b) * h - k * h * (1.0 - h)


def _smax(a, b, k):
    return -_smin(-a, -b, k)


def gt_sdf(p: np.ndarray) -> np.ndarray:
    """Analytic scene SDF at points ``p`` [..., 3] (synthetic_dtu.py:39-71):
    a sphere with three blobs, a torus handle and a concavity, all smoothly
    blended, plus a low-amplitude trigonometric displacement."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = np.sqrt(np.sum(p * p, axis=-1) + 1e-12)
    d = r - 0.40
    for c, rad in (
        ((0.28, 0.10, 0.18), 0.16),
        ((-0.22, 0.24, -0.10), 0.19),
        ((0.02, -0.30, 0.24), 0.14),
    ):
        dc = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2 + 1e-12) - rad
        d = _smin(d, dc, 0.07)
    ty = y - 0.38
    q = np.sqrt(x * x + ty * ty + 1e-12) - 0.22
    dt = np.sqrt(q * q + z * z + 1e-12) - 0.055
    d = _smin(d, dt, 0.05)
    dc = np.sqrt((x + 0.42) ** 2 + y * y + (z - 0.05) ** 2 + 1e-12) - 0.22
    d = _smax(d, -dc, 0.06)
    disp = 0.012 * np.sin(19.0 * x) * np.sin(17.0 * y + 1.1) * np.sin(21.0 * z + 2.3)
    return d + disp


def gt_normal(p: np.ndarray, eps: float = 5e-4) -> np.ndarray:
    """Central-difference normals of ``gt_sdf`` (synthetic_dtu.py:74-80)."""
    offs = np.eye(3) * eps
    n = np.stack([gt_sdf(p + offs[i]) - gt_sdf(p - offs[i]) for i in range(3)], axis=-1)
    return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)


def gt_surface_samples(n: int = 200_000, seed: int = 0) -> np.ndarray:
    """About ``n`` points on the GT surface (synthetic_dtu.py:238-255):
    ``4 n`` uniform draws in the box from ``RandomState(seed)``, the ones
    within 0.08 of the surface projected along the normal four times, kept
    where |sdf| < 5e-4, then ``n`` chosen without replacement."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.7, 0.7, size=(n * 4, 3)).astype(np.float64)
    d = gt_sdf(pts)
    keep = np.abs(d) < 0.08
    pts, d = pts[keep], d[keep]
    for _ in range(4):
        nrm = gt_normal(pts)
        pts = pts - d[..., None] * nrm
        d = gt_sdf(pts)
    pts = pts[np.abs(d) < 5e-4]
    if len(pts) > n:
        pts = pts[rng.choice(len(pts), n, replace=False)]
    return pts


def chamfer_l1_to_gt(pred_verts: np.ndarray, crop_radius: float = 0.75) -> dict:
    """Chamfer-L1 between predicted mesh vertices and the GT surface
    (synthetic_dtu.py:258-285): accuracy is the mean |gt_sdf| at the cropped
    vertices (the SDF is near-metric at the surface), completeness the mean
    distance from the GT samples to their nearest cropped vertex."""
    from scipy.spatial import cKDTree

    v = pred_verts[np.linalg.norm(pred_verts, axis=1) < crop_radius]
    if len(v) == 0:
        return {"accuracy": np.inf, "completeness": np.inf, "chamfer_l1": np.inf}
    accuracy = float(np.abs(gt_sdf(v)).mean())
    d_min, _ = cKDTree(v).query(gt_surface_samples(), k=1)
    completeness = float(np.asarray(d_min).mean())
    return {
        "accuracy": accuracy,
        "completeness": completeness,
        "chamfer_l1": 0.5 * (accuracy + completeness),
        "n_pred_cropped": int(len(v)),
    }
