"""The heritage-like scene's judge (counterpart of the parts of
``sdfstudio_tpu/data/synthetic_heritage.py`` that ``chamfer_l1_to_gt``
needs): the monument's analytic SDF (a gate of pillars, plinths, lintel
and crown with an arched opening and a masonry displacement, :63-82), the
ground smooth-unioned to it (:84-86), the parser's normalisation recomputed
from the scene's committed sparse model (:181-207), the surface samples
(Newton-projected SfM-like points, :210-229, :353-356) and Chamfer-L1 of a
mesh extracted in the normalised frame (:359-388).

The scene itself is committed (``.parity/heritage_like``): the generator is
not ported. numpy and scipy's ``cKDTree``.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Tuple

import numpy as np

from sdfstudio_tpu_torch.data.dataparsers.colmap_family import heritage_normalization
from sdfstudio_tpu_torch.data.utils import colmap_utils


def _length(v):
    return np.sqrt(np.sum(v * v, axis=-1) + 1e-12)


def _rbox(p, center, half, r):
    """Rounded-box SDF."""
    q = np.abs(p - np.asarray(center, dtype=p.dtype)) - np.asarray(half, dtype=p.dtype)
    outside = _length(np.maximum(q, 0.0))
    inside = np.minimum(np.maximum(q[..., 0], np.maximum(q[..., 1], q[..., 2])), 0.0)
    return outside + inside - r


def _smin(a, b, k):
    h = np.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b + (a - b) * h - k * h * (1.0 - h)


def _smax(a, b, k):
    return -_smin(-a, -b, k)


def monument_sdf(p: np.ndarray) -> np.ndarray:
    """The gate without the ground (synthetic_heritage.py:63-81)."""
    d = None
    for sx in (-2.2, 2.2):
        pillar = _rbox(p, (sx, 0.0, 2.5), (0.62, 0.62, 2.5), 0.06)
        plinth = _rbox(p, (sx, 0.0, 0.45), (0.95, 0.95, 0.45), 0.04)
        leg = _smin(pillar, plinth, 0.08)
        d = leg if d is None else _smin(d, leg, 0.05)
    lintel = _rbox(p, (0.0, 0.0, 5.45), (3.35, 0.85, 0.55), 0.06)
    crown = _rbox(p, (0.0, 0.0, 6.35), (1.1, 0.62, 0.42), 0.05)
    d = _smin(d, _smin(lintel, crown, 0.07), 0.06)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    arch = np.sqrt(x * x + (z - 4.4) ** 2 + 1e-12) - 1.35
    d = _smax(d, -arch, 0.08)
    disp = 0.02 * np.sin(7.1 * x) * np.sin(6.3 * y + 0.9) * np.sin(8.7 * z + 1.7)
    return d + disp


def gt_sdf(p: np.ndarray) -> np.ndarray:
    """The monument smooth-unioned with the ground plane z = 0 (:84-86)."""
    return _smin(monument_sdf(p), p[..., 2], 0.04)


def gt_normal(p: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    offs = np.eye(3) * eps
    n = np.stack([gt_sdf(p + offs[i]) - gt_sdf(p - offs[i]) for i in range(3)], axis=-1)
    return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)


def load_normalization(scene_dir: Path) -> Tuple[np.ndarray, float]:
    """(centre, radius) of the heritage parser's world -> normalised map,
    from the scene's committed ``sparse/points3D.txt`` (:194-207)."""
    pts = colmap_utils.read_points3d_text(Path(scene_dir) / "sparse" / "points3D.txt")
    xyz = np.stack([p.xyz for p in pts.values()])
    track = np.asarray([len(p.image_ids) for p in pts.values()])
    _, center, radius = heritage_normalization(xyz, track, 3, 0.05)
    return center, radius


def _sfm_points(rng: np.random.RandomState, n: int = 4000) -> np.ndarray:
    """Points near the monument and the plaza, Newton-projected to the
    zero level (:210-229)."""
    pts = np.concatenate([
        rng.uniform([-3.6, -1.2, 0.0], [3.6, 1.2, 7.2], size=(n * 6, 3)),
        rng.uniform([-6, -6, -0.1], [6, 6, 0.15], size=(n * 2, 3)),
    ])
    d = gt_sdf(pts)
    keep = np.abs(d) < 0.12
    pts, d = pts[keep], d[keep]
    for _ in range(4):
        pts = pts - d[..., None] * gt_normal(pts)
        d = gt_sdf(pts)
    pts = pts[np.abs(d) < 2e-3]
    if len(pts) > n:
        pts = pts[rng.choice(len(pts), n, replace=False)]
    return pts


@functools.lru_cache(maxsize=2)
def gt_surface_samples(n: int = 150_000, seed: int = 1) -> np.ndarray:
    """World-space samples of the monument and the near ground (:353-356),
    read-only: a pure function of its arguments that takes ~20 s of numpy at
    the judge's size, so a process computes it once."""
    pts = _sfm_points(np.random.RandomState(seed), n)
    pts.setflags(write=False)
    return pts


def chamfer_l1_to_gt(pred_verts_normalized: np.ndarray, scene_dir: Path,
                     crop_radius: float = 0.9) -> dict:
    """Chamfer-L1 of a mesh in the parser's normalised frame (:359-388):
    vertices within ``crop_radius`` of the origin; accuracy the mean
    |gt_sdf| at the vertices mapped back to the world, over the radius;
    completeness the mean distance from the cropped surface samples to the
    nearest vertex; both in normalised units."""
    from scipy.spatial import cKDTree

    center, radius = load_normalization(scene_dir)
    v_n = pred_verts_normalized
    v_n = v_n[np.linalg.norm(v_n, axis=1) < crop_radius]
    if len(v_n) == 0:
        return {"accuracy": np.inf, "completeness": np.inf, "chamfer_l1": np.inf}
    accuracy = float(np.abs(gt_sdf(v_n * radius + center)).mean() / radius)
    gt_n = (gt_surface_samples() - center) / radius
    gt_n = gt_n[np.linalg.norm(gt_n, axis=1) < crop_radius]
    d_min, _ = cKDTree(v_n).query(gt_n, k=1)
    completeness = float(np.asarray(d_min).mean())
    return {"accuracy": accuracy, "completeness": completeness,
            "chamfer_l1": 0.5 * (accuracy + completeness), "n_pred_cropped": int(len(v_n))}
