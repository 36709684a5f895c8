"""Shape validation at the layer boundaries the render path crosses.

Counterpart of ``sdfstudio_tpu/utils/checks.py`` (only what the render path
calls: ``check_ray_bundle``, ``check_ray_samples``, ``check_bins_weights``,
``check_weights_values``, ``check_sample_axis``, ``check_positions``). In
eager PyTorch a wrong shape usually raises by itself; these checks keep the
same contracts so a silently broadcast [R, 1, 3] against [R, S] cannot pass.
``SST_NO_CHECKS=1`` disables them, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

ENABLED = os.environ.get("SST_NO_CHECKS", "") != "1"


def assert_shape(x, spec: Sequence[Optional[int]], name: str = "array"):
    """``spec`` entries: int = exact, None = any (checks.py:23-36)."""
    if x is None or not ENABLED:
        return
    shape = tuple(x.shape)
    ok = len(shape) == len(spec) and all(s is None or s == d for s, d in zip(spec, shape))
    if not ok:
        raise ValueError(f"{name}: expected shape {tuple(spec)} (None=any), got {shape}")


def check_positions(x, name: str = "positions", dim: int = 3):
    """Float array with trailing dim ``dim`` (checks.py:48-62)."""
    if x is None or not ENABLED:
        return
    if x.ndim < 1 or x.shape[-1] != dim:
        raise ValueError(f"{name}: expected trailing dim {dim}, got shape {tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"{name}: expected float dtype, got {x.dtype}")


def check_bins_weights(bins, weights, name: str = "pdf_sampler"):
    """bins [R, N+1] must bracket weights [R, N] (checks.py:65-80)."""
    if bins is None or weights is None or not ENABLED:
        return
    if bins.ndim != 2 or weights.ndim != 2:
        raise ValueError(
            f"{name}: bins/weights must be rank-2 [R, .], got "
            f"{tuple(bins.shape)} / {tuple(weights.shape)}"
        )
    if bins.shape[0] != weights.shape[0] or bins.shape[1] != weights.shape[1] + 1:
        raise ValueError(
            f"{name}: expected bins [R, N+1] vs weights [R, N], got "
            f"{tuple(bins.shape)} vs {tuple(weights.shape)}"
        )


def check_weights_values(weights, values, name: str = "renderer"):
    """values [..., S, C] composited by weights [..., S] (checks.py:83-97)."""
    if weights is None or values is None or not ENABLED:
        return
    if values.ndim != weights.ndim + 1 or tuple(values.shape[:-1]) != tuple(weights.shape):
        raise ValueError(
            f"{name}: values must be weights-shape + channel ([..., S, C]); got "
            f"weights {tuple(weights.shape)} vs values {tuple(values.shape)}"
        )


def check_sample_axis(name: str = "renderer", **arrays):
    """All per-sample arrays ([..., S]) must agree exactly (checks.py:100-114)."""
    if not ENABLED:
        return
    items = [(k, v) for k, v in arrays.items() if v is not None]
    if not items:
        return
    ref_name, ref = items[0]
    for k, v in items[1:]:
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(
                f"{name}: {k} {tuple(v.shape)} does not match {ref_name} {tuple(ref.shape)}"
            )


def check_ray_bundle(rb):
    """checks.py:117-137."""
    if not ENABLED:
        return
    r = rb.origins.shape[0]
    assert_shape(rb.origins, (r, 3), "RayBundle.origins")
    assert_shape(rb.directions, (r, 3), "RayBundle.directions")
    assert_shape(rb.pixel_area, (r, 1), "RayBundle.pixel_area")
    assert_shape(rb.nears, (r, 1), "RayBundle.nears")
    assert_shape(rb.fars, (r, 1), "RayBundle.fars")
    assert_shape(rb.directions_norm, (r, 1), "RayBundle.directions_norm")
    if rb.camera_indices is not None:
        if tuple(rb.camera_indices.shape) not in ((r,), (r, 1)):
            raise ValueError(
                f"RayBundle.camera_indices: expected ({r},) or ({r}, 1), "
                f"got {tuple(rb.camera_indices.shape)}"
            )
        if rb.camera_indices.dtype.is_floating_point:
            raise ValueError(
                f"RayBundle.camera_indices must be integer, got {rb.camera_indices.dtype}"
            )


def check_ray_samples(rs):
    """checks.py:140-151."""
    if not ENABLED:
        return
    r, s = rs.starts.shape[0], rs.starts.shape[-1]
    assert_shape(rs.starts, (r, s), "RaySamples.starts")
    assert_shape(rs.ends, (r, s), "RaySamples.ends")
    assert_shape(rs.origins, (r, 3), "RaySamples.origins")
    assert_shape(rs.directions, (r, 3), "RaySamples.directions")
    assert_shape(rs.spacing_starts, (r, s), "RaySamples.spacing_starts")
    assert_shape(rs.spacing_ends, (r, s), "RaySamples.spacing_ends")
    assert_shape(rs.s_near, (r, 1), "RaySamples.s_near")
    assert_shape(rs.s_far, (r, 1), "RaySamples.s_far")
