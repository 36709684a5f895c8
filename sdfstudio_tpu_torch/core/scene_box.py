"""Scene bounds (counterpart of ``sdfstudio_tpu/core/scene_box.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SceneBox:
    """Axis-aligned bounds + collider selection (scene_box.py:14-32)."""

    aabb: np.ndarray = field(
        default_factory=lambda: np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    )
    coarse_binary_grid: Optional[np.ndarray] = None
    """Coarse occupancy from the sparse SfM points, [c, c, c] bool (the
    heritage parser's; ``neusW`` and ``dto`` read it)."""
    near: Optional[float] = 0.1
    far: Optional[float] = 6.0
    radius: Optional[float] = 1.0
    collider_type: str = "box"  # box | near_far | sphere

    @staticmethod
    def get_normalized_positions(positions, aabb):
        """Positions -> [0, 1]^3 within ``aabb`` (scene_box.py:43-48)."""
        lengths = aabb[1] - aabb[0]
        return (positions - aabb[0]) / lengths
