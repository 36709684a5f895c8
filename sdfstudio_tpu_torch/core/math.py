"""Math helpers (counterpart of ``sdfstudio_tpu/core/math.py``)."""
from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """L2-normalize along the last axis (core/math.py:117-119)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def searchsorted_right(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``searchsorted(a, v, side="right")`` (core/math.py:122-150).

    The JAX package counts ``a <= v`` because a vmapped binary search is a
    serial loop on the TPU; ``torch.searchsorted(right=True)`` is a batched
    binary search on either device and returns the same tie-inclusive
    indices. Returns int64 [..., M] in [0, N].
    """
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=True)
