"""Scene contraction (counterpart of ``sdfstudio_tpu/ops/contraction.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def contract(x: torch.Tensor, order: Optional[float] = None, eps: float = 1e-12) -> torch.Tensor:
    """MipNeRF-360 contraction (contraction.py:17-38): identity for
    ||x|| <= 1, else (2 - 1/||x||) * x/||x||. ``order`` None or 2 is the L2
    norm, ``inf`` the L-inf norm that grid encodings use."""
    if order is None or order == 2:
        mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    elif order == math.inf:
        mag = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    else:
        mag = torch.sum(torch.abs(x) ** order, dim=-1, keepdim=True) ** (1.0 / order)
    safe_mag = torch.clamp(mag, min=eps)
    contracted = (2.0 - 1.0 / safe_mag) * (x / safe_mag)
    return torch.where(mag >= 1.0, contracted, x)
