"""Dense segment-sum (counterpart of ``sdfstudio_tpu/ops/scatter.py``).

The JAX package builds ``sorted_segment_add`` from a merged sort and a
cumsum because scatter-add is slow on a TPU. On the card the same function
is one ``index_add_`` in f32; the sort construction is not ported.
"""
from __future__ import annotations

import torch


def sorted_segment_add(idx: torch.Tensor, upd: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``zeros((num_rows, F)).at[idx].add(upd)`` (scatter.py:28): ``idx [M]``
    int rows, ``upd [M, F]``; returns ``[num_rows, F]`` in ``upd``'s dtype,
    summed in f32. Indices lie in [0, num_rows]; an update at ``num_rows``
    is dropped, as the reference's merged sort drops it (its key sorts after
    every row's query)."""
    out = torch.zeros((num_rows + 1, upd.shape[-1]), dtype=torch.float32, device=upd.device)
    out.index_add_(0, idx, upd.to(torch.float32))
    return out[:num_rows].to(upd.dtype)
